"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet),
frozen here as the yardstick's copy of ``chip_smoke.py``'s constants.

They assume the card's full 700 W power limit; a run records the limit
``nvidia-smi`` reports beside its numbers.
"""

PEAK_BF16_FLOPS = 989e12        # tensor cores, bf16, no sparsity
PEAK_TF32_FLOPS = 495e12        # tensor cores, TF32
PEAK_BYTES = 3.35e12            # HBM3, bytes a second
