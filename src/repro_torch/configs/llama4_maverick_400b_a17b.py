"""Llama-4-Maverick 400B-A17B MoE backbone [hf:meta-llama (unverified)].

48 layers, d_model 5120, GQA kv=8; MoE every 2nd layer (interleave step 2,
as published for Maverick): 128 routed experts top-1 (expert d_ff 8192) plus
one shared expert; dense layers use d_ff 16384.  This lands at ~400B total /
~17B active parameters, matching the model name.  The early-fusion
multimodal frontend is out of scope for the LM backbone (text path).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=16_384, vocab_size=202_048,
    n_experts=128, n_experts_active=1, moe_d_ff=8192,
    shared_expert_d_ff=8192, moe_every=2,
    rope_theta=500_000.0, qk_norm=True,
)
