"""Gemma-2 9B [arXiv:2408.00118].

42 layers, alternating local(4096-window)/global attention, GQA kv=8,
head_dim 256, attention and final logit soft-capping.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14_336, vocab_size=256_000,
    sliding_window=4096, local_global_every=2,  # alternate local/global
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    act="gelu", tie_embeddings=True,
)
