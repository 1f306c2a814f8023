"""Zamba2-2.7B hybrid [arXiv:2411.15242].

54 Mamba2 layers with 2 shared full-attention blocks cycled in every 6
layers (the shared-block weight reuse is Zamba's signature).  MHA kv=32,
head_dim 80, ssm_state 64.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10_240, vocab_size=32_000,
    ssm_state=64, mamba_version=2, ssm_head_dim=64,
    attn_every=6, n_shared_attn_blocks=2,
)
