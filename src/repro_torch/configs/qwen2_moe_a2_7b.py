"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

60 routed experts (top-4, expert d_ff=1408) + 4 shared experts (fused as one
5632-wide shared MLP), 24 layers, GQA with 16 kv heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab_size=151_936,
    n_experts=60, n_experts_active=4, moe_d_ff=1408,
    shared_expert_d_ff=5632,
    rope_theta=1_000_000.0,
)
