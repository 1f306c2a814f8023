"""Falcon-Mamba 7B [hf:tiiuae/falcon-mamba-7b, arXiv:2410.05355]: pure
Mamba-1, attention-free."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65_024,
    ssm_state=16, ssm_conv=4, ssm_expand=2, mamba_version=1,
)
