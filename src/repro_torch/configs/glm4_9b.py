"""GLM-4 9B [hf:THUDM/glm-4-9b]: RoPE, aggressive GQA (kv=2)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13_696, vocab_size=151_552,
    rope_theta=10_000.0, norm_eps=1.5625e-7,
)
