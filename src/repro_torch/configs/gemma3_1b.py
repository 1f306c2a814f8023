"""Gemma-3 1B [hf:google/gemma-3-1b-pt (unverified)].

26 layers, 5:1 local:global attention (window 512), MQA (1 kv head),
head_dim 256, huge 262k vocab, 128k context capable.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262_144,
    sliding_window=512, local_global_every=6,   # every 6th layer global
    rope_theta=1_000_000.0, qk_norm=True,
    final_logit_softcap=30.0, act="gelu", tie_embeddings=True,
)
