"""MusicGen-medium decoder backbone [arXiv:2306.05284; hf:facebook/musicgen-medium].

Decoder-only transformer over EnCodec tokens (vocab 2048).  The EnCodec /
text-conditioning frontend is a stub: ``input_specs`` provides precomputed
conditioning frame embeddings (n_media_tokens) prepended to the sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    n_media_tokens=64, media_embed_dim=1536,   # stub conditioning frames
    act="gelu", norm_eps=1e-5,
)
