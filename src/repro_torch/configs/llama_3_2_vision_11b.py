"""Llama-3.2 11B Vision [hf:meta-llama/Llama-3.2-11B-Vision (unverified)].

40-layer text backbone with gated cross-attention blocks every 5th layer
attending to vision tokens; the ViT frontend is a stub — ``input_specs``
provides precomputed patch embeddings (1601 tokens x 4096).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14_336, vocab_size=128_256,
    cross_attn_every=5,
    n_media_tokens=1601, media_embed_dim=4096,  # stub ViT output
    rope_theta=500_000.0,
)
