"""Model configuration: a copy of ``repro/configs/base.py`` ``ModelConfig``,
and of its dry-run shapes (``ShapeConfig``, ``SHAPES``,
``shape_applicable``).

The port keeps its own copy so that it imports nothing of the reference
package.  Fields and ``reduced()`` are the reference's, unchanged, so a
config built here describes the same model as its namesake there.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // n_heads

    # --- attention variants ---
    rope_theta: float = 10_000.0
    sliding_window: int = 0                # >0: local-attention window size
    local_global_every: int = 0            # N: every Nth layer is global
    attn_logit_softcap: float = 0.0        # gemma2-style tanh capping
    final_logit_softcap: float = 0.0
    qk_norm: bool = False

    # --- MoE ---
    n_experts: int = 0
    n_experts_active: int = 0              # top-k
    moe_d_ff: int = 0                      # routed expert hidden dim
    shared_expert_d_ff: int = 0            # shared expert(s) hidden dim
    moe_every: int = 1                     # llama4: MoE every Nth layer

    # --- SSM (mamba) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mamba_version: int = 1                 # 1: falcon-mamba, 2: zamba2
    ssm_head_dim: int = 64                 # mamba2 heads

    # --- hybrid (zamba2) ---
    attn_every: int = 0                    # insert shared attn block every N
    n_shared_attn_blocks: int = 0          # distinct shared blocks, cycled

    # --- multimodal stubs ---
    cross_attn_every: int = 0              # vlm: cross-attn block every N
    n_media_tokens: int = 0                # vision/audio stub token count
    media_embed_dim: int = 0               # stub frontend output dim

    # --- misc ---
    norm_eps: float = 1e-6
    act: str = "silu"                      # silu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- framework features ---
    remat_policy: str = "dots"             # none | dots | full
    overlap: str = "none"                  # none | shared_bus (paper technique)
    constrain_activations: bool = False    # pin residual stream to pure-DP
    #   sharding at layer boundaries (weights gather; activations stay put)
    constrain_internals: bool = False      # additionally pin qkv + mlp hidden
    #   activations (kills partial-sum all-reduces; §Perf iteration 5)
    unroll_layers: bool = False            # dry-run cost probes: XLA counts
    #   scan bodies once, so probes compile fully unrolled (dryrun.py)

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic long-context: SSM / hybrid / mostly-local attention.

        The local:global allowance requires a mostly-local design (>= 4
        local layers per global, e.g. gemma3's 5:1 128k-context recipe);
        gemma2's 1:1 alternation is an 8k-context design and is excluded
        (DESIGN.md Sec 5)."""
        return self.family in ("ssm", "hybrid") or (
            self.sliding_window > 0 and self.local_global_every >= 5)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        def cut(v, lo=1):
            return max(lo, v)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if self.attn_every or
                         self.cross_attn_every else 2),
            d_model=64,
            n_heads=cut(min(self.n_heads, 4)),
            n_kv_heads=cut(min(self.n_kv_heads, 2)),
            head_dim=16 if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            sliding_window=min(self.sliding_window, 8) if self.sliding_window
            else 0,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            n_experts_active=min(self.n_experts_active, 2)
            if self.n_experts_active else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            shared_expert_d_ff=64 if self.shared_expert_d_ff else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_head_dim=16 if self.family in ("ssm", "hybrid") else 64,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            cross_attn_every=min(self.cross_attn_every, 2)
            if self.cross_attn_every else 0,
            n_media_tokens=min(self.n_media_tokens, 8)
            if self.n_media_tokens else 0,
            media_embed_dim=32 if self.media_embed_dim else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch, shape) cell runs; reason recorded in EXPERIMENTS.md."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("SKIP: pure full-attention architecture; 500k context "
                       "requires sub-quadratic attention (DESIGN.md Sec 5)")
    return True, "ok"
