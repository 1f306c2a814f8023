"""Operations and bytes of the functions the benchmark bounds, from their
shapes alone: the flash attention forward and backward, the Mamba-2 scan
forward and backward, and the model's own FLOPs a training step or a
prefill.  Frozen copies of ``chip_smoke.py``'s ``attn_cost``,
``_bwd_cost``, ``_mamba2_cost`` and ``_mamba2_bwd_cost`` (the function's
least work, not a kernel design's), and a model count of the benchmark's
own that reads only the configuration file's ``model`` sizes.

A bound is ``max(flops / peak rate, bytes / peak bandwidth)``: each input
read once and each output written once.
"""

from __future__ import annotations

from yardstick import peaks

SSD_CHUNK = 64          # the chunk of the Mamba-2 scan's SSD form


def bound_seconds(flops: float, nbytes: float,
                  peak_flops: float = peaks.PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the peak bandwidth."""
    return max(flops / peak_flops, nbytes / peaks.PEAK_BYTES)


def flash_fwd(B: int, Tq: int, Tk: int, H: int, K: int, D: int,
              itemsize: int, causal: bool = True, lse: bool = False
              ) -> tuple[int, int]:
    """q.k and p.v over the unmasked pairs (two products of depth D; a
    causal call has Tq == Tk); q, k, v read and o written once, and the
    float32 row log-sum-exp written when the call returns it (the training
    forward)."""
    if causal and Tq != Tk:
        raise ValueError(f"a causal call has Tq == Tk, got {Tq}, {Tk}")
    pairs = Tq * (Tq + 1) // 2 if causal else Tq * Tk
    flops = 4 * D * pairs * B * H
    nbytes = itemsize * D * (2 * B * Tq * H + 2 * B * Tk * K)
    if lse:
        nbytes += 4 * B * H * Tq
    return flops, nbytes


def flash_bwd(B: int, T: int, H: int, K: int, D: int, itemsize: int
              ) -> tuple[int, int]:
    """The causal gradient's five T x T x D products over the pairs a query
    sees; q, k, v, o, dO and the LSE read once, dQ, dK, dV written once."""
    pairs = T * (T + 1) // 2
    flops = 5 * 2 * D * pairs * B * H
    nbytes = itemsize * D * (4 * B * T * H + 4 * B * T * K) + 4 * B * H * T
    return flops, nbytes


def mamba2_fwd(B: int, T: int, H: int, P: int, N: int, itemsize: int
               ) -> tuple[int, int]:
    """The Mamba-2 scan as the chunked product (SSD, chunk Q): a chunk's
    C B^T (shared by the heads), each head's masked (C B^T) X, its chunk
    state B^T X and the carried state's output C h, ~2 B T (Q N + H P (Q +
    2 N)) flops, at the TF32 rate (the state is float32).  dt, x, b, c, A,
    h0 read once; y (float32) and the last state written once."""
    Q = min(SSD_CHUNK, T)
    flops = 2 * B * T * (Q * N + H * P * (Q + 2 * N))
    nbytes = (4 * B * T * H + itemsize * B * T * H * P
              + 2 * itemsize * B * T * N + 4 * H + 2 * 4 * B * H * P * N
              + 4 * B * T * H * P)
    return flops, nbytes


def mamba2_bwd(B: int, T: int, H: int, P: int, N: int, itemsize: int
               ) -> tuple[int, int]:
    """Each of the forward's products differentiated once for each
    operand: twice its flops.  dt, x, b, c, A, h0, dy and dh_last read
    once; ddt, dx, db, dc, dA and dh0 written once."""
    flops = 2 * mamba2_fwd(B, T, H, P, N, itemsize)[0]
    nbytes = (2 * (4 * B * T * H + itemsize * B * T * H * P
                   + 2 * itemsize * B * T * N + 4 * H)
              + 3 * 4 * B * H * P * N + 4 * B * T * H * P)
    return flops, nbytes


# --- the model's FLOPs -------------------------------------------------

def _attn_params(m: dict) -> int:
    d, H, K, Dh = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    return d * H * Dh + 2 * d * K * Dh + H * Dh * d


def _mlp_params(m: dict) -> int:
    return 3 * m["d_model"] * m["d_ff"]


def _mamba2_params(m: dict) -> int:
    """in_proj, bc_proj, dt_proj_h, out_proj of one Mamba-2 layer."""
    d = m["d_model"]
    di = m["ssm_expand"] * d
    H = di // m["ssm_head_dim"]
    return d * 2 * di + d * 2 * m["ssm_state"] + d * H + di * d


def _attn_core(m: dict, T: int) -> int:
    """Q K^T and P V of one causal attention layer over one sequence."""
    return 4 * m["n_heads"] * m["head_dim"] * (T * (T + 1) // 2)


def forward_flops(m: dict, B: int, T: int, logit_positions: int) -> int:
    """FLOPs of one forward pass over B sequences of T tokens, counting
    every matrix product of the model (attention's over the causal pairs,
    the Mamba-2 scan's SSD products) and the unembedding at
    ``logit_positions`` positions a sequence; no recompute, no elementwise
    work.  ``m`` is a configuration file's ``model``."""
    d, V, L = m["d_model"], m["vocab_size"], m["n_layers"]
    tokens = B * T
    if m["family"] == "dense":
        per_token = L * (_attn_params(m) + _mlp_params(m))
        core = L * B * _attn_core(m, T)
    elif m["family"] == "hybrid":
        n_shared = L // m["attn_every"]
        per_token = (L * _mamba2_params(m)
                     + n_shared * (_attn_params(m) + _mlp_params(m)))
        di = m["ssm_expand"] * d
        scan = mamba2_fwd(B, T, di // m["ssm_head_dim"], m["ssm_head_dim"],
                          m["ssm_state"], 2)[0]
        core = n_shared * B * _attn_core(m, T) + L * scan
    else:
        raise ValueError(f"no FLOP count for family {m['family']!r}")
    return 2 * tokens * per_token + core + 2 * B * logit_positions * d * V


def train_step_flops(m: dict, B: int, T: int) -> int:
    """Model FLOPs of one training step: the forward with logits at every
    position, and the backward's two products for each of its products."""
    return 3 * forward_flops(m, B, T, T)


def prefill_flops(m: dict, T: int) -> int:
    """Model FLOPs of one request's prefill of T prompt tokens, alone and
    unpadded: the forward and the last position's logits."""
    return forward_flops(m, 1, T, 1)
