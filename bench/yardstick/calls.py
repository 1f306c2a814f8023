"""The kernel calls a traced window made, with their shapes, and the
roofline share of a kind of kernel: the bound of every call (``flops``)
over the device seconds its kernels took (``trace``).

A training step's calls all have the step's shape, so their number is the
program's launch counter over the traced steps.  A scoring batch's prefill
makes one flash forward a shared attention layer and one chunked Mamba-2
scan a Mamba-2 layer at its padded length; the counters must agree, or
the share is not read.
"""

from __future__ import annotations

from yardstick import flops
from yardstick.peaks import PEAK_BF16_FLOPS, PEAK_TF32_FLOPS


def n_attn(m: dict) -> int:
    return m["n_layers"] // m["attn_every"] if m["family"] == "hybrid" \
        else m["n_layers"]


def n_mamba(m: dict) -> int:
    return m["n_layers"] if m["family"] == "hybrid" else 0


def _scan_dims(m: dict) -> tuple[int, int, int]:
    di = m["ssm_expand"] * m["d_model"]
    return di // m["ssm_head_dim"], m["ssm_head_dim"], m["ssm_state"]


def bounds(rec, kind: str) -> float | None:
    """Seconds the card needs at least for the traced window's calls of
    one kind; None where the program's counters disagree with the calls
    the shapes give."""
    m = rec.model
    H, K, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    total = 0.0
    for unit in rec.traced:
        B, T, launches = unit["B"], unit["T"], unit["launches"]
        if kind == "flash_fwd":
            n = launches["flash_fwd"]
            if rec.kind == "score" and n != n_attn(m):
                return None
            cost = flops.flash_fwd(B, T, T, H, K, D, 2,
                                   lse=rec.kind == "train")
            peak = PEAK_BF16_FLOPS
        elif kind == "flash_bwd":
            n = launches["flash_bwd"]
            cost, peak = flops.flash_bwd(B, T, H, K, D, 2), PEAK_BF16_FLOPS
        elif kind == "mamba2_scan_fwd":
            n = launches["mamba2_scan"]
            if rec.kind == "score":
                decode = n_mamba(m) if unit["decode_step"] else 0
                if n != n_mamba(m) + decode:
                    return None
                n = n_mamba(m)
            cost = flops.mamba2_fwd(B, T, *_scan_dims(m), 2)
            peak = PEAK_TF32_FLOPS
        elif kind == "mamba2_scan_bwd":
            n = launches["mamba2_scan_bwd"]
            cost, peak = flops.mamba2_bwd(B, T, *_scan_dims(m), 2), \
                PEAK_TF32_FLOPS
        else:
            raise ValueError(f"no bound for {kind!r}")
        total += n * flops.bound_seconds(*cost, peak_flops=peak)
    return total


def roofline(rec, kind: str) -> float | None:
    """100 x bound / device time of the kind's kernels in the traced
    window; None where it ran none or the calls are unknown."""
    if rec.trace is None:
        return None
    t = rec.trace.seconds(kind)
    b = bounds(rec, kind)
    if not t or not b:
        return None
    return 100.0 * b / t
