"""The flash forward's bound (causal attention at each batch's padded
length) over its kernels' device time (``fa_fwd*``)."""

from yardstick import calls


def read(rec):
    return calls.roofline(rec, "flash_fwd") if rec.kind == "score" else None
