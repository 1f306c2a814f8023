"""The flash forward's bound (causal attention with its row LSE, at the
training shape) over its kernels' device time (``fa_fwd*``)."""

from yardstick import calls


def read(rec):
    return calls.roofline(rec, "flash_fwd") if rec.kind == "train" else None
