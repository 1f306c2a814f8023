"""The flash backward's bound (the causal gradient's five products) over
its kernels' device time (``delta_kernel``, ``dkdv_*``, ``dq_*``)."""

from yardstick import calls


def read(rec):
    return calls.roofline(rec, "flash_bwd") if rec.kind == "train" else None
