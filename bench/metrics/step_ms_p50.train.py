"""Median host-clock time of the window's training steps, each ending in
the host read of its loss (``train/train_step.py``'s step)."""

import statistics


def read(rec):
    if rec.kind != "train" or not rec.step_s:
        return None
    return statistics.median(rec.step_s) * 1e3
