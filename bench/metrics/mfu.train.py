"""The training step's share of the card's bf16 peak: the benchmark's
model FLOPs a step (no recompute) over the median step time."""

import statistics

from yardstick import flops, peaks


def read(rec):
    if rec.kind != "train" or not rec.step_s:
        return None
    work = flops.train_step_flops(rec.model, rec.spec["batch"],
                                  rec.spec["seq_len"])
    return 100.0 * work / statistics.median(rec.step_s) \
        / peaks.PEAK_BF16_FLOPS
