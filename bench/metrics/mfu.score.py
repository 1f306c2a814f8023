"""The prefill's share of the card's bf16 peak: each completed request's
model FLOPs, alone and unpadded, over the window's time."""

from yardstick import flops, peaks


def read(rec):
    if rec.kind != "score" or not rec.lengths:
        return None
    work = sum(flops.prefill_flops(rec.model, n)
               for batch in rec.lengths for n in batch)
    return 100.0 * work / rec.window_s / peaks.PEAK_BF16_FLOPS
