"""Device time a traced step in the program's ``train.optimizer`` span
(``adamw.apply_updates``: the global norm, the clip, the chunked passes),
by its CUDA events."""

from yardstick import spans


def read(rec):
    return spans.device_ms(rec, "train", "train.optimizer")
