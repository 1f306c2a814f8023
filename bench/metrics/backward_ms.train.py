"""Device time a traced step in the program's ``train.backward`` spans
(``torch.autograd.grad``, remat's recompute included), by its CUDA
events."""

from yardstick import spans


def read(rec):
    return spans.device_ms(rec, "train", "train.backward")
