"""Device time a traced step in the program's ``train.forward`` spans
(``model.train_loss``, once a microbatch): from each span's entry to the
end of its last work, by the program's CUDA events."""

from yardstick import spans


def read(rec):
    return spans.device_ms(rec, "train", "train.forward")
