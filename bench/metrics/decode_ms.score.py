"""Device time a traced batch in the program's ``serve.decode_step``
spans (each lockstep iteration: ``decode_step``, sampling, the host copy),
by its CUDA events."""

from yardstick import spans


def read(rec):
    return spans.device_ms(rec, "score", "serve.decode_step")
