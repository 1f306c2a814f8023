"""Share of the traced window in which no kernel ran on the device."""


def read(rec):
    if rec.trace is None or not rec.trace.kernels:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
