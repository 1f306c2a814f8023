"""Device time a traced batch in kernels that are neither cuBLAS's GEMMs
nor the port's own (eager elementwise work, reductions, copies)."""


def read(rec):
    if rec.kind != "score" or rec.trace is None or not rec.traced:
        return None
    t = rec.trace.seconds("eager")
    return t / len(rec.traced) * 1e3 if t else None
