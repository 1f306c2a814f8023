"""Device time a traced step in kernels that are neither cuBLAS's GEMMs
nor the port's own: the eager elementwise work, reductions and copies of
``models/layers.py``, ``models/ssm.py`` and ``optim/adamw.py``."""


def read(rec):
    if rec.kind != "train" or rec.trace is None or not rec.traced:
        return None
    t = rec.trace.seconds("eager")
    return t / len(rec.traced) * 1e3 if t else None
