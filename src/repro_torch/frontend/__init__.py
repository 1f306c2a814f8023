"""Model-inference workload frontend (PyTorch port of ``repro/frontend/``).

Lowers the model zoo (:mod:`repro_torch.configs`) into the simulator's
structural :class:`~repro_torch.core.ir.TaskGraph` IR and registers every
registry arch as an app, so a sweep or a placement names a model the same
way it names a Fig-8 micro-app::

    from repro_torch.core import taskgraph

    g = taskgraph.structural("qwen2-moe-a2.7b", phase="prefill",
                             n_pes=64, n_layers=2)

Importing this package is what performs the registration;
:func:`repro_torch.core.taskgraph.structural` (and therefore the batch
sweeps) import it lazily on the first unknown app name, so the model half
of the simulator stays off the hot import path of pure-Fig-8 runs.
"""

from repro_torch.frontend.lower import (  # noqa: F401
    MODEL_APPS, MODEL_PARAMS, MODEL_PHASES, _model_struct, decode_step,
    kv_tiles_for, lower, model_struct)
from repro_torch.core import taskgraph


def register() -> None:
    """Register every registry arch as a structural app (idempotent)."""
    for arch in MODEL_APPS:
        if arch in taskgraph.known_apps(load_registered=False):
            continue

        def fn(_arch=arch, **kw):
            return model_struct(_arch, **kw)

        fn.cache_clear = _model_struct.cache_clear
        taskgraph.register_app(arch, fn, MODEL_PARAMS)


register()
