"""Pipeline parallelism with Shared-PIM-style stage hand-off (PyTorch port
of ``repro/train/pipeline.py``).

Stages lie along one mesh dimension, a ``ProcessGroup``; each microbatch's
activations move stage -> stage by ``isend``/``irecv``: the same
double-buffered "shared row" hand-off as ``core/overlap``.  A stage posts
the receive of its next microbatch before it computes the current one, so
one buffer streams in while the stage computes on the other (Fig 4's
pipelining, at pipeline scale).

The GPipe schedule: with S stages and M microbatches the loop runs
S + M - 1 ticks; at tick t, stage s computes microbatch t - s when that is
in range.  Stage 0 takes it from ``xs``; the other stages take what
arrived from stage s - 1 last tick.  Inactive ticks produce nothing (the
reference computes zeros there), and a stage sends only what the next stage
will use.  The last stage records its outputs, and an all-reduce of the
outputs masked to the last stage (the reference's ``psum``) gives them to
every rank.

``pipeline()`` is model-agnostic: it takes a per-stage apply function
``f(stage_params, x) -> x``; each rank passes its own stage's parameters.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.overlap.sharedbus import global_rank


def _stage_body(stage_params, xs: torch.Tensor, f, group,
                n_micro: int) -> torch.Tensor:
    """This rank's stage over the schedule: xs (n_micro, mb, ...) input
    microbatches (only stage 0 reads them).  Returns the stacked outputs,
    zeros except on the last stage."""
    n_stages = dist.get_world_size(group)
    me = dist.get_rank(group)
    outs = torch.zeros_like(xs)
    bufs = [torch.empty_like(xs[0]), torch.empty_like(xs[0])]

    def active(stage, t):
        return 0 <= t - stage < n_micro

    for t in range(n_stages + n_micro - 1):
        works = []
        # the receiving buffer fills with what stage me - 1 computes now ...
        if me > 0 and active(me - 1, t):
            works.append(dist.irecv(bufs[(t + 1) % 2],
                                    global_rank(group, me - 1), group))
        # ... while this stage computes on the resident one
        if active(me, t):
            mb_idx = t - me
            y = f(stage_params, xs[mb_idx] if me == 0 else bufs[t % 2])
            if me == n_stages - 1:
                outs[mb_idx] = y
            else:
                # hand the activations to the next stage ("transmit shared
                # row")
                works.append(dist.isend(y.contiguous(),
                                        global_rank(group, me + 1), group))
        for w in works:
            w.wait()
    return outs


def pipeline(f, stage_params, xs: torch.Tensor, mesh,
             axis_name: str = "pipe") -> torch.Tensor:
    """Run ``f`` as a pipeline over the mesh dimension ``axis_name``.

    stage_params: this rank's stage's parameters.  xs: (n_micro, mb, ...)
    microbatched inputs, the same on every rank.  Returns (n_micro, mb, ...)
    outputs of the final stage, on every rank.
    """
    group = mesh.get_group(axis_name)
    outs = _stage_body(stage_params, xs, f, group, xs.shape[0])
    # only the last stage holds nonzero outputs; the all-reduce broadcasts
    dist.all_reduce(outs, group=group)
    return outs
