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

Gradients flow through the hand-offs as JAX transposes the reference's
``ppermute`` and ``psum``: the receive of a microbatch (``_Recv``) sends
its gradient back to the stage that computed it, and the send (``_Send``)
returns a token that ``_Broadcast`` ties into every rank's output, so
each stage's backward receives its outputs' gradients from the next stage.
The broadcast's output is replicated, so its transpose hands each rank's
cotangent to its own outputs (the reference's ``psum`` transposed in
``shard_map``): the last stage's reach its stage function, the others'
are dropped.  Every stage's backward takes the microbatches in the reverse
order of their forward, so the blocking hand-offs of the backward pair up.

``pipeline()`` is model-agnostic: it takes a per-stage apply function
``f(stage_params, x) -> x``; each rank passes its own stage's parameters.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from repro_torch.core.overlap.sharedbus import global_rank


class _Recv(torch.autograd.Function):
    """Post the receive of a microbatch like ``like`` from global rank
    ``src``; returns the buffer (valid once ``works`` are waited on).
    Backward: send the buffer's gradient back to ``src``.  ``anchors`` (the
    inputs and this stage's parameters) only put the node on the path to
    them, so a backward that asks for their gradients runs it."""

    @staticmethod
    def forward(ctx, src, group, works, like, *anchors):
        buf = torch.empty_like(like)
        works.append(dist.irecv(buf, src, group))
        ctx.src, ctx.group = src, group
        return buf

    @staticmethod
    def backward(ctx, grad):
        dist.send(grad.contiguous(), ctx.src, ctx.group)
        return (None,) * len(ctx.needs_input_grad)


class _Send(torch.autograd.Function):
    """Post the send of ``y`` to global rank ``dst``; returns an empty
    token.  Backward: receive ``y``'s gradient from ``dst``."""

    @staticmethod
    def forward(ctx, y, dst, group, works):
        y = y.contiguous()
        works.append(dist.isend(y, dst, group))
        ctx.dst, ctx.group = dst, group
        ctx.meta = (y.shape, y.dtype, y.device)
        return y.new_empty((0,))

    @staticmethod
    def backward(ctx, _grad):
        shape, dtype, device = ctx.meta
        grad = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(grad, ctx.dst, ctx.group)
        return grad, None, None, None


class _Broadcast(torch.autograd.Function):
    """The all-reduce of the outputs masked to the last stage, which gives
    them to every rank.  Backward: each rank's cotangent to its own
    outputs (the output is replicated); the tokens of the sends get empty
    gradients, which start their backwards."""

    @staticmethod
    def forward(ctx, outs, group, *tokens):
        outs = outs.clone()
        dist.all_reduce(outs, group=group)
        return outs

    @staticmethod
    def backward(ctx, grad):
        return (grad, None,
                *(grad.new_zeros((0,)) for _ in ctx.needs_input_grad[2:]))


def _stage_body(stage_params, xs: torch.Tensor, f, group,
                n_micro: int) -> tuple[torch.Tensor, list]:
    """This rank's stage over the schedule: xs (n_micro, mb, ...) input
    microbatches (only stage 0 reads them).  Returns the stacked outputs,
    zeros except on the last stage, and the tokens of this stage's sends.
    The hand-offs carry gradients when grad mode is on and ``xs`` or a
    parameter requires grad, on every stage alike."""
    n_stages = dist.get_world_size(group)
    me = dist.get_rank(group)
    outs: list = [torch.zeros_like(xs[0])] * n_micro
    tokens = []
    recvd = None
    anchors = [t for t in pytree.tree_leaves(stage_params)
               if isinstance(t, torch.Tensor) and t.requires_grad]

    def active(stage, t):
        return 0 <= t - stage < n_micro

    for t in range(n_stages + n_micro - 1):
        works: list = []
        # the receiving buffer fills with what stage me - 1 computes now ...
        incoming = None
        if me > 0 and active(me - 1, t):
            incoming = _Recv.apply(global_rank(group, me - 1), group, works,
                                   xs[0], *anchors)
        # ... while this stage computes on the resident one
        if active(me, t):
            mb_idx = t - me
            y = f(stage_params, xs[mb_idx] if me == 0 else recvd)
            if me == n_stages - 1:
                outs[mb_idx] = y
            else:
                # hand the activations to the next stage ("transmit shared
                # row")
                tokens.append(_Send.apply(y, global_rank(group, me + 1),
                                          group, works))
        for w in works:
            w.wait()
        recvd = incoming
    return torch.stack(outs), tokens


def pipeline(f, stage_params, xs: torch.Tensor, mesh,
             axis_name: str = "pipe") -> torch.Tensor:
    """Run ``f`` as a pipeline over the mesh dimension ``axis_name``.

    stage_params: this rank's stage's parameters.  xs: (n_micro, mb, ...)
    microbatched inputs, the same on every rank.  Returns (n_micro, mb, ...)
    outputs of the final stage, on every rank.
    """
    group = mesh.get_group(axis_name)
    outs, tokens = _stage_body(stage_params, xs, f, group, xs.shape[0])
    # only the last stage holds nonzero outputs; the all-reduce broadcasts
    return _Broadcast.apply(outs, group, *tokens)
