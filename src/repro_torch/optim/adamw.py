"""AdamW with optional 8-bit (block-quantized) moments (PyTorch port of
``repro/optim/adamw.py``).

The arithmetic is the reference's step for step: the gradient widened to
float32 and scaled by the clip factor, the moment updates, the bias
corrections, ``new_p = (p.float() - lr * u).to(p.dtype)``; the 8-bit
variant keeps m and sqrt(v) as int8 codes with per-block float32 scales.

Unlike the reference's functional update, ``apply_updates`` writes the
parameters and the moments **in place**, leaf by leaf, and each leaf in
chunks over its leading dim: at full width a functional update would hold
two copies of params + m + v (2 x ~25 GB for granite-3-2b), and one float32
temporary of its largest stacked leaf (40 x 2048 x 8192) is 2.7 GB.  So a
failure once the writes have begun leaves a state that mixes two steps:
``apply_updates`` then raises ``PartialUpdateError``, which must not be
retried on that state.

DTensor parameters (a model under a ``DeviceMesh``) get DTensor moments of
the same placements; the update runs on each rank's local shards, the
gradient first redistributed to its parameter's placements, and the global
norm is summed over every rank's shards.  An 8-bit moment of a DTensor
parameter holds the blocks of each rank's local shard, in its local flat
order (``_zeros_q_sharded``): the update then needs no collective.  Where
a shard's contiguous runs are whole blocks (its last sharded dim's local
extent times the dims after it a multiple of ``BLOCK``) these are the
reference's blocks, and the step equals the step without a mesh;
elsewhere a block that the reference's flat order would lay across two
shards is two blocks here, each with its own scale.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator

import torch

from repro_torch import tree
from repro_torch.core.overlap import compression

Params = Any

CHUNK = 1 << 26          # elements of a leaf updated at once (256 MB in f32)


class PartialUpdateError(RuntimeError):
    """``apply_updates`` failed in its in-place update: the state may hold
    some leaves of the new step and some of the old one."""


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_bits: int = 32          # 32 | 8


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in float32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _zeros_q(p: torch.Tensor) -> dict:
    """``quantize`` of zeros, built directly: zero codes, zero scales."""
    from repro_torch.kernels._symbolic import is_dtensor

    if is_dtensor(p):
        return _zeros_q_sharded(p)
    return _zero_blocks(-(-p.numel() // compression.BLOCK), p.device)


def _zero_blocks(n: int, device) -> dict:
    return {"c": torch.zeros((n, compression.BLOCK), dtype=torch.int8,
                             device=device),
            "s": torch.zeros((n,), dtype=torch.float32, device=device)}


def _zeros_q_sharded(p) -> dict:
    """The 8-bit zero moment of the DTensor ``p``: on each rank the blocks
    of its local shard (as many as the largest shard needs), as DTensors
    sharded on dim 0 over every mesh dimension that shards ``p`` and
    replicated over the others."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = p.device_mesh
    size, n = list(p.shape), 1
    for i, pl in enumerate(p.placements):
        if pl.is_shard():
            size[pl.dim] = -(-size[pl.dim] // mesh.size(i))
            n *= mesh.size(i)
    nb = -(-math.prod(size) // compression.BLOCK)
    placements = [Shard(0) if pl.is_shard() else Replicate()
                  for pl in p.placements]
    local = _zero_blocks(nb, p.to_local().device)
    return {k: DTensor.from_local(
        t, mesh, placements, run_check=False, shape=(n * nb, *t.shape[1:]),
        stride=t.stride()) for k, t in local.items()}


def init_state(cfg: AdamWConfig, params: Params) -> dict:
    def zeros(p):
        # zeros_like: a DTensor parameter gets a moment of its placements
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)

    make = _zeros_q if cfg.state_bits == 8 else zeros
    dev = tree.leaves(params)[0].device
    return {"m": tree.map_leaves(make, params),
            "v": tree.map_leaves(make, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _chunks(p: torch.Tensor, align: int = 1) -> Iterator[tuple[slice, int]]:
    """(rows, flat start) pieces of ``p`` over its leading dim, each at most
    ``CHUNK`` elements where the row size allows and each a multiple of
    ``align`` elements; one piece when it cannot be cut so."""
    rows = p.shape[0] if p.dim() else 1
    row = p.numel() // max(rows, 1)
    step = align // math.gcd(row, align) if row else 1
    per = (CHUNK // max(row, 1)) // step * step
    if p.dim() == 0 or per == 0 or per >= rows:
        yield slice(None), 0
        return
    for r0 in range(0, rows, per):
        yield slice(r0, min(rows, r0 + per)), r0 * row


def _local(t: torch.Tensor, like: torch.Tensor | None = None
           ) -> torch.Tensor:
    """The local shard of a DTensor (first redistributed to ``like``'s
    placements); a plain tensor as it is."""
    from repro_torch.kernels._symbolic import is_dtensor

    if not is_dtensor(t):
        return t
    if like is not None and t.placements != like.placements:
        t = t.redistribute(like.device_mesh, like.placements)
    return t.to_local()


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` on ``p``'s placements when both are DTensors."""
    from repro_torch.kernels._symbolic import is_dtensor

    if is_dtensor(g) and is_dtensor(p) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    """sum(g^2) in float32, chunk by chunk; for a DTensor over its local
    shard, then summed over the ranks that hold other shards."""
    from repro_torch.kernels._symbolic import is_dtensor

    if not is_dtensor(g):
        total = 0
        for sl, _ in _chunks(g):
            total = total + torch.sum(torch.square(g[sl].float()))
        return total
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = g.device_mesh
    g = g.redistribute(mesh, [Replicate() if p.is_partial() else p
                              for p in g.placements])
    local = _square_sum(g.to_local())
    if not isinstance(local, torch.Tensor):
        local = torch.zeros((), dtype=torch.float32, device=g.device)
    return DTensor.from_local(
        local, mesh, [Partial() if p.is_shard() else Replicate()
                      for p in g.placements], run_check=False).full_tensor()


def global_norm(grads) -> torch.Tensor:
    total = 0
    for g in tree.leaves(grads):
        total = total + _square_sum(g)
    return torch.sqrt(total)


def _dq(q: dict, start: int, shape: tuple[int, ...]) -> torch.Tensor:
    """Dequantize the blocks of one chunk (flat offset ``start``)."""
    b0 = start // compression.BLOCK
    n = -(-math.prod(shape) // compression.BLOCK)
    return compression.dequantize(q["c"][b0:b0 + n], q["s"][b0:b0 + n],
                                  shape, torch.float32)


def _store_q(q: dict, start: int, x: torch.Tensor) -> None:
    c, s = compression.quantize(x)
    b0 = start // compression.BLOCK
    q["c"][b0:b0 + c.shape[0]].copy_(c)
    q["s"][b0:b0 + s.shape[0]].copy_(s)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Params, grads: Params,
                  state: dict) -> tuple[Params, dict, dict]:
    """One AdamW step, in place.  Returns (params, state, metrics): the
    same parameter and moment tensors, updated, and a new step counter.
    A failure in the gradient norm leaves the state as it was; one in the
    leaf-by-leaf update raises ``PartialUpdateError``."""
    step = _local(state["step"]) + 1       # a replicated DTensor: its copy
    # a DTensor gradient (a partial sum, or another layout) takes its
    # parameter's placements first: a reduce-scatter, not a gather
    grads = tree.unflatten(grads, [_like(g, p) for g, p in zip(
        tree.leaves(grads), tree.leaves(params))])
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip > 0 else 1.0
    lr = schedule(cfg, step)
    bc1 = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(cfg.b2, step.to(torch.float32))
    eight = cfg.state_bits == 8

    def upd(p, g, m, v):
        for sl, start in _chunks(p, compression.BLOCK if eight else 1):
            pc = p[sl]
            gf = g[sl].float() * scale
            if eight:
                mf = _dq(m, start, tuple(pc.shape))
                vf = torch.square(_dq(v, start, tuple(pc.shape)))
            else:
                mf, vf = m[sl], v[sl]
            mf = cfg.b1 * mf + (1 - cfg.b1) * gf
            vf = cfg.b2 * vf + (1 - cfg.b2) * torch.square(gf)
            u = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
            u = u + cfg.weight_decay * pc.float()
            pc.copy_((pc.float() - lr * u).to(p.dtype))
            if eight:
                _store_q(m, start, mf)
                _store_q(v, start, torch.sqrt(vf))
            else:
                m[sl].copy_(mf)
                v[sl].copy_(vf)

    flat_p = tree.leaves(params)
    moments = list(zip(_moment_leaves(state["m"], len(flat_p), eight),
                       _moment_leaves(state["v"], len(flat_p), eight)))
    for i, (p, g, (m, v)) in enumerate(zip(flat_p, tree.leaves(grads),
                                           moments)):
        try:
            if eight:
                m, v = _local_q(m, p), _local_q(v, p)
            else:
                m, v = _local(m), _local(v)
            upd(_local(p), _local(g, p), m, v)
        except Exception as e:
            raise PartialUpdateError(
                f"AdamW failed at leaf {i} of {len(flat_p)}: the leaves "
                "before it, and part of it, may hold the new step") from e
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics


def _local_q(q: dict, p: torch.Tensor) -> dict:
    """The local codes and scales of the 8-bit moment of ``p``; for a
    DTensor ``p`` they must hold its local shard's blocks
    (``init_state`` from the DTensor parameters makes them so)."""
    out = {k: _local(t) for k, t in q.items()}
    need = -(-_local(p).numel() // compression.BLOCK)
    if out["s"].shape[0] < need:
        raise ValueError(
            f"an 8-bit moment of {out['s'].shape[0]} blocks for a local "
            f"shard of {need}: make the moments of DTensor parameters with "
            "init_state from the DTensors")
    return out


def _moment_leaves(t, n: int, eight: bool) -> list:
    """One moment per parameter leaf: a tensor, or the {"c", "s"} dict of an
    8-bit moment (the reference's ``flatten_up_to``)."""
    out = []

    def walk(node):
        if isinstance(node, dict) and not (eight and set(node) == {"c", "s"}):
            for key in sorted(node):
                walk(node[key])
        else:
            out.append(node)

    walk(t)
    if len(out) != n:
        raise ValueError(f"{len(out)} moments for {n} parameters")
    return out
