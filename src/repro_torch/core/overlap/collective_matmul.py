"""Collective matmuls: all-gather-matmul and matmul-reduce-scatter rings
(PyTorch port of ``repro/core/overlap/collective_matmul.py``).

The Shared-PIM-style replacements for the blocking collectives around
tensor-parallel products:

* ``ag_matmul``: Y = X @ W with X sequence-sharded and W column-sharded.
  Instead of all-gathering X and then multiplying, the X chunks ride the
  ring; each step multiplies the resident chunk while the next is in
  flight.
* ``matmul_rs``: Y = X @ W with W row-sharded, output sequence-sharded.
  Instead of a full partial-sum product and a blocking reduce-scatter, the
  partial sums ride the ring, each hop overlapped with the next chunk's
  product.

The ``*_body`` functions are the shard_map bodies of the reference: they
run on every rank of ``group`` with that rank's local shards.  The others
take a ``DeviceMesh`` and the name of its dimension, as the reference takes
a mesh and an axis name, and are called with the local shards too (eager
PyTorch has no shard_map to split global arrays).  The products stay plain
``torch.einsum``, as the reference's are plain ``jnp``.

Both are differentiable: every ring hand-off is ``sharedbus.shift``, whose
backward is the reverse hand-off.  So ``ag_matmul``'s input gradient
reduce-scatters along the ring back to each chunk's owner, and
``matmul_rs``'s backward all-gathers the output cotangent along it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.overlap import sharedbus


def ag_matmul_body(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """x: (B, T/n, D) local; w: (D, F/n) local.

    Returns (B, T, F/n): the all-gathered-dim output, computed chunk by
    chunk while the chunks circulate.
    """
    n = dist.get_world_size(group)
    B, t, _ = x.shape
    F = w.shape[1]
    out0 = torch.zeros((n, B, t, F), dtype=x.dtype, device=x.device)

    def consume(acc, chunk, src):
        acc[src] = torch.einsum("btd,df->btf", chunk, w)
        return acc

    out = sharedbus.stream_ring(x, group, consume, out0)
    return out.transpose(0, 1).reshape(B, n * t, F)


def matmul_rs_body(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """x: (B, T, F/n) local; w: (F/n, D) local.

    Returns (B, T/n, D): reduce-scattered over T.  Step i computes the
    partial product for the chunk i hops ahead and adds it to the incoming
    partial sums; the accumulator goes to the neighbour ("transmit shared
    row") while the next partial product is computed.  It is handed on
    n - 1 times and kept on the last step, at its home rank.
    """
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    B, T, f = x.shape
    t = T // n

    def part(i):
        # the accumulator arriving at step i represents chunk (me - 1 - i);
        # after n steps it sits at its home rank (= chunk me)
        idx = (me + n - 1 - i) % n
        return torch.einsum("btf,fd->btd", x[:, idx * t:(idx + 1) * t], w)

    acc = part(0)
    for i in range(1, n):
        works: list = []
        recv = sharedbus.shift(acc, 1, group, works)
        p = part(i)                      # overlapped with the hand-off
        for wk in works:
            wk.wait()
        acc = recv + p
    return acc


def ag_matmul(x: torch.Tensor, w: torch.Tensor, mesh,
              axis_name: str = "model") -> torch.Tensor:
    """Local Y[B, T, F/n] of X[B, T, D] @ W[D, F], X seq-sharded and W
    col-sharded on ``axis_name``: x is (B, T/n, D), w is (D, F/n)."""
    return ag_matmul_body(x, w, mesh.get_group(axis_name))


def matmul_rs(x: torch.Tensor, w: torch.Tensor, mesh,
              axis_name: str = "model") -> torch.Tensor:
    """Local Y[B, T/n, D] = reduce_scatter_T(X[B, T, F] @ W[F, D]) with F
    sharded: x is (B, T, F/n), w is (F/n, D)."""
    return matmul_rs_body(x, w, mesh.get_group(axis_name))


def overlapped_ffn(x: torch.Tensor, wi_gate: torch.Tensor,
                   wi_up: torch.Tensor, wo: torch.Tensor, mesh, act,
                   axis_name: str = "model") -> torch.Tensor:
    """Full Shared-PIM-style TP FFN: AG-matmul in, matmul-RS out.

    x arrives sequence-sharded, (B, T/n, D) locally; returns the same
    layout.  The two blocking collectives (all-gather before,
    reduce-scatter after) become rings overlapped with the two products.
    """
    g = ag_matmul(x, wi_gate, mesh, axis_name)
    u = ag_matmul(x, wi_up, mesh, axis_name)
    h = act(g) * u
    return matmul_rs(h, wo, mesh, axis_name)
