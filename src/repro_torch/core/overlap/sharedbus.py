"""SharedBus: the Shared-PIM staging-row abstraction on a ring of ranks
(PyTorch port of ``repro/core/overlap/sharedbus.py``).

The paper's mechanism: two *shared rows* per subarray, one transmitting
while one receives, let the bus move data concurrently with subarray
compute.  On one dimension of a mesh, a ``ProcessGroup``, the analogue is a
double-buffered ring: at step *i* a rank computes on the resident buffer
("the row being consumed") while the other buffer ("the receiving shared
row") is filled by its neighbour.  Each step posts the ``isend``/``irecv``
of the next chunk (``dist.batch_isend_irecv``) before it consumes the
resident chunk and waits after, so the transfer costs max(compute,
transfer), not the sum.

The functions run on every rank of ``group`` (``None``: the default group)
with that rank's local chunk, the shard_map body's contract in the
reference.  The last step starts no transfer (the reference's last hop
carries a chunk nobody reads), so a group of one sends nothing.

Every hand-off is differentiable (``shift``): the transpose of a +shift
send is a -shift send, so a gradient that reaches a received chunk travels
back to the rank that sent it, as JAX transposes the reference's
``ppermute``.  The backward's hand-offs are blocking.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def ring_perm(group=None, shift: int = 1) -> list[tuple[int, int]]:
    n = dist.get_world_size(group)
    return [(i, (i + shift) % n) for i in range(n)]


def global_rank(group, rank: int) -> int:
    """The global rank of ``group``'s rank ``rank``."""
    return rank if group is None else dist.get_global_rank(group, rank)


def shift_start(sends, recvs, shifts, group, tag0: int = 0) -> list:
    """Start sending each ``sends[j]`` to the rank ``shifts[j]`` ahead on the
    ring and receiving ``recvs[j]`` from the rank ``shifts[j]`` behind (tag
    ``tag0 + j``); returns the requests to wait on (none in a group of
    one)."""
    n = dist.get_world_size(group)
    if n == 1:
        return []
    me = dist.get_rank(group)
    ops = []
    for tag, (s, r, shift) in enumerate(zip(sends, recvs, shifts), tag0):
        dst = global_rank(group, dict(ring_perm(group, shift))[me])
        src = global_rank(group, dict(ring_perm(group, -shift))[me])
        ops.append(dist.P2POp(dist.isend, s, dst, group, tag))
        ops.append(dist.P2POp(dist.irecv, r, src, group, tag))
    return dist.batch_isend_irecv(ops)


class _Shift(torch.autograd.Function):
    """Post the send of ``x`` to the rank ``shift`` ahead and the receive
    of the same shape from the rank ``shift`` behind; returns the receiving
    buffer, which holds the neighbour's chunk once the requests appended to
    ``works`` are waited on.  Backward: the -shift hand-off of the
    gradient."""

    @staticmethod
    def forward(ctx, x, shift, group, works, tag):
        recv = torch.empty_like(x)
        works.extend(shift_start([x.contiguous()], [recv], [shift], group,
                                 tag))
        ctx.shift, ctx.group, ctx.tag = shift, group, tag
        return recv

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad)
        for w in shift_start([grad.contiguous()], [out], [-ctx.shift],
                             ctx.group, ctx.tag):
            w.wait()
        return out, None, None, None, None


def shift(x: torch.Tensor, shift: int, group, works: list,
          tag: int = 0) -> torch.Tensor:
    """The differentiable hand-off: start moving ``x`` ``shift`` ranks
    ahead on the ring and return the buffer that receives the chunk of the
    rank ``shift`` behind; it is valid once every request appended to
    ``works`` has been waited on."""
    return _Shift.apply(x, shift, group, works, tag)


def _ring(chunks: list[torch.Tensor], shifts: list[int], group,
          consume: Callable, carry):
    """n steps of ``carry = consume(carry, i, residents)``, each overlapped
    with the transfer of the next chunks into new receiving buffers (a
    consumed buffer may be saved for a backward, so none is reused).  The
    caller's chunks are never written."""
    n = dist.get_world_size(group)
    resident = [c.contiguous() for c in chunks]
    for i in range(n):
        last = i == n - 1
        works: list = []
        # launch the transfer of the NEXT chunk (fills the receiving row) ...
        recv = [] if last else [shift(r, s, group, works, tag)
                                for tag, (r, s) in enumerate(
                                    zip(resident, shifts))]
        # ... while consuming the resident one (NOP, not STALL)
        carry = consume(carry, i, resident)
        for w in works:
            w.wait()
        if not last:
            resident = recv
    return carry


def stream_ring(x: torch.Tensor, group,
                consume: Callable[[object, torch.Tensor, int], object],
                init, *, reverse: bool = False):
    """Run ``consume(carry, chunk, src_index)`` over every ring-neighbour
    chunk and return the final carry.

    ``x`` is this rank's resident chunk; after i hops of +shift the resident
    chunk originated at rank ``(me - i * shift) mod n``.
    """
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    shift = -1 if reverse else 1
    return _ring([x], [shift], group,
                 lambda c, i, res: consume(c, res[0], (me - i * shift) % n),
                 init)


def bidirectional_stream(x: torch.Tensor, group, consume: Callable, init):
    """Split-ring variant: half the chunk (its leading dim) flows clockwise,
    half counter-clockwise (the paper's segmented bus operating its
    segments in parallel).  ``consume`` gets the two halves concatenated
    and their sources ``(src_f, src_b)``."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    half = x.shape[0] // 2
    return _ring([x[:half], x[half:]], [1, -1], group,
                 lambda c, i, res: consume(c, torch.cat(res, dim=0),
                                           ((me - i) % n, (me + i) % n)),
                 init)
