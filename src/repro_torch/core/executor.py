"""Functional execution of the Fig-8 applications on the pLUTo ALU (PyTorch
port of ``repro/core/executor.py``).

The reference's dataflows (products, serial accumulation, butterflies)
computed with :mod:`repro_torch.core.pluto_alu` LUT operations only, each a
handful of whole-tensor operations a nibble on the lanes' device; plain
PyTorch, as the reference is plain ``jnp``.  All arithmetic is mod 2^32
(matmul / pmm / bfs) or mod q (ntt), the paper's 32-bit operation width.

Tensors are used on their own device; anything else (a numpy array, a
list) goes to ``device``, ``cuda`` unless the caller passes the CPU.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from repro_torch.core import pluto_alu as alu
from repro_torch.device import resolve


def _on(x, device) -> torch.Tensor:
    """int64 lanes of ``x`` on its own device (a tensor) or ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x).astype(np.int64))
        return alu._lanes(x.to(resolve(device or "cuda")))
    return alu._lanes(x if device is None else x.to(resolve(device)))


def matmul(a, b, device=None) -> torch.Tensor:
    """C = A @ B (mod 2^32) via LUT mul + serial LUT accumulation."""
    a, b = _on(a, device), _on(b, device)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64,
                      device=a.device)
    for k in range(a.shape[1]):
        # producers: vectorized products of A[:, k] x B[k, :]
        prod = alu._mul(a[:, k][:, None], b[k, :][None, :], 32)
        # aggregator: serial accumulation (Fig 4(b) pipeline)
        acc = alu._add(acc, prod, 32)
    return acc.to(torch.uint32)


def pmm(a, b, device=None) -> torch.Tensor:
    """Naive polynomial multiply (mod 2^32): c_k = sum_i a_i * b_{k-i}."""
    a, b = _on(a, device), _on(b, device)
    n = a.shape[0]
    out = torch.zeros(2 * n - 1, dtype=torch.int64, device=a.device)
    for i in range(n):
        prod = alu._mul(a[i], b, 32)            # row-vectorized products
        # accumulate onto diagonal i
        out[i:i + n] = alu._add(out[i:i + n], prod, 32)
    return out.to(torch.uint32)


def _bit_reverse(x: np.ndarray) -> np.ndarray:
    n = len(x)
    bits = int(np.log2(n))
    idx = np.array([int(format(i, f"0{bits}b")[::-1], 2) for i in range(n)])
    return x[idx]


def ntt(x, q: int = 7681, root: int = 17, device=None) -> torch.Tensor:
    """Iterative radix-2 NTT over Z_q, butterflies on the LUT ALU.

    ``root`` must be a primitive n-th root of unity mod q for n = len(x).
    The bit reversal and the twiddle tables are built on the host (as the
    DRAM LUT rows would be stored), then moved to the device.
    """
    if isinstance(x, torch.Tensor):
        device = x.device if device is None else device
        x = x.to(torch.int64).cpu().numpy()
    xs = np.asarray(x).astype(np.uint32)
    n = len(xs)
    stages = int(np.log2(n))
    if not (pow(root, n, q) == 1 and pow(root, n // 2, q) != 1):
        raise ValueError("root must be a primitive n-th root of unity mod q")
    data = _on(_bit_reverse(xs), device)
    for s in range(stages):
        m = 1 << (s + 1)
        wm = pow(root, n // m, q)
        tw = np.array([pow(wm, j, q) for j in range(m // 2)], dtype=np.int64)
        d = data.reshape(n // m, m)
        lo, hi = d[:, : m // 2], d[:, m // 2:]
        t = alu._mulmod(hi, _on(tw, data.device)[None, :], q)
        add = alu._addmod(lo, t, q)
        sub = alu._addmod(lo, alu._sub(torch.full_like(t, q), t, 32), q)
        data = torch.cat([add, sub], dim=1).reshape(n)
    return data.to(torch.uint32)


def ntt_oracle(x: np.ndarray, q: int = 7681, root: int = 17) -> np.ndarray:
    """O(n^2) DFT over Z_q as the oracle."""
    n = len(x)
    j = np.arange(n)
    mat = np.array([[pow(root, int(i * k) % n, q) for k in j] for i in j],
                   dtype=np.uint64)
    return ((mat * x.astype(np.uint64)[None, :]).sum(axis=1) % q).astype(
        np.uint32)


def bfs(adj, src: int = 0, device=None) -> np.ndarray:
    """Level-synchronous BFS distances via LUT add/compare semantics.

    ``dist + 1`` saturates at 0xFFFFFFFF (unreached nodes stay there); the
    host reads whether a level changed anything once a level.
    """
    if isinstance(adj, torch.Tensor):
        dev = adj.device if device is None else resolve(device)
        adj = adj.to(dev, torch.bool)
    else:
        adj = torch.from_numpy(np.asarray(adj).astype(bool)).to(
            resolve(device or "cuda"))
    n = adj.shape[0]
    inf = alu.U32
    dist = torch.full((n,), inf, dtype=torch.int64, device=adj.device)
    dist[src] = 0
    ones = torch.ones_like(dist)

    def body(dist):
        # saturating distance+1 (unreached nodes stay at inf)
        plus1 = torch.where(dist == inf, inf, alu._add(dist, ones, 32))
        frontier_cost = torch.where(adj, plus1[:, None], inf)
        new = torch.minimum(dist, frontier_cost.amin(dim=0))
        return new, bool((new != dist).any())

    dist, changed = body(dist)
    while changed:
        dist, changed = body(dist)
    return dist.cpu().numpy().astype(np.uint32)


def bfs_oracle(adj: np.ndarray, src: int = 0) -> np.ndarray:
    n = adj.shape[0]
    dist = np.full(n, 0xFFFFFFFF, np.uint32)
    dist[src] = 0
    dq = deque([src])
    while dq:
        u = dq.popleft()
        for v in np.nonzero(adj[u])[0]:
            if dist[v] == 0xFFFFFFFF:
                dist[v] = dist[u] + 1
                dq.append(v)
    return dist
