"""Functional pLUTo ALU: arithmetic as in-DRAM table lookups (PyTorch port
of ``repro/core/pluto_alu.py``).

pLUTo computes by querying lookup tables stored in DRAM rows.  Here every
arithmetic step is one query of a table tensor on the lanes' device (an
indexing of ``ADD4_LUT`` or ``MUL4_LUT``); shifts and masks only model the
column wiring, as in the reference.  The N-bit compositions are the
reference's: a carry chain of 4-bit adds, 4x4 partial products accumulated
by LUT adds, two's complement subtraction, and modular reduction by
conditional LUT subtraction of shifted q.

Lanes are computed in ``int64`` with every value kept in ``[0, 2^32)``:
this torch has no ``>>`` or ``+`` on ``uint32``, and an ``int64`` shift or
complement does not wrap as ``uint32``'s does, so each is masked where the
reference relies on the wrap.  Inputs are ``uint32`` or ``int64`` tensors
(or Python ints, broadcast against the other operand); results are
``torch.uint32`` on the inputs' device, equal bit for bit to the
reference's ``uint32``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# --- LUT construction (what the DRAM rows would hold) ----------------------

_A, _B = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")

#: (cin, a, b) -> 5-bit {cout:1, sum:4}; the 4-bit adder subarray LUT
ADD4_LUT = torch.from_numpy(
    np.stack([(_A + _B), (_A + _B + 1)], axis=0).astype(np.uint8))

#: (a, b) -> 8-bit product; the 4-bit multiplier subarray LUT
MUL4_LUT = torch.from_numpy((_A * _B).astype(np.uint8))

U32 = 0xFFFFFFFF


@functools.cache
def _tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The two LUTs on ``device``, as int64 (the rows a query reads)."""
    return ADD4_LUT.to(device, torch.int64), MUL4_LUT.to(device, torch.int64)


def _mask(bits: int) -> int:
    return U32 if bits >= 32 else (1 << bits) - 1


def _lanes(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` as int64 lanes in ``[0, 2^32)`` (the reference's ``astype
    (uint32)``, which wraps); a Python int goes to ``like``'s device."""
    if not isinstance(x, torch.Tensor):
        device = like.device if like is not None else None
        x = torch.as_tensor(int(x) & U32, dtype=torch.int64, device=device)
    return x.to(torch.int64) & U32


def _nibble(x: torch.Tensor, i: int) -> torch.Tensor:
    """Column wiring: select nibble i of a lane."""
    return (x >> (4 * i)) & 0xF


def _lut_add4(cin: torch.Tensor, a: torch.Tensor, b: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One 4-bit adder LUT query -> (sum nibble, carry out)."""
    v = _tables(a.device)[0][cin, a, b]
    return v & 0xF, v >> 4


def _lut_mul4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One 4-bit multiplier LUT query -> 8-bit partial product."""
    return _tables(a.device)[1][a, b]


def _add(x: torch.Tensor, y: torch.Tensor, bits: int) -> torch.Tensor:
    x, y = torch.broadcast_tensors(x, y)
    out = torch.zeros_like(x)
    carry = torch.zeros_like(x)
    for i in range(bits // 4):
        s, carry = _lut_add4(carry, _nibble(x, i), _nibble(y, i))
        out = out | (s << (4 * i))
    return out & _mask(bits)


def _mul(x: torch.Tensor, y: torch.Tensor, bits: int) -> torch.Tensor:
    k = bits // 4
    x, y = torch.broadcast_tensors(x, y)
    acc = torch.zeros_like(x)
    for i in range(k):
        xi = _nibble(x, i)
        for j in range(k - i):  # 4*(i+j) < bits
            pp = _lut_mul4(xi, _nibble(y, j))
            # uint32 drops what a shift moves past bit 31; int64 keeps it
            pp_shifted = (pp << (4 * (i + j))) & _mask(bits)
            acc = _add(acc, pp_shifted, bits)
    return acc


def _sub(x: torch.Tensor, y: torch.Tensor, bits: int) -> torch.Tensor:
    mask = _mask(bits)
    ny = (~y) & mask                   # ~y is negative in int64: mask it
    return _add(_add(x, ny, bits), torch.ones_like(ny), bits)


def _addmod(x: torch.Tensor, y: torch.Tensor, q: int) -> torch.Tensor:
    s = _add(x, y, 32)
    return torch.where(s >= q, _sub(s, _lanes(q, s), 32), s)


def _mulmod(x: torch.Tensor, y: torch.Tensor, q: int) -> torch.Tensor:
    p = _mul(x, y, 32)
    # binary long division by conditional subtraction: 32 steps, skipping
    # each shift whose q << shift does not fit 32 bits
    for shift in range(31, -1, -1):
        if (q << shift) >= (1 << 32):
            continue
        qs = _lanes(q << shift, p)
        p = torch.where(p >= qs, _sub(p, qs, 32), p)
    return p


def _binary(op, x, y, *args) -> torch.Tensor:
    like = x if isinstance(x, torch.Tensor) else y
    return op(_lanes(x, like), _lanes(y, like), *args).to(torch.uint32)


def pluto_add(x, y, bits: int = 32) -> torch.Tensor:
    """N-bit addition (mod 2^N) via a carry chain of 4-bit LUT queries."""
    return _binary(_add, x, y, bits)


def pluto_mul(x, y, bits: int = 32) -> torch.Tensor:
    """N-bit multiplication (mod 2^N) via 4x4 partial products + LUT adds.

    Partial product pp(i, j) = MUL4(x_i, y_j) << 4(i+j); products with
    4(i+j) >= bits fall outside the modular result and are skipped.  The
    8-bit partial products are accumulated with LUT adds, so no native
    arithmetic touches the data path.
    """
    return _binary(_mul, x, y, bits)


def pluto_sub(x, y, bits: int = 32) -> torch.Tensor:
    """N-bit subtraction via two's complement: x + ~y + 1 (LUT adds)."""
    return _binary(_sub, x, y, bits)


def pluto_addmod(x, y, q: int) -> torch.Tensor:
    """(x + y) mod q for q < 2^31, via LUT add + conditional LUT subtract."""
    return _binary(_addmod, x, y, q)


def pluto_mulmod(x, y, q: int) -> torch.Tensor:
    """(x * y) mod q for small q (q^2 < 2^32): 32-bit LUT mul + reduction
    by repeated conditional subtraction of shifted q (LUT adds/subs)."""
    return _binary(_mulmod, x, y, q)
