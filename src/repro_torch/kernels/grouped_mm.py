"""Grouped product over the kept prefixes of sorted segments: the wrapper
around the Hopper kernel, its custom ops and its gradient.

Replaces no TPU kernel: the reference runs the experts of its MoE layer as
three einsums over an (E, C, d) buffer (``repro/models/moe.py:74-77``).
``models/moe.py`` runs them on the assignments as its sort lays them out,
rows sorted by expert, with expert g's kept rows the prefix ``[start_g,
start_g + kept_g)`` of its segment: ``grouped_mm(x, w, start, kept)`` is
``x[r] @ w[g]`` on those rows and zero on every other row, and
``grouped_mm_wgrad(a, b, start, kept)`` is ``a[rows].T @ b[rows]`` over each
segment's kept rows.  The lengths stay on the device: the kernels
(``csrc/grouped_mm.cu``) find their tiles from them, so a call reads
nothing on the host.

A tensor on the CPU goes to the plain versions (``ref.grouped_mm_ref``,
``ref.grouped_mm_wgrad_ref``); a CUDA tensor goes to the kernels or the call
raises.  Both check what the kernels take (``_check``: shapes, layout,
widths, the number of segments) on every device, so a layout the kernel
would refuse fails on the CPU too; only the dtype is free there (float64
for ``gradcheck``).  Under grad mode with an input that requires grad, and
for a fake input, ``grouped_mm`` is ``GroupedMM``, an autograd ``Function``
over the ``repro_torch::grouped_mm`` op, whose backward is the same op with
the weight read transposed (dX) and the ``repro_torch::grouped_mm_wgrad``
op (dW).  Both are dispatcher ops, so selective activation checkpointing
recomputes them under remat "dots" and the planner counts them; each has a
fake implementation and a ``FlopCounterMode`` formula.  They take local
tensors: under a mesh ``models/moe.py`` hands them each rank's shards
(``to_local``), and a DTensor is refused.  ``grouped_mm.launches`` and
``grouped_mm_wgrad.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, _symbolic
from repro_torch.kernels.ref import grouped_mm_ref, grouped_mm_wgrad_ref

MAX_GROUPS = 256                # csrc's MAX_G
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("grouped_mm").lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grouped_mm.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.grouped_mm.restype = i
    lib.grouped_mm_wgrad.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.grouped_mm_wgrad.restype = i
    lib.gmm_error_string.argtypes = [i]
    lib.gmm_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err} "
                           f"({_lib().gmm_error_string(err).decode()})")


def _check(what: str, mats: dict, widths: tuple, start: torch.Tensor,
           kept: torch.Tensor) -> None:
    """What the kernels take: operands of one dtype, float32 or bfloat16
    on a card (the plain version takes float64 too), contiguous and 16-byte
    aligned, widths a multiple of 16 bytes (of 4-byte elements for
    float64); (G,) int64 start and kept, 1 <= G <= MAX_GROUPS, all on one
    device.  The device is cpu or cuda."""
    dtypes = {t.dtype for t in mats.values()}
    dtype = next(iter(dtypes))
    if len(dtypes) != 1 or dtype not in _DTYPES and (
            dtype != torch.float64 or start.device.type != "cpu"):
        raise TypeError(f"{what}: operands {sorted(map(str, dtypes))}; the "
                        "kernel takes float32 or bfloat16, one dtype")
    vec = 16 // min(4, dtype.itemsize)
    if any(n <= 0 or n % vec for n in widths):
        raise ValueError(f"{what}: widths {widths} must be positive "
                         f"multiples of {vec} (16 bytes)")
    G = start.shape[0]
    if start.dim() != 1 or tuple(kept.shape) != (G,) or not \
            1 <= G <= MAX_GROUPS:
        raise ValueError(f"{what}: start {tuple(start.shape)}, kept "
                         f"{tuple(kept.shape)}: want (G,), 1 <= G <= "
                         f"{MAX_GROUPS}")
    if start.dtype != torch.int64 or kept.dtype != torch.int64:
        raise TypeError(f"{what}: start and kept must be int64")
    devices = {t.device for t in (*mats.values(), start, kept)}
    if len(devices) != 1:
        raise ValueError(f"{what}: operands on {devices}")
    for name, t in {**mats, "start": start, "kept": kept}.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    for name, t in mats.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned (the "
                             "kernel copies 16-byte pieces)")


def _forward(x: torch.Tensor, w: torch.Tensor, start: torch.Tensor,
             kept: torch.Tensor, capacity: int, transposed: bool
             ) -> torch.Tensor:
    """One call: the plain version on the CPU, else one launch."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"grouped_mm: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}: want (R, K), (G, K, N)")
    R, K = x.shape
    G, K_w, N = (w.shape[0], w.shape[2], w.shape[1]) if transposed \
        else tuple(w.shape)
    if K_w != K or G != start.shape[0]:
        raise ValueError(f"grouped_mm: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} (transposed {transposed}), "
                         f"{start.shape[0]} segments")
    _check("grouped_mm", {"x": x, "w": w}, (K, N), start, kept)
    if x.device.type == "cpu":
        return grouped_mm_ref(x, w, start, kept, transposed)
    y = torch.empty((R, N), dtype=x.dtype, device=x.device)
    if R == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().grouped_mm(x.data_ptr(), w.data_ptr(), start.data_ptr(),
                                kept.data_ptr(), y.data_ptr(),
                                _DTYPES[x.dtype], R, K, N, G, capacity,
                                int(transposed), stream)
    _raise_on(err, "grouped_mm")
    grouped_mm.launches += 1
    return y


def _wgrad(a: torch.Tensor, b: torch.Tensor, start: torch.Tensor,
           kept: torch.Tensor) -> torch.Tensor:
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"grouped_mm_wgrad: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}: want (R, M), (R, N)")
    (R, M), N, G = a.shape, b.shape[1], start.shape[0]
    _check("grouped_mm_wgrad", {"a": a, "b": b}, (M, N), start, kept)
    if a.device.type == "cpu":
        return grouped_mm_wgrad_ref(a, b, start, kept)
    dw = torch.empty((G, M, N), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _lib().grouped_mm_wgrad(a.data_ptr(), b.data_ptr(),
                                      start.data_ptr(), kept.data_ptr(),
                                      dw.data_ptr(), _DTYPES[a.dtype], R, M,
                                      N, G, stream)
    _raise_on(err, "grouped_mm_wgrad")
    grouped_mm_wgrad.launches += 1
    return dw


# --- the ops --------------------------------------------------------------------

@torch.library.custom_op("repro_torch::grouped_mm", mutates_args=())
def _grouped_mm_op(x: torch.Tensor, w: torch.Tensor, start: torch.Tensor,
                   kept: torch.Tensor, capacity: int, transposed: bool
                   ) -> torch.Tensor:
    return _forward(x, w, start, kept, capacity, transposed)


@torch.library.custom_op("repro_torch::grouped_mm_wgrad", mutates_args=())
def _grouped_mm_wgrad_op(a: torch.Tensor, b: torch.Tensor,
                         start: torch.Tensor, kept: torch.Tensor,
                         capacity: int) -> torch.Tensor:
    return _wgrad(a, b, start, kept)


@_grouped_mm_op.register_fake
def _grouped_mm_fake(x, w, start, kept, capacity, transposed):
    return x.new_empty((x.shape[0], w.shape[1] if transposed
                        else w.shape[2]))


@_grouped_mm_wgrad_op.register_fake
def _grouped_mm_wgrad_fake(a, b, start, kept, capacity):
    return a.new_empty((start.shape[0], a.shape[1], b.shape[1]))


def _rows(R: int, G: int, capacity: int) -> int:
    """Rows a call can compute at most: every row, or G segments of at
    most ``capacity`` kept rows where that is fewer (a rank that holds a
    few experts of many); the segments' lengths are on the device."""
    return min(R, G * capacity) if capacity > 0 else R


@register_flop_formula(torch.ops.repro_torch.grouped_mm)
def _grouped_mm_flops(x_shape, w_shape, start_shape, kept_shape, capacity,
                      transposed, *args, out_shape=None, **kwargs) -> int:
    """2 R K N over the rows a call can keep (``_rows``)."""
    R, K = x_shape
    N = w_shape[1] if transposed else w_shape[2]
    return 2 * _rows(R, start_shape[0], capacity) * K * N


@register_flop_formula(torch.ops.repro_torch.grouped_mm_wgrad)
def _grouped_mm_wgrad_flops(a_shape, b_shape, start_shape, kept_shape,
                            capacity, *args, out_shape=None,
                            **kwargs) -> int:
    """2 R M N over the rows a call can keep (``_rows``)."""
    R, M = a_shape
    return 2 * _rows(R, start_shape[0], capacity) * M * b_shape[1]


def _local(what: str, *ts) -> None:
    if any(map(_symbolic.is_dtensor, ts)):
        raise TypeError(f"{what} takes local tensors, not DTensors: hand it "
                        "each rank's shards (to_local), as models/moe.py does")


class GroupedMM(torch.autograd.Function):
    """``grouped_mm`` under autograd: dX is the grouped product of dY by
    the weight read the other way round, dW the weight gradient over the
    same kept rows; the segments take no gradient."""

    @staticmethod
    def forward(ctx, x, w, start, kept, capacity, transposed):
        ctx.save_for_backward(x, w, start, kept)
        ctx.attrs = (capacity, transposed)
        return torch.ops.repro_torch.grouped_mm(x, w, start, kept, capacity,
                                                transposed)

    @staticmethod
    def backward(ctx, dy):
        x, w, start, kept = ctx.saved_tensors
        capacity, transposed = ctx.attrs
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.repro_torch.grouped_mm(dy, w, start, kept,
                                                  capacity, not transposed)
        if ctx.needs_input_grad[1]:
            a, b = (dy, x) if transposed else (x, dy)
            dw = torch.ops.repro_torch.grouped_mm_wgrad(a, b, start, kept,
                                                        capacity)
        return dx, dw, None, None, None, None


def grouped_mm(x: torch.Tensor, w: torch.Tensor, start: torch.Tensor,
               kept: torch.Tensor, capacity: int = 0, *,
               transposed: bool = False) -> torch.Tensor:
    """(R, N): ``x[r] @ w[g]`` (``w[g].T`` with ``transposed``) for the
    rows r of each segment's kept prefix ``[start[g], start[g] +
    kept[g])``, zero elsewhere.  x (R, K); w (G, K, N) or (G, N, K); start
    and kept (G,) int64, segments in ascending order and disjoint;
    ``capacity`` bounds every kept (0: no bound) and only sizes the
    kernel's grid and the FLOP count.  Differentiable in x and w."""
    _local("grouped_mm", x, w, start, kept)
    if _symbolic.symbolic(x, w, start, kept) or torch.is_grad_enabled() \
            and (x.requires_grad or w.requires_grad):
        return GroupedMM.apply(x, w, start, kept, capacity, transposed)
    return _forward(x, w, start, kept, capacity, transposed)


grouped_mm.launches = 0


def grouped_mm_wgrad(a: torch.Tensor, b: torch.Tensor, start: torch.Tensor,
                     kept: torch.Tensor, capacity: int = 0) -> torch.Tensor:
    """(G, M, N): ``a[rows].T @ b[rows]`` over each segment's kept rows, a
    (R, M), b (R, N); zero for a segment that keeps none."""
    _local("grouped_mm_wgrad", a, b, start, kept)
    if _symbolic.symbolic(a, b, start, kept):
        return torch.ops.repro_torch.grouped_mm_wgrad(a, b, start, kept,
                                                      capacity)
    return _wgrad(a, b, start, kept)


grouped_mm_wgrad.launches = 0
