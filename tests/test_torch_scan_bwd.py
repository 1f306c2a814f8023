"""The Mamba-2 scan's backward in the chunked (SSD) form: its plain
version ``ref.mamba2_scan_chunked_bwd_ref`` (the stages of
``csrc/mamba_scan.cu``'s chunked backward as explicit per-chunk products)
against the step-by-step ``ref.mamba2_scan_bwd_ref``, against autograd of
``ref.mamba2_scan_chunked_ref`` and against ``jax.vjp`` of the reference's
scan, at rtol 1e-4; and its emulation of the kernel's bfloat16 terms
against the card's limits (``chip_smoke.SCAN_BWD_ROUND_RTOL``).

The algorithm is held in float64 (both plain versions keep float64, and
the reference's scan runs under ``jax.enable_x64``): two float32 orders of
the log-decay gradient's sums of ~4096 terms differ by more than 1e-5
where they cancel, whichever is right (each is within 1e-4 of a float64
evaluation, which is what these tests check).  The kernel runs only on a
card (``test_torch_kernels.py``, marked ``cuda``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm

from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ref

F32_TOL = dict(rtol=1e-4, atol=1e-5)      # test_torch_hybrid_train.py's
NAMES = ("ddt", "dx", "db", "dc", "dA", "dh0")
# the card's limits (chip_smoke.py): |got - want| <= SCAN_TOL's atol +
# rtol |want| + sqrt(n) 2^-24 max |want|, n the case's longest sum; rtol
# 1e-4 for the float32 outputs and 2^-8 for those rounded to bf16
CARD_ATOL, CARD_RTOL = 1e-4, {torch.float32: 1e-4, torch.bfloat16: 2 ** -8}

# (B, T, H, P, N, reset): T of one step, one below, at and one past a
# 64-step chunk, and two chunks and a bit; N 16 and 64; P = 33 (a ragged
# row block); ``reset`` puts dt A = -1000 (the decay underflowing to 0) at
# step 3 of every 64
CASES = ([(2, T, 3, 33, N, False) for T in (1, 63, 64, 65, 130)
          for N in (16, 64)]
         + [(2, 130, 3, 33, 16, True), (1, 130, 2, 33, 64, True)])


def _inputs(B, T, H, P, N, reset, seed, dtype=np.float64):
    """dt from a softplus, A < 0, h0, dy and dh_last nonzero; b and c
    slices of one projection, as the model passes them."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(size=(B, T, H)) - 1))
    x = rng.normal(size=(B, T, H, P))
    proj = rng.normal(size=(B, T, 2 * N + 3))
    A = -np.exp(rng.normal(size=(H,)))
    h0 = rng.normal(size=(B, H, P, N)) * 0.5
    dy = rng.normal(size=(B, T, H, P))
    dh = rng.normal(size=(B, H, P, N))
    if reset:
        dt[:, 3::64] = 1000.0 / -A
        x[:, 3::64] = 0.0
    b, c = proj[..., 3:3 + N], proj[..., 3 + N:]
    return [np.ascontiguousarray(a, dtype=dtype)
            for a in (dt, x, b, c, A, h0, dy, dh)]


def _hold(got, want, tol=F32_TOL):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("case", CASES)
def test_chunked_bwd_ref_matches_the_step_by_step_ref(case):
    args = list(map(torch.from_numpy, _inputs(*case, seed=sum(case))))
    got = ref.mamba2_scan_chunked_bwd_ref(*args)
    want = ref.mamba2_scan_bwd_ref(*args)
    assert [g.dtype for g in got] == [torch.float64] * 6
    assert [g.shape for g in got] == [w.shape for w in want]
    _hold([g.numpy() for g in got], [w.numpy() for w in want])


@pytest.mark.parametrize("case", CASES[1::2])
def test_chunked_bwd_ref_matches_autograd_of_the_chunked_forward(case):
    dt, x, b, c, A, h0, dy, dh = map(torch.from_numpy,
                                     _inputs(*case, seed=sum(case) + 1))
    ins = [t.clone().requires_grad_() for t in (dt, x, b, c, A, h0)]
    y, h = ref.mamba2_scan_chunked_ref(*ins)
    want = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), ins)
    got = ref.mamba2_scan_chunked_bwd_ref(dt, x, b, c, A, h0, dy, dh)
    _hold([g.numpy() for g in got], [w.numpy() for w in want])


def _jax_scan(dt, x, b, c, A, h0):
    """The reference's Mamba-2 scan, as in test_torch_hybrid_train.py."""
    def make_chunk(dt_c, xh_c, b_c, _c_c):
        decay = jnp.exp(dt_c * A)[..., None, None]
        bx = (dt_c[..., None] * xh_c)[..., None] * b_c[:, :, None, None, :]
        return jnp.broadcast_to(decay, bx.shape), bx

    def emit_chunk(h_all, _dt, _xh, _b, c_c):
        return jnp.einsum("bchdn,bcn->bchd", h_all, c_c)

    return jssm.fused_ssm_scan(make_chunk, emit_chunk, (dt, x, b, c), h0,
                               dt.shape[1], jssm.CHUNK // 4)


@pytest.mark.parametrize("case", CASES[::2] + CASES[-2:])
def test_chunked_bwd_ref_matches_jax_vjp_of_the_reference_scan(case):
    dt, x, b, c, A, h0, dy, dh = _inputs(*case, seed=sum(case) + 2)
    with jax.enable_x64(True):
        _, vjp = jax.vjp(_jax_scan, *map(jnp.asarray, (dt, x, b, c, A, h0)))
        want = [np.asarray(w) for w in vjp((jnp.asarray(dy),
                                           jnp.asarray(dh)))]
    assert all(w.dtype == np.float64 for w in want)
    got = ref.mamba2_scan_chunked_bwd_ref(
        *map(torch.from_numpy, (dt, x, b, c, A, h0, dy, dh)))
    _hold([g.numpy() for g in got], want)


def _card_ratios(terms, case, seed):
    """The emulation of the kernel's products with ``terms`` bf16 terms
    (bf16 x, b, c; float32 else; dx, db, dc rounded to bf16, as the kernel
    returns them) against ``mamba2_scan_bwd_ref`` on float32 copies, each
    output's worst |got - want| over its card limit."""
    dt, x, b, c, A, h0, dy, dh = map(torch.from_numpy,
                                     _inputs(*case, seed=seed,
                                             dtype=np.float32))
    x, b, c = (t.bfloat16() for t in (x, b, c))
    got = ref.mamba2_scan_chunked_bwd_ref(dt, x, b, c, A, h0, dy, dh,
                                          bf16_terms=terms)
    want = ref.mamba2_scan_bwd_ref(dt, x.float(), b.float(), c.float(), A,
                                   h0, dy, dh)
    B, T, H, P = x.shape
    n = max(P * b.shape[2], H * P, B * T)
    out = {}
    for name, g, w in zip(NAMES, got, want):
        lim = (CARD_ATOL + CARD_RTOL[g.dtype] * w.abs()
               + n ** 0.5 * 2.0 ** -24 * w.abs().max())
        out[name] = ((g.float() - w).abs() / lim).max().item()
    return out


# zamba2's widths (P = N = 64) over three chunks, the reset, and N = 16
CARD_CASES = [(2, 150, 3, 64, 64, False), (1, 150, 2, 64, 64, True),
              (2, 130, 3, 64, 16, False)]


@pytest.mark.parametrize("case", CARD_CASES)
def test_three_bf16_terms_hold_the_card_limits(case):
    """The kernel's scheme: a float32 side in three bf16 terms; where both
    sides are float32 (Mᵀ dY, dY h_in) both split and the six pairs of
    terms (i, j) with i + j < 3 summed.  dx, db and dc sit near their
    limit by the limit's design: their bf16 rounding alone may take up to
    2^-8 of the value."""
    ratios = _card_ratios(3, case, seed=sum(case) + 1)
    assert max(ratios.values()) <= 1.0, ratios


def test_two_bf16_terms_miss_the_card_limits():
    """One term fewer (two terms, the three pairs i + j < 2) misses on
    these cases (ddt at N = 16 by ~2.5x): the third term is needed."""
    worst = max(max(_card_ratios(2, case, seed=sum(case) + 1).values())
                for case in CARD_CASES)
    assert worst > 1.0, worst


@pytest.mark.parametrize("B,T,H,P,N,heads,row_blocks,chunks", [
    (4, 2048, 80, 64, 64, 20, 1, 32),          # zamba2's training shape
    (2, 130, 3, 33, 16, 20, 1, 3), (1, 300, 2, 100, 64, 20, 2, 5),
    (2, 9, 30, 64, 5, 20, 1, 1)])
def test_chunked_bwd_plan_mirror(B, T, H, P, N, heads, row_blocks, chunks):
    """The wrapper's mirror of the chunked backward's plan: bf16 with
    T > 8 and N <= 64; 64 rows of P a block; head groups of
    ``BWD_HEADS``; scratch for the state entering and the gradient
    leaving every (batch row, chunk, head) in float32, the per-(b, t,
    head group, row block) partial sums of db and dc and the
    per-(b, t, head, row block) ones of da and ddt's direct terms."""
    plan = ms.mamba2_bwd_plan(B, T, H, P, N, torch.bfloat16)
    assert plan.path == "chunked"
    assert (plan.rows, plan.row_blocks, plan.chunks, plan.heads) == (
        64, row_blocks, chunks, heads)
    groups = -(-H // heads)
    assert plan.scratch == (2 * B * chunks * H * P * N
                            + 2 * B * T * groups * row_blocks * N
                            + 2 * B * T * H * row_blocks)
    assert 2 * (plan.smem + 1024) <= 228 * 1024       # two blocks an SM


@pytest.mark.parametrize("T,N,dtype,path", [
    (8, 64, torch.bfloat16, "cudacore"), (9, 64, torch.bfloat16, "chunked"),
    (2048, 65, torch.bfloat16, "cudacore"),
    (2048, 64, torch.float32, "cudacore")])
def test_bwd_plan_path_follows_shape_and_dtype(T, N, dtype, path):
    """The forward's rule: bf16 x, b, c with N <= 64 and T > 8 take the
    chunked form; float32, N > 64 or T <= 8 PR 21's CUDA-core form."""
    assert ms.mamba2_bwd_plan(2, T, 3, 64, N, dtype).path == path
