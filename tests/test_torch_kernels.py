"""Port's kernels against the JAX reference kernels and oracles.

The port's plain versions (``repro_torch.kernels.ref``) and its wrappers
are held against JAX's ``ref.py`` oracles, the Pallas kernels in interpret
mode and the model code that computes the same function (``layers.attention``
for flash attention, ``mamba1_block``'s scan for the selective scan), on the
same numpy inputs.  The CUDA kernels themselves run only on a card: their
tests are marked ``cuda`` and skip here.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lut_matmul as lm
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops, ref


def _jax():
    """The JAX reference modules, imported by the parity tests only: the
    card's machine, where the ``cuda`` test runs, has no JAX."""
    names = ("jax.numpy", "repro.kernels.flash_attention",
             "repro.kernels.ops", "repro.kernels.ref", "repro.models.layers")
    return [importlib.import_module(n) for n in names]

# TestFlashAttention's grid in tests/test_kernels.py
GRID = [
    (128, 128, 64, 0, 0.0, True),
    (256, 256, 64, 0, 0.0, True),
    (128, 128, 128, 64, 0.0, True),       # sliding window
    (128, 128, 64, 0, 50.0, True),        # gemma softcap
    (128, 256, 64, 0, 0.0, False),        # non-causal (cross-attn)
    (256, 128, 32, 100, 30.0, True),      # window + cap combined
]


def _qkv(Tq, Tk, D, seed, BH=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(BH, Tq, D)).astype(np.float32),
            rng.normal(size=(BH, Tk, D)).astype(np.float32),
            rng.normal(size=(BH, Tk, D)).astype(np.float32))


@pytest.mark.parametrize("against", ["jax_ref", "pallas_interpret"])
@pytest.mark.parametrize("Tq,Tk,D,window,softcap,causal", GRID)
def test_ref_matches_jax(Tq, Tk, D, window, softcap, causal, against):
    jnp, jfa, _, jref, _ = _jax()
    q, k, v = _qkv(Tq, Tk, D, Tq + Tk + D + window)
    kw = dict(causal=causal, window=window, softcap=softcap)
    if against == "jax_ref":
        want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), **kw)
    else:
        want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), interpret=True, **kw)
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    # the wrapper takes a CPU tensor to the same plain version
    got_w = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw)
    np.testing.assert_array_equal(got_w.numpy(), got.numpy())


def _gqa_inputs(B, T, K, G, D, seed, Tk=None):
    rng = np.random.default_rng(seed)
    Tk = T if Tk is None else Tk
    return (rng.normal(size=(B, T, K * G, D)).astype(np.float32),
            rng.normal(size=(B, Tk, K, D)).astype(np.float32),
            rng.normal(size=(B, Tk, K, D)).astype(np.float32))


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (64, 0.0), (0, 30.0),
                                            (48, 20.0)])
def test_gqa_matches_jax_ops_and_model_attention(window, softcap):
    jnp, _, jops, _, jlayers = _jax()
    B, T, K, G, D = 1, 256, 2, 2, 32
    q, k, v = _gqa_inputs(B, T, K, G, D, 3 + window)
    got = ops.gqa_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), window=window,
                                  softcap=softcap).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_ops = jops.gqa_flash_attention(jq, jk, jv, window=window,
                                        softcap=softcap)
    spec = jlayers.AttnSpec(K * G, K, D, window=window, softcap=softcap)
    want_model = jlayers.attention(jq, jk, jv, spec, q_offset=0,
                                   is_global=False)
    np.testing.assert_allclose(got, np.asarray(want_ops), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(want_model), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("T,window", [(100, 0), (203, 37)])
def test_gqa_ragged_T_matches_model_attention(T, window):
    """Lengths that are not multiples of 128 (the Pallas kernel asserts
    they are; the model's attention and the port take them)."""
    jnp, _, _, _, jlayers = _jax()
    B, K, G, D = 2, 2, 3, 16
    q, k, v = _gqa_inputs(B, T, K, G, D, T)
    got = ops.gqa_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), window=window).numpy()
    spec = jlayers.AttnSpec(K * G, K, D, window=window, kv_block=64)
    want = jlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             spec, q_offset=0, is_global=False)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bad,err", [
    ("dtype", TypeError), ("head_dim", ValueError), ("strides", ValueError),
    ("gqa", ValueError), ("bf16_misaligned", ValueError)])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    B, T, H, K, D = 1, 8, 4, 2, 64
    q = torch.zeros(B, T, H, D)
    k = torch.zeros(B, T, K, D)
    if bad == "dtype":
        q, k = q.half(), k.half()
    elif bad == "head_dim":
        q, k = torch.zeros(B, T, H, 32), torch.zeros(B, T, K, 32)
    elif bad == "strides":
        q = torch.zeros(B, T, D, H).transpose(2, 3)
    elif bad == "gqa":
        k = torch.zeros(B, T, 3, D)
    elif bad == "bf16_misaligned":      # rows start 1 element off 16 bytes
        q = torch.zeros(B * T * H * D + 1, dtype=torch.bfloat16)[1:].view(
            B, T, H, D)
        k = k.bfloat16()
    with pytest.raises(err):
        fa._check(q, k, k, 0, 0.0)


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises; it
    never reaches the plain version."""
    q = torch.zeros(1, 8, 2, 64, device="meta")
    before = fa.flash_attention_gqa.launches
    with pytest.raises(ValueError):
        fa.flash_attention_gqa(q, q, q)
    assert fa.flash_attention_gqa.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_cuda_kernel_matches_plain_version(D, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    dt = getattr(torch, dtype)
    tol = 2e-5 if dtype == "float32" else 2e-2
    rng = np.random.default_rng(D)
    for (B, Tq, Tk, H, K, causal, window, softcap) in [
            (2, 200, 200, 4, 2, True, 0, 0.0),
            (1, 130, 260, 4, 1, False, 0, 30.0),
            (2, 300, 300, 4, 4, True, 50, 50.0)]:
        q = torch.tensor(rng.normal(size=(B, Tq, H, D)), dtype=dt,
                         device="cuda")
        k = torch.tensor(rng.normal(size=(B, Tk, K, D)), dtype=dt,
                         device="cuda")
        v = torch.tensor(rng.normal(size=(B, Tk, K, D)), dtype=dt,
                         device="cuda")
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = fa.flash_attention_gqa(q, k, v, **kw).float()
        want = ref.flash_attention_gqa_ref(q.float(), k.float(), v.float(),
                                           **kw)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= tol


def _jmods(*names):
    return [importlib.import_module(n) for n in names]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


# ---- selective scan ---------------------------------------------------------

# TestMambaScan's grid in tests/test_kernels.py: B, T, D, N, bt
SCAN_GRID = [(1, 64, 32, 8, 32), (2, 128, 64, 16, 64), (2, 128, 16, 4, 128),
             (3, 192, 8, 16, 64)]


def _scan_inputs(B, T, D, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.0, (B, T, D, N)).astype(np.float32),
            (rng.normal(size=(B, T, D, N)) * 0.1).astype(np.float32),
            rng.normal(size=(B, T, N)).astype(np.float32))


@pytest.mark.parametrize("against", ["jax_ref", "pallas_interpret"])
@pytest.mark.parametrize("B,T,D,N,bt", SCAN_GRID)
def test_mamba_scan_ref_matches_jax(B, T, D, N, bt, against):
    """At TestMambaScan's 1e-4."""
    jnp, jms, jref = _jmods("jax.numpy", "repro.kernels.mamba_scan",
                            "repro.kernels.ref")
    decay, u, c = _scan_inputs(B, T, D, N, B * T + D)
    jin = [jnp.asarray(a) for a in (decay, u, c)]
    want = (jref.mamba_scan_ref(*jin) if against == "jax_ref"
            else jms.mamba_scan(*jin, bt=bt, interpret=True))
    tin = [torch.from_numpy(a) for a in (decay, u, c)]
    got = ref.mamba_scan_ref(*tin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # the wrapper takes a CPU tensor to the same plain version
    np.testing.assert_array_equal(ops.mamba_scan(*tin).numpy(), got.numpy())


def test_mamba_scan_state_carries_over_the_whole_sequence():
    """TestMambaScan's impulse: a unit input at t=0 with decay 1 persists to
    the last step (the TPU kernel's carry across time blocks)."""
    jnp, jms = _jmods("jax.numpy", "repro.kernels.mamba_scan")
    B, T, D, N = 1, 128, 4, 2
    decay = np.ones((B, T, D, N), np.float32)
    u = np.zeros((B, T, D, N), np.float32)
    u[:, 0] = 1.0
    c = np.ones((B, T, N), np.float32)
    y = ops.mamba_scan(*(torch.from_numpy(a) for a in (decay, u, c)))
    np.testing.assert_allclose(y[0, -1].numpy(), np.full(D, N), rtol=1e-6)
    want = jms.mamba_scan(*(jnp.asarray(a) for a in (decay, u, c)), bt=32,
                          interpret=True)
    np.testing.assert_array_equal(y.numpy(), np.asarray(want))


def _selective_inputs(B, T, D, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.01, 1.0, (B, T, D)).astype(np.float32),   # dt
            rng.normal(size=(B, T, D)).astype(np.float32),          # x
            rng.normal(size=(B, T, N)).astype(np.float32),          # b
            rng.normal(size=(B, T, N)).astype(np.float32),          # c
            -rng.uniform(0.5, 8.0, (D, N)).astype(np.float32),      # A
            (rng.normal(size=(B, D, N)) * 0.5).astype(np.float32))  # h0


def _jax_mamba1_scan(dt, x, b, c, A, h0):
    """The scan of ``repro.models.ssm.mamba1_block``: ``fused_ssm_scan``
    with its ``make_chunk``/``emit_chunk`` (ssm.py:167-176)."""
    jnp, jssm = _jmods("jax.numpy", "repro.models.ssm")
    A = jnp.asarray(A)

    def make_chunk(dt_c, x_c, b_c, _c_c):
        decay = jnp.exp(dt_c[..., None] * A)
        bx = (dt_c * x_c.astype(jnp.float32))[..., None] \
            * b_c.astype(jnp.float32)[..., None, :]
        return decay, bx

    def emit_chunk(h_all, _dt, _x, _b, c_c):
        return jnp.einsum("bcin,bcn->bci", h_all, c_c.astype(jnp.float32))

    ins = tuple(jnp.asarray(a) for a in (dt, x, b, c))
    return jssm.fused_ssm_scan(make_chunk, emit_chunk, ins, jnp.asarray(h0),
                               dt.shape[1], jssm.CHUNK)


@pytest.mark.parametrize("T", [1, 37, 300])
def test_selective_scan_ref_matches_jax_mamba1_scan(T):
    """From a non-zero h0, across the reference's 256-step chunk at T=300;
    float32 summation order only, at the model parity tests' 2e-4."""
    args = _selective_inputs(2, T, 16, 8, T)
    jy, jh = _jax_mamba1_scan(*args)
    tin = [torch.from_numpy(a) for a in args]
    ty, th = ref.selective_scan_ref(*tin)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-4,
                               atol=2e-4)
    wy, wh = ops.selective_scan(*tin)
    np.testing.assert_array_equal(wy.numpy(), ty.numpy())
    np.testing.assert_array_equal(wh.numpy(), th.numpy())


def test_selective_scan_ref_is_mamba_scan_ref_on_built_inputs():
    """From h0 = 0, the fused form is the TPU contract on the decay and u it
    builds."""
    dt, x, b, c, A, _ = (torch.from_numpy(a) for a in
                         _selective_inputs(2, 20, 8, 4, 5))
    y, _ = ref.selective_scan_ref(dt, x, b, c, A, torch.zeros(2, 8, 4))
    decay = torch.exp(dt[..., None] * A)
    u = (dt * x)[..., None] * b[:, :, None, :]
    np.testing.assert_allclose(y.numpy(),
                               ref.mamba_scan_ref(decay, u, c).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad,err", [
    ("dtype", TypeError), ("c_shape", ValueError), ("strides", ValueError),
    ("state", ValueError)])
def test_mamba_scan_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    B, T, D, N = 1, 4, 8, 16
    decay, u, c = torch.zeros(B, T, D, N), torch.zeros(B, T, D, N), \
        torch.zeros(B, T, N)
    if bad == "dtype":
        u = u.double()
    elif bad == "c_shape":
        c = torch.zeros(B, T, N + 1)
    elif bad == "strides":
        decay = torch.zeros(B, T, N, D).transpose(2, 3)
    elif bad == "state":
        decay = u = torch.zeros(B, T, D, ms.MAX_STATE + 1)
        c = torch.zeros(B, T, ms.MAX_STATE + 1)
    with pytest.raises(err):
        ms._check_scan(decay, u, c)


@pytest.mark.parametrize("bad,err", [
    ("dt_dtype", TypeError), ("mixed_dtypes", TypeError),
    ("last_stride", ValueError), ("A_shape", ValueError),
    ("h0_strides", ValueError)])
def test_selective_scan_wrapper_rejects_what_the_kernel_does_not_take(bad,
                                                                      err):
    B, T, D, N = 2, 3, 8, 4
    dt, x = torch.zeros(B, T, D), torch.zeros(B, T, D)
    b = c = torch.zeros(B, T, N)
    A, h0 = torch.zeros(D, N), torch.zeros(B, D, N)
    if bad == "dt_dtype":
        dt = dt.bfloat16()
    elif bad == "mixed_dtypes":
        x = x.bfloat16()
    elif bad == "last_stride":
        b = torch.zeros(B, T, 2 * N)[:, :, ::2]
    elif bad == "A_shape":
        A = torch.zeros(N, D)
    elif bad == "h0_strides":
        h0 = torch.zeros(B, N, D).transpose(1, 2)
    with pytest.raises(err):
        ms._check_selective(dt, x, b, c, A, h0)
    # the model's b, c: batch/time-strided slices of one projection pass
    proj = torch.zeros(B, T, 5 + 2 * N)
    ms._check_selective(torch.zeros(B, T, D), torch.zeros(B, T, D),
                        proj[..., 5:5 + N], proj[..., 5 + N:],
                        torch.zeros(D, N), torch.zeros(B, D, N))


# ---- LUT matmul -------------------------------------------------------------

# TestLutMatmul's shapes in tests/test_kernels.py (M, K, N)
LUT_GRID = [(128, 128, 128), (256, 256, 128), (128, 512, 256),
            (384, 128, 128)]


@pytest.mark.parametrize("M,K,N", LUT_GRID)
def test_quantize_weights_matches_jax(M, K, N):
    """Codes byte for byte; levels within 1 float32 ulp."""
    jnp, jlm = _jmods("jax.numpy", "repro.kernels.lut_matmul")
    w = np.random.default_rng(M + K + N).normal(size=(K, N)).astype(
        np.float32)
    jcodes, jlut = jlm.quantize_weights(jnp.asarray(w))
    tcodes, tlut = ops.quantize_weights(torch.from_numpy(w))
    assert tcodes.dtype == torch.uint8 and tlut.dtype == torch.float32
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_max_ulp(tlut.numpy(), np.asarray(jlut), maxulp=1)


@pytest.mark.parametrize("against", ["jax_ref", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", LUT_GRID)
def test_lut_matmul_ref_matches_jax(M, K, N, dtype, against):
    """At TestLutMatmul's tolerances: 1e-5 (f32), 2e-2 (bf16)."""
    jnp, jlm, jref = _jmods("jax.numpy", "repro.kernels.lut_matmul",
                            "repro.kernels.ref")
    rng = np.random.default_rng(M + K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    codes, lut = jlm.quantize_weights(jnp.asarray(w))
    want = (jref.lut_matmul_ref(jx, codes, lut) if against == "jax_ref"
            else jlm.lut_matmul(jx, codes, lut, interpret=True))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tc, tl = torch.from_numpy(np.array(codes)), torch.from_numpy(
        np.array(lut))
    got = ref.lut_matmul_ref(tx, tc, tl)
    assert got.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol * 10)
    np.testing.assert_array_equal(ops.lut_matmul(tx, tc, tl).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lut_matmul_ref_random_codebooks_match_jax(seed):
    """TestLutMatmul.test_random_codebooks' inputs, 1e-5 / 1e-4."""
    jnp, jref = _jmods("jax.numpy", "repro.kernels.ref")
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(128, 128)).astype(np.float32)
    codes = rng.integers(0, 16, (128, 128)).astype(np.uint8)
    lut = rng.normal(size=(128 // lm.GROUP, 128, 16)).astype(np.float32)
    want = jref.lut_matmul_ref(jnp.asarray(x), jnp.asarray(codes),
                               jnp.asarray(lut))
    got = ref.lut_matmul_ref(*(torch.from_numpy(a) for a in (x, codes, lut)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_quantizer_reconstruction_error_bounded():
    """TestLutMatmul's bound: half a quantization step per (group, column)."""
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=(256, 128)).astype(np.float32))
    codes, lut = ops.quantize_weights(w)
    g = w.reshape(-1, lm.GROUP, 128)
    scale = (g.amax(1) - g.amin(1)) / 15.0
    wq = ref.lut_matmul_ref(torch.eye(256), codes, lut)
    bound = scale.repeat_interleave(lm.GROUP, dim=0) * 0.5 + 1e-6
    assert bool(((wq - w).abs() <= bound).all())


@pytest.mark.parametrize("bad,err", [
    ("K", ValueError), ("codes_dtype", TypeError), ("lut_shape", ValueError),
    ("x_dtype", TypeError), ("misaligned", ValueError),
    ("strides", ValueError)])
def test_lut_matmul_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    M, K, N = 4, 128, 32
    x = torch.zeros(M, K)
    codes = torch.zeros(K, N, dtype=torch.uint8)
    lut = torch.zeros(K // lm.GROUP, N, 16)
    if bad == "K":
        x, codes = torch.zeros(M, 96), torch.zeros(96, N, dtype=torch.uint8)
    elif bad == "codes_dtype":
        codes = codes.int()
    elif bad == "lut_shape":
        lut = torch.zeros(K // lm.GROUP, 16, N)
    elif bad == "x_dtype":
        x = x.half()
    elif bad == "misaligned":     # rows start 1 element off 16 bytes
        x = torch.zeros(M * K + 1)[1:].view(M, K)
    elif bad == "strides":
        x = torch.zeros(K, M).T
    with pytest.raises(err):
        lm._check(x, codes, lut)


@pytest.mark.parametrize("which", ["mamba_scan", "selective_scan",
                                   "lut_matmul"])
def test_new_wrappers_never_fall_back_off_the_cpu(which):
    """A tensor that is not on the CPU goes to the kernel or raises; it
    never reaches the plain version."""
    meta = dict(device="meta")
    if which == "mamba_scan":
        fn = ms.mamba_scan
        args = (torch.zeros(1, 4, 8, 4, **meta),) * 2 + (
            torch.zeros(1, 4, 4, **meta),)
    elif which == "selective_scan":
        fn = ms.selective_scan
        args = (torch.zeros(1, 4, 8, **meta),) * 2 + (
            torch.zeros(1, 4, 4, **meta),) * 2 + (
            torch.zeros(8, 4, **meta), torch.zeros(1, 8, 4, **meta))
    else:
        fn = lm.lut_matmul
        args = (torch.zeros(2, 64, **meta),
                torch.zeros(64, 8, dtype=torch.uint8, **meta),
                torch.zeros(1, 8, 16, **meta))
    before = fn.launches
    with pytest.raises(ValueError):
        fn(*args)
    assert fn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,N", [(1, 64, 32, 8), (2, 128, 64, 16),
                                     (2, 128, 16, 4), (3, 192, 8, 16),
                                     (1, 100, 5, 2), (2, 33, 40, 12)])
def test_cuda_mamba_scan_matches_plain_version(B, T, D, N):
    """TestMambaScan's shapes and ragged ones, at its 1e-4."""
    _cuda_or_skip()
    decay, u, c = (torch.from_numpy(a).cuda() for a in
                   _scan_inputs(B, T, D, N, T + D + N))
    got = ms.mamba_scan(decay, u, c)
    want = ref.mamba_scan_ref(decay, u, c)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,N", [(1, 16), (37, 8), (300, 16), (70, 5)])
def test_cuda_selective_scan_matches_plain_version(T, N, dtype):
    """b and c as slices of one projection, as the model passes them; the
    bf16 inputs widen exactly, so both dtypes hold 2e-4."""
    _cuda_or_skip()
    dt, x, b, c, A, h0 = (torch.from_numpy(a).cuda() for a in
                          _selective_inputs(2, T, 48, N, T + N))
    dtp = getattr(torch, dtype)
    proj = torch.cat([torch.zeros_like(b[..., :3]), b, c], dim=-1).to(dtp)
    x, b, c = x.to(dtp), proj[..., 3:3 + N], proj[..., 3 + N:]
    y, h = ms.selective_scan(dt, x, b, c, A, h0)
    wy, wh = ref.selective_scan_ref(dt, x, b, c, A, h0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, wy, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h, wh, rtol=2e-4, atol=2e-4)


# ---- the selective scan's launch plan (host code, mirrored in Python) ------

def _plan_operands(B, T, D, N, dtype=torch.bfloat16, offset=256,
                   x_pad=0, dt_shift=0):
    """dt, x, b, c, A, h0, h_last as the model passes them: b and c slices
    of one projection ``offset`` columns in; ``x_pad`` extra columns on x's
    rows and ``dt_shift`` elements of storage offset on dt."""
    dt = torch.zeros(B * T * D + dt_shift)[dt_shift:].view(B, T, D)
    x = torch.zeros(B, T, D + x_pad, dtype=dtype)[..., :D]
    proj = torch.zeros(B, T, offset + 2 * N, dtype=dtype)
    return (dt, x, proj[..., offset:offset + N], proj[..., offset + N:],
            torch.zeros(D, N), torch.zeros(B, D, N), torch.zeros(B, D, N))


@pytest.mark.parametrize("N,S,P", [(1, 8, 1), (4, 8, 1), (8, 8, 1),
                                   (9, 8, 2), (12, 8, 2), (16, 8, 2),
                                   (17, 16, 2), (64, 16, 4), (100, 16, 8),
                                   (128, 16, 8)])
def test_selective_plan_states_and_lanes(N, S, P):
    """S = 8 states a lane up to N = 16, 16 above; P, the fewest lanes that
    hold N, a power of two; RING_THREADS / P channels a ring block."""
    dt, x, _, _, A, h0, hl = _plan_operands(2, 40, 96, N)
    plan = ms.selective_plan(dt, x, A, h0, hl)
    assert (plan.states, plan.lanes) == (S, P)
    assert S * P >= N and (P == 1 or S * P // 2 < N)
    assert plan.channels == ms.RING_THREADS // P
    assert plan.vec == (N % 4 == 0)


@pytest.mark.parametrize("B,T,D,N,direct,grid", [
    (4, 1, 8192, 16, True, (512, 1)),       # decode: 4*8192*2 lanes / 128
    (4, 8, 8192, 16, True, (512, 1)),
    (4, 9, 8192, 16, False, (64, 4)),       # 128 channels a block
    (4, 1100, 8192, 16, False, (64, 4)),    # the serving prefill
    (9, 33, 304, 5, False, (2, 9)),         # P = 1: 256 channels a block
    (1, 7, 80, 128, True, (5, 1)),          # 80 * 8 lanes / 128
    (1, 1100, 80, 128, False, (3, 1))])     # P = 8: 32 channels a block
def test_selective_plan_path_and_grid(B, T, D, N, direct, grid):
    dt, x, _, _, A, h0, hl = _plan_operands(B, T, D, N)
    plan = ms.selective_plan(dt, x, A, h0, hl)
    assert plan.direct == direct and plan.direct == (T <= ms.DIRECT_T)
    assert plan.grid == grid
    assert plan.tma_dt == plan.tma_x == (not direct)


@pytest.mark.parametrize("case,tma_dt,tma_x", [
    (dict(), True, True),                           # the model's operands
    (dict(offset=7), True, True),                   # b, c never take TMA
    (dict(x_pad=3), True, False),                   # x rows 2*(D+3) bytes
    (dict(x_pad=8), True, True),                    # x rows 16 bytes longer
    (dict(dt_shift=1), False, True),                # dt's base off 16 bytes
    (dict(dtype=torch.float32, x_pad=1), True, False),
    (dict(dtype=torch.float32, x_pad=4), True, True)])
def test_selective_plan_tma_by_alignment(case, tma_dt, tma_x):
    """TMA for dt and x where the base is 16-byte aligned and the batch and
    time strides are multiples of 16 bytes; the producer warp's lanes load
    the rest (and b and c always)."""
    dt, x, _, _, A, h0, hl = _plan_operands(4, 100, 96, 16, **case)
    plan = ms.selective_plan(dt, x, A, h0, hl)
    assert (plan.tma_dt, plan.tma_x) == (tma_dt, tma_x)


def test_selective_plan_tma_strides():
    """A size-1 batch's stride is not used; a zero (broadcast) time stride
    or a time stride of 4 bf16 elements (8 bytes) cannot be mapped."""
    assert ms._tma_ok(torch.zeros(1, 10, 16)[:, :, :])
    assert ms._tma_ok(torch.zeros(1, 10, 20)[:, :, :16])
    assert not ms._tma_ok(torch.zeros(2, 10, 20)[:, :, :16][:, :, 1:])
    assert not ms._tma_ok(torch.zeros(2, 1, 16).expand(2, 10, 16))
    assert not ms._tma_ok(torch.zeros(2, 10, 4, dtype=torch.bfloat16))
    assert ms._tma_ok(torch.zeros(2, 10, 8, dtype=torch.bfloat16))


def test_selective_plan_vectors_need_alignment():
    dt, x, _, _, A, h0, hl = _plan_operands(2, 40, 96, 16)
    assert ms.selective_plan(dt, x, A, h0, hl).vec
    A_off = torch.zeros(96 * 16 + 1)[1:].view(96, 16)
    assert not ms.selective_plan(dt, x, A_off, h0, hl).vec


def test_selective_folded_exp2_holds_the_scan_tolerance():
    """The kernel's exponential: 2^(dt * (A log2 e)) with log2 e folded into
    A once, in float32, through a whole serving-length scan from a nonzero
    h0, against the plain version's exp(dt * A), at chip_smoke's SCAN_TOL
    (1e-4 + 1e-4 |want|)."""
    dt, x, b, c, A, h0 = (torch.from_numpy(a) for a in
                          _selective_inputs(2, 1100, 16, 16, 11))
    want_y, want_h = ref.selective_scan_ref(dt, x, b, c, A, h0)
    A2 = A * 1.4426950408889634
    h, ys = h0.clone(), []
    for t in range(dt.shape[1]):
        decay = torch.exp2(dt[:, t, :, None] * A2)
        h = decay * h + (dt[:, t] * x[:, t])[..., None] * b[:, t, None, :]
        ys.append((h * c[:, t, None, :]).sum(-1))
    torch.testing.assert_close(torch.stack(ys, 1), want_y, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)


# the selective scan's design on the card: the direct path (T <= 8), the ring
# at one stage (32 steps) -1, 0, +1, and the serving length
SEL_T = [1, 7, 31, 32, 33, 1100]


def _sel_case(B, T, D, N, dtype, offset, seed, x_pad=0):
    """Inputs on the card: b, c slices ``offset`` columns into one
    projection, x with ``x_pad`` extra columns a row, h0 nonzero."""
    dt, x, b, c, A, h0 = (torch.from_numpy(a).cuda() for a in
                          _selective_inputs(B, T, D, N, seed))
    proj = torch.cat([torch.zeros_like(b[..., :1]).expand(B, T, offset), b,
                      c], dim=-1).to(dtype)
    xs = torch.zeros(B, T, D + x_pad, dtype=dtype, device="cuda")
    xs[..., :D] = x.to(dtype)
    return (dt, xs[..., :D], proj[..., offset:offset + N],
            proj[..., offset + N:], A, h0)


def _hold_selective(args):
    y, h = ms.selective_scan(*args)
    wy, wh = ref.selective_scan_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, wy, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, wh, rtol=1e-4, atol=1e-4)
    return y, h


@pytest.mark.cuda
@pytest.mark.parametrize("offset,dtype", [(256, "bfloat16"), (7, "float32")])
@pytest.mark.parametrize("T", SEL_T)
@pytest.mark.parametrize("N", [1, 5, 12, 16, 64, 128])
def test_cuda_selective_scan_stress(N, T, offset, dtype):
    """Every state path (S, P) and both paths in time, aligned (256) and
    unaligned (7) b/c slices, B of 1, 4 and 9 in turn, D = 80 (no multiple
    of a block's channels), h0 nonzero and held through h_last; at
    chip_smoke's SCAN_TOL."""
    B = (1, 4, 9)[(SEL_T.index(T) + N) % 3]
    _cuda_or_skip()
    _hold_selective(_sel_case(B, T, 80, N, getattr(torch, dtype), offset,
                              N * 1000 + T))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [7, 33, 300])
def test_cuda_selective_scan_strided_operands(T, dtype):
    """x with 3 extra columns a row and dt off 16 bytes: the producer warp's
    lanes load them (no TMA), as the plan says; the same results."""
    _cuda_or_skip()
    B, D, N = 4, 96, 16
    dt, x, b, c, A, h0 = _sel_case(B, T, D, N, getattr(torch, dtype), 7,
                                   T, x_pad=3)
    dt = torch.cat([torch.zeros(1, device="cuda"), dt.flatten()])[1:].view(
        B, T, D)
    plan = ms.selective_plan(dt, x, A, h0, torch.empty_like(h0))
    assert not plan.tma_dt and not plan.tma_x and plan.direct == (T <= 8)
    _hold_selective((dt, x, b, c, A, h0))


@pytest.mark.cuda
def test_cuda_selective_scan_plan_matches_the_mirror():
    """The kernel's host code makes the plan ``selective_plan`` says, over
    states, paths, alignments and dtypes."""
    _cuda_or_skip()
    cases = [dict(B=4, T=1100, D=8192, N=16), dict(B=4, T=1, D=8192, N=16),
             dict(B=9, T=33, D=80, N=5), dict(B=1, T=40, D=80, N=128),
             dict(B=2, T=40, D=96, N=12, offset=7, x_pad=3),
             dict(B=2, T=40, D=96, N=16, dt_shift=1),
             dict(B=2, T=40, D=96, N=64, dtype=torch.float32, x_pad=1)]
    for case in cases:
        dt, x, b, c, A, h0, hl = (t.cuda() for t in _plan_operands(**case))
        want = ms.selective_plan(dt, x, A, h0, hl)
        assert ms.kernel_plan(dt, x, b, c, A, h0, hl) == want, case


@pytest.mark.cuda
def test_cuda_selective_scan_carries_state_across_calls():
    """Prefill then decode steps, as the model runs them: the scan of T
    steps from h0 equals the scan of the first T - 3 steps followed by three
    T = 1 calls, each from the last's h_last."""
    _cuda_or_skip()
    args = _sel_case(4, 200, 96, 16, torch.bfloat16, 256, 5)
    y, h = ms.selective_scan(*args)
    dt, x, b, c, A, h0 = args
    ys = []
    y0, hc = ms.selective_scan(dt[:, :197], x[:, :197], b[:, :197],
                               c[:, :197], A, h0)
    for t in range(197, 200):
        yt, hc = ms.selective_scan(dt[:, t:t + 1], x[:, t:t + 1],
                                   b[:, t:t + 1], c[:, t:t + 1], A, hc)
        ys.append(yt)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([y0, *ys], 1), y, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(hc, h, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (384, 128, 128),
                                   (100, 192, 77), (3, 512, 300)])
def test_cuda_lut_matmul_matches_plain_version(M, K, N, dtype):
    """TestLutMatmul's f32 tolerance (1e-5 relative, 1e-4 absolute) for
    both dtypes: bf16 x widens exactly and the products are f32 in both;
    the plain version's matmul runs with TF32 off."""
    _cuda_or_skip()
    rng = np.random.default_rng(M + K + N)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).cuda()
    w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).cuda()
    codes, lut = ops.quantize_weights(w)
    x = x.to(getattr(torch, dtype))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = lm.lut_matmul(x, codes, lut)
        want = ref.lut_matmul_ref(x, codes, lut)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


# ---- the build --------------------------------------------------------------

def test_build_hash_covers_the_shared_headers(tmp_path):
    """A library is named by its source, the ``csrc/*.cuh`` headers and the
    flags: an edited header renames (so rebuilds) every library, and an
    edited source renames only its own."""
    import shutil
    from repro_torch.kernels import _build
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp_path / f.name)
    names = sorted(p.stem for p in tmp_path.glob("*.cu"))
    assert {"flash_attention", "lut_matmul"} <= set(names)
    assert (tmp_path / "hopper.cuh").exists()
    before = {n: _build.digest(n, tmp_path) for n in names}
    assert before == {n: _build.digest(n, tmp_path) for n in names}
    header = tmp_path / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build.digest(n, tmp_path) for n in names}
    assert all(after[n] != before[n] for n in names)
    src = tmp_path / "lut_matmul.cu"
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    again = {n: _build.digest(n, tmp_path) for n in names}
    assert [n for n in names if again[n] != after[n]] == ["lut_matmul"]
    assert "-I" in _build.NVCC_FLAGS


# ---- the Hopper kernels' numerical designs, emulated on the CPU -------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits' range to
    the bit pattern (sign-magnitude, so this rounds the magnitude), then
    clear them."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores do with a float32 operand: keep TF32's 10
    mantissa bits, drop the other 13 (truncation)."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    u = 2.0 ** -10                          # one TF32 ulp at 1
    x = torch.tensor([1 + u / 2, 1 + 1.5 * u, -(1 + 1.5 * u), 1 + u / 4,
                      3.0, -2 - u / 2], dtype=torch.float32)
    want = torch.tensor([1 + u, 1 + 2 * u, -(1 + 2 * u), 1.0, 3.0, -2.0],
                        dtype=torch.float32)
    assert torch.equal(_tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(1).normal(size=4096).astype(
        np.float32))
    assert not bool((_tf32(y).view(torch.int32) & 0x1FFF).any())
    assert float(((_tf32(y) - y).abs() / y.abs()).max()) <= 2.0 ** -11


def _lut_design_inputs(dtype, M=64, K=4096, N=256):
    """``chip_smoke.py``'s LUT statistics: x ~ N(0, 1), weights N(0, 1/K)
    through ``quantize_weights``; W dequantized on the CPU."""
    rng = np.random.default_rng(K + N)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    x = x.to(getattr(torch, dtype)).float()
    w = torch.from_numpy((rng.normal(size=(K, N)) * K ** -0.5).astype(
        np.float32))
    codes, lut = ops.quantize_weights(w)
    W = ref.lut_matmul_ref(torch.eye(K), codes, lut)
    return x, W


def _lut_err(got, want):
    """Max error and whether each element is within the kernel's tolerance
    1e-4 + 1e-5 |want|."""
    d = (got - want).abs()
    return float(d.max()), bool((d <= 1e-4 + 1e-5 * want.abs()).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lut_3xtf32_scheme_holds_the_kernel_tolerance(dtype):
    """The LUT kernel's arithmetic: x and W split into a TF32 hi (rounded
    to nearest) and the residual, which the tensor cores truncate to TF32;
    the three products x_hi W_hi + x_hi W_lo + x_lo W_hi (exact on the
    tensor cores, summed here in float64), at K = 4096 against the float64
    product.  bf16 x is exact in TF32 (x_lo = 0), so two products do."""
    x, W = _lut_design_inputs(dtype)
    xh, Wh = _tf32(x), _tf32(W)
    xl, Wl = _tf32_trunc(x - xh), _tf32_trunc(W - Wh)
    if dtype == "bfloat16":
        assert torch.equal(xh, x) and not bool(xl.any())
    d = torch.float64
    got = (xh.to(d) @ Wh.to(d) + xh.to(d) @ Wl.to(d) + xl.to(d) @ Wh.to(d))
    err, ok = _lut_err(got.float().to(d), x.to(d) @ W.to(d))
    assert ok, err
    assert err < 1e-5


def test_lut_single_tf32_product_misses_the_kernel_tolerance():
    """Why the kernel splits: one TF32 product (10-bit operands) misses
    1e-4 + 1e-5 |want| at K = 4096 by an order of magnitude."""
    x, W = _lut_design_inputs("float32")
    d = torch.float64
    err, ok = _lut_err((_tf32(x).to(d) @ _tf32(W).to(d)).float().to(d),
                       x.to(d) @ W.to(d))
    assert not ok and err > 1e-4


LOG2E = 1.4426950408889634


def _flash_bf16_scheme(q, k, v, *, causal, window, softcap, bk, split=True):
    """The bf16 flash kernel's arithmetic on one head: q (Tq, D), k/v
    (Tk, D) holding bf16 values.  Scores q k^T in float32 (bf16 products are
    exact), in log2 units, masked with the finite -1e30; online softmax over
    key tiles of ``bk``; P split into hi (its top 16 bits) + lo (the rest,
    rounded to bf16) and both multiplied by V in float32.  Returns the
    float32 output before its cast to bf16."""
    Tq, D = q.shape
    scale = D ** -0.5
    m = torch.full((Tq,), ref.NEG_INF)
    l = torch.zeros(Tq)
    o = torch.zeros(Tq, D)
    qpos = torch.arange(Tq)[:, None]
    for k0 in range(0, k.shape[0], bk):
        kb, vb = k[k0:k0 + bk], v[k0:k0 + bk]
        s = q @ kb.T
        x = (softcap * LOG2E * torch.tanh(s * scale / softcap) if softcap
             else s * (scale * LOG2E))
        kpos = torch.arange(k0, k0 + kb.shape[0])[None]
        ok = torch.ones_like(x, dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window:
            ok &= (qpos - kpos) < window
        x = torch.where(ok, x, torch.tensor(ref.NEG_INF))
        m_new = torch.maximum(m, x.max(dim=1).values)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[:, None])
        l = l * corr + p.sum(dim=1)
        o = o * corr[:, None]
        if split:
            hi = (p.view(torch.int32) & -65536).view(torch.float32)
            o = o + hi @ vb + (p - hi).bfloat16().float() @ vb
        else:
            o = o + p.bfloat16().float() @ vb
        m = m_new
    return o / l.clamp_min(1e-30)[:, None]


def _attention_f64(q, k, v, *, causal, window, softcap):
    out = ref.flash_attention_ref(q[None].double(), k[None].double(),
                                  v[None].double(), causal=causal,
                                  window=window, softcap=softcap)
    return out[0]


FLASH_DESIGN_CASES = [
    # Tq, Tk, D, causal, window, softcap, key tile of the kernel at D
    (130, 130, 64, True, 0, 0.0, 128),
    (300, 300, 128, True, 100, 30.0, 128),
    (200, 333, 256, False, 0, 50.0, 64),
    (1100, 1100, 128, True, 0, 0.0, 128),
]


def _bf16_heads(Tq, Tk, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(T, D)).astype(np.float32))
            .bfloat16().float() for T in (Tq, Tk, Tk)]


@pytest.mark.parametrize("Tq,Tk,D,causal,window,softcap,bk",
                         FLASH_DESIGN_CASES)
def test_flash_bf16_scheme_matches_float64_attention(Tq, Tk, D, causal,
                                                     window, softcap, bk):
    """P as hi + lo keeps the output within 5e-5 of float64 attention on the
    same bf16 inputs before the cast, and within the kernel's 2e-2 after."""
    q, k, v = _bf16_heads(Tq, Tk, D, Tq + D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _flash_bf16_scheme(q, k, v, bk=bk, **kw)
    want = _attention_f64(q, k, v, **kw)
    assert float((got.double() - want).abs().max()) <= 5e-5
    assert float((got.bfloat16().double() - want).abs().max()) <= 2e-2


def test_flash_single_bf16_p_loses_the_f32_product():
    """Why P is split: one bf16 P (8 significant bits) is off float64
    attention by ~3e-3, where the reference multiplies p @ v in f32."""
    q, k, v = _bf16_heads(300, 300, 128, 7)
    kw = dict(causal=True, window=0, softcap=0.0)
    got = _flash_bf16_scheme(q, k, v, bk=128, split=False, **kw)
    assert float((got.double() - _attention_f64(q, k, v, **kw)).abs().max()) \
        > 5e-4


# ---- the Hopper kernels on the card -----------------------------------------

def _bf16_gqa(rng, B, Tq, Tk, H, K, D):
    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.bfloat16,
                            device="cuda")
    return t(B, Tq, H, D), t(B, Tk, K, D), t(B, Tk, K, D)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,K,D,window,softcap", [
    (1, 130, 2, 2, 128, 0, 0.0),          # ragged: one full and one short tile
    (4, 1100, 32, 2, 128, 0, 0.0),        # the serving prefill shape
    (4, 1100, 16, 16, 128, 0, 0.0),       # qwen2-moe's prefill, G = 1
    (2, 300, 4, 2, 64, 100, 30.0),        # window + soft-cap
    (2, 300, 4, 2, 256, 100, 30.0),
    (1, 1000, 2, 1, 256, 64, 50.0),       # tiles skipped outside the window
])
def test_cuda_flash_bf16_against_plain_version(B, T, H, K, D, window,
                                               softcap):
    """The TMA/wgmma bf16 kernel at the 2e-2 of ``chip_smoke.py``."""
    _cuda_or_skip()
    q, k, v = _bf16_gqa(np.random.default_rng(T + D), B, T, T, H, K, D)
    kw = dict(causal=True, window=window, softcap=softcap)
    got = fa.flash_attention_gqa(q, k, v, **kw)
    want = ref.flash_attention_gqa_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_cuda_flash_bf16_reads_a_cache_slice_in_place():
    """Prefill passes ``cache[:, :T]``: batch and time strides of the longer
    cache, read through the tensor maps without a copy."""
    _cuda_or_skip()
    rng = np.random.default_rng(5)
    q, ck, cv = _bf16_gqa(rng, 2, 300, 512, 8, 2, 128)
    k, v = ck[:, :300], cv[:, :300]
    assert not k.is_contiguous()
    got = fa.flash_attention_gqa(q, k, v)
    want = ref.flash_attention_gqa_ref(q, k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(1, 64, 1), (257, 192, 129),
                                   (100, 4096, 300), (130, 128, 260)])
def test_cuda_lut_matmul_ragged_against_plain_version(M, K, N, dtype):
    """The 3xTF32 kernel at ragged M and N (edges of its 128 x 128 tiles,
    odd N for the scalar stores), ``chip_smoke.py``'s statistics and its
    1e-4 + 1e-5 |want|."""
    _cuda_or_skip()
    rng = np.random.default_rng(M + N)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).cuda()
    w = torch.from_numpy((rng.normal(size=(K, N)) * K ** -0.5).astype(
        np.float32)).cuda()
    codes, lut = ops.quantize_weights(w)
    x = x.to(getattr(torch, dtype))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = lm.lut_matmul(x, codes, lut)
        want = ref.lut_matmul_ref(x, codes, lut)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


# ---- flash attention backward ----------------------------------------------

# The backward kernel against its plain version: float32 differs by
# summation order and exp2 (~1e-5 at these sizes); bfloat16 rounds P and dS
# to bf16 before the tensor-core products and dQ, dK, dV once more on
# output (1 ulp of |x| < 16 is <= 6.3e-2), which
# test_flash_bwd_bf16_scheme_holds_the_kernel_tolerance bounds on the CPU
BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}

# (B, T, H, K, D, window, softcap): GQA, ragged T, window, soft-cap
BWD_GRID = [(2, 37, 4, 2, 16, 0, 0.0), (1, 100, 6, 2, 32, 0, 0.0),
            (2, 64, 2, 2, 16, 16, 0.0), (1, 73, 4, 1, 32, 20, 30.0),
            (2, 50, 4, 4, 16, 0, 5.0)]


def _bwd_inputs(B, T, H, K, D, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=dtype)
    return t(B, T, H, D), t(B, T, K, D), t(B, T, K, D), t(B, T, H, D)


@pytest.mark.parametrize("B,T,H,K,D,window,softcap", BWD_GRID)
def test_bwd_ref_matches_autograd_of_the_forward(B, T, H, K, D, window,
                                                 softcap):
    q, k, v, do = _bwd_inputs(B, T, H, K, D, T + D, torch.float64)
    kw = dict(window=window, softcap=softcap)
    o, lse = ref.flash_attention_gqa_ref(q, k, v, return_lse=True, **kw)
    got = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(ref.flash_attention_gqa_ref(q, k, v, **kw),
                               (q, k, v), do)
    for g, w in zip(got, want):       # the plain versions compute in f32
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,T,H,K,D,window,softcap", BWD_GRID)
def test_bwd_ref_matches_jax_grad_of_model_attention(B, T, H, K, D, window,
                                                     softcap):
    """``jax.grad`` of ``layers.attention`` (the reference's training
    attention, recomputed blocks and all) on the same inputs."""
    jax_, jnp, jlayers = _jmods("jax", "jax.numpy", "repro.models.layers")
    q, k, v, do = _bwd_inputs(B, T, H, K, D, 2 * T + D)
    spec = jlayers.AttnSpec(H, K, D, window=window, softcap=softcap,
                            kv_block=32)

    def f(q, k, v):
        o = jlayers.attention(q, k, v, spec, q_offset=0, is_global=False)
        return jnp.sum(o * jnp.asarray(do.numpy()))

    want = jax_.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    kw = dict(window=window, softcap=softcap)
    o, lse = ref.flash_attention_gqa_ref(q, k, v, return_lse=True, **kw)
    got = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (7, 0.0), (0, 20.0)])
def test_plain_lse_is_the_logsumexp_of_the_scores(window, softcap):
    q, k, v, _ = _bwd_inputs(2, 45, 4, 2, 16, 11)
    _, lse = ref.flash_attention_gqa_ref(q, k, v, return_lse=True,
                                         window=window, softcap=softcap)
    qd, kd = q.double().numpy(), k.double().numpy()
    kd = np.repeat(kd, 2, axis=2)                       # G = 2
    s = np.einsum("bqhd,bkhd->bhqk", qd, kd) * 16 ** -0.5
    if softcap:
        s = softcap * np.tanh(s / softcap)
    qpos, kpos = np.arange(45)[:, None], np.arange(45)[None, :]
    ok = (kpos <= qpos) & ((qpos - kpos < window) if window else True)
    s = np.where(ok, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


def test_differentiable_op_on_the_cpu_is_autograd_of_the_plain_version():
    q, k, v, do = _bwd_inputs(1, 40, 4, 2, 16, 3)
    qs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.gqa_flash_attention(*qs, window=9, softcap=15.0)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, qs, do)
    rs = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_gqa_ref(
        *rs, window=9, softcap=15.0), rs, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    with torch.no_grad():                # serving: no LSE, nothing saved
        assert ops.gqa_flash_attention(*qs).grad_fn is None
    assert ops.gqa_flash_attention(q, k, v).grad_fn is None


@pytest.mark.parametrize("bad", ["not_causal", "tq_ne_tk", "lse_shape",
                                 "do_dtype", "do_layout", "o_layout"])
def test_bwd_wrapper_rejects_what_the_kernel_does_not_take(bad):
    B, T, H, K, D = 1, 8, 4, 2, 64
    q, o, do = (torch.zeros(B, T, H, D) for _ in range(3))
    k = torch.zeros(B, T, K, D)
    lse = torch.zeros(B, H, T)
    causal = True
    if bad == "not_causal":
        causal = False
    elif bad == "tq_ne_tk":
        k = torch.zeros(B, T + 1, K, D)
    elif bad == "lse_shape":
        lse = torch.zeros(B, T, H)
    elif bad == "do_dtype":
        do = do.bfloat16()
    elif bad == "do_layout":            # heads and head_dim not contiguous
        do = torch.zeros(B, T, D, H).transpose(2, 3)
    elif bad == "o_layout":
        o = torch.zeros(B, H, T, D).transpose(1, 2)
    with pytest.raises(ValueError):
        fa._check_bwd(q, k, o, lse, do, causal)


def test_bwd_wrapper_never_falls_back_off_the_cpu():
    q = torch.zeros(1, 8, 2, 64, device="meta")
    lse = torch.zeros(1, 2, 8, device="meta")
    before = fa.flash_attention_bwd.launches
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, q, q, q, lse, q)
    assert fa.flash_attention_bwd.launches == before


def _bwd_bf16_scheme(q, k, v, o, lse, do, *, window, softcap):
    """The bf16 kernel's arithmetic in float64: P and dS rounded to bf16
    before their products, f32-exact products of the bf16 inputs, outputs
    rounded to bf16."""
    def bf(x):
        return x.to(torch.bfloat16).double()

    B, T, H, D = q.shape
    K = k.shape[2]
    qf, kf, vf = (x.double() for x in ref._heads_major(q, k, v))
    of, dof = (x.double().permute(0, 2, 1, 3).reshape(B * H, T, D)
               for x in (o, do))
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * D ** -0.5
    dcap = torch.ones_like(s)
    if softcap:
        th = torch.tanh(s / softcap)
        s, dcap = softcap * th, 1 - th * th
    ok = ref._mask(T, T, True, window, q.device)[None]
    p = torch.where(ok, torch.exp(s - lse.reshape(B * H, T, 1).double()),
                    torch.zeros_like(s))
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    ds = p * (dp - (dof * of).sum(-1, keepdim=True)) * dcap
    dv = torch.einsum("bqk,bqd->bkd", bf(p), dof)
    dk = torch.einsum("bqk,bqd->bkd", bf(ds), qf) * D ** -0.5
    dq = torch.einsum("bqk,bkd->bqd", bf(ds), kf) * D ** -0.5
    G = H // K

    def kv(x):
        return x.reshape(B, K, G, T, D).sum(2).permute(0, 2, 1, 3)

    return (dq.reshape(B, H, T, D).permute(0, 2, 1, 3).to(torch.bfloat16),
            kv(dk).to(torch.bfloat16), kv(dv).to(torch.bfloat16))


@pytest.mark.parametrize("T,H,K,D,window,softcap", [
    (300, 4, 2, 64, 0, 0.0), (257, 2, 1, 128, 100, 30.0),
    (1024, 2, 1, 64, 0, 0.0)])
def test_flash_bwd_bf16_scheme_holds_the_kernel_tolerance(T, H, K, D,
                                                          window, softcap):
    """The bf16 roundings of the kernel's design keep dQ, dK, dV within
    ``BWD_TOL`` of the plain version, with room to spare (half of it)."""
    q, k, v, do = _bwd_inputs(1, T, H, K, D, T, torch.bfloat16)
    kw = dict(window=window, softcap=softcap)
    o, lse = ref.flash_attention_gqa_ref(q, k, v, return_lse=True, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    got = _bwd_bf16_scheme(q, k, v, o, lse, do, **kw)
    half = {n: x / 2 for n, x in BWD_TOL[torch.bfloat16].items()}
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), **half)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("B,T,H,K,window,softcap", [
    (2, 300, 4, 2, 0, 0.0),       # GQA, ragged last tile
    (1, 130, 4, 1, 100, 30.0),    # window + soft-cap
    (2, 64, 2, 2, 0, 0.0),        # one tile
    (1, 1000, 4, 2, 64, 50.0),    # tiles skipped outside the window
    (1, 200, 8, 1, 0, 0.0),       # G = 8: eight query heads a kv head
    (2, 37, 4, 2, 0, 0.0),        # T < 64: one ragged tile
    (1, 129, 4, 2, 0, 0.0),       # T one past two tiles
    (1, 300, 4, 2, 64, 0.0),      # a window of one tile
    (1, 300, 4, 2, 20, 0.0),      # a window shorter than a tile
    (2, 300, 4, 4, 0, 0.0)])      # G = 1: one query head a kv head
def test_cuda_flash_bwd_matches_plain_version(B, T, H, K, D, window,
                                              softcap, dtype):
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    q, k, v, do = (x.cuda() for x in _bwd_inputs(B, T, H, K, D, T + D, dt))
    kw = dict(window=window, softcap=softcap)
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == dt
        torch.testing.assert_close(g.float(), w.float(), **BWD_TOL[dt])


@pytest.mark.cuda
def test_cuda_flash_bwd_at_qwen2_moe_training_shape():
    """qwen2-moe-a2.7b's training attention (B=4, T=2048, 16 query heads
    over 16 kv heads of 128, bf16 causal) within ``BWD_TOL``."""
    _cuda_or_skip()
    dt = torch.bfloat16
    q, k, v, do = (x.cuda() for x in _bwd_inputs(4, 2048, 16, 16, 128, 17,
                                                  dt))
    o, lse = fa.flash_attention_lse(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), **BWD_TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_cuda_flash_bwd_is_deterministic(D, dtype):
    """No atomics: two calls give dQ, dK, dV bit for bit alike (GQA, a
    ragged tail, a window)."""
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    q, k, v, do = (x.cuda() for x in _bwd_inputs(2, 333, 8, 2, D, D, dt))
    o, lse = fa.flash_attention_lse(q, k, v, window=100)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, window=100)
    second = fa.flash_attention_bwd(q, k, v, o, lse, do, window=100)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_cuda_forward_with_lse_equals_forward_without(D, dtype):
    """Writing the LSE leaves ``o`` bit for bit as it was; the LSE is the
    plain version's within 1e-4 (natural-log units)."""
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    q, k, v, _ = (x.cuda() for x in _bwd_inputs(2, 333, 4, 2, D, D, dt))
    for kw in (dict(), dict(window=50, softcap=20.0)):
        o, lse = fa.flash_attention_lse(q, k, v, **kw)
        o0 = fa.flash_attention_gqa(q, k, v, **kw)
        _, want = ref.flash_attention_gqa_ref(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(o, o0)
        torch.testing.assert_close(lse, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_launch_counters_under_grad_and_serving():
    """Under grad: one forward launch (with LSE) and one backward launch a
    call; without grad (serving): one forward launch and no backward."""
    _cuda_or_skip()
    q, k, v, do = (x.cuda() for x in _bwd_inputs(2, 200, 4, 2, 64, 1,
                                                  torch.bfloat16))
    f0, b0 = fa.flash_attention_gqa.launches, fa.flash_attention_bwd.launches
    qs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.gqa_flash_attention(*qs)
    got = torch.autograd.grad(out, qs, do)
    assert (fa.flash_attention_gqa.launches - f0,
            fa.flash_attention_bwd.launches - b0) == (1, 1)
    o, lse = ref.flash_attention_gqa_ref(q, k, v, return_lse=True)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(),
                                   **BWD_TOL[torch.bfloat16])
    with torch.no_grad():
        ops.gqa_flash_attention(*qs)
    torch.cuda.synchronize()
    assert (fa.flash_attention_gqa.launches - f0,
            fa.flash_attention_bwd.launches - b0) == (2, 1)
