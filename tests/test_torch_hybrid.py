"""Port's Mamba-2 and the hybrid family (zamba2) against ``repro.models.ssm``
and ``repro.models.model`` on converted parameters.

Reduced zamba2 (4 layers, attn_every 2, 8 heads of 16, state 8): the JAX
parameter tree goes through ``convert.params_from_numpy`` and both packages
run the same numpy inputs.  The reference scans with a chunked associative
scan (``CHUNK // 4`` = 64 steps a chunk), the port with a sequential
recurrence (its kernel's plain version on the CPU): in float32 they differ
by summation order only, held to 2e-4 as ``test_torch_ssm.py``; T = 100 and
130 cross the chunk boundary.  The plain version of the kernel's chunked
(SSD) prefill path, ``ref.mamba2_scan_chunked_ref``, is held to both at
the scans' tolerance, with and without its emulation of the kernel's bf16
terms.  The kernel itself (``mamba2_scan_fwd``) and flash at head_dim 80
run only on a card: their tests are in ``test_torch_kernels.py``, marked
``cuda`` (that file imports JAX only inside its parity tests, since the
card's machine has no JAX).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig

from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.optim import adamw
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train import train_step as ts

ARCH = "zamba2-2.7b"
TOL = 2e-4
F32_LEAVES = ("dt_bias", "A_log", "D", "dt_proj_h")


def _np_tree(params):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _cfgs(dtype="float32", arch=ARCH, **kw):
    return (dataclasses.replace(jreg.get(arch).reduced(), dtype=dtype, **kw),
            dataclasses.replace(treg.get(arch).reduced(), dtype=dtype, **kw))


def _pair(dtype="float32", seed=0, arch=ARCH, **kw):
    jcfg, tcfg = _cfgs(dtype, arch, **kw)
    jm = jmodel.build(jcfg)
    np_tree = _np_tree(jm.init(jax.random.key(seed)))
    # a decay a head (A = -exp(A_log), 0 at init) and a norm that scales
    np_tree["blocks"]["mixer"]["A_log"] = np.random.default_rng(seed).normal(
        size=np_tree["blocks"]["mixer"]["A_log"].shape).astype(np.float32)
    np_tree["blocks"]["mixer"]["norm_w"] = np.random.default_rng(
        seed + 1).normal(size=np_tree["blocks"]["mixer"]["norm_w"].shape
                         ).astype(np.float32) * 0.1
    jp = jax.tree.map(jnp.asarray, np_tree)
    if jcfg.dtype == "bfloat16":
        jp = jax.tree.map(lambda a, b: a.astype(b.dtype), jp,
                          jm.init(jax.random.key(seed)))
    tm = tmodel.build(tcfg, "cpu")
    tp = convert.params_from_numpy(np_tree, tcfg, "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _tokens(cfg, B=2, T=12, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def _mixer(pair, layer=0):
    _, jp, _, tp = pair
    jmix = jax.tree.map(lambda a: a[layer], jp["blocks"]["mixer"])
    tmix = {k: v[layer] for k, v in tp["blocks"]["mixer"].items()}
    return jmix, tmix


# ---- config and parameters ---------------------------------------------------

def test_config_copy_matches_reference():
    assert dataclasses.asdict(treg.get(ARCH)) == dataclasses.asdict(
        jreg.get(ARCH))
    assert dataclasses.asdict(treg.get(ARCH).reduced()) == dataclasses.asdict(
        jreg.get(ARCH).reduced())
    cfg = treg.get(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_state,
            cfg.ssm_head_dim, cfg.head_dim, cfg.attn_every,
            cfg.n_shared_attn_blocks) == (54, 2560, 5120, 64, 64, 80, 6, 2)
    small = treg.get(ARCH).reduced()
    assert (small.n_layers, small.attn_every, small.d_inner //
            small.ssm_head_dim, small.ssm_head_dim, small.ssm_state) == (
                4, 2, 8, 16, 8)


@pytest.mark.parametrize("arch", [ARCH, "falcon-mamba-7b"])
def test_init_shapes_dtypes_std(arch):
    """Leaf for leaf the reference's tree, shapes and dtypes; the hybrid's
    ``shared_attn`` stack, and Mamba-2 in an ``ssm`` model too."""
    kw = {"mamba_version": 2} if arch != ARCH else {}
    jcfg = dataclasses.replace(jreg.get(arch).reduced(), **kw)
    tcfg = dataclasses.replace(treg.get(arch).reduced(), **kw)
    jp = jmodel.build(jcfg).init(jax.random.key(0))
    tp = tmodel.build(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    flat_j = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}['{k}']")
            else:
                flat_t[f"{prefix}['{k}']"] = v
    walk(tp, "")
    assert flat_t.keys() == flat_j.keys()
    for k, t in flat_t.items():
        j = flat_j[k]
        assert tuple(t.shape) == j.shape, k
        assert str(t.dtype).split(".")[-1] == str(j.dtype), k
        sj, st = np.asarray(j, np.float32).std(), t.float().std().item()
        assert (sj == 0 and st == 0) or abs(st - sj) < 0.15 * sj, (k, sj, st)
    if arch == ARCH:
        assert tp["shared_attn"]["attn"]["wq"].shape[0] == 2


def test_convert_keeps_float32_leaves_under_bf16():
    """Mamba-2's float32 leaves stay float32 under a bf16 config, exact; the
    others, ``shared_attn`` included, are bf16 as the port's init makes
    them."""
    jcfg, tcfg = jreg.get(ARCH).reduced(), treg.get(ARCH).reduced()
    assert tcfg.dtype == "bfloat16"
    jp = jmodel.build(jcfg).init(jax.random.key(4))
    # decay and step parameters that bf16 would round
    jp["blocks"]["mixer"]["A_log"] = jp["blocks"]["mixer"]["A_log"] + 1e-3
    jp["blocks"]["mixer"]["dt_bias"] = jp["blocks"]["mixer"]["dt_bias"] + 1e-3
    tp = convert.params_from_numpy(_np_tree(jp), tcfg, "cpu")
    want = tmodel.build(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    for k, v in tp["blocks"]["mixer"].items():
        assert v.dtype == want["blocks"]["mixer"][k].dtype, k
        assert (v.dtype == torch.float32) == (k in F32_LEAVES), k
        np.testing.assert_array_equal(
            v.float().numpy(), np.asarray(jp["blocks"]["mixer"][k],
                                          np.float32), err_msg=k)
    for leaf in (tp["shared_attn"]["attn"]["wq"], tp["shared_attn"]["ln"],
                 tp["shared_attn"]["mlp"]["wo"], tp["embed"]):
        assert leaf.dtype == torch.bfloat16


# ---- the scan ----------------------------------------------------------------

def _mamba2_inputs(B, T, H, P, N, seed):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(size=(B, T, H)) - 1)).astype(np.float32)
    return (dt, rng.normal(size=(B, T, H, P)).astype(np.float32),
            rng.normal(size=(B, T, N)).astype(np.float32),
            rng.normal(size=(B, T, N)).astype(np.float32),
            -np.exp(rng.normal(size=(H,))).astype(np.float32),
            (rng.normal(size=(B, H, P, N)) * 0.5).astype(np.float32))


def _jax_mamba2_scan(dt, x, b, c, A, h0):
    """The scan of the reference's ``mamba2_block``: its make_chunk and
    emit_chunk through ``fused_ssm_scan`` at ``CHUNK // 4``."""
    A = jnp.asarray(A)

    def make_chunk(dt_c, xh_c, b_c, _c_c):
        decay = jnp.exp(dt_c * A)[..., None, None]
        bx = (dt_c[..., None] * xh_c)[..., None] * b_c[:, :, None, None, :]
        return jnp.broadcast_to(decay, bx.shape), bx

    def emit_chunk(h_all, _dt, _xh, _b, c_c):
        return jnp.einsum("bchdn,bcn->bchd", h_all, c_c)

    ins = tuple(jnp.asarray(a) for a in (dt, x, b, c))
    return jssm.fused_ssm_scan(make_chunk, emit_chunk, ins, jnp.asarray(h0),
                               dt.shape[1], jssm.CHUNK // 4)


@pytest.mark.parametrize("T", [1, 5, 64, 100, 130])
def test_mamba2_scan_ref_matches_jax_mamba2_scan(T):
    """From a nonzero h0, across the reference's 64-step chunks; float32
    summation order only, at 2e-4; the CPU wrapper is the plain version."""
    args = _mamba2_inputs(2, T, 3, 4, 8, T)
    jy, jh = _jax_mamba2_scan(*args)
    tin = [torch.from_numpy(a) for a in args]
    ty, th = ref.mamba2_scan_ref(*tin)
    assert ty.shape == (2, T, 3, 4) and th.shape == (2, 3, 4, 8)
    _close(ty, jy)
    _close(th, jh)
    wy, wh = ops.mamba2_scan(*tin)
    np.testing.assert_array_equal(wy.numpy(), ty.numpy())
    np.testing.assert_array_equal(wh.numpy(), th.numpy())


def test_mamba2_scan_ref_is_selective_scan_ref_on_broadcast_inputs():
    """The Mamba-2 form is the Mamba-1 form with dt and x over (head, row)
    channels, dt and A broadcast over a head's rows: the same function."""
    dt, x, b, c, A, h0 = (torch.from_numpy(a) for a in
                          _mamba2_inputs(2, 9, 3, 4, 5, 1))
    y, h = ref.mamba2_scan_ref(dt, x, b, c, A, h0)
    B, T, H, P = x.shape
    y1, h1 = ref.selective_scan_ref(
        dt[..., None].expand(B, T, H, P).reshape(B, T, H * P),
        x.reshape(B, T, H * P), b, c,
        A[:, None, None].expand(H, P, 5).reshape(H * P, 5),
        h0.reshape(B, H * P, 5))
    np.testing.assert_allclose(y.reshape(B, T, H * P).numpy(), y1.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(h.reshape(B, H * P, 5).numpy(), h1.numpy(),
                               rtol=1e-6, atol=1e-6)


# ---- the chunked (SSD) form of the kernel's prefill path --------------------
# ``ref.mamba2_scan_chunked_ref`` is the plain version of what
# ``csrc/mamba_scan.cu``'s chunked path computes: 64-step chunks, direct
# segment sums, and (``bf16_terms``) the float32 side of three of its four
# tensor-core products as bfloat16 terms.  It is held at the scans'
# tolerance (``chip_smoke.SCAN_TOL``, what the kernel is held to on the card)
# against the sequential recurrence and the reference's chunked scan.

SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TERMS = 3           # bf16 terms of a float32 operand in the kernel


def _scan_close(t, want):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(want, np.float32),
                               **SCAN_TOL)


def _chunked_inputs(T, P, N, dtype, seed, reset=False):
    """``_mamba2_inputs`` at B = 2, H = 3 as torch tensors, x, b and c in
    ``dtype`` (and the float32 numpy arrays of the same values for JAX).
    ``reset``: dt A = -1000 and x = 0 at step 3 of every 64-step chunk, so
    the state is wiped without an input of that size."""
    dt, x, b, c, A, h0 = _mamba2_inputs(2, T, 3, P, N, seed)
    if reset:
        dt[:, 3::64] = 1000.0 / -A
        x[:, 3::64] = 0
    tin = [torch.from_numpy(a) for a in (dt, x, b, c, A, h0)]
    tin[1:4] = [t.to(getattr(torch, dtype)) for t in tin[1:4]]
    return tin, [t.float().numpy() for t in tin]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,N", [(64, 64), (40, 16)])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 130, 200])
def test_mamba2_scan_chunked_ref_matches_plain_and_jax(T, P, N, dtype):
    """From a nonzero h0, across chunk edges and a ragged last chunk, at
    zamba2's P = N = 64 and a ragged P and N: with the kernel's bf16 terms
    and with exact float32 operands."""
    tin, nin = _chunked_inputs(T, P, N, dtype, 10 * T + N)
    jy, jh = _jax_mamba2_scan(*nin)
    wy, wh = ref.mamba2_scan_ref(*tin)
    for terms in (KERNEL_TERMS, 0):
        y, h = ref.mamba2_scan_chunked_ref(*tin, bf16_terms=terms)
        assert y.shape == (2, T, 3, P) and h.shape == (2, 3, P, N)
        for got, want in ((y, wy), (h, wh), (y, jy), (h, jh)):
            _scan_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [70, 200])
def test_mamba2_scan_chunked_ref_segment_sums_are_direct(T, dtype):
    """The SSD "segsum" trap: a step of dt A = -1000 early in each chunk,
    small steps after it.  The segment sums past it reach -1e3, where a
    difference of two running sums loses ~1e3 * 2^-24 of an exponent (a
    copy of the plain version that takes such differences fails this
    test); the direct sums hold it."""
    tin, nin = _chunked_inputs(T, 64, 64, dtype, T, reset=True)
    jy, jh = _jax_mamba2_scan(*nin)
    wy, wh = ref.mamba2_scan_ref(*tin)
    y, h = ref.mamba2_scan_chunked_ref(*tin, bf16_terms=KERNEL_TERMS)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    for got, want in ((y, wy), (h, wh), (y, jy), (h, jh)):
        _scan_close(got, want)


def test_mamba2_scan_chunked_ref_needs_three_bf16_terms():
    """At zamba2's widths (P = N = 64) over 1100 steps, a float32 operand
    as two bf16 terms (a truncation and a rounding, ~15 bits) misses the
    scans' tolerance; as three (~22 bits), as the kernel splits it, it
    holds."""
    tin, _ = _chunked_inputs(1100, 64, 64, "bfloat16", 3)
    wy, wh = ref.mamba2_scan_ref(*tin)
    y, h = ref.mamba2_scan_chunked_ref(*tin, bf16_terms=KERNEL_TERMS)
    _scan_close(y, wy)
    _scan_close(h, wh)
    y2, _ = ref.mamba2_scan_chunked_ref(*tin, bf16_terms=2)
    within = (y2 - wy).abs() <= SCAN_TOL["atol"] + SCAN_TOL["rtol"] * wy.abs()
    assert not bool(within.all())


def _wrapper_inputs(B=2, T=3, H=4, P=8, N=4):
    proj = torch.zeros(B, T, 3 + 2 * N)
    return [torch.zeros(B, T, H), torch.zeros(B, T, H * P).view(B, T, H, P),
            proj[..., 3:3 + N], proj[..., 3 + N:], torch.zeros(H),
            torch.zeros(B, H, P, N)]


@pytest.mark.parametrize("bad,err", [
    ("dt_dtype", TypeError), ("mixed_dtypes", TypeError),
    ("half", TypeError), ("last_stride", ValueError),
    ("A_shape", ValueError), ("h0_shape", ValueError),
    ("h0_strides", ValueError), ("state", ValueError),
    ("x_rank", ValueError), ("empty", ValueError)])
def test_mamba2_scan_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    dt, x, b, c, A, h0 = _wrapper_inputs()
    B, T, H, P = x.shape
    N = b.shape[2]
    if bad == "dt_dtype":
        dt = dt.bfloat16()
    elif bad == "mixed_dtypes":
        x = x.bfloat16()
    elif bad == "half":
        x, b, c = x.half(), b.half(), c.half()
    elif bad == "last_stride":
        x = torch.zeros(B, T, H, 2 * P)[..., ::2]
    elif bad == "A_shape":
        A = torch.zeros(H, 1)
    elif bad == "h0_shape":
        h0 = torch.zeros(B, H, N, P)
    elif bad == "h0_strides":
        h0 = torch.zeros(B, H, N, P).transpose(2, 3)
    elif bad == "state":
        b = c = torch.zeros(B, T, ms.MAX_STATE + 1)
        h0 = torch.zeros(B, H, P, ms.MAX_STATE + 1)
    elif bad == "x_rank":
        x = x.reshape(B, T, H * P)
    elif bad == "empty":
        dt, x = dt[:, :0], x[:, :0]
        b, c = b[:, :0], c[:, :0]
    with pytest.raises(err):
        ms._check_mamba2(dt, x, b, c, A, h0)
    # the model's operands pass: b and c slices of one projection, x a view
    # of the conv output
    ms._check_mamba2(*_wrapper_inputs())


def test_mamba2_scan_wrapper_never_falls_back_off_the_cpu():
    args = [t.to("meta") for t in _wrapper_inputs()]
    before = ms.mamba2_scan.launches
    with pytest.raises(ValueError):
        ms.mamba2_scan(*args)
    assert ms.mamba2_scan.launches == before


# ---- the block and the model -------------------------------------------------

@pytest.mark.parametrize("T", [5, 130])
def test_mamba2_block_matches_jax(pair, T):
    jcfg, tcfg = _cfgs()
    jmix, tmix = _mixer(pair)
    rng = np.random.default_rng(T + 1)
    x = rng.normal(size=(2, T, tcfg.d_model)).astype(np.float32)
    jy, (jconv, jh) = jssm.mamba2_block(jmix, jnp.asarray(x), jcfg)
    ty, (tconv, th) = tssm.mamba2_block(tmix, torch.from_numpy(x), tcfg)
    H = tcfg.d_inner // tcfg.ssm_head_dim
    assert th.dtype == torch.float32 and th.shape == (
        2, H, tcfg.ssm_head_dim, tcfg.ssm_state)
    _close(ty, jy)
    _close(tconv, jconv, 0)
    _close(th, jh)


def test_mamba2_block_state_carries(pair):
    """A sequence run as two calls with the state carried from the first
    into the second equals JAX doing the same, and the single call."""
    jcfg, tcfg = _cfgs()
    jmix, tmix = _mixer(pair, layer=1)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 150, tcfg.d_model)).astype(np.float32)
    a, b = x[:, :70], x[:, 70:]
    jy1, jst = jssm.mamba2_block(jmix, jnp.asarray(a), jcfg)
    jy2, (jconv, jh) = jssm.mamba2_block(jmix, jnp.asarray(b), jcfg,
                                         state=jst)
    ty1, tst = tssm.mamba2_block(tmix, torch.from_numpy(a), tcfg)
    ty2, (tconv, th) = tssm.mamba2_block(tmix, torch.from_numpy(b), tcfg,
                                         state=tst)
    _close(ty1, jy1)
    _close(ty2, jy2)
    _close(th, jh)
    _close(tconv, jconv, 0)
    ty, (_, th_once) = tssm.mamba2_block(tmix, torch.from_numpy(x), tcfg)
    _close(torch.cat([ty1, ty2], dim=1), ty.numpy(), 1e-5)
    _close(th, th_once.numpy(), 1e-5)


@pytest.mark.parametrize("T", [12, 130])
def test_forward_matches_jax(pair, T):
    jm, jp, tm, tp = pair
    toks = _tokens(tm.cfg, T=T)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, T, tm.cfg.vocab_size)
    _close(got, want)


def test_prefill_and_decode_match_jax(pair):
    """Every cache leaf after prefill and after three decode steps: the
    conv and SSM state of each layer, and the K/V row of each application
    of a shared block (n_layers // attn_every = 2 rows)."""
    jm, jp, tm, tp = pair
    toks = _tokens(tm.cfg, T=9, seed=1)
    jl, jc = jm.prefill(jp, jm.init_cache(2, 16), jnp.asarray(toks))
    tc0 = tm.init_cache(2, 16)
    assert set(tc0) == set(jc)
    for k in ("conv", "h", "k", "v"):
        assert tuple(tc0[k].shape) == tuple(jc[k].shape), k
    assert tc0["h"].dtype == torch.float32 and tc0["k"].shape[0] == 2
    tl, tc = tm.prefill(tp, tc0, torch.from_numpy(toks).long())
    _close(tl, jl)
    for k in ("conv", "h", "k", "v"):
        _close(tc[k], jc[k])
    assert tc["pos"] == int(jc["pos"]) == 9
    nxt = _tokens(tm.cfg, T=1, seed=2)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt).long())
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
            np.int32)
    for k in ("conv", "h", "k", "v"):
        _close(tc[k], jc[k])
    assert tc["pos"] == int(jc["pos"]) == 12


def test_decode_matches_forward():
    """Token-by-token decode from an empty cache == forward, in the port's
    own bf16 model (the reference's test_decode_matches_forward at 2e-2)."""
    cfg = treg.get(ARCH).reduced()
    m = tmodel.build(cfg, "cpu")
    params = m.init(torch.Generator().manual_seed(1))
    T = 8
    toks = torch.from_numpy(_tokens(cfg, B=1, T=T, seed=3)).long()
    with torch.no_grad():
        full = m.forward(params, {"tokens": toks})
    cache = m.init_cache(1, T)
    for t in range(T):
        logits, cache = m.decode_step(params, cache, toks[:, t:t + 1])
        np.testing.assert_allclose(logits[0, 0].float().numpy(),
                                   full[0, t].float().numpy(),
                                   rtol=2e-2, atol=2e-2)


# the port's bf16 forward's relative L2 from the float32 forward, over the
# reference's bf16 forward's, is at most 1.1448 over these seeds (seed 5;
# 0.78-1.14, CPU); the port-vs-reference bf16 relative L2 is 0.023-0.045
BF16_RATIO = 1.15


@pytest.mark.parametrize("seed", range(8))
def test_bf16_forward_matches_jax(seed):
    """The config's own bf16, through converted parameters.  The
    reference's own bf16 forward of this model is 3-6% (relative L2) off
    its float32 forward on the same parameters: bf16 rounding alone moves
    it that far, so two bf16 implementations that round at different
    places (XLA keeps excess precision inside a fusion) cannot be held to
    each other at ``test_torch_ssm.py``'s 3e-2.  The port's bf16 forward is
    held instead to be no farther from that float32 forward than
    ``BF16_RATIO`` times the reference's bf16 forward is, and to the
    max-abs limit of ``test_torch_ssm.py`` (0.1 of the logits' scale)
    against the reference's bf16 forward.  The float32 tests above hold
    the algorithm at 2e-4."""
    jcfg, tcfg = jreg.get(ARCH).reduced(), treg.get(ARCH).reduced()
    jm, tm = jmodel.build(jcfg), tmodel.build(tcfg, "cpu")
    jp = jm.init(jax.random.key(seed))
    tp = convert.params_from_numpy(_np_tree(jp), tcfg, "cpu")
    j32 = jmodel.build(dataclasses.replace(jcfg, dtype="float32"))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    toks = _tokens(tcfg, seed=6)
    want = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(toks)}),
                      np.float32)
    exact = np.asarray(j32.forward(jp32, {"tokens": jnp.asarray(toks)}),
                       np.float32)
    with torch.no_grad():
        got = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    got = got.float().numpy()

    def rel(a):
        return np.linalg.norm(a - exact) / np.linalg.norm(exact)
    assert rel(got) <= BF16_RATIO * rel(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.1 * max(np.abs(want).max(), 1.0))


def test_ssm_family_with_mamba2_matches_jax():
    """An ``ssm`` model with ``mamba_version=2`` (no shared attention):
    forward, prefill and decode against the reference."""
    jm, jp, tm, tp = _pair(arch="falcon-mamba-7b", mamba_version=2)
    assert "shared_attn" not in tp
    toks = _tokens(tm.cfg, T=70, seed=8)
    _close(tm.forward(tp, {"tokens": torch.from_numpy(toks).long()}),
           jm.forward(jp, {"tokens": jnp.asarray(toks)}))
    jl, jc = jm.prefill(jp, jm.init_cache(2, 80), jnp.asarray(toks[:, :60]))
    tl, tc = tm.prefill(tp, tm.init_cache(2, 80),
                        torch.from_numpy(toks[:, :60]).long())
    assert set(tc) == set(jc)
    _close(tl, jl)
    for t in range(60, 63):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(
            toks[:, t:t + 1]).long())
        _close(tl, jl)
    _close(tc["h"], jc["h"])
    _close(tc["conv"], jc["conv"])


def test_greedy_generate_matches_jax_engine():
    """Left-padded prompts, unmasked pads run through the state, as the
    reference: the same greedy tokens as the JAX engine."""
    jm, jp, tm, tp = _pair(seed=2)
    kw = dict(max_batch=4, max_len=96)
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(2, tm.cfg.vocab_size, size=n)))
               for n in (3, 7, 5, 9)]
    want = JEngine(jm, jp, JServeConfig(**kw)).generate(prompts, max_new=8)
    engine = Engine(tm, tp, ServeConfig(**kw))
    assert engine.generate(prompts, max_new=8) == want
    assert engine.timing["decode_steps"] == 8


def test_launcher_smoke_on_cpu_serves_zamba2():
    outs = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--max-new", "4"])
    assert len(outs) == 4
    assert all(0 <= t < 256 for o in outs for t in o)


def test_training_the_hybrid_still_refused():
    """The hybrid builds, serves and, since the Mamba-2 scan has its
    backward, trains: ``make_train_step`` accepts it and a step gives a
    finite loss and moves every parameter leaf (its parity with the
    reference is ``tests/test_torch_hybrid_train.py``)."""
    m = tmodel.build(treg.get(ARCH).reduced(), "cpu")
    opt = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    state = ts.make_train_state(m, opt, torch.Generator().manual_seed(0))
    before = [p.clone() for p in jax.tree.leaves(state["params"])]
    tokens = np.random.default_rng(0).integers(0, m.cfg.vocab_size, (2, 16))
    state, metrics = ts.make_train_step(m, opt)(state, {"tokens": tokens})
    assert np.isfinite(float(metrics["loss"]))
    moved = [not torch.equal(a, b)
             for a, b in zip(before, jax.tree.leaves(state["params"]))]
    assert all(moved)


def test_build_refuses_a_ragged_hybrid():
    cfg = dataclasses.replace(treg.get(ARCH).reduced(), n_layers=5)
    with pytest.raises(ValueError, match="attn_every"):
        tmodel.build(cfg, "cpu")


# ---- flash at head_dim 80 ------------------------------------------------------

def test_flash_takes_head_dim_80_forward_only():
    """zamba2's shared attention: the forward kernel takes head_dim 80 (and
    a slice of the (B, max_len, K, 80) cache), and so does the backward
    now, in both dtypes; a head_dim neither kernel has (96) is refused by
    both."""
    B, T, H, D = 2, 9, 4, 80
    cache = torch.zeros(B, 32, H, D, dtype=torch.bfloat16)
    q = torch.zeros(B, T, H, D, dtype=torch.bfloat16)
    fa._check(q, cache[:, :T], cache[:, :T], 0, 0.0)
    fa._check(q.float(), cache[:, :T].float(), cache[:, :T].float(), 0, 0.0)
    lse = torch.zeros(B, H, T)
    fa._check_bwd(q, q, q, lse, q, True)
    fa._check_bwd(q.float(), q.float(), q.float(), lse, q.float(), True)
    assert 80 in fa.BWD_HEAD_DIMS
    q96 = torch.zeros(B, T, H, 96)
    with pytest.raises(ValueError, match="head_dim 96"):
        fa._check(q96, q96, q96, 0, 0.0)
    with pytest.raises(ValueError, match="head_dim 96"):
        fa._check_bwd(q96, q96, q96, lse, q96, True)


def test_flash_plain_version_at_head_dim_80_matches_model_attention():
    """On the CPU the wrapper's plain version at D = 80 is the model's
    blockwise attention (the reference's ``layers.attention``), as the
    prefill path calls it."""
    from repro_torch.models import layers
    rng = np.random.default_rng(80)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 37, 4, 80)).astype(
        np.float32)) for _ in range(3))
    got = ops.gqa_flash_attention(q, k, v, causal=True)
    want = layers.attention(q, k, v, layers.AttnSpec(4, 4, 80))
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
