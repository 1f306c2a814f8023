"""Training the Mamba-1 SSM family (falcon-mamba): the port against the JAX
reference.

The selective scan's backward, ``ref.selective_scan_bwd_ref`` (explicit
formulas, the plain version of ``csrc/mamba_scan.cu``'s
``selective_scan_bwd``), is held in float64 at rtol 1e-4 against autograd
of ``ref.selective_scan_ref``, against ``jax.vjp`` of the reference's
Mamba-1 scan (``fused_ssm_scan`` with ``mamba1_block``'s make_chunk /
emit_chunk, under ``jax.enable_x64``) and against autograd of
``ref.mamba_scan_ref`` on the decay and input it builds; the
``repro_torch::selective_scan`` op under autograd against it;
``mamba1_block``'s gradient against ``jax.vjp`` of the reference's; and
reduced falcon-mamba in float32 in ``train_loss``, every gradient leaf and
three train steps with 8-bit AdamW moments and remat "full" (the settings
the full-width model trains with on one card) against ``jax.grad`` of the
reference's ``Model.train_loss`` and its ``train_step``.  Tolerances:
``test_torch_train.py``'s F32_TOL for the block and
``test_torch_hybrid_train.py``'s LEAF_TOL for the whole model's leaves
(sums in other orders: the port's scan is sequential, the reference's a
chunked associative scan).  The kernel itself runs only on a card
(``test_torch_kernels.py``, marked ``cuda``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import pipeline as jpipe
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.optim import adamw as jadamw
from repro.train import train_step as jts

from repro_torch import convert, tree
from repro_torch.configs import registry as treg
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops, ref
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

ARCH = "falcon-mamba-7b"
F64_TOL = dict(rtol=1e-4, atol=1e-9)        # two float64 orders of a sum
F32_TOL = dict(rtol=1e-4, atol=1e-5)        # test_torch_train.py's
# the whole model's leaves: F32_TOL's rtol, its atol relative to the leaf
# (test_torch_hybrid_train.py's LEAF_TOL and its reasons)
LEAF_TOL = dict(rtol=1e-4, atol_of_max=1e-4)


def _np(a):
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- the scan's backward ----------------------------------------------------

# (B, T, D, N, reset): T of one step, below, at and past a 64-step chunk
# and past the reference's 256-step chunk; N of one lane (4) and the
# model's 16; ``reset`` puts dt A <= -1000 (the decay underflowing to 0)
# at step 3 of every 64
SCAN_CASES = ([(2, T, 6, N, False) for T in (1, 63, 64, 65, 300)
               for N in (4, 16)]
              + [(2, 130, 5, 16, True), (1, 70, 3, 4, True)])


def _scan_inputs(B, T, D, N, reset, seed, dtype=np.float64):
    """dt from a softplus, A < 0 a (channel, state), h0, dy and dh_last
    nonzero; b and c slices of one projection, as the model passes them."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(size=(B, T, D)) - 1))
    x = rng.normal(size=(B, T, D))
    proj = rng.normal(size=(B, T, 2 * N + 3)).astype(dtype)
    A = -rng.uniform(0.5, 8.0, (D, N))
    h0 = rng.normal(size=(B, D, N)) * 0.5
    dy = rng.normal(size=(B, T, D))
    dh = rng.normal(size=(B, D, N))
    if reset:
        dt[:, 3::64] = 1000.0 / np.abs(A).min()
        x[:, 3::64] = 0.0
    dt, x, A, h0, dy, dh = (a.astype(dtype) for a in (dt, x, A, h0, dy, dh))
    return dt, x, proj[..., 3:3 + N], proj[..., 3 + N:], A, h0, dy, dh


def _jax_scan(dt, x, b, c, A, h0):
    """The reference's Mamba-1 scan: ``mamba1_block``'s make_chunk and
    emit_chunk through ``fused_ssm_scan`` at its ``CHUNK``, with A an
    argument (so that ``jax.vjp`` differentiates it)."""
    def make_chunk(dt_c, x_c, b_c, _c_c):
        decay = jnp.exp(dt_c[..., None] * A)
        bx = (dt_c * x_c)[..., None] * b_c[..., None, :]
        return decay, bx

    def emit_chunk(h_all, _dt, _x, _b, c_c):
        return jnp.einsum("bcin,bcn->bci", h_all, c_c)

    return jssm.fused_ssm_scan(make_chunk, emit_chunk, (dt, x, b, c), h0,
                               dt.shape[1], jssm.CHUNK)


def _hold(got, want, tol=F64_TOL, names=("ddt", "dx", "db", "dc", "dA",
                                         "dh0")):
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_bwd_ref_matches_autograd_of_the_forward(case):
    dt, x, b, c, A, h0, dy, dh = map(torch.from_numpy,
                                     _scan_inputs(*case, seed=sum(case)))
    ins = [t.clone().requires_grad_() for t in (dt, x, b, c, A, h0)]
    y, h = ref.selective_scan_ref(*ins)
    want = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), ins)
    got = ref.selective_scan_bwd_ref(dt, x, b, c, A, h0, dy, dh)
    assert [tuple(g.shape) for g in got] == [tuple(t.shape) for t in ins]
    assert all(g.dtype == torch.float64 for g in got)
    if case[-1]:
        assert all(bool(torch.isfinite(g).all()) for g in got)
    _hold([g.numpy() for g in got], [w.numpy() for w in want])


@pytest.mark.parametrize("case", SCAN_CASES[::2] + SCAN_CASES[-2:])
def test_scan_bwd_ref_matches_jax_vjp_of_the_reference_scan(case):
    dt, x, b, c, A, h0, dy, dh = _scan_inputs(*case, seed=sum(case) + 1)
    with jax.enable_x64(True):
        _, vjp = jax.vjp(_jax_scan, *map(jnp.asarray, (dt, x, b, c, A, h0)))
        want = [np.asarray(w) for w in vjp((jnp.asarray(dy),
                                           jnp.asarray(dh)))]
    assert all(w.dtype == np.float64 for w in want)
    got = ref.selective_scan_bwd_ref(*map(torch.from_numpy,
                                          (dt, x, b, c, A, h0, dy, dh)))
    _hold([g.numpy() for g in got], want)


@pytest.mark.parametrize("case", [(2, 65, 6, 16, False),
                                  (2, 130, 5, 4, True)])
def test_scan_bwd_ref_is_mamba_scan_refs_gradient_on_built_inputs(case):
    """From h0 = 0 with no state gradient, the fused form's gradient is
    the TPU contract's (``mamba_scan_ref``) through the decay and input
    built from (dt, x, b, A)."""
    dt, x, b, c, A, _, dy, _ = map(torch.from_numpy,
                                   _scan_inputs(*case, seed=sum(case) + 2))
    ins = [t.clone().requires_grad_() for t in (dt, x, b, c, A)]
    dti, xi, bi, ci, Ai = ins
    decay = torch.exp(dti[..., None] * Ai)
    u = (dti * xi)[..., None] * bi[:, :, None, :]
    y = ref.mamba_scan_ref(decay, u, ci)
    assert y.dtype == torch.float64
    want = torch.autograd.grad((y * dy).sum(), ins)
    B, _, D = dt.shape
    zeros = torch.zeros((B, D, b.shape[2]), dtype=torch.float64)
    got = ref.selective_scan_bwd_ref(dt, x, b, c, A, zeros, dy, zeros)
    _hold([g.numpy() for g in got[:5]], [w.numpy() for w in want])


def test_scan_bwd_ref_keeps_the_operands_dtypes():
    """dx, db, dc come back in x's, b's and c's dtype (bf16 in training),
    the rest float32: the bf16 gradient is the float32 one, rounded once."""
    dt, x, b, c, A, h0, dy, dh = map(
        torch.from_numpy, _scan_inputs(2, 20, 6, 16, False, 5, np.float32))
    xb, bb, cb = (t.bfloat16() for t in (x, b, c))
    got = ref.selective_scan_bwd_ref(dt, xb, bb, cb, A, h0, dy, dh)
    want = ref.selective_scan_bwd_ref(dt, xb.float(), bb.float(), cb.float(),
                                      A, h0, dy, dh)
    assert [g.dtype for g in got] == [torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.bfloat16,
                                      torch.float32, torch.float32]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.to(g.dtype), rtol=0, atol=0)


@pytest.mark.parametrize("case", SCAN_CASES[1:6:2] + SCAN_CASES[-2:])
def test_op_under_autograd_is_the_bwd_ref(case):
    """``repro_torch::selective_scan`` under autograd on the CPU: its
    gradients are ``selective_scan_bwd_ref``'s, through the
    ``repro_torch::selective_scan_bwd`` op; without grad the wrapper makes
    no graph."""
    dt, x, b, c, A, h0, dy, dh = map(
        torch.from_numpy, _scan_inputs(*case, seed=sum(case) + 3,
                                       dtype=np.float32))
    ins = [t.clone().requires_grad_() for t in (dt, x, b, c, A, h0)]
    y, h = ops.selective_scan(*ins)
    assert "selective_scan" in type(y.grad_fn).__name__
    got = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), ins)
    want = ref.selective_scan_bwd_ref(dt, x, b, c, A, h0, dy, dh)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    wy, wh = ref.selective_scan_ref(dt, x, b, c, A, h0)
    torch.testing.assert_close(y.detach(), wy, rtol=0, atol=0)
    torch.testing.assert_close(h.detach(), wh, rtol=0, atol=0)
    with torch.no_grad():
        assert ops.selective_scan(*ins)[0].grad_fn is None
    assert ops.selective_scan(dt, x, b, c, A, h0)[0].grad_fn is None


def test_op_backward_without_dh_last_takes_zeros():
    """y alone reaching the loss (the model drops h_last): the state's
    output gradient is zeros."""
    dt, x, b, c, A, h0, dy, _ = map(
        torch.from_numpy, _scan_inputs(2, 30, 6, 16, False, 6, np.float32))
    ins = [t.clone().requires_grad_() for t in (dt, x, b, c, A, h0)]
    y, _ = ops.selective_scan(*ins)
    got = torch.autograd.grad((y * dy).sum(), ins)
    want = ref.selective_scan_bwd_ref(dt, x, b, c, A, h0, dy,
                                      torch.zeros_like(h0))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,N,P,NB,Q,chunks", [
    (4, 2048, 8192, 16, 2, 128, 16, 128),   # falcon-mamba-7b's training
    (2, 65, 203, 4, 1, 2, 8, 9), (1, 1, 40, 128, 16, 5, 8, 1),
    (3, 300, 96, 33, 8, 6, 8, 38), (2, 16, 64, 9, 2, 1, 16, 1)])
def test_bwd_plan_mirror(B, T, D, N, P, NB, Q, chunks, dtype):
    """The wrapper's mirror of the backward's plan (its scratch is what the
    wrapper allocates): 8 states a lane, P = next_pow2(N / 8) lanes a
    channel and 128 / P channels a block; chunks of 16 steps, 8 where a
    two-stage ring of 16 would not let four blocks share an SM's 228 KB
    (1 KB reserved a block).  Shared memory: the ring's stages (a chunk's
    dt, x, dy a channel and b, c over NP = 8 P states as f32, bf16 b and c
    also as loaded), two chunk-entry state slots and one a 4-step
    sub-chunk between a chunk's first and last, a chunk's warp sums of db
    and dc and four barriers; the ring three stages deep where four blocks
    still fit, else two.  Scratch: a state slot a block and chunk, dA's
    partial sums a batch row and db's and dc's a channel block.  No
    operand through TMA without the operands."""
    plan = ms.selective_scan_bwd_plan(B, T, D, N, dtype)
    CH, NP, tile = 128 // P, 8 * P, 8 * 128
    xb = 2 if dtype == torch.bfloat16 else 4
    assert (plan.states, plan.lanes, plan.channels, plan.channel_blocks,
            plan.chunk, plan.chunks) == (8, P, CH, NB, Q, chunks)

    def smem(q, depth):
        stage = q * CH * (4 + xb + 4) + q * NP * 4 * 2
        if xb == 2:
            stage += q * NP * 2 * 2
        assert stage % 128 == 0
        return (128 + depth * stage + 4 * max(q // 4, 2) * tile
                + 4 * q * 4 * 2 * NP + 4 * 8)

    def fits(q, depth):
        return 4 * (smem(q, depth) + 1024) <= 228 * 1024

    assert Q == (16 if fits(16, 2) else 8)
    assert plan.depth == (3 if fits(Q, 3) else 2)
    assert plan.smem == smem(Q, plan.depth)
    assert plan.scratch == (B * NB * chunks * tile + B * D * N
                            + 2 * B * T * NB * N)
    assert plan.tma == (False,) * 5
    assert plan.as_ints() == [8, P, CH, NB, Q, chunks, plan.depth, plan.smem,
                              plan.scratch, 0, 0, 0, 0, 0]
    assert plan.smem <= 227 * 1024
    if N <= 16:                     # the model's state: four blocks an SM
        assert fits(Q, plan.depth)
    if N == 16:                     # falcon's: two stages of 16 steps
        assert (plan.chunk, plan.depth) == (16, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,offset,want", [
    (256, 256, (True,) * 5),            # falcon's layout: every operand
    (203, 256, (False, False, False, True, True)),   # rows of 203
    (256, 7, (True, True, True, False, False)),      # b, c at column 7
    (40, 0, (True, True, True, True, True))])
def test_bwd_plan_tma_choices(D, offset, want, dtype):
    """Which operands the backward's plan loads through TMA: a 16-byte
    aligned base and batch and time strides that are multiples of 16 bytes
    (dt, x, b, c as the model passes them, b and c slices of one
    projection ``offset`` columns in; dy the wrapper's contiguous float32),
    the others by the block's threads."""
    B, T, N = 2, 20, 16
    dt = torch.zeros((B, T, D))
    x = torch.zeros((B, T, D), dtype=dtype)
    proj = torch.zeros((B, T, offset + 2 * N), dtype=dtype)
    b, c = proj[..., offset:offset + N], proj[..., offset + N:]
    dy = torch.zeros((B, T, D))
    plan = ms.selective_scan_bwd_plan(B, T, D, N, dtype, (dt, x, b, c, dy))
    want = tuple(w and (t.data_ptr() % 16 == 0)
                 for w, t in zip(want, (dt, x, dy, b, c)))
    assert plan.tma == want
    assert plan == dataclasses.replace(
        ms.selective_scan_bwd_plan(B, T, D, N, dtype), tma=want)


def test_scan_bwd_wrapper_never_falls_back_off_the_cpu():
    args = map(torch.from_numpy,
               _scan_inputs(1, 5, 4, 8, False, 7, np.float32))
    meta = [t.to("meta") for t in args]
    before = ms.selective_scan_bwd.launches
    with pytest.raises(ValueError):
        ms.selective_scan_bwd(*meta)            # neither CPU nor CUDA
    assert ms.selective_scan_bwd.launches == before


# ---- the block and the model ------------------------------------------------

def _cfgs(dtype="float32", **kw):
    return (dataclasses.replace(jreg.get(ARCH).reduced(), dtype=dtype, **kw),
            dataclasses.replace(treg.get(ARCH).reduced(), dtype=dtype, **kw))


def _randomize(params, seed):
    """Decays that differ a (channel, state), dt_bias off zero and a skip
    weight D that is not 1 (the init's A_log = log(1..n), 0 and 1)."""
    rng = np.random.default_rng(seed)
    mix = params["blocks"]["mixer"]
    for name, scale, shift in (("A_log", 0.5, 0.0), ("dt_bias", 0.5, -1.0),
                               ("D", 0.2, 1.0)):
        mix[name] = (rng.normal(size=mix[name].shape) * scale + shift
                     + (mix[name] if name == "A_log" else 0)
                     ).astype(np.float32)
    return params


def _states(seed=0, state_bits=32, **kw):
    """(jax model, jax state, port model, port state, jax AdamW config,
    port AdamW config), one float32 state carried across."""
    jcfg, tcfg = _cfgs(**kw)
    opt = dict(lr=1e-2, total_steps=50, warmup_steps=2,
               state_bits=state_bits)
    jopt, topt = jadamw.AdamWConfig(**opt), adamw.AdamWConfig(**opt)
    jm = jmodel.build(jcfg)
    jstate = jts.make_train_state(jm, jopt, jax.random.key(seed))
    np_state = jax.tree.map(_np, jstate)
    np_state["params"] = _randomize(np_state["params"], seed)
    jstate = jax.tree.map(lambda a, w: jnp.asarray(a).astype(w.dtype),
                          np_state, jstate)
    tm = tmodel.build(tcfg, "cpu")
    tstate = convert.train_state_from_numpy(jax.tree.map(_np, jstate), tcfg,
                                            "cpu")
    return jm, jstate, tm, tstate, jopt, topt


def _batch(step=0, B=4, T=32, seed=0):
    cfg = jpipe.DataConfig(vocab_size=256, seq_len=T, global_batch=B,
                           seed=seed)
    return jpipe.SyntheticCorpus(cfg).batch_at(step)


def _assert_leaves_close(got, want):
    """Every leaf within ``LEAF_TOL``."""
    got, want = list(tree.items(got)), jax.tree.leaves(want)
    assert len(got) == len(want)
    for (path, g), w in zip(got, want):
        w = _np(w)
        atol = LEAF_TOL["atol_of_max"] * float(np.abs(w).max())
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=path,
                                   rtol=LEAF_TOL["rtol"], atol=atol)


def test_mamba1_block_grad_matches_jax_vjp():
    """Reduced falcon-mamba's Mamba-1 mixer in float32: the gradient of
    every leaf and of the input, for one output cotangent (that of a mean
    over the B x T positions, as ``train_loss``'s), against ``jax.vjp`` of
    the reference's ``mamba1_block``; T = 300 crosses the reference's
    256-step chunk."""
    _, jstate, tm, tstate, _, _ = _states(seed=3)
    cfg = tm.cfg
    jmix = jax.tree.map(lambda a: a[1], jstate["params"]["blocks"]["mixer"])
    tmix = {k: v[1] for k, v in tstate["params"]["blocks"]["mixer"].items()}
    rng = np.random.default_rng(3)
    B, T = 2, 300
    x = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    dy = (rng.normal(size=(B, T, cfg.d_model)) / (B * T)).astype(np.float32)
    jcfg = jreg.get(ARCH).reduced()

    def jfn(p, x):
        return jssm.mamba1_block(p, x, jcfg)[0]

    _, vjp = jax.vjp(jfn, jmix, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))
    leaves = {k: v.clone().requires_grad_() for k, v in tmix.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out = tssm.mamba1_block(leaves, xt, cfg)[0]
    names = sorted(leaves)
    got = torch.autograd.grad(out, [leaves[k] for k in names] + [xt],
                              torch.from_numpy(dy))
    for name, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), _np(jgp[name]), err_msg=name,
                                   **F32_TOL)
    np.testing.assert_allclose(got[-1].numpy(), _np(jgx), **F32_TOL)


@pytest.mark.parametrize("seed", [1, 2])
def test_train_loss_and_every_grad_match_jax(seed):
    """Reduced falcon-mamba in float32: ``train_loss`` and every gradient
    leaf (the Mamba-1 layers' and the embeddings') against
    ``jax.value_and_grad`` of the reference's; grads keep the params'
    dtypes."""
    jm, jstate, tm, tstate, _, _ = _states(seed=seed)
    batch = _batch(1)
    jloss, jgrads = jax.value_and_grad(jm.train_loss)(
        jstate["params"], {"tokens": jnp.asarray(batch["tokens"])})
    tloss, tgrads = ts._loss_and_grads(
        tm, tstate["params"], {"tokens": _t(batch["tokens"])}, 1)
    assert float(tloss) == pytest.approx(float(jloss), rel=F32_TOL["rtol"])
    for (path, g), p in zip(tree.items(tgrads),
                            tree.leaves(tstate["params"])):
        assert g.dtype == p.dtype, path
    _assert_leaves_close(tgrads, jgrads)


def test_train_steps_with_8bit_moments_and_full_remat_match_jax():
    """Three train steps with the settings falcon-mamba-7b trains with on
    one card (8-bit AdamW moments, remat "full"), on the corpus' batches
    0..2 (two rows of 32 tokens): each loss against the reference's
    ``train_step`` with the same settings at rel 1e-3; the state against
    the reference's AdamW fed the port's own gradients at each step:
    params at ``test_apply_updates_one_step_equal``'s tolerance with its
    rtol times ten for the three steps' roundings, the moments' float32
    block scales likewise and their int8 codes equal."""
    jm, jstate, tm, tstate, jopt, topt = _states(seed=2, state_bits=8,
                                                 remat_policy="full")
    assert tm.cfg.remat_policy == "full"
    jstep = jax.jit(jts.make_train_step(jm, jopt))
    tstep = ts.make_train_step(tm, topt)
    jp, jopt_state = jstate["params"], jstate["opt"]
    jl, tl = [], []
    for s in range(3):
        batch = _batch(s, B=2)
        tokens = {"tokens": _t(batch["tokens"])}
        _, grads = ts._loss_and_grads(tm, tstate["params"], tokens, 1)
        jp, jopt_state, _ = jadamw.apply_updates(
            jopt, jp, jax.tree.map(lambda g: jnp.asarray(g.numpy()), grads),
            jopt_state)
        tstate, tmet = tstep(tstate, batch)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"])})
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert int(tstate["step"]) == 3
    got, want = list(tree.items(tstate["params"])), jax.tree.leaves(jp)
    assert len(got) == len(want)
    for (path, g), w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), err_msg=path,
                                   rtol=1e-5, atol=1e-7)
    for name in ("m", "v"):
        got = list(tree.items(tstate["opt"][name]))
        want = jax.tree.leaves(jopt_state[name])
        assert len(got) == len(want)
        for (path, g), w in zip(got, want):
            if g.dtype == torch.int8:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=path)
            else:
                np.testing.assert_allclose(g.numpy(), _np(w), err_msg=path,
                                           rtol=1e-5, atol=1e-9)


def test_remat_policies_give_the_same_grads():
    """"dots" and "full" recompute each layer (the scan op included) and
    give the gradients of "none"."""
    grads = {}
    for policy in ("none", "dots", "full"):
        _, _, tm, tstate, _, _ = _states(seed=5, remat_policy=policy)
        leaves = [p.detach().requires_grad_()
                  for p in tree.leaves(tstate["params"])]
        loss = tm.train_loss(tree.unflatten(tstate["params"], leaves),
                             {"tokens": _t(_batch(2)["tokens"])})
        grads[policy] = torch.autograd.grad(loss, leaves)
    for policy in ("dots", "full"):
        for a, b in zip(grads[policy], grads["none"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-8, err_msg=policy)


def test_serving_paths_unchanged_under_grad_mode():
    """A forward under grad mode with nothing requiring grad takes the
    serving path (the scan's launch, not the op): the same logits as under
    ``no_grad``."""
    _, _, tm, tstate, _, _ = _states(seed=6)
    batch = {"tokens": _t(_batch(0)["tokens"])}
    with torch.no_grad():
        want = tm.forward(tstate["params"], batch)
    got = tm.forward(tstate["params"], batch)
    assert got.grad_fn is None
    torch.testing.assert_close(got, want, rtol=0, atol=0)
