"""Training the hybrid family (zamba2) and the Mamba-2 form: the port
against the JAX reference.

The Mamba-2 scan's backward, ``ref.mamba2_scan_bwd_ref`` (explicit
formulas, the plain version of ``csrc/mamba_scan.cu``'s
``mamba2_scan_bwd``), is held against autograd of ``ref.mamba2_scan_ref``
and against ``jax.vjp`` of the reference's scan (``fused_ssm_scan`` with
``mamba2_block``'s make_chunk / emit_chunk); the ``repro_torch::mamba2_scan``
op under autograd against it; ``mamba2_block``'s gradient against
``jax.vjp`` of the reference's; and reduced zamba2 in float32 (4 layers,
two groups of 2 Mamba-2 layers and a shared block) in ``train_loss``, every
gradient leaf and a few train steps against ``jax.grad`` of the
reference's ``Model.train_loss`` and its ``train_step``.  Tolerances:
``test_torch_train.py``'s F32_TOL for the scan and the block (sums in
other orders: the port's scan is sequential, the reference's a chunked
associative scan), and ``LEAF_TOL`` for the whole model's leaves.  The
reduced model is compared in float32 only: in bfloat16 each package's
gradients miss its own float32 ones by 30-70% in relative L2 (the two
packages' bf16 gradients are 10-17% apart), so a bf16 comparison would
hold rounding, not the algorithm.  The kernel itself runs only on a card
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
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

ARCH = "zamba2-2.7b"
F32_TOL = dict(rtol=1e-4, atol=1e-5)      # test_torch_train.py's
# the whole model's gradient leaves and train state in float32: an element
# carries the rounding of the terms it sums, which is of the order of its
# leaf's scale, not of the element, and the reduced hybrid's leaves reach
# 6-14 (the embedding); on seed 1's input the reference's own float32
# gradient is up to 1.4e-4 from its float64 one (measured with the
# reference run in float64), above F32_TOL's atol whatever the port does.
# So F32_TOL's rtol, with its atol taken relative to the leaf: 1e-4 of the
# leaf's largest element
LEAF_TOL = dict(rtol=1e-4, atol_of_max=1e-4)


def _np(a):
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- the scan's backward ----------------------------------------------------

# (B, T, H, P, N, reset): T below, at and past the reference's 64-step
# chunk; ``reset`` puts dt A = -1000 (decay underflowing to 0) at step 3
# of every 64
SCAN_CASES = [(2, 9, 3, 5, 4, False), (1, 64, 2, 8, 16, False),
              (2, 130, 3, 4, 8, False), (2, 70, 2, 6, 5, True),
              (1, 1, 2, 3, 4, False)]


def _scan_inputs(B, T, H, P, N, reset, seed):
    """dt from a softplus, A < 0, h0, dy and dh_last nonzero; b and c
    slices of one projection, as the model passes them."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(size=(B, T, H)) - 1)).astype(np.float32)
    x = rng.normal(size=(B, T, H, P)).astype(np.float32)
    proj = rng.normal(size=(B, T, 2 * N + 3)).astype(np.float32)
    A = -np.exp(rng.normal(size=(H,))).astype(np.float32)
    h0 = (rng.normal(size=(B, H, P, N)) * 0.5).astype(np.float32)
    dy = rng.normal(size=(B, T, H, P)).astype(np.float32)
    dh = rng.normal(size=(B, H, P, N)).astype(np.float32)
    if reset:
        dt[:, 3::64] = 1000.0 / -A
        x[:, 3::64] = 0.0
    b, c = proj[..., 3:3 + N], proj[..., 3 + N:]
    return dt, x, b, c, A, h0, dy, dh


def _jax_scan(dt, x, b, c, A, h0):
    """The reference's Mamba-2 scan: ``mamba2_block``'s make_chunk and
    emit_chunk through ``fused_ssm_scan`` at ``CHUNK // 4``, with A an
    argument (so that ``jax.vjp`` differentiates it)."""
    def make_chunk(dt_c, xh_c, b_c, _c_c):
        decay = jnp.exp(dt_c * A)[..., None, None]
        bx = (dt_c[..., None] * xh_c)[..., None] * b_c[:, :, None, None, :]
        return jnp.broadcast_to(decay, bx.shape), bx

    def emit_chunk(h_all, _dt, _xh, _b, c_c):
        return jnp.einsum("bchdn,bcn->bchd", h_all, c_c)

    return jssm.fused_ssm_scan(make_chunk, emit_chunk, (dt, x, b, c), h0,
                               dt.shape[1], jssm.CHUNK // 4)


def _hold(got, want, tol=F32_TOL):
    names = ("ddt", "dx", "db", "dc", "dA", "dh0")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), err_msg=name,
                                   **tol)


@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_bwd_ref_matches_autograd_of_the_forward(case):
    dt, x, b, c, A, h0, dy, dh = map(torch.from_numpy,
                                     _scan_inputs(*case, seed=sum(case)))
    ins = [t.clone().requires_grad_() for t in (dt, x, b, c, A, h0)]
    y, h = ref.mamba2_scan_ref(*ins)
    want = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), ins)
    got = ref.mamba2_scan_bwd_ref(dt, x, b, c, A, h0, dy, dh)
    assert [tuple(g.shape) for g in got] == [tuple(t.shape) for t in ins]
    assert all(g.dtype == torch.float32 for g in got)
    _hold([g.numpy() for g in got], [w.numpy() for w in want])


@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_bwd_ref_matches_jax_vjp_of_the_reference_scan(case):
    dt, x, b, c, A, h0, dy, dh = _scan_inputs(*case, seed=sum(case) + 1)
    _, vjp = jax.vjp(_jax_scan, *map(jnp.asarray, (dt, x, b, c, A, h0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = ref.mamba2_scan_bwd_ref(*map(torch.from_numpy,
                                       (dt, x, b, c, A, h0, dy, dh)))
    _hold([g.numpy() for g in got], [np.asarray(w) for w in want])


def test_scan_bwd_ref_keeps_the_operands_dtypes():
    """dx, db, dc come back in x's, b's and c's dtype (bf16 in training),
    the rest float32: the bf16 gradient is the float32 one, rounded once."""
    dt, x, b, c, A, h0, dy, dh = map(torch.from_numpy,
                                     _scan_inputs(2, 20, 2, 4, 8, False, 5))
    xb, bb, cb = (t.bfloat16() for t in (x, b, c))
    got = ref.mamba2_scan_bwd_ref(dt, xb, bb, cb, A, h0, dy, dh)
    want = ref.mamba2_scan_bwd_ref(dt, xb.float(), bb.float(), cb.float(), A,
                                   h0, dy, dh)
    assert [g.dtype for g in got] == [torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.bfloat16,
                                      torch.float32, torch.float32]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.to(g.dtype), rtol=0, atol=0)


@pytest.mark.parametrize("case", SCAN_CASES[:4])
def test_op_under_autograd_is_the_bwd_ref(case):
    """``repro_torch::mamba2_scan`` under autograd on the CPU: its
    gradients are ``mamba2_scan_bwd_ref``'s, through the
    ``repro_torch::mamba2_scan_bwd`` op; without grad the wrapper makes no
    graph."""
    dt, x, b, c, A, h0, dy, dh = map(torch.from_numpy,
                                     _scan_inputs(*case, seed=sum(case) + 2))
    ins = [t.clone().requires_grad_() for t in (dt, x, b, c, A, h0)]
    y, h = ops.mamba2_scan(*ins)
    assert "mamba2_scan" in type(y.grad_fn).__name__
    got = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), ins)
    want = ref.mamba2_scan_bwd_ref(dt, x, b, c, A, h0, dy, dh)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    wy, wh = ref.mamba2_scan_ref(dt, x, b, c, A, h0)
    torch.testing.assert_close(y.detach(), wy, rtol=0, atol=0)
    with torch.no_grad():
        assert ops.mamba2_scan(*ins)[0].grad_fn is None
    assert ops.mamba2_scan(dt, x, b, c, A, h0)[0].grad_fn is None


def test_op_backward_without_dh_last_takes_zeros():
    """y alone reaching the loss (the model drops h_last): the state's
    output gradient is zeros."""
    dt, x, b, c, A, h0, dy, _ = map(torch.from_numpy,
                                    _scan_inputs(2, 30, 2, 4, 8, False, 6))
    ins = [t.clone().requires_grad_() for t in (dt, x, b, c, A, h0)]
    y, _ = ops.mamba2_scan(*ins)
    got = torch.autograd.grad((y * dy).sum(), ins)
    want = ref.mamba2_scan_bwd_ref(dt, x, b, c, A, h0, dy,
                                   torch.zeros_like(h0))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("B,T,H,P,N,L,R,RB,chunks", [
    (4, 2048, 80, 64, 64, 16, 32, 2, 32),      # zamba2's training shape
    (2, 130, 3, 33, 16, 4, 128, 1, 3), (1, 1, 2, 64, 128, 32, 16, 4, 1),
    (2, 65, 3, 100, 5, 4, 128, 1, 2), (1, 64, 1, 8, 33, 16, 32, 1, 1)])
def test_bwd_plan_mirror(B, T, H, P, N, L, R, RB, chunks):
    """The wrapper's mirror of the CUDA-core backward's plan (float32; the
    chunked form's is held in test_torch_scan_bwd.py; its scratch is what
    the wrapper allocates): the forward's CUDA-core lanes and rows, row blocks
    a head, 64-step chunks, and scratch for a state slot a block and
    (sub-)chunk and the per-(b, t, head, row block) partial sums."""
    plan = ms.mamba2_bwd_plan(B, T, H, P, N, torch.float32)
    assert plan.path == "cudacore"
    assert (plan.lanes, plan.rows, plan.row_blocks, plan.chunks) == (
        L, R, RB, chunks)
    slot = 16 * 128
    assert plan.scratch == (B * H * RB * (chunks + 16) * slot
                            + B * T * H * RB * (2 * N + 2))
    assert plan.smem <= 227 * 1024
    if N <= 64:                          # zamba2's state: three blocks an SM
        assert 3 * (plan.smem + 1024) <= 228 * 1024


def test_scan_bwd_wrapper_never_falls_back_off_the_cpu():
    dt, x, b, c, A, h0, dy, dh = map(torch.from_numpy,
                                     _scan_inputs(1, 5, 2, 4, 8, False, 7))
    meta = [t.to("meta") for t in (dt, x, b, c, A, h0, dy, dh)]
    before = ms.mamba2_scan_bwd.launches
    with pytest.raises(ValueError):
        ms.mamba2_scan_bwd(*meta)               # neither CPU nor CUDA
    assert ms.mamba2_scan_bwd.launches == before


# ---- the block and the model ------------------------------------------------

def _cfgs(dtype="float32", arch=ARCH, **kw):
    return (dataclasses.replace(jreg.get(arch).reduced(), dtype=dtype, **kw),
            dataclasses.replace(treg.get(arch).reduced(), dtype=dtype, **kw))


def _np_tree(t):
    return jax.tree.map(_np, t)


def _randomize(np_tree, seed):
    """A decay a head (A_log 0 at init gives A = -1 everywhere), a gated
    norm that scales, and dt_bias off zero."""
    rng = np.random.default_rng(seed)
    mix = np_tree["blocks"]["mixer"]
    mix["A_log"] = rng.normal(size=mix["A_log"].shape).astype(np.float32)
    if "norm_w" in mix:                 # Mamba-2's gated norm
        mix["norm_w"] = (rng.normal(size=mix["norm_w"].shape) * 0.1).astype(
            mix["norm_w"].dtype)
    mix["dt_bias"] = (rng.normal(size=mix["dt_bias"].shape) * 0.5).astype(
        np.float32)
    return np_tree


def _states(dtype="float32", arch=ARCH, seed=0, **kw):
    """(jax model, jax state, port model, port state), one state carried
    across (float32 parameters randomized as ``_randomize``)."""
    jcfg, tcfg = _cfgs(dtype, arch, **kw)
    opt = dict(lr=1e-2, total_steps=50, warmup_steps=2)
    jopt, topt = jadamw.AdamWConfig(**opt), adamw.AdamWConfig(**opt)
    jm = jmodel.build(jcfg)
    jstate = jts.make_train_state(jm, jopt, jax.random.key(seed))
    np_state = _np_tree(jstate)
    np_state["params"] = _randomize(np_state["params"], seed)
    jstate = jax.tree.map(lambda a, w: jnp.asarray(a).astype(w.dtype),
                          np_state, jstate)
    tm = tmodel.build(tcfg, "cpu")
    tstate = convert.train_state_from_numpy(_np_tree(jstate), tcfg, "cpu")
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


def test_mamba2_block_grad_matches_jax_vjp():
    """Reduced zamba2's Mamba-2 mixer in float32: the gradient of every
    leaf and of the input, for one output cotangent (that of a mean over
    the B x T positions, as ``train_loss``'s), against ``jax.vjp`` of the
    reference's ``mamba2_block``."""
    _, jstate, tm, tstate, _, _ = _states(seed=3)
    cfg = tm.cfg
    jmix = jax.tree.map(lambda a: a[1], jstate["params"]["blocks"]["mixer"])
    tmix = {k: v[1] for k, v in tstate["params"]["blocks"]["mixer"].items()}
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 70, cfg.d_model)).astype(np.float32)
    dy = (rng.normal(size=(2, 70, cfg.d_model)) / (2 * 70)).astype(
        np.float32)
    jcfg = jreg.get(ARCH).reduced()

    def jfn(p, x):
        return jssm.mamba2_block(p, x, jcfg)[0]

    _, vjp = jax.vjp(jfn, jmix, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))
    leaves = {k: v.clone().requires_grad_() for k, v in tmix.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out = tssm.mamba2_block(leaves, xt, cfg)[0]
    names = sorted(leaves)
    got = torch.autograd.grad(out, [leaves[k] for k in names] + [xt],
                              torch.from_numpy(dy))
    for name, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), _np(jgp[name]), err_msg=name,
                                   **F32_TOL)
    np.testing.assert_allclose(got[-1].numpy(), _np(jgx), **F32_TOL)


@pytest.mark.parametrize("seed", [1, 2])
def test_train_loss_and_every_grad_match_jax(seed):
    """Reduced zamba2 in float32: ``train_loss`` and every gradient leaf
    (the Mamba-2 layers', the two shared blocks' and the embeddings')
    against ``jax.value_and_grad`` of the reference's; grads keep the
    params' dtypes."""
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


def _ssm_mamba2_kw():
    return dict(arch="falcon-mamba-7b", mamba_version=2, ssm_head_dim=16)


@pytest.mark.parametrize("model", ["hybrid", "ssm_mamba2", "ssm_mamba1"])
def test_train_steps_match_jax(model):
    """Three train steps from one float32 state on the corpus' batches
    0..2 (two rows of 32 tokens).  Each loss against the reference's
    ``train_step`` at rel 1e-3 (test_torch_train.py's loss tolerance
    against the reference after a step).  The state: the port's step
    against the reference's AdamW fed the port's own gradients at each
    step, params and moments at ``test_apply_updates_one_step_equal``'s
    tolerances with its rtol times ten for the three steps' roundings (the
    gradients themselves are held against ``jax.grad`` above; holding two
    states that each took its own package's gradients would hold Adam's
    lr-sized steps on the near-zero gradients whose sign float32 noise
    decides).
    ``ssm_mamba2`` is the SSM family with Mamba-2 layers (falcon-mamba's
    reduced config, ``mamba_version=2``), each layer under its own
    remat; ``ssm_mamba1`` falcon-mamba's reduced config itself, its
    Mamba-1 layers through the ``repro_torch::selective_scan`` op."""
    kw = {"hybrid": {}, "ssm_mamba2": _ssm_mamba2_kw(),
          "ssm_mamba1": dict(arch="falcon-mamba-7b")}[model]
    jm, jstate, tm, tstate, jopt, topt = _states(seed=2, **kw)
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
    for got, want, tol in (
            (tstate["params"], jp, dict(rtol=1e-5, atol=1e-7)),
            (tstate["opt"]["m"], jopt_state["m"], dict(rtol=1e-5, atol=1e-9)),
            (tstate["opt"]["v"], jopt_state["v"], dict(rtol=1e-5, atol=1e-9))):
        got, want = list(tree.items(got)), jax.tree.leaves(want)
        assert len(got) == len(want)
        for (path, g), w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), _np(w), err_msg=path, **tol)


def test_training_unstacks_the_layers_and_shared_blocks():
    """Under grad the hybrid's stacks are split once (``_unstack``), so
    each stacked leaf's gradient is one stack of its layers' gradients:
    no layer of ``blocks`` nor either ``shared_attn`` block is selected by
    ``a[i]`` (each select would add a zero-filled gradient of the whole
    stack in the backward)."""
    _, _, tm, tstate, _, _ = _states(seed=4)
    params = tstate["params"]
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    loss = tm.train_loss(tree.unflatten(params, leaves),
                         {"tokens": _t(_batch(0)["tokens"])})
    stacked = {id(p) for name in ("blocks", "shared_attn")
               for p in tree.leaves(tree.unflatten(params, leaves)[name])}
    readers: dict[int, list[str]] = {}       # a stacked leaf's consumers
    seen, todo = set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            var = getattr(nxt, "variable", None)
            if var is not None and id(var) in stacked:
                readers.setdefault(id(var), []).append(type(fn).__name__)
            todo.append(nxt)
    assert len(readers) == len(stacked)
    assert all(r == ["UnbindBackward0"] for r in readers.values())


def test_hybrid_remat_policies_give_the_same_grads():
    """"dots" and "full" recompute each group (the scan op included) and
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
    serving path: the same logits as under ``no_grad``."""
    _, _, tm, tstate, _, _ = _states(seed=6)
    batch = {"tokens": _t(_batch(0)["tokens"])}
    with torch.no_grad():
        want = tm.forward(tstate["params"], batch)
    got = tm.forward(tstate["params"], batch)
    assert got.grad_fn is None
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_launcher_smoke_on_cpu_trains_zamba2(tmp_path):
    out = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--steps", "6", "--batch", "2", "--seq", "32",
                        "--lr", "1e-2", "--ckpt-dir", str(tmp_path)])
    losses = [m["loss"] for m in out["metrics"]]
    assert out["final_step"] == 6 and len(losses) == 6
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_mamba1_training_still_refused(tmp_path):
    """falcon-mamba (Mamba-1) is no longer refused: its selective scan has
    a backward, and the launcher trains the reduced model on the CPU with
    a falling loss."""
    m = tmodel.build(treg.get("falcon-mamba-7b").reduced(), "cpu")
    assert callable(ts.make_train_step(m, adamw.AdamWConfig()))
    out = tlaunch.main(["--arch", "falcon-mamba-7b", "--smoke", "--device",
                        "cpu", "--steps", "6", "--batch", "2", "--seq", "32",
                        "--lr", "1e-2", "--ckpt-dir", str(tmp_path)])
    losses = [m["loss"] for m in out["metrics"]]
    assert out["final_step"] == 6 and len(losses) == 6
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
