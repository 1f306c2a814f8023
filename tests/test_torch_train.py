"""Port's training path against the JAX reference.

Each test runs the JAX function and its port on the same seeded numpy
inputs (or on one train state carried across by
``convert.train_state_from_numpy``) and states its tolerance: the int8
quantizer, AdamW, the data pipeline, ``train_loss`` and every gradient leaf
against ``jax.grad``, the train step over 8 steps, microbatching, the remat
policies, checkpoints across the two packages, the trainer's fault
tolerance and the launcher.  Reduced granite-3-2b throughout.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import registry as jreg
from repro.core.overlap import compression as jcomp
from repro.data import pipeline as jpipe
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.train import train_step as jts

from repro_torch import convert, tree
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry as treg
from repro_torch.core.overlap import compression
from repro_torch.data import pipeline
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "granite-3-2b"
# float32 gradients: the port's plain attention materializes the scores
# where the reference scans KV blocks, so sums run in other orders
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# bfloat16 gradients: tests/test_train_infra.py's microbatching tolerance
# (bf16 roundings land at other places in the two frameworks)
BF16_TOL = dict(rtol=3e-2, atol=6e-3)


def _np(a):
    """A JAX array as numpy, bfloat16 widened to float32 (exact)."""
    a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
    return a


def _np_tree(t):
    return jax.tree.map(_np, t)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(dtype):
    return (dataclasses.replace(jreg.get(ARCH).reduced(), dtype=dtype),
            dataclasses.replace(treg.get(ARCH).reduced(), dtype=dtype))


def _opt_cfgs(**kw):
    base = dict(lr=1e-2, total_steps=50, warmup_steps=2)
    base.update(kw)
    return jadamw.AdamWConfig(**base), adamw.AdamWConfig(**base)


def _states(dtype, state_bits=32, **opt_kw):
    """(jax model, jax state, port model, port state) from one JAX state."""
    jcfg, tcfg = _cfgs(dtype)
    jopt, topt = _opt_cfgs(state_bits=state_bits, **opt_kw)
    jm = jmodel.build(jcfg)
    jstate = jts.make_train_state(jm, jopt, jax.random.key(0))
    tm = tmodel.build(tcfg, "cpu")
    tstate = convert.train_state_from_numpy(_np_tree(jstate), tcfg, "cpu")
    return jm, jstate, tm, tstate, jopt, topt


def _batch(step=0, B=4, T=32, seed=0):
    cfg = jpipe.DataConfig(vocab_size=256, seq_len=T, global_batch=B,
                           seed=seed)
    return jpipe.SyntheticCorpus(cfg).batch_at(step)


def _assert_tree_close(got, want, tol):
    for (path, g), w in zip(tree.items(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.float().numpy(), _np(w), err_msg=path,
                                   **tol)


# --- int8 quantizer ---------------------------------------------------------

@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4096])
def test_quantize_codes_equal_jax_byte_for_byte(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) * rng.uniform(0.1, 10)).astype(np.float32)
    x[:: 7] = 0.0
    jc, js = jcomp.quantize(jnp.asarray(x))
    tc, tsc = compression.quantize(_t(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(js))
    back = compression.dequantize(tc, tsc, (n,), torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcomp.dequantize(jc, js, (n,), jnp.float32)))


# --- AdamW ------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 140])
def test_schedule_equal(step):
    jcfg, tcfg = _opt_cfgs(lr=1.0, warmup_steps=10, total_steps=100)
    want = float(jadamw.schedule(jcfg, jnp.asarray(step, jnp.int32)))
    got = float(adamw.schedule(tcfg, torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


def _param_tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"b": {"w": rng.normal(size=(3, 40, 24)).astype(dtype)},
            "a": rng.normal(size=(300,)).astype(dtype),
            "c": rng.normal(size=(5, 7)).astype(dtype)}


def test_global_norm_equal():
    g = _param_tree(1)
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, g)))
    got = float(adamw.global_norm(jax.tree.map(_t, g)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("state_bits", [32, 8])
def test_apply_updates_one_step_equal(state_bits):
    """One step from equal params, grads and a state two steps in: equal
    params and moments (float32 to 1 ulp-ish), and, for 8-bit, equal int8
    codes.  The grads' norm stays under the clip, so the clip factor is
    exactly 1 in both."""
    jcfg, tcfg = _opt_cfgs(state_bits=state_bits, weight_decay=0.1)
    p = _param_tree(2)
    grads = [jax.tree.map(lambda a: a * 0.01, _param_tree(s))
             for s in (3, 4, 5)]
    jp = jax.tree.map(jnp.asarray, p)
    jstate = jadamw.init_state(jcfg, jp)
    for g in grads[:2]:            # two reference steps give nonzero moments
        jp, jstate, _ = jadamw.apply_updates(
            jcfg, jp, jax.tree.map(jnp.asarray, g), jstate)
    tp = jax.tree.map(lambda a: _t(np.asarray(a)), jp)
    tstate = jax.tree.map(lambda a: _t(np.asarray(a)), jstate)
    tstate["step"] = tstate["step"].to(torch.int32)
    jp, jstate, jm = jadamw.apply_updates(
        jcfg, jp, jax.tree.map(jnp.asarray, grads[2]), jstate)
    tp, tstate, tm = adamw.apply_updates(tcfg, tp, jax.tree.map(
        _t, grads[2]), tstate)
    assert float(jm["grad_norm"]) < 1.0
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    _assert_tree_close(tp, jp, dict(rtol=1e-6, atol=1e-7))
    for name in ("m", "v"):
        got, want = tree.leaves(tstate[name]), jax.tree.leaves(jstate[name])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            if a.dtype == torch.int8:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-9)


def test_apply_updates_chunks_large_leaves_as_one():
    """A leaf updated in chunks over its leading dim (CHUNK shrunk to force
    it, 8-bit blocks aligned) equals the leaf updated whole."""
    cfg = adamw.AdamWConfig(state_bits=8, warmup_steps=0)
    rng = np.random.default_rng(6)
    p = {"w": torch.from_numpy(rng.normal(size=(4, 16, 32)).astype(
        np.float32))}
    g = {"w": p["w"] * 0.01}
    whole_p = {"w": p["w"].clone()}
    s_whole = adamw.init_state(cfg, whole_p)
    adamw.apply_updates(cfg, whole_p, g, s_whole)
    old = adamw.CHUNK
    adamw.CHUNK = 1024          # two layers of 16 x 32 = 512 elements
    try:
        assert len(list(adamw._chunks(p["w"], 256))) == 2
        chunked_p = {"w": p["w"].clone()}
        s_chunk = adamw.init_state(cfg, chunked_p)
        adamw.apply_updates(cfg, chunked_p, g, s_chunk)
    finally:
        adamw.CHUNK = old
    np.testing.assert_array_equal(chunked_p["w"].numpy(), whole_p["w"].numpy())
    for name in ("m", "v"):
        for a, b in zip(tree.leaves(s_chunk[name]), tree.leaves(s_whole[name])):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


# --- data -------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 2, 3])
def test_batch_at_equal_byte_for_byte(step):
    kw = dict(vocab_size=300, seq_len=24, global_batch=4, seed=7)
    want = jpipe.SyntheticCorpus(jpipe.DataConfig(**kw)).batch_at(step)
    got = pipeline.SyntheticCorpus(pipeline.DataConfig(**kw)).batch_at(step)
    assert got["tokens"].dtype == want["tokens"].dtype
    assert got["tokens"].tobytes() == want["tokens"].tobytes()


def test_prefetch_resumes_at_step():
    c = pipeline.SyntheticCorpus(pipeline.DataConfig(
        vocab_size=100, seq_len=16, global_batch=4))
    it = pipeline.PrefetchIterator(c, start_step=5)
    try:
        step, batch = next(it)
        step2, _ = next(it)
    finally:
        it.close()
    assert (step, step2) == (5, 6)
    np.testing.assert_array_equal(batch["tokens"], c.batch_at(5)["tokens"])


# --- loss and gradients -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loss_and_every_grad_match_jax(dtype):
    jm, jstate, tm, tstate, _, _ = _states(dtype)
    batch = _batch(1)
    jloss, jgrads = jax.value_and_grad(jm.train_loss)(
        jstate["params"], {"tokens": jnp.asarray(batch["tokens"])})
    tloss, tgrads = ts._loss_and_grads(
        tm, tstate["params"], {"tokens": _t(batch["tokens"])}, 1)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert float(tloss) == pytest.approx(float(jloss), rel=tol["rtol"])
    assert tloss.dtype == torch.float32
    for path, g in tree.items(tgrads):   # grads keep the params' dtype
        assert g.dtype == tmodel.torch_dtype(dtype), path
    assert len(tree.leaves(tgrads)) == len(jax.tree.leaves(jgrads))
    _assert_tree_close(tgrads, jgrads, tol)


def test_loss_curve_matches_jax_over_8_steps():
    """Eight train steps from one state on the corpus' batches 0..7, float32
    model: each step's loss against the reference's at 1e-4."""
    jm, jstate, tm, tstate, jopt, topt = _states("float32")
    jstep = jax.jit(jts.make_train_step(jm, jopt))
    tstep = ts.make_train_step(tm, topt)
    jl, tl = [], []
    for s in range(8):
        batch = _batch(s)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"])})
        tstate, tmet = tstep(tstate, batch)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    assert int(tstate["step"]) == int(tstate["opt"]["step"]) == 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_microbatching_equivalent(dtype):
    """Two microbatches against one (the port), tests/test_train_infra.py's
    tolerances; in float32 also against the reference's two microbatches
    (in bfloat16 the two frameworks' gradient roundings flip the sign of
    near-zero gradients, which Adam's first step turns into lr-sized
    parameter differences; the bf16 gradients themselves are held in
    ``test_train_loss_and_every_grad_match_jax``)."""
    jm, jstate, tm, tstate, jopt, topt = _states(dtype)
    batch = _batch(1)
    s1 = ts.make_train_step(tm, topt, ts.TrainSettings(1))
    s2 = ts.make_train_step(tm, topt, ts.TrainSettings(2))
    st1, m1 = s1(jax.tree.map(torch.clone, tstate), batch)
    st2, m2 = s2(jax.tree.map(torch.clone, tstate), batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-3)
    for a, b in zip(tree.leaves(st1["params"]), tree.leaves(st2["params"])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   **BF16_TOL)
    jst2, jm2 = jax.jit(jts.make_train_step(jm, jopt, jts.TrainSettings(2)))(
        jstate, {"tokens": jnp.asarray(batch["tokens"])})
    assert float(m2["loss"]) == pytest.approx(float(jm2["loss"]), rel=1e-3)
    if dtype == "float32":
        _assert_tree_close(st2["params"], jst2["params"], BF16_TOL)


def test_split_microbatches_row_order():
    x = torch.arange(12).reshape(6, 2)
    parts = ts._split_microbatches({"tokens": x}, 3)
    want = np.asarray(jts._split_microbatches(
        {"tokens": jnp.asarray(x.numpy())}, 3)["tokens"])
    for i, p in enumerate(parts):
        np.testing.assert_array_equal(p["tokens"].numpy(), want[i])


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _grads_under(policy, counter=None):
    _, tcfg = _cfgs("float32")
    tm = tmodel.build(dataclasses.replace(tcfg, remat_policy=policy), "cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    batch = {"tokens": _t(_batch(2)["tokens"])}
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    loss = tm.train_loss(tree.unflatten(params, leaves), batch)
    if counter is None:
        return torch.autograd.grad(loss, leaves)
    with counter:
        return torch.autograd.grad(loss, leaves)


def test_grads_equal_under_remat_policies():
    want = _grads_under("none")
    for policy in ("dots", "full"):
        for a, b in zip(_grads_under(policy), want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-8, err_msg=policy)


@pytest.mark.parametrize("policy,flash,mm", [("none", 0, 0),
                                             ("dots", 2, 0),
                                             ("full", 2, 6 * 2)])
def test_remat_policy_recomputes_what_it_should(policy, flash, mm):
    """Ops run in the backward pass of reduced granite (2 layers): "dots"
    recomputes attention (the flash op) but no projection (``aten.mm``);
    "full" recomputes both (6 of the 7 projections a layer: the
    recompute stops after the last tensor the backward needs, and the MLP's
    output projection is not one); "none" neither."""
    counter = _CountOps()
    _grads_under(policy, counter)
    assert counter.counts.get("repro_torch.flash_attn", 0) == flash
    assert counter.counts.get("repro_torch.flash_attn_bwd", 0) == 2
    bwd_only = counter.counts.get("aten.mm", 0) + counter.counts.get(
        "aten.addmm", 0)
    no_remat = _CountOps()
    _grads_under("none", no_remat)
    base = no_remat.counts.get("aten.mm", 0) + no_remat.counts.get(
        "aten.addmm", 0)
    assert bwd_only - base == mm


# --- checkpoints across the two packages --------------------------------------

@pytest.mark.parametrize("state_bits", [32, 8])
def test_jax_checkpoint_restores_in_port(tmp_path, state_bits):
    _, jstate, tm, tstate, _, _ = _states("bfloat16", state_bits)
    JCheckpointer(tmp_path).save(jstate, 7)
    target = jax.tree.map(torch.zeros_like, tstate)
    restored, step = Checkpointer(tmp_path).restore(target)
    assert step == 7
    for (path, got), want in zip(tree.items(restored),
                                 jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      _np(want).astype(np.float32),
                                      err_msg=path)
    for a, b in zip(tree.leaves(restored), tree.leaves(tstate)):
        assert a.dtype == b.dtype and a.shape == b.shape


@pytest.mark.parametrize("state_bits", [32, 8])
def test_port_checkpoint_restores_in_jax(tmp_path, state_bits):
    _, jstate, tm, tstate, _, topt = _states("bfloat16", state_bits)
    tstep = ts.make_train_step(tm, topt)
    tstate, _ = tstep(tstate, _batch(0))          # moments away from zero
    Checkpointer(tmp_path).save(tstate, 3)
    restored, step = JCheckpointer(tmp_path).restore(
        jax.eval_shape(lambda: jstate))
    assert step == 3
    for (path, want), got in zip(tree.items(tstate),
                                 jax.tree.leaves(restored)):
        assert got.shape == tuple(want.shape), path
        np.testing.assert_array_equal(_np(got).astype(np.float32),
                                      want.float().numpy(), err_msg=path)
    assert int(restored["step"]) == 1


def test_checkpoint_rejects_another_structure(tmp_path):
    _, _, _, tstate, _, _ = _states("float32")
    ck = Checkpointer(tmp_path)
    ck.save(tstate, 1)
    with pytest.raises(ValueError):
        ck.restore({"just": torch.zeros(3)})
    (tmp_path / "step_00000009.tmp").mkdir()
    assert ck.latest_step() == 1
    ck.save_async(tstate, 4)
    ck.wait()
    assert ck.latest_step() == 4


@pytest.mark.parametrize("state_bits", [32, 8])
def test_save_async_snapshots_the_state_at_call_time(tmp_path, monkeypatch,
                                                     state_bits):
    """A float32 state (32-bit moments) and one with int8 moment codes:
    every leaf is written in place after ``save_async`` returns and before
    its thread writes, as the next step's update does; the checkpoint holds
    the state as it was at the call."""
    _, _, _, tstate, _, _ = _states("float32", state_bits)
    leaves = tree.leaves(tstate)
    assert {x.dtype for x in leaves} >= ({torch.float32, torch.int8}
                                         if state_bits == 8
                                         else {torch.float32})
    before = [x.clone() for x in leaves]
    ck = Checkpointer(tmp_path)
    go = threading.Event()
    write = ck._write

    def held(*args):
        assert go.wait(30)
        return write(*args)

    monkeypatch.setattr(ck, "_write", held)
    ck.save_async(tstate, 2)
    for x in leaves:
        x.add_(1)                                 # in place, every leaf
    go.set()
    ck.wait()
    restored, step = ck.restore(tstate)
    assert step == 2
    for (path, got), want in zip(tree.items(restored), before):
        assert torch.equal(got, want), path


# --- trainer (tests/test_train_infra.py::TestTrainerFaultTolerance) -----------

@pytest.fixture(scope="module")
def tiny():
    _, tcfg = _cfgs("bfloat16")
    model = tmodel.build(tcfg, "cpu")
    opt = adamw.AdamWConfig(lr=1e-2, total_steps=50, warmup_steps=2)
    step = ts.make_train_step(model, opt)
    data = pipeline.DataConfig(vocab_size=tcfg.vocab_size, seq_len=32,
                               global_batch=4)
    return model, opt, step, data


def _trainer(tiny, tmp_path, fail_hook=None, total=12):
    model, opt, step, data = tiny
    state = ts.make_train_state(model, opt,
                                torch.Generator().manual_seed(1))
    return Trainer(step, state, data, str(tmp_path),
                   TrainerConfig(total_steps=total, checkpoint_every=5,
                                 log_every=4, max_retries=2),
                   fail_hook=fail_hook)


def test_trainer_runs_and_checkpoints(tiny, tmp_path):
    tr = _trainer(tiny, tmp_path)
    out = tr.run()
    assert out["final_step"] == 12
    assert tr.ckpt.latest_step() == 10
    assert [m["step"] for m in out["metrics"]] == [4, 8, 12]
    assert int(tr.state["step"]) == 12


def test_trainer_transient_failure_retried(tiny, tmp_path):
    boom = {"left": 2}

    def hook(step):
        if step == 3 and boom["left"] > 0:
            boom["left"] -= 1
            raise RuntimeError("injected node failure")

    tr = _trainer(tiny, tmp_path, fail_hook=hook)
    out = tr.run()
    assert out["final_step"] == 12
    assert boom["left"] == 0
    assert int(tr.state["step"]) == 12      # no step taken twice


def test_trainer_failure_in_the_backward_leaves_the_state(tiny, tmp_path):
    """A step that fails after the forward (here: in the backward's op)
    writes nothing, so the retry starts from the last good state."""
    model, opt, step, data = tiny
    state = ts.make_train_state(model, opt, torch.Generator().manual_seed(1))
    before = [t.clone() for t in tree.leaves(state)]
    batch = pipeline.SyntheticCorpus(data).batch_at(0)
    bad = dict(batch, tokens=np.full_like(batch["tokens"], 10 ** 6))
    with pytest.raises(IndexError):
        step(state, bad)
    for a, b in zip(tree.leaves(state), before):
        assert torch.equal(a, b)


def test_trainer_permanent_failure_raises(tiny, tmp_path):
    def hook(step):
        if step == 3:
            raise RuntimeError("persistent failure")

    tr = _trainer(tiny, tmp_path, fail_hook=hook)
    with pytest.raises(RuntimeError):
        tr.run()


def test_trainer_does_not_retry_a_partial_update(tiny, tmp_path,
                                                 monkeypatch):
    """AdamW fails at step 3 after it has written two leaves in place: the
    state then mixes steps 3 and 4, so the trainer raises
    ``PartialUpdateError`` instead of retrying the step on it, and reports
    no step past the last whole one."""
    n_leaves = len(tree.leaves(_trainer(tiny, tmp_path / "n").state["params"]))
    chunks = adamw._chunks
    armed = {"calls": None}

    def hook(step):
        if step == 3 and armed["calls"] is None:
            armed["calls"] = 0

    def failing(p, align=1):
        # global_norm takes one call a leaf, then the update one a leaf
        if armed["calls"] is not None:
            armed["calls"] += 1
            if armed["calls"] == n_leaves + 3:
                raise RuntimeError("injected failure inside the update")
        yield from chunks(p, align)

    monkeypatch.setattr(adamw, "_chunks", failing)
    tr = _trainer(tiny, tmp_path, fail_hook=hook)
    with pytest.raises(adamw.PartialUpdateError):
        tr.run()
    assert armed["calls"] == n_leaves + 3       # one attempt, no retry
    assert int(tr.state["step"]) == 3
    assert tr.metrics_log == []                 # step 4 was never logged
    assert tr.ckpt.latest_step() is None


def test_adamw_failure_before_any_write_is_not_partial(tiny, monkeypatch):
    """A failure in the gradient norm, before the first in-place write,
    raises as it is: the state is the last good one and may be retried."""
    model, opt, _, _ = tiny
    state = ts.make_train_state(model, opt, torch.Generator().manual_seed(1))
    before = [t.clone() for t in tree.leaves(state)]
    grads = tree.map_leaves(torch.ones_like, state["params"])

    def norm_fails(_):
        raise RuntimeError("injected failure in the gradient norm")

    monkeypatch.setattr(adamw, "global_norm", norm_fails)
    with pytest.raises(RuntimeError) as err:
        adamw.apply_updates(opt, state["params"], grads, state["opt"])
    assert not isinstance(err.value, adamw.PartialUpdateError)
    for a, b in zip(tree.leaves(state), before):
        assert torch.equal(a, b)


def test_trainer_resumes_from_checkpoint(tiny, tmp_path):
    tr = _trainer(tiny, tmp_path, total=7)
    tr.run()
    assert tr.ckpt.latest_step() == 5
    tr2 = _trainer(tiny, tmp_path, total=7)
    assert tr2.start_step == 5
    assert int(tr2.state["step"]) == 5


# --- launcher ------------------------------------------------------------------

def test_launcher_smoke_on_cpu_loss_falls(tmp_path):
    out = tlaunch.main(["--smoke", "--device", "cpu", "--steps", "10",
                        "--batch", "4", "--seq", "32", "--lr", "1e-2",
                        "--ckpt-dir", str(tmp_path)])
    losses = [m["loss"] for m in out["metrics"]]
    assert out["final_step"] == 10 and len(losses) == 10
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_launcher_default_device_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tlaunch.main(["--smoke", "--ckpt-dir", str(tmp_path)])


def test_train_step_refuses_the_families_without_a_backward():
    """No family lacks a backward any more: falcon-mamba (Mamba-1), the
    last one refused, gets a train step, which takes a step with a finite
    loss and moves every parameter leaf."""
    tcfg = dataclasses.replace(treg.get("falcon-mamba-7b").reduced(),
                               dtype="float32")
    tm = tmodel.build(tcfg, "cpu")
    opt = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    state = ts.make_train_state(tm, opt, torch.Generator().manual_seed(0))
    before = [p.clone() for p in tree.leaves(state["params"])]
    state, metrics = ts.make_train_step(tm, opt)(state, _batch(0, B=2))
    assert np.isfinite(float(metrics["loss"]))
    assert int(state["step"]) == 1
    assert all(not torch.equal(a, b) for a, b in
               zip(before, tree.leaves(state["params"])))


def test_pod_compression_raises_without_a_mesh():
    _, tcfg = _cfgs("float32")
    tm = tmodel.build(tcfg, "cpu")
    with pytest.raises(ValueError, match="pod"):
        ts.make_train_step(tm, adamw.AdamWConfig(),
                           ts.TrainSettings(compress_pod_grads=True))
