"""Port's MoE layer and MoE family against ``repro.models.moe`` and the JAX
model, on the same seeded inputs and converted parameters.

``moe_block`` without drops, with tight capacity, in the decode case (one
slot an expert) and with a shared expert, over three seeds, at
``tests/test_moe.py``'s tolerance, with the routed experts and the kept
assignments equal to the reference's.  Reduced qwen2-moe-a2.7b and
llama4-maverick-400b-a17b (also at 4 layers, two dense + MoE groups, where
the cache rows are not in run order) in float32 at ``test_torch_model.py``'s
2e-4: forward, prefill and decode with their caches; ``train_loss`` and
every gradient leaf against ``jax.grad`` at ``test_torch_train.py``'s
tolerances; AdamW steps against the reference's loss curve.  Also the plain
loop that ``chip_smoke.py`` holds the card's ``moe_block`` against,
``convert``'s float32 router, what remat "dots" recomputes, and the
training launcher on the CPU (the serving launcher's MoE smoke tests are in
``test_torch_serve.py``).
"""

import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as jreg
from repro.data import pipeline as jpipe
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro.train import train_step as jts

from repro_torch import convert, tree
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import train as ttrain_launch
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

ROOT = pathlib.Path(__file__).resolve().parents[1]
# tests/test_moe.py's tolerance for the layer, test_torch_model.py's for
# the model, test_torch_train.py's for the gradients
MOE_TOL = dict(rtol=2e-4, atol=2e-5)
TOL = 2e-4
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=6e-3)

# moe_block cases: experts, top-k, tokens (B, T), capacity factor, shared
CASES = {
    "no_drops": dict(E=8, k=2, B=2, T=12, cf=100.0, shared=0),
    "tight": dict(E=4, k=2, B=2, T=32, cf=0.25, shared=0),
    "decode": dict(E=8, k=2, B=4, T=1, cf=1.25, shared=0),
    "shared": dict(E=8, k=2, B=1, T=8, cf=100.0, shared=64),
}
# the reduced MoE models; llama4 also at 4 layers: two (dense, MoE) groups
MODELS = {
    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {}),
    "llama4-maverick-400b-a17b": ("llama4-maverick-400b-a17b", {}),
    "llama4-4-layers": ("llama4-maverick-400b-a17b", {"n_layers": 4}),
}


def _np(a):
    """A JAX array as numpy, bfloat16 widened to float32 (exact)."""
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def _np_tree(t):
    return jax.tree.map(_np, t)


def _layer_cfgs(E, k, shared, d=16, f=32):
    """tests/test_moe.py's ``_cfg``, in both packages."""
    kw = dict(n_experts=E, n_experts_active=k, moe_d_ff=f, d_model=d,
              shared_expert_d_ff=shared)
    return (dataclasses.replace(jreg.get("qwen2-moe-a2.7b").reduced(), **kw),
            dataclasses.replace(treg.get("qwen2-moe-a2.7b").reduced(), **kw))


def _layer(case, seed):
    c = CASES[case]
    jcfg, tcfg = _layer_cfgs(c["E"], c["k"], c["shared"])
    jp = jmoe.init_moe_params(jax.random.key(seed), jcfg.d_model, jcfg,
                              jnp.float32)
    tp = tree.map_leaves(lambda a: torch.from_numpy(np.array(a)),
                         _np_tree(jp))
    x = np.random.default_rng(seed).normal(
        size=(c["B"], c["T"], jcfg.d_model)).astype(np.float32)
    return c, jcfg, tcfg, jp, tp, x


def _jax_routing(jp, x, cfg, cf):
    """The reference's expert ids and kept mask (in sorted order), by the
    lines of ``repro.models.moe.moe_block`` that compute them."""
    E, k = cfg.n_experts, cfg.n_experts_active
    N = x.shape[0] * x.shape[1]
    xf = jnp.asarray(x).reshape(N, -1)
    logits = jnp.einsum("nd,de->ne", xf, jp["router"])
    _, experts = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    C = max(1, int(cf * k * N / E))
    se = experts.reshape(-1)[jnp.argsort(experts.reshape(-1))]
    seg_start = jnp.searchsorted(se, jnp.arange(E), side="left")
    keep = (jnp.arange(N * k) - seg_start[se]) < C
    return np.asarray(experts), np.asarray(keep), C


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_block_matches_jax(case, seed):
    c, jcfg, tcfg, jp, tp, x = _layer(case, seed)
    want = jmoe.moe_block(jp, jnp.asarray(x), jcfg, capacity_factor=c["cf"])
    got = tmoe.moe_block(tp, torch.from_numpy(x), tcfg,
                         capacity_factor=c["cf"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)

    want_ex, want_keep, C = _jax_routing(jp, x, jcfg, c["cf"])
    N = c["B"] * c["T"]
    _, ex = tmoe.route(tp, torch.from_numpy(x).reshape(N, -1), c["k"])
    _, keep, _ = tmoe.dispatch(ex, c["E"], C)
    np.testing.assert_array_equal(ex.numpy(), want_ex)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert tmoe.capacity(c["cf"], c["k"], N, c["E"]) == C
    if case == "tight":
        assert not keep.all()                  # the case does drop
    if case == "decode":
        assert C == 1


def test_moe_block_dtypes_and_contiguous_experts():
    """bfloat16 in, bfloat16 out; the router float32; the permuted expert
    weights contiguous, as the grouped product wants them."""
    _, tcfg = _layer_cfgs(8, 2, 64)
    p = tmoe.init_moe_params(torch.Generator().manual_seed(0), 16, tcfg,
                             torch.bfloat16)
    assert p["router"].dtype == torch.float32
    for name, shape in (("wi_gate", (8, 16, 32)), ("wi_up", (8, 16, 32)),
                        ("wo", (8, 32, 16))):
        assert tuple(p[name].shape) == shape and p[name].is_contiguous()
        assert p[name].dtype == torch.bfloat16
    x = torch.randn((2, 5, 16), generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    out = tmoe.moe_block(p, x, tcfg)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert torch.equal(out, tmoe.moe_block(p, x, tcfg))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", ["tight", "decode", "shared"])
def test_chip_smoke_plain_loop_matches_jax(case):
    """``chip_smoke.moe_loop_ref``, the plain float32 loop over experts
    that the card's ``moe_block`` is held against: the reference's output,
    expert ids and kept assignments."""
    c, jcfg, tcfg, jp, tp, x = _layer(case, 3)
    want = jmoe.moe_block(jp, jnp.asarray(x), jcfg, capacity_factor=c["cf"])
    got, ex, keep = _chip_smoke().moe_loop_ref(tp, torch.from_numpy(x), tcfg,
                                               capacity_factor=c["cf"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    want_ex, want_keep, _ = _jax_routing(jp, x, jcfg, c["cf"])
    np.testing.assert_array_equal(ex.numpy(), want_ex)
    order = np.argsort(want_ex.reshape(-1), kind="stable")
    np.testing.assert_array_equal(keep.numpy().reshape(-1)[order], want_keep)


# --- the model -----------------------------------------------------------------

def _cfgs(name, dtype="float32"):
    arch, kw = MODELS[name]
    return (dataclasses.replace(jreg.get(arch).reduced(), dtype=dtype, **kw),
            dataclasses.replace(treg.get(arch).reduced(), dtype=dtype, **kw))


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for name in MODELS:
        jcfg, tcfg = _cfgs(name)
        jm = jmodel.build(jcfg)
        jp = jm.init(jax.random.key(0))
        tm = tmodel.build(tcfg, "cpu")
        out[name] = (jm, jp, tm, convert.params_from_numpy(_np_tree(jp), tcfg,
                                                           "cpu"))
    return out


def _tokens(cfg, B=2, T=12, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(MODELS))
def test_parameter_tree_matches_jax(pairs, name):
    jm, jp, tm, tp = pairs[name]
    flat_j = {jax.tree_util.keystr(p): np.shape(a) for p, a in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {"".join(f"['{k}']" for k in path.strip("/").split("/")):
              tuple(a.shape) for path, a in tree.items(tp)}
    assert flat_t == flat_j
    assert ("moe_blocks" in tp) == (tm.cfg.moe_every > 1)


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax(pairs, name):
    jm, jp, tm, tp = pairs[name]
    toks = _tokens(tm.cfg)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 12, tm.cfg.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_and_decode_match_jax(pairs, name):
    """Logits and K/V caches; decode runs 2 tokens a step, one slot an
    expert (C = 1), so assignments are dropped as in the reference; for
    llama4 the cache holds the dense layers' rows first."""
    jm, jp, tm, tp = pairs[name]
    toks = _tokens(tm.cfg, T=9, seed=1)
    S = 16
    jl, jc = jm.prefill(jp, jm.init_cache(2, S), jnp.asarray(toks))
    tl, tc = tm.prefill(tp, tm.init_cache(2, S), torch.from_numpy(toks).long())
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    assert tc["pos"] == int(jc["pos"]) == 9
    nxt = _tokens(tm.cfg, T=1, seed=2)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt).long())
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
            np.int32)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    assert tc["pos"] == int(jc["pos"]) == 12


def test_interleave_cache_rows_are_dense_layers_first(pairs):
    """llama4 at 4 layers runs dense 0, MoE 0, dense 1, MoE 1; its cache
    rows are dense 0, dense 1, MoE 0, MoE 1 (``_moe_grouped_pass``)."""
    _, _, tm, tp = pairs["llama4-4-layers"]
    groups = tm._layer_groups(tp, grad=False)
    assert [[row for _, _, row in g] for g in groups] == [[0, 2], [1, 3]]
    assert [["moe" in blk for blk, _, _ in g] for g in groups] == [
        [False, True], [False, True]]


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "llama4-4-layers"])
def test_decode_matches_forward_without_drops(name, monkeypatch):
    """With no assignment dropped (the reference tests' capacity factor
    100) token-by-token decode equals the forward; under the default 1.25
    the two are different functions (a decode step has one token a slot,
    the forward many)."""
    _, tcfg = _cfgs(name)
    m = tmodel.build(tcfg, "cpu")
    params = m.init(torch.Generator().manual_seed(1))
    T = 8
    toks = torch.from_numpy(_tokens(tcfg, B=1, T=T, seed=3)).long()

    def run():
        with torch.no_grad():
            full = m.forward(params, {"tokens": toks})
            cache, steps = m.init_cache(1, T), []
            for t in range(T):
                logits, cache = m.decode_step(params, cache, toks[:, t:t + 1])
                steps.append(logits[0, 0])
        return full[0], torch.stack(steps)

    full, steps = run()
    assert not torch.allclose(steps, full, rtol=1e-4, atol=1e-4)
    monkeypatch.setattr(tmoe, "moe_block", functools.partial(
        tmoe.moe_block, capacity_factor=100.0))
    full, steps = run()
    torch.testing.assert_close(steps, full, rtol=1e-4, atol=1e-4)


# --- training ------------------------------------------------------------------

def _batch(step=0, B=4, T=32):
    cfg = jpipe.DataConfig(vocab_size=256, seq_len=T, global_batch=B)
    return jpipe.SyntheticCorpus(cfg).batch_at(step)


def _jax_value_and_grad(jcfg, jp, batch):
    return jax.value_and_grad(jmodel.build(jcfg).train_loss)(
        jp, {"tokens": jnp.asarray(batch["tokens"])})


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b",
                                  "llama4-maverick-400b-a17b"])
def test_train_loss_and_every_grad_match_jax(name, dtype):
    """Every leaf at ``test_torch_train.py``'s tolerance, but for the
    untied input embedding in bfloat16: its gradient sums a token's
    position gradients (token 0 takes 39 of this batch's 128 positions),
    each framework rounds that sum in bf16 in its own order, and the two
    land up to ~0.05 apart at a few elements while each is as far from
    the float32 gradient as the other (~3e-2 relative L2).  That leaf is
    held to the reference's own accuracy: its distance from the float32
    gradient of the same weights within 1.25x the reference's."""
    jcfg, tcfg = _cfgs(name, dtype)
    tm = tmodel.build(tcfg, "cpu")
    jp = jmodel.build(jcfg).init(jax.random.key(0))
    tp = convert.params_from_numpy(_np_tree(jp), tcfg, "cpu")
    batch = _batch(1)
    jloss, jgrads = _jax_value_and_grad(jcfg, jp, batch)
    tloss, tgrads = ts._loss_and_grads(
        tm, tp, {"tokens": torch.from_numpy(np.array(batch["tokens"]))}, 1)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert float(tloss) == pytest.approx(float(jloss), rel=tol["rtol"])
    assert len(tree.leaves(tgrads)) == len(jax.tree.leaves(jgrads))
    for (path, g), w, p in zip(tree.items(tgrads), jax.tree.leaves(jgrads),
                               tree.leaves(tp)):
        assert g.dtype == p.dtype, path        # grads keep the params' dtype
        if dtype == "bfloat16" and path == "/embed":
            continue
        np.testing.assert_allclose(g.float().numpy(), _np(w), err_msg=path,
                                   **tol)
    if dtype == "bfloat16":
        f32 = dataclasses.replace(jcfg, dtype="float32")
        _, exact = _jax_value_and_grad(
            f32, jax.tree.map(lambda a: a.astype(jnp.float32), jp), batch)
        want = _np(exact["embed"])
        port = _rel_l2(tgrads["embed"].float().numpy(), want)
        assert port <= 1.25 * _rel_l2(_np(jgrads["embed"]), want)


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "llama4-4-layers"])
def test_loss_curve_matches_jax(name):
    """Four AdamW steps from one float32 state on the corpus' batches 0..3:
    each step's loss against the reference's at 1e-4."""
    jcfg, tcfg = _cfgs(name)
    jopt = jadamw.AdamWConfig(lr=1e-2, total_steps=50, warmup_steps=2)
    topt = adamw.AdamWConfig(lr=1e-2, total_steps=50, warmup_steps=2)
    jm = jmodel.build(jcfg)
    jstate = jts.make_train_state(jm, jopt, jax.random.key(0))
    tm = tmodel.build(tcfg, "cpu")
    tstate = convert.train_state_from_numpy(_np_tree(jstate), tcfg, "cpu")
    jstep = jax.jit(jts.make_train_step(jm, jopt))
    tstep = ts.make_train_step(tm, topt)
    jl, tl = [], []
    for s in range(4):
        batch = _batch(s)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"])})
        tstate, tmet = tstep(tstate, batch)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert int(tstate["step"]) == 4


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(policy):
    _, tcfg = _cfgs("qwen2-moe-a2.7b")
    tm = tmodel.build(dataclasses.replace(tcfg, remat_policy=policy), "cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    loss = tm.train_loss(tree.unflatten(params, leaves),
                         {"tokens": torch.from_numpy(
                             np.array(_batch(2)["tokens"]))})
    counter = _CountOps()
    with counter:
        grads = torch.autograd.grad(loss, leaves)
    return counter.counts, grads


def test_remat_dots_recomputes_the_grouped_products_not_the_router():
    """Ops of the backward pass of reduced qwen2-moe (2 MoE layers): under
    "dots" each layer's three grouped products (the
    ``repro_torch::grouped_mm`` op) and its attention (the flash op) run
    again, no ``aten.mm`` (projections, router, shared MLP) does; the
    gradients equal those without remat."""
    dots, g_dots = _backward_ops("dots")
    none, g_none = _backward_ops("none")
    gmm = "repro_torch.grouped_mm"
    assert dots.get(gmm, 0) - none.get(gmm, 0) == 3 * 2
    assert dots.get("repro_torch.flash_attn", 0) == 2
    mm = ("aten.mm", "aten.addmm")
    assert sum(dots.get(k, 0) for k in mm) == sum(none.get(k, 0) for k in mm)
    for a, b in zip(g_dots, g_none):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-8)


def test_convert_keeps_router_float32_under_bf16():
    for arch in ("qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"):
        jcfg, tcfg = jreg.get(arch).reduced(), treg.get(arch).reduced()
        jp = jmodel.build(jcfg).init(jax.random.key(0))
        tp = convert.params_from_numpy(_np_tree(jp), tcfg, "cpu")
        stack = "moe_blocks" if tcfg.moe_every > 1 else "blocks"
        for path, leaf in tree.items(tp):
            want = (torch.float32 if path.endswith("/router")
                    else torch.bfloat16)
            assert leaf.dtype == want, path
        np.testing.assert_array_equal(tp[stack]["moe"]["router"].numpy(),
                                      _np(jp[stack]["moe"]["router"]))


# --- what is accepted and what is refused ------------------------------------

def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def test_build_and_train_step_accept_the_moe_family():
    for arch in ("qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"):
        m = tmodel.build(treg.get(arch), "cpu")
        assert m.cfg.family == "moe"
        ts.make_train_step(tmodel.build(treg.get(arch).reduced(), "cpu"),
                           adamw.AdamWConfig())


@pytest.mark.parametrize("arch,item", [("zamba2-2.7b", "7b")])
def test_build_still_refuses_the_other_families(arch, item):
    """``item`` ported the hybrid: it builds now, and its training (item
    5b-i) is accepted too: no family of the reference is refused by
    ``build`` or, apart from Mamba-1, by ``make_train_step``."""
    m = tmodel.build(_port_cfg(jreg.get(arch).reduced()), "cpu")
    assert m.cfg.family == "hybrid"
    assert callable(ts.make_train_step(m, adamw.AdamWConfig()))


def test_build_still_refuses_mamba2():
    """Mamba-2 builds in the SSM family too, and trains: a train step gives
    a finite loss (the steps' parity with the reference is
    ``tests/test_torch_hybrid_train.py``)."""
    cfg = dataclasses.replace(treg.get("falcon-mamba-7b").reduced(),
                              mamba_version=2)
    m = tmodel.build(cfg, "cpu")
    assert "bc_proj" in m.init(torch.Generator().manual_seed(0))[
        "blocks"]["mixer"]
    state = ts.make_train_state(m, adamw.AdamWConfig(),
                                torch.Generator().manual_seed(0))
    tokens = np.random.default_rng(1).integers(0, m.cfg.vocab_size, (2, 16))
    state, metrics = ts.make_train_step(m, adamw.AdamWConfig())(
        state, {"tokens": tokens})
    assert np.isfinite(float(metrics["loss"])) and int(state["step"]) == 1


def test_train_launcher_on_cpu_trains_qwen2_moe(tmp_path):
    out = ttrain_launch.main(["--arch", "qwen2-moe-a2.7b", "--smoke",
                              "--device", "cpu", "--steps", "10", "--batch",
                              "4", "--seq", "32", "--lr", "1e-2",
                              "--ckpt-dir", str(tmp_path)])
    losses = [m["loss"] for m in out["metrics"]]
    assert out["final_step"] == 10 and len(losses) == 10
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
