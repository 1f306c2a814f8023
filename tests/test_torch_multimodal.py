"""Port's VLM and audio families against the JAX model, on the same seeded
inputs and converted parameters.

Reduced llama-3.2-vision-11b (4 layers: two groups of two self layers and
a gated cross block) and musicgen-medium (2 layers, 8 conditioning frames
prefixed) in float32 at ``test_torch_model.py``'s 2e-4: forward, prefill
and decode with their K/V and media K/V caches and positions; ``train_loss``
and every gradient leaf against ``jax.grad`` at ``test_torch_train.py``'s
tolerances; AdamW steps against the reference's loss curve.  Random media
throughout, and the VLM's cross gates set to nonzero values in the numpy
tree before it goes to both packages (the reference initialises them to 0,
so that at init a cross block adds nothing and a wrong one would not show).
Also ``attn_block`` with ``xkv`` (Tq != Tk), decode against forward inside
the port, ``convert``'s float32 gates, what remat "dots" recomputes, and the
training launcher on the CPU (the serving launcher's and the engine's tests
of these archs are in ``test_torch_serve.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as jreg
from repro.data import pipeline as jpipe
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.train import train_step as jts

from repro_torch import convert, tree
from repro_torch.configs import registry as treg
from repro_torch.launch import train as ttrain_launch
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

ARCHS = ["llama-3.2-vision-11b", "musicgen-medium"]
# test_torch_model.py's tolerance for the model, test_torch_train.py's for
# the gradients
TOL = 2e-4
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=6e-3)
GATES = (0.5, -0.7)         # the reduced VLM's two cross gates


def _np(a):
    """A JAX array as numpy, bfloat16 widened to float32 (exact)."""
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jreg.get(arch).reduced(), dtype=dtype),
            dataclasses.replace(treg.get(arch).reduced(), dtype=dtype))


def _gated(np_tree):
    """The numpy parameter tree with the cross gates set to ``GATES``."""
    if "cross_blocks" in np_tree:
        np_tree["cross_blocks"]["gate"] = np.asarray(GATES, np.float32)
    return np_tree


def _params(jcfg, tcfg, seed=0):
    """(JAX params, port params) from one JAX init, gates set, the JAX
    side's leaves in its config's dtype."""
    jp = jmodel.build(jcfg).init(jax.random.key(seed))
    np_tree = _gated(jax.tree.map(_np, jp))
    jp = jax.tree.map(lambda a, ref: jnp.asarray(a, ref.dtype), np_tree, jp)
    return jp, convert.params_from_numpy(np_tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        jp, tp = _params(jcfg, tcfg)
        out[arch] = (jmodel.build(jcfg), jp, tmodel.build(tcfg, "cpu"), tp)
    return out


def _tokens(cfg, B=2, T=12, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def _media(cfg, B=2, seed=0):
    rng = np.random.default_rng(seed + 100)
    return rng.normal(size=(B, cfg.n_media_tokens, cfg.media_embed_dim)
                      ).astype(np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def _both(toks, media):
    return ({"tokens": jnp.asarray(toks), "media": jnp.asarray(media)},
            {"tokens": torch.from_numpy(toks).long(),
             "media": torch.from_numpy(media)})


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_tree_matches_jax(pairs, arch):
    jm, jp, tm, tp = pairs[arch]
    flat_j = {jax.tree_util.keystr(p): np.shape(a) for p, a in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {"".join(f"['{k}']" for k in path.strip("/").split("/")):
              tuple(a.shape) for path, a in tree.items(tp)}
    assert flat_t == flat_j
    assert "media_proj" in tp
    assert ("cross_blocks" in tp) == (tm.cfg.family == "vlm")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(pairs, arch):
    jm, jp, tm, tp = pairs[arch]
    jb, tb = _both(_tokens(tm.cfg), _media(tm.cfg))
    want = jm.forward(jp, jb)
    with torch.no_grad():
        got = tm.forward(tp, tb)
    # audio: the conditioning frames are stripped before the unembedding
    assert got.shape == (2, 12, tm.cfg.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_depends_on_media(pairs, arch):
    """The media path is live: other media change the logits."""
    _, _, tm, tp = pairs[arch]
    toks = _tokens(tm.cfg)
    with torch.no_grad():
        a = tm.forward(tp, _both(toks, _media(tm.cfg))[1])
        b = tm.forward(tp, _both(toks, _media(tm.cfg, seed=1))[1])
    assert (a - b).abs().max().item() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(pairs, arch):
    """Logits, the K/V cache, the VLM's media K/V and the position (audio:
    the prompt plus its conditioning frames) after prefill and after each
    of three decode steps."""
    jm, jp, tm, tp = pairs[arch]
    cfg = tm.cfg
    toks, media = _tokens(cfg, T=9, seed=1), _media(cfg, seed=1)
    S = 24
    jl, jc = jm.prefill(jp, jm.init_cache(2, S), jnp.asarray(toks),
                        jnp.asarray(media))
    tl, tc = tm.prefill(tp, tm.init_cache(2, S),
                        torch.from_numpy(toks).long(),
                        torch.from_numpy(media))
    _close(tl, jl)
    want_pos = 9 + (cfg.n_media_tokens if cfg.family == "audio" else 0)
    assert tc["pos"] == int(jc["pos"]) == want_pos
    names = ["k", "v"] + (["media_k", "media_v"] if cfg.family == "vlm"
                          else [])
    assert set(tc) == set(jc)
    for name in names:
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name])
    nxt = _tokens(cfg, T=1, seed=2)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.asarray(media))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt).long(),
                                torch.from_numpy(media))
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
            np.int32)
    for name in names:
        _close(tc[name], jc[name])
    assert tc["pos"] == int(jc["pos"]) == want_pos + 3


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(pairs, arch):
    """Token-by-token decode from an empty cache (after the media: the
    VLM's media K/V, audio's frames in the cache) == forward, in the port's
    own float32 model."""
    _, _, tm, tp = pairs[arch]
    cfg = tm.cfg
    T = 8
    toks = torch.from_numpy(_tokens(cfg, B=1, T=T, seed=3)).long()
    media = torch.from_numpy(_media(cfg, B=1, seed=3))
    with torch.no_grad():
        full = tm.forward(tp, {"tokens": toks, "media": media})
        logits, cache = tm.prefill(tp, tm.init_cache(1, T + 16),
                                   toks[:, :1], media)
        steps = [logits[0, 0]]
        for t in range(1, T):
            logits, cache = tm.decode_step(tp, cache, toks[:, t:t + 1])
            steps.append(logits[0, 0])
    torch.testing.assert_close(torch.stack(steps), full[0], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("Tq,Tk", [(5, 11), (11, 5), (1, 16)])
def test_attn_block_xkv_matches_jax(Tq, Tk):
    """Cross-attention: q from x, k and v from xkv, no rope, every query
    over every key; the returned (k, v) are xkv's projections."""
    B, d, H, K, Dh = 2, 32, 4, 2, 16
    jspec = jlayers.AttnSpec(H, K, Dh)
    tspec = tlayers.AttnSpec(H, K, Dh)
    jp = jlayers.init_attn_params(jax.random.key(3), d, jspec, jnp.float32)
    tp = tree.map_leaves(lambda a: torch.from_numpy(np.array(a)),
                         jax.tree.map(_np, jp))
    rng = np.random.default_rng(Tq * 100 + Tk)
    x = rng.normal(size=(B, Tq, d)).astype(np.float32)
    xkv = rng.normal(size=(B, Tk, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Tq), (B, Tq))
    want, (wk, wv) = jlayers.attn_block(
        jp, jnp.asarray(x), jspec, rope_theta=1e4, norm_eps=1e-6,
        positions=jnp.asarray(pos), xkv=jnp.asarray(xkv), use_rope=False)
    got, (gk, gv) = tlayers.attn_block(
        tp, torch.from_numpy(x), tspec, rope_theta=1e4, norm_eps=1e-6,
        positions=torch.from_numpy(pos.copy()), xkv=torch.from_numpy(xkv),
        use_rope=False)
    assert got.shape == (B, Tq, d) and gk.shape == (B, Tk, K, Dh)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


# --- training ---------------------------------------------------------------

def _batch(cfg, step=0, B=4, T=32):
    dcfg = jpipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=T,
                            global_batch=B,
                            n_media_tokens=cfg.n_media_tokens,
                            media_embed_dim=cfg.media_embed_dim)
    return jpipe.SyntheticCorpus(dcfg).batch_at(step)


def _jax_value_and_grad(jcfg, jp, batch):
    return jax.value_and_grad(jmodel.build(jcfg).train_loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_grad_match_jax(arch, dtype):
    """Every leaf, the cross gates and ``media_proj`` included, at
    ``test_torch_train.py``'s tolerance; in bfloat16 the untied input
    embedding is held as ``test_torch_moe.py`` holds it (each framework
    rounds a token's summed position gradients in bf16 in its own order):
    its distance from the float32 gradient within 1.25x the reference's,
    summed over the corpus' batches 1..3.  One batch alone is a single draw
    of that rounding: for musicgen the port's distance is 1.26x, 0.85x and
    1.05x the reference's on batches 1, 2 and 3."""
    jcfg, tcfg = _cfgs(arch, dtype)
    tm = tmodel.build(tcfg, "cpu")
    jp, tp = _params(jcfg, tcfg)
    batch = _batch(tcfg, 1)
    jloss, jgrads = _jax_value_and_grad(jcfg, jp, batch)
    tloss, tgrads = ts._loss_and_grads(
        tm, tp, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
        1)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert float(tloss) == pytest.approx(float(jloss), rel=tol["rtol"])
    assert len(tree.leaves(tgrads)) == len(jax.tree.leaves(jgrads))
    paths = []
    for (path, g), w, p in zip(tree.items(tgrads), jax.tree.leaves(jgrads),
                               tree.leaves(tp)):
        paths.append(path)
        assert g.dtype == p.dtype, path        # grads keep the params' dtype
        assert float(np.abs(_np(w)).max()) > 0, path   # every leaf is live
        if dtype == "bfloat16" and path == "/embed":
            continue
        np.testing.assert_allclose(g.float().numpy(), _np(w), err_msg=path,
                                   **tol)
    assert "/media_proj" in paths
    assert ("/cross_blocks/gate" in paths) == (tcfg.family == "vlm")
    if dtype == "bfloat16":
        f32 = dataclasses.replace(jcfg, dtype="float32")
        jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        port = ref = 0.0
        for step in (1, 2, 3):
            if step > 1:
                batch = _batch(tcfg, step)
                _, jgrads = _jax_value_and_grad(jcfg, jp, batch)
                _, tgrads = ts._loss_and_grads(
                    tm, tp, {k: torch.from_numpy(np.array(v))
                             for k, v in batch.items()}, 1)
            want = _np(_jax_value_and_grad(f32, jp32, batch)[1]["embed"])
            port += _rel_l2(tgrads["embed"].float().numpy(), want)
            ref += _rel_l2(_np(jgrads["embed"]), want)
        assert port <= 1.25 * ref


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_curve_matches_jax(arch):
    """Four AdamW steps from one float32 state (gates set) on the corpus'
    batches 0..3, media included: each step's loss against the reference's
    at 1e-4."""
    jcfg, tcfg = _cfgs(arch)
    jopt = jadamw.AdamWConfig(lr=1e-2, total_steps=50, warmup_steps=2)
    topt = adamw.AdamWConfig(lr=1e-2, total_steps=50, warmup_steps=2)
    jm = jmodel.build(jcfg)
    jstate = jts.make_train_state(jm, jopt, jax.random.key(0))
    np_state = jax.tree.map(_np, jstate)
    _gated(np_state["params"])
    jstate = jax.tree.map(jnp.asarray, np_state)
    tm = tmodel.build(tcfg, "cpu")
    tstate = convert.train_state_from_numpy(np_state, tcfg, "cpu")
    jstep = jax.jit(jts.make_train_step(jm, jopt))
    tstep = ts.make_train_step(tm, topt)
    jl, tl = [], []
    for s in range(4):
        batch = _batch(tcfg, s)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
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


def _backward_ops(arch, policy):
    _, tcfg = _cfgs(arch)
    tm = tmodel.build(dataclasses.replace(tcfg, remat_policy=policy), "cpu")
    _, params = _params(*_cfgs(arch))
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in _batch(tcfg, 2).items()}
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    loss = tm.train_loss(tree.unflatten(params, leaves), batch)
    counter = _CountOps()
    with counter:
        grads = torch.autograd.grad(loss, leaves)
    return counter.counts, grads


@pytest.mark.parametrize("arch,flash", [("llama-3.2-vision-11b", 4 + 2),
                                        ("musicgen-medium", 2)])
def test_remat_dots_recomputes_attention_not_the_projections(arch, flash):
    """Ops of the backward pass: under "dots" each group's attention runs
    again (the VLM: its self layers' and its cross block's flash op), no
    ``aten.mm`` (projections, cross projections, ``media_proj``) does;
    the gradients equal those without remat."""
    dots, g_dots = _backward_ops(arch, "dots")
    none, g_none = _backward_ops(arch, "none")
    assert dots.get("repro_torch.flash_attn", 0) == flash
    assert none.get("repro_torch.flash_attn", 0) == 0
    mm = ("aten.mm", "aten.addmm")
    assert sum(dots.get(k, 0) for k in mm) == sum(none.get(k, 0) for k in mm)
    for a, b in zip(g_dots, g_none):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-8)


def test_convert_keeps_cross_gates_float32_under_bf16():
    jcfg, tcfg = (jreg.get("llama-3.2-vision-11b").reduced(),
                  treg.get("llama-3.2-vision-11b").reduced())
    assert tcfg.dtype == "bfloat16"
    jp, tp = _params(jcfg, tcfg)
    for path, leaf in tree.items(tp):
        want = (torch.float32 if path == "/cross_blocks/gate"
                else torch.bfloat16)
        assert leaf.dtype == want, path
    np.testing.assert_array_equal(tp["cross_blocks"]["gate"].numpy(),
                                  np.asarray(GATES, np.float32))
    init = tmodel.build(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    assert init["cross_blocks"]["gate"].dtype == torch.float32
    assert init["cross_blocks"]["gate"].shape == (2,)


# --- what is accepted -------------------------------------------------------

def test_build_and_train_step_accept_the_vlm_and_audio_families():
    for arch, family in (("llama-3.2-vision-11b", "vlm"),
                         ("musicgen-medium", "audio")):
        m = tmodel.build(treg.get(arch), "cpu")
        assert m.cfg.family == family
        ts.make_train_step(tmodel.build(treg.get(arch).reduced(), "cpu"),
                           adamw.AdamWConfig())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_on_cpu_trains_the_multimodal_archs(arch, tmp_path):
    out = ttrain_launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--steps", "10", "--batch", "4", "--seq", "32",
                              "--lr", "1e-2", "--ckpt-dir", str(tmp_path)])
    losses = [m["loss"] for m in out["metrics"]]
    assert out["final_step"] == 10 and len(losses) == 10
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
