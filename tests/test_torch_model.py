"""Port's dense model against ``repro.models.model`` on converted parameters.

Reduced granite, glm4, gemma2 and gemma3 in float32: the JAX parameter tree
goes through ``convert.params_from_numpy`` and both packages run the same
tokens.  ``init`` is held by shapes, dtypes and per-leaf std (the two RNGs
differ), decode against forward inside the port at the reference's 2e-2.
The config copies and ``init`` are held for the MoE, VLM and audio archs
too; their forward, cache and gradients are in ``test_torch_moe.py`` and
``test_torch_multimodal.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model as jmodel

from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.models import model as tmodel

ARCHS = ["granite-3-2b", "glm4-9b", "gemma2-9b", "gemma3-1b"]
MOE_ARCHS = ["qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"]
MULTIMODAL_ARCHS = ["llama-3.2-vision-11b", "musicgen-medium"]
TOL = 2e-4


def _np_tree(params):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for arch in ARCHS:
        jcfg = dataclasses.replace(jreg.get(arch).reduced(), dtype="float32")
        tcfg = dataclasses.replace(treg.get(arch).reduced(), dtype="float32")
        jm = jmodel.build(jcfg)
        jp = jm.init(jax.random.key(0))
        tm = tmodel.build(tcfg, "cpu")
        tp = convert.params_from_numpy(_np_tree(jp), tcfg, "cpu")
        out[arch] = (jm, jp, tm, tp)
    return out


def _tokens(cfg, B=2, T=12, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS + MULTIMODAL_ARCHS)
def test_config_copy_matches_reference(arch):
    assert dataclasses.asdict(treg.get(arch)) == dataclasses.asdict(
        jreg.get(arch))
    assert dataclasses.asdict(treg.get(arch).reduced()) == dataclasses.asdict(
        jreg.get(arch).reduced())


@pytest.mark.parametrize("arch", ["zamba2-2.7b"])
def test_other_families_not_ported(arch):
    """Every arch of the reference registry is ported now (zamba2 last),
    and the hybrid's training too: ``make_train_step`` accepts it (its
    parity is ``tests/test_torch_hybrid_train.py``)."""
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts
    assert set(treg.ARCHS) == set(jreg.ARCHS)
    cfg = treg.get(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jreg.get(arch))
    step = ts.make_train_step(tmodel.build(cfg.reduced(), "cpu"),
                              adamw.AdamWConfig())
    assert callable(step)


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS + MULTIMODAL_ARCHS)
def test_init_shapes_dtypes_std(arch):
    jcfg, tcfg = jreg.get(arch).reduced(), treg.get(arch).reduced()
    shapes = jax.eval_shape(jmodel.build(jcfg).init, jax.random.key(0))
    params = tmodel.build(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    flat_j = {jax.tree_util.keystr(p): s for p, s in
              jax.tree_util.tree_flatten_with_path(shapes)[0]}
    flat_t = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}['{k}']")
            else:
                flat_t[f"{prefix}['{k}']"] = v
    walk(params, "")
    assert flat_t.keys() == flat_j.keys()
    jref_params = jmodel.build(jcfg).init(jax.random.key(0))
    flat_jv = {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in
               jax.tree_util.tree_flatten_with_path(jref_params)[0]}
    for k, t in flat_t.items():
        assert tuple(t.shape) == flat_j[k].shape, k
        assert str(t.dtype).split(".")[-1] == str(flat_j[k].dtype), k
        sj, st = flat_jv[k].std(), t.float().std().item()
        # zero-init norms stay zero; random leaves share their scale
        assert (sj == 0 and st == 0) or abs(st - sj) < 0.15 * sj, (k, sj, st)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(pairs, arch):
    jm, jp, tm, tp = pairs[arch]
    toks = _tokens(tm.cfg)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 12, tm.cfg.vocab_size)
    _close(got.detach(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(pairs, arch):
    jm, jp, tm, tp = pairs[arch]
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
    assert tc["pos"] == int(jc["pos"]) == 12


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Token-by-token decode from an empty cache == forward, in the port's
    own bf16 model (the reference's test_decode_matches_forward_dense)."""
    cfg = treg.get(arch).reduced()
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


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_jax(arch):
    """The configs' own bf16, through converted parameters, at 2e-2 of the
    logits' scale."""
    jcfg, tcfg = jreg.get(arch).reduced(), treg.get(arch).reduced()
    jm, tm = jmodel.build(jcfg), tmodel.build(tcfg, "cpu")
    jp = jm.init(jax.random.key(4))
    tp = convert.params_from_numpy(_np_tree(jp), tcfg, "cpu")
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))
    toks = _tokens(tcfg, seed=5)
    want = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(toks)}),
                      np.float32)
    with torch.no_grad():
        got = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * max(scale, 1.0))
