"""Port's Mamba-1 (falcon-mamba) against ``repro.models.ssm`` and
``repro.models.model`` on converted parameters.

Reduced falcon-mamba in float32: the JAX parameter tree goes through
``convert.params_from_numpy`` and both packages run the same numpy inputs.
The reference scans with a chunked associative scan (256 steps a chunk),
the port with a sequential recurrence (its kernel's plain version on the
CPU): the two differ by float32 summation order only, held to 2e-4 as the
dense parity tests.  T=300 crosses the reference's chunk boundary.
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

from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm

ARCH = "falcon-mamba-7b"
TOL = 2e-4
F32_LEAVES = ("dt_proj", "dt_bias", "A_log", "D")


def _np_tree(params):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jreg.get(ARCH).reduced(), dtype=dtype),
            dataclasses.replace(treg.get(ARCH).reduced(), dtype=dtype))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    jm = jmodel.build(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = tmodel.build(tcfg, "cpu")
    tp = convert.params_from_numpy(_np_tree(jp), tcfg, "cpu")
    return jm, jp, tm, tp


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _tokens(cfg, B=2, T=12, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def _mixer(pair):
    """Layer 0's mixer parameters of both packages."""
    _, jp, _, tp = pair
    jmix = jax.tree.map(lambda a: a[0], jp["blocks"]["mixer"])
    tmix = {k: v[0] for k, v in tp["blocks"]["mixer"].items()}
    return jmix, tmix


def test_config_copy_matches_reference():
    assert dataclasses.asdict(treg.get(ARCH)) == dataclasses.asdict(
        jreg.get(ARCH))
    assert dataclasses.asdict(treg.get(ARCH).reduced()) == dataclasses.asdict(
        jreg.get(ARCH).reduced())
    cfg = treg.get(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_state,
            cfg.vocab_size) == (64, 4096, 8192, 16, 65_024)


def test_init_shapes_dtypes_std():
    jcfg, tcfg = jreg.get(ARCH).reduced(), treg.get(ARCH).reduced()
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
        # zero-init norms and biases stay zero; A_log is the same constant;
        # random leaves share their scale
        assert (sj == 0 and st == 0) or abs(st - sj) < 0.15 * sj, (k, sj, st)
    # A_log = log(1..n): within one float32 ulp (two log implementations)
    np.testing.assert_allclose(
        tp["blocks"]["mixer"]["A_log"].numpy(),
        np.asarray(jp["blocks"]["mixer"]["A_log"]), rtol=2 ** -23, atol=0)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    rng = np.random.default_rng(7)
    B, T, K, D = 2, 9, 4, 16
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    w = rng.normal(size=(K, D)).astype(np.float32)
    b = rng.normal(size=(D,)).astype(np.float32)
    st = rng.normal(size=(B, K - 1, D)).astype(np.float32) if with_state \
        else None
    jo, jst = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b),
                                 None if st is None else jnp.asarray(st))
    to, tst = tssm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b),
                                 None if st is None else torch.from_numpy(st))
    _close(to, jo, 1e-6)
    _close(tst, jst, 0)
    # T=1 against the state: the decode step
    jo1, jst1 = jssm.causal_conv1d(jnp.asarray(x[:, :1]), jnp.asarray(w),
                                   jnp.asarray(b), jst)
    to1, tst1 = tssm.causal_conv1d(torch.from_numpy(x[:, :1]),
                                   torch.from_numpy(w), torch.from_numpy(b),
                                   tst)
    _close(to1, jo1, 1e-6)
    _close(tst1, jst1, 0)


@pytest.mark.parametrize("T", [7, 300])
def test_chunked_selective_scan_matches_jax(T):
    rng = np.random.default_rng(T)
    B, D, N = 2, 6, 4
    decay = rng.uniform(0.5, 1.0, (B, T, D, N)).astype(np.float32)
    inp = (rng.normal(size=(B, T, D, N)) * 0.1).astype(np.float32)
    h0 = rng.normal(size=(B, D, N)).astype(np.float32)
    jh, jlast = jssm.chunked_selective_scan(jnp.asarray(decay),
                                            jnp.asarray(inp), jnp.asarray(h0))
    th, tlast = tssm.chunked_selective_scan(torch.from_numpy(decay),
                                            torch.from_numpy(inp),
                                            torch.from_numpy(h0))
    _close(th, jh, 1e-5)
    _close(tlast, jlast, 1e-5)


@pytest.mark.parametrize("T", [5, 300])
def test_mamba1_block_matches_jax(pair, T):
    jcfg, tcfg = _cfgs()
    jmix, tmix = _mixer(pair)
    rng = np.random.default_rng(T + 1)
    x = rng.normal(size=(2, T, tcfg.d_model)).astype(np.float32)
    jy, (jconv, jh) = jssm.mamba1_block(jmix, jnp.asarray(x), jcfg)
    ty, (tconv, th) = tssm.mamba1_block(tmix, torch.from_numpy(x), tcfg)
    assert th.dtype == torch.float32 and th.shape == (2, tcfg.d_inner,
                                                      tcfg.ssm_state)
    _close(ty, jy)
    _close(tconv, jconv, 0)
    _close(th, jh)


def test_mamba1_block_state_carries(pair):
    """A sequence run as two calls with the state carried from the first
    into the second equals JAX doing the same, and the single call."""
    jcfg, tcfg = _cfgs()
    jmix, tmix = _mixer(pair)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 270, tcfg.d_model)).astype(np.float32)
    a, b = x[:, :200], x[:, 200:]
    jy1, jst = jssm.mamba1_block(jmix, jnp.asarray(a), jcfg)
    jy2, (jconv, jh) = jssm.mamba1_block(jmix, jnp.asarray(b), jcfg,
                                         state=jst)
    ty1, tst = tssm.mamba1_block(tmix, torch.from_numpy(a), tcfg)
    ty2, (tconv, th) = tssm.mamba1_block(tmix, torch.from_numpy(b), tcfg,
                                         state=tst)
    _close(ty1, jy1)
    _close(ty2, jy2)
    _close(th, jh)
    _close(tconv, jconv, 0)
    ty, (_, th_once) = tssm.mamba1_block(tmix, torch.from_numpy(x), tcfg)
    _close(torch.cat([ty1, ty2], dim=1), ty.numpy(), 1e-5)
    _close(th, th_once.numpy(), 1e-5)


@pytest.mark.parametrize("T", [12, 300])
def test_forward_matches_jax(pair, T):
    jm, jp, tm, tp = pair
    toks = _tokens(tm.cfg, T=T)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, T, tm.cfg.vocab_size)
    _close(got, want)


def test_prefill_and_decode_match_jax(pair):
    jm, jp, tm, tp = pair
    toks = _tokens(tm.cfg, T=9, seed=1)
    jl, jc = jm.prefill(jp, jm.init_cache(2, 16), jnp.asarray(toks))
    tc0 = tm.init_cache(2, 16)
    assert tc0["h"].dtype == torch.float32
    assert tc0["conv"].shape == tuple(jc["conv"].shape)
    tl, tc = tm.prefill(tp, tc0, torch.from_numpy(toks).long())
    _close(tl, jl)
    _close(tc["conv"], jc["conv"])
    _close(tc["h"], jc["h"])
    assert tc["pos"] == int(jc["pos"]) == 9
    nxt = _tokens(tm.cfg, T=1, seed=2)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt).long())
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
            np.int32)
    _close(tc["h"], jc["h"])
    _close(tc["conv"], jc["conv"])
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


def test_convert_keeps_float32_leaves_under_bf16():
    """The model's float32 leaves stay float32 under a bf16 config, exact;
    the others are bf16, as the port's own init makes them."""
    jcfg, tcfg = jreg.get(ARCH).reduced(), treg.get(ARCH).reduced()
    assert tcfg.dtype == "bfloat16"
    jp = jmodel.build(jcfg).init(jax.random.key(4))
    # a decay parameter that bf16 would round
    jp["blocks"]["mixer"]["A_log"] = jp["blocks"]["mixer"]["A_log"] + 1e-3
    tp = convert.params_from_numpy(_np_tree(jp), tcfg, "cpu")
    want = tmodel.build(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    for k, v in tp["blocks"]["mixer"].items():
        assert v.dtype == want["blocks"]["mixer"][k].dtype, k
        assert (v.dtype == torch.float32) == (k in F32_LEAVES), k
        np.testing.assert_array_equal(
            v.float().numpy(), np.asarray(jp["blocks"]["mixer"][k],
                                          np.float32), err_msg=k)
    assert tp["embed"].dtype == tp["unembed"].dtype == torch.bfloat16


def test_bf16_forward_matches_jax():
    """The config's own bf16, through converted parameters: relative L2
    <= 3e-2 and max abs <= 0.1 of the logits' scale.  Wider than the dense
    family's 2e-2 max abs: the two packages round bf16 intermediates at
    different places (XLA keeps excess precision inside a fusion, and its
    logistic differs from torch's silu by up to one bf16 ulp), and the
    recurrence integrates those differences over the sequence (1.1-1.6%
    relative L2 and 1.2-4.5% max abs over five seeds on the CPU).  The
    float32 tests above hold the algorithm at 2e-4."""
    jcfg, tcfg = jreg.get(ARCH).reduced(), treg.get(ARCH).reduced()
    jm, tm = jmodel.build(jcfg), tmodel.build(tcfg, "cpu")
    jp = jm.init(jax.random.key(5))
    tp = convert.params_from_numpy(_np_tree(jp), tcfg, "cpu")
    toks = _tokens(tcfg, seed=6)
    want = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(toks)}),
                      np.float32)
    with torch.no_grad():
        got = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    got = got.float().numpy()
    assert np.linalg.norm(got - want) <= 3e-2 * np.linalg.norm(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.1 * max(np.abs(want).max(), 1.0))


def test_convert_rejects_a_tree_of_another_model(pair):
    _, jp, _, _ = pair
    tree = _np_tree(jp)
    del tree["unembed"]
    with pytest.raises(KeyError, match="unembed"):
        convert.params_from_numpy(tree, _cfgs()[1], "cpu")


def test_mamba2_not_ported():
    """Mamba-2 is ported (``tests/test_torch_hybrid.py`` holds it against
    the reference): the model builds and ``init_mamba_params`` gives the
    reference's Mamba-2 leaves; it trains (the Mamba-2 scan has its
    backward, ``tests/test_torch_hybrid_train.py``), and so does Mamba-1,
    no longer refused (its scan's backward is held in
    ``tests/test_torch_ssm_train.py``)."""
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts
    cfg = dataclasses.replace(treg.get(ARCH).reduced(), mamba_version=2)
    m = tmodel.build(cfg, "cpu")
    p = tssm.init_mamba_params(torch.Generator(), cfg, torch.float32)
    H = cfg.d_inner // cfg.ssm_head_dim
    assert set(p) == {"in_proj", "conv_w", "conv_b", "out_proj", "bc_proj",
                      "dt_bias", "A_log", "D", "dt_proj_h", "norm_w"}
    assert p["A_log"].shape == (H,) and p["dt_proj_h"].shape == (
        cfg.d_model, H)
    step = ts.make_train_step(m, adamw.AdamWConfig())
    state = ts.make_train_state(m, adamw.AdamWConfig(),
                                torch.Generator().manual_seed(0))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    state, metrics = step(state, {"tokens": tokens})
    assert np.isfinite(float(metrics["loss"])) and int(state["step"]) == 1
    m1 = tmodel.build(treg.get(ARCH).reduced(), "cpu")
    state = ts.make_train_state(m1, adamw.AdamWConfig(),
                                torch.Generator().manual_seed(0))
    state, metrics = ts.make_train_step(m1, adamw.AdamWConfig())(
        state, {"tokens": tokens})
    assert np.isfinite(float(metrics["loss"])) and int(state["step"]) == 1
