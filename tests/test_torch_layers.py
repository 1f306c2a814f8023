"""Port's layer primitives against ``repro.models.layers`` on the same inputs.

f32 at the reference tests' 2e-4 (1e-5 for the elementwise ops), bf16 at
2e-2.  Weights are made with numpy and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl

from repro_torch.models import layers as tl

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(a, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    j = jnp.asarray(a, jnp.float32).astype(jdt)
    t = torch.from_numpy(np.asarray(a, np.float32)).to(tdt)
    return j, t


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.normal(size=(2, 5, 64)) * 3, dtype)
    wj, wt = _pair(rng.normal(size=(64,)) * 0.1, dtype)
    tol = 1e-5 if dtype == "float32" else DTYPES[dtype][2]
    _close(tl.rms_norm(xt, wt, 1e-6), jl.rms_norm(xj, wj, 1e-6), tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(dtype, theta):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.normal(size=(2, 7, 3, 16)), dtype)
    pos = rng.integers(0, 500, size=(2, 7))
    tol = 1e-5 if dtype == "float32" else DTYPES[dtype][2]
    _close(tl.rope(xt, torch.from_numpy(pos), theta),
           jl.rope(xj, jnp.asarray(pos), theta), tol * 10)


ATTN_CASES = [
    # Tq, Tk, q_offset, kv_len, window, is_global, softcap, kv_block
    (8, 8, 0, None, 0, True, 0.0, 512),
    (1, 24, 13, 14, 0, True, 0.0, 512),          # decode step
    (3, 40, 20, 23, 0, True, 0.0, 16),           # Tk not a multiple of block
    (1, 40, 30, 31, 8, False, 0.0, 16),          # local layer
    (1, 40, 30, 31, 8, True, 0.0, 16),           # global layer, same spec
    (12, 12, 0, None, 5, False, 50.0, 512),      # window + softcap
    (4, 37, 25, 29, 6, False, 30.0, 8),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("Tq,Tk,q_offset,kv_len,window,is_global,softcap,blk",
                         ATTN_CASES)
def test_attention(Tq, Tk, q_offset, kv_len, window, is_global, softcap, blk,
                   dtype):
    rng = np.random.default_rng(Tq * 100 + Tk)
    B, K, G, D = 2, 2, 2, 16
    qj, qt = _pair(rng.normal(size=(B, Tq, K * G, D)), dtype)
    kj, kt = _pair(rng.normal(size=(B, Tk, K, D)), dtype)
    vj, vt = _pair(rng.normal(size=(B, Tk, K, D)), dtype)
    jspec = jl.AttnSpec(K * G, K, D, window=window, softcap=softcap,
                        kv_block=blk)
    tspec = tl.AttnSpec(K * G, K, D, window=window, softcap=softcap,
                        kv_block=blk)
    want = jl.attention(qj, kj, vj, jspec, q_offset=q_offset,
                        is_global=is_global, kv_len=kv_len)
    got = tl.attention(qt, kt, vt, tspec, q_offset=q_offset,
                       is_global=is_global, kv_len=kv_len)
    _close(got, want, DTYPES[dtype][2])


def _attn_params(rng, d, H, K, Dh, qk_norm):
    p = {"wq": rng.normal(size=(d, H, Dh)) / d ** 0.5,
         "wk": rng.normal(size=(d, K, Dh)) / d ** 0.5,
         "wv": rng.normal(size=(d, K, Dh)) / d ** 0.5,
         "wo": rng.normal(size=(H, Dh, d)) / (H * Dh) ** 0.5}
    if qk_norm:
        p["q_norm"] = rng.normal(size=(Dh,)) * 0.1
        p["k_norm"] = rng.normal(size=(Dh,)) * 0.1
    return p


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["self", "prefill", "decode"])
@pytest.mark.parametrize("qk_norm,window,is_global,softcap", [
    (False, 0, True, 0.0), (True, 4, False, 0.0), (False, 4, True, 50.0)])
def test_attn_block(mode, qk_norm, window, is_global, softcap, dtype):
    rng = np.random.default_rng(5)
    B, d, H, K, Dh, S = 2, 32, 4, 2, 16, 24
    T = 1 if mode == "decode" else 6
    pos = 9 if mode == "decode" else 0
    p = _attn_params(rng, d, H, K, Dh, qk_norm)
    pj = {k: _pair(v, dtype)[0] for k, v in p.items()}
    pt = {k: _pair(v, dtype)[1] for k, v in p.items()}
    xj, xt = _pair(rng.normal(size=(B, T, d)), dtype)
    positions = np.ascontiguousarray(np.broadcast_to(pos + np.arange(T), (B, T)))
    kw = dict(rope_theta=10_000.0, norm_eps=1e-6, is_global=is_global)
    jspec = jl.AttnSpec(H, K, Dh, window=window, softcap=softcap)
    tspec = tl.AttnSpec(H, K, Dh, window=window, softcap=softcap)
    if mode == "self":
        oj, (kj, vj) = jl.attn_block(pj, xj, jspec,
                                     positions=jnp.asarray(positions), **kw)
        ot, (kt, vt) = tl.attn_block(pt, xt, tspec,
                                     positions=torch.from_numpy(positions),
                                     **kw)
    else:
        ck = rng.normal(size=(B, S, K, Dh)) * (mode == "decode")
        cv = rng.normal(size=(B, S, K, Dh)) * (mode == "decode")
        cj = (_pair(ck, dtype)[0], _pair(cv, dtype)[0])
        ct = (_pair(ck, dtype)[1], _pair(cv, dtype)[1])
        oj, (kj, vj) = jl.attn_block(pj, xj, jspec,
                                     positions=jnp.asarray(positions),
                                     kv_cache=cj, cache_len=jnp.int32(pos),
                                     **kw)
        ot, (kt, vt) = tl.attn_block(pt, xt, tspec,
                                     positions=torch.from_numpy(positions),
                                     kv_cache=ct, cache_len=pos, **kw)
    tol = DTYPES[dtype][2]
    _close(ot, oj, tol)
    _close(kt, kj, tol)          # cache written at cache_len, rest untouched
    _close(vt, vj, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_block(act, dtype):
    rng = np.random.default_rng(7)
    d, F = 32, 64
    p = {"wi_gate": rng.normal(size=(d, F)) / d ** 0.5,
         "wi_up": rng.normal(size=(d, F)) / d ** 0.5,
         "wo": rng.normal(size=(F, d)) / F ** 0.5}
    xj, xt = _pair(rng.normal(size=(2, 5, d)), dtype)
    want = jl.mlp_block({k: _pair(v, dtype)[0] for k, v in p.items()}, xj,
                        act)
    got = tl.mlp_block({k: _pair(v, dtype)[1] for k, v in p.items()}, xt, act)
    _close(got, want, DTYPES[dtype][2])


def test_dense_init_std():
    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init(gen, 256, (64, 8), torch.float32)
    assert w.shape == (256, 64, 8)
    assert abs(w.std().item() - 256 ** -0.5) < 0.05 * 256 ** -0.5
