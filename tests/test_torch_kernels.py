"""Port's flash attention against the JAX reference kernel and oracle.

The port's plain version (``repro_torch.kernels.ref``) and its GQA wrapper
are held against JAX's ``ref.flash_attention_ref``, the Pallas kernel in
interpret mode and the model's ``layers.attention``, on the same numpy
inputs.  The CUDA kernel itself runs only on a card: its test is marked
``cuda`` and skips here.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
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
