"""The port's pLUTo ALU and Fig-8 applications (``repro_torch.core.
pluto_alu`` / ``executor``): every case of ``tests/test_pluto_alu.py``
against native integer arithmetic and the NumPy oracles, on the CPU and
(``cuda``-marked, skipped without a card) on the card; and each case's
seeded inputs through the JAX package and the port, equal bit for bit
(tolerance 0).  JAX is imported only inside the parity tests, so the
``cuda`` cases run on a machine without it.
"""

import importlib

import numpy as np
import pytest
import torch

from _hypothesis_compat import hypothesis, st  # noqa: F401

from repro_torch.core import executor
from repro_torch.core import pluto_alu as alu

u32 = st.integers(0, 2**32 - 1)
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
WIDTHS = [4, 8, 16, 24, 32]
Q = 7681


def _need(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _i64(x, device):
    return torch.tensor(np.asarray(x, np.int64), device=device)


def _int(t) -> int:
    assert t.dtype == torch.uint32
    return int(t.to(torch.int64).item())


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    assert t.dtype == torch.uint32
    return t.cpu().numpy()


def _root(n, q=Q):
    return next(c for c in range(2, q)
                if pow(c, n, q) == 1 and pow(c, n // 2, q) != 1)


def _bfs_graph(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 20))
    adj = rng.random((n, n)) < 0.25
    adj |= adj.T
    np.fill_diagonal(adj, False)
    return adj.astype(np.uint8)


def _jax():
    jnp = importlib.import_module("jax.numpy")
    jalu = importlib.import_module("repro.core.pluto_alu")
    jexe = importlib.import_module("repro.core.executor")
    return jnp, jalu, jexe


# ---- scalar properties ------------------------------------------------------

@pytest.mark.parametrize("device", DEVICES)
@hypothesis.given(u32, u32)
@hypothesis.settings(max_examples=80, deadline=None)
def test_add32(device, x, y):
    _need(device)
    got = _int(alu.pluto_add(_i64(x, device), _i64(y, device)))
    assert got == (x + y) % 2**32


@pytest.mark.parametrize("device", DEVICES)
@hypothesis.given(u32, u32)
@hypothesis.settings(max_examples=80, deadline=None)
def test_mul32(device, x, y):
    _need(device)
    got = _int(alu.pluto_mul(_i64(x, device), _i64(y, device)))
    assert got == (x * y) % 2**32


@pytest.mark.parametrize("device", DEVICES)
@hypothesis.given(u32, u32)
@hypothesis.settings(max_examples=80, deadline=None)
def test_sub32(device, x, y):
    _need(device)
    got = _int(alu.pluto_sub(_i64(x, device), _i64(y, device)))
    assert got == (x - y) % 2**32


@pytest.mark.parametrize("device", DEVICES)
@hypothesis.given(st.integers(0, Q - 1), st.integers(0, Q - 1))
@hypothesis.settings(max_examples=40, deadline=None)
def test_modular_ops(device, x, y):
    _need(device)
    a, b = _i64(x, device), _i64(y, device)
    assert _int(alu.pluto_addmod(a, b, Q)) == (x + y) % Q
    assert _int(alu.pluto_mulmod(a, b, Q)) == (x * y) % Q


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("bits", WIDTHS)
def test_width_sweep(device, bits):
    _need(device)
    rng = np.random.default_rng(bits)
    m = (1 << bits) - 1
    x = rng.integers(0, m + 1, 64, dtype=np.uint32)
    y = rng.integers(0, m + 1, 64, dtype=np.uint32)
    tx, ty = _i64(x, device), _i64(y, device)
    np.testing.assert_array_equal(_np(alu.pluto_add(tx, ty, bits=bits)),
                                  (x + y) & m)
    np.testing.assert_array_equal(_np(alu.pluto_mul(tx, ty, bits=bits)),
                                  (x * y) & m)


@pytest.mark.parametrize("device", DEVICES)
def test_uint32_and_int64_inputs_agree(device):
    """A ``uint32`` tensor, an ``int64`` one and a negative ``int64`` (which
    the reference's ``astype(uint32)`` wraps) give the same lanes."""
    _need(device)
    x = np.array([0, 1, 2**31, 2**32 - 1], np.int64)
    y = np.array([2**32 - 1, 7, 2**31, 2**32 - 1], np.int64)
    as_u32 = alu.pluto_mul(_i64(x, device).to(torch.uint32),
                           _i64(y, device).to(torch.uint32))
    as_i64 = alu.pluto_mul(_i64(x, device), _i64(y - 2**32, device))
    want = (x.astype(np.uint64) * y.astype(np.uint64)) & 0xFFFFFFFF
    np.testing.assert_array_equal(_np(as_u32), want)
    np.testing.assert_array_equal(_np(as_i64), want)
    assert as_u32.device.type == device


# ---- the Fig-8 applications -------------------------------------------------

@pytest.mark.parametrize("device", DEVICES)
def test_matmul(device):
    _need(device)
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, (8, 6), dtype=np.uint32)
    b = rng.integers(0, 2**32, (6, 7), dtype=np.uint32)
    got = _np(executor.matmul(a, b, device=device))
    want = (a.astype(np.uint64) @ b.astype(np.uint64)) & 0xFFFFFFFF
    np.testing.assert_array_equal(got, want.astype(np.uint32))


@pytest.mark.parametrize("device", DEVICES)
def test_pmm(device):
    _need(device)
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2**32, 9, dtype=np.uint32)
    b = rng.integers(0, 2**32, 9, dtype=np.uint32)
    got = _np(executor.pmm(_i64(a, device), _i64(b, device)))
    want = np.zeros(17, dtype=np.uint64)
    for i in range(9):
        want[i:i + 9] = (want[i:i + 9] + a[i].astype(np.uint64) * b) % 2**32
    np.testing.assert_array_equal(got, want.astype(np.uint32))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("n", [8, 16, 32])
def test_ntt(device, n):
    _need(device)
    root = _root(n)
    rng = np.random.default_rng(n)
    x = rng.integers(0, Q, n, dtype=np.uint32)
    got = _np(executor.ntt(x, q=Q, root=root, device=device))
    np.testing.assert_array_equal(got, executor.ntt_oracle(x, q=Q, root=root))


def test_ntt_refuses_a_root_that_is_not_primitive():
    with pytest.raises(ValueError, match="primitive"):
        executor.ntt(np.arange(8), q=Q, root=1, device="cpu")


@pytest.mark.parametrize("device", DEVICES)
@hypothesis.given(st.integers(0, 10_000))
@hypothesis.settings(max_examples=10, deadline=None)
def test_bfs_random_graphs(device, seed):
    _need(device)
    adj = _bfs_graph(seed)
    np.testing.assert_array_equal(executor.bfs(adj, device=device),
                                  executor.bfs_oracle(adj))


@pytest.mark.parametrize("device", DEVICES)
def test_bfs_dense_worst_case(device):
    """The paper's benchmark graph is fully connected (all distances 1);
    validated on a smaller dense instance here, at 1000 nodes on the card
    by ``chip_smoke.py``."""
    _need(device)
    n = 64
    adj = ~np.eye(n, dtype=bool)
    got = executor.bfs(adj.astype(np.uint8), device=device)
    want = np.ones(n, np.uint32)
    want[0] = 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("device", DEVICES)
def test_bfs_unreached_nodes_stay_saturated(device):
    _need(device)
    adj = np.zeros((5, 5), np.uint8)
    adj[0, 1] = adj[1, 0] = adj[1, 2] = adj[2, 1] = 1
    got = executor.bfs(adj, device=device)
    np.testing.assert_array_equal(got, executor.bfs_oracle(adj))
    assert got[3] == got[4] == 0xFFFFFFFF


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        executor.matmul(np.ones((2, 2), np.uint32), np.ones((2, 2), np.uint32))


# ---- the JAX package and the port, bit for bit ------------------------------

def _pairs(seed, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    y = rng.integers(0, 2**32, n, dtype=np.uint32)
    edges = np.array([0, 1, 0xF, 0x10, 2**31, 2**32 - 1], np.uint32)
    ex, ey = np.meshgrid(edges, edges)
    return np.concatenate([x, ex.ravel()]), np.concatenate([y, ey.ravel()])


@pytest.mark.parametrize("seed, op", enumerate(
    ["pluto_add", "pluto_mul", "pluto_sub"]))
def test_alu_equals_jax_32(seed, op):
    jnp, jalu, _ = _jax()
    x, y = _pairs(seed)
    want = np.asarray(getattr(jalu, op)(jnp.asarray(x), jnp.asarray(y)))
    got = _np(getattr(alu, op)(_i64(x, "cpu"), _i64(y, "cpu")))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["pluto_addmod", "pluto_mulmod"])
def test_modular_equals_jax(op):
    jnp, jalu, _ = _jax()
    rng = np.random.default_rng(7)
    x = rng.integers(0, Q, 2048, dtype=np.uint32)
    y = rng.integers(0, Q, 2048, dtype=np.uint32)
    want = np.asarray(getattr(jalu, op)(jnp.asarray(x), jnp.asarray(y), Q))
    got = _np(getattr(alu, op)(_i64(x, "cpu"), _i64(y, "cpu"), Q))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", WIDTHS)
def test_width_sweep_equals_jax(bits):
    """Full 32-bit operands at every width: the reference reads only the
    low ``bits / 4`` nibbles, and so must the port."""
    jnp, jalu, _ = _jax()
    x, y = _pairs(bits, n=512)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = _i64(x, "cpu"), _i64(y, "cpu")
    for op in ("pluto_add", "pluto_mul", "pluto_sub"):
        want = np.asarray(getattr(jalu, op)(jx, jy, bits=bits))
        got = _np(getattr(alu, op)(tx, ty, bits=bits))
        np.testing.assert_array_equal(got, want, err_msg=op)


def test_matmul_equals_jax():
    jnp, _, jexe = _jax()
    rng = np.random.default_rng(10)
    a = rng.integers(0, 2**32, (8, 6), dtype=np.uint32)
    b = rng.integers(0, 2**32, (6, 7), dtype=np.uint32)
    want = np.asarray(jexe.matmul(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(
        _np(executor.matmul(a, b, device="cpu")), want)


def test_pmm_equals_jax():
    jnp, _, jexe = _jax()
    rng = np.random.default_rng(11)
    a = rng.integers(0, 2**32, 9, dtype=np.uint32)
    b = rng.integers(0, 2**32, 9, dtype=np.uint32)
    want = np.asarray(jexe.pmm(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(_np(executor.pmm(a, b, device="cpu")),
                                  want)


@pytest.mark.parametrize("n", [8, 16, 32])
def test_ntt_equals_jax(n):
    jnp, _, jexe = _jax()
    root = _root(n)
    x = np.random.default_rng(100 + n).integers(0, Q, n, dtype=np.uint32)
    want = np.asarray(jexe.ntt(jnp.asarray(x), q=Q, root=root))
    got = _np(executor.ntt(x, q=Q, root=root, device="cpu"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bfs_random_equals_jax(seed):
    _, _, jexe = _jax()
    adj = _bfs_graph(seed)
    np.testing.assert_array_equal(executor.bfs(adj, device="cpu"),
                                  jexe.bfs(adj))


def test_bfs_dense_equals_jax():
    _, _, jexe = _jax()
    adj = (~np.eye(64, dtype=bool)).astype(np.uint8)
    np.testing.assert_array_equal(executor.bfs(adj, device="cpu"),
                                  jexe.bfs(adj))


def test_oracles_equal_jax():
    _, _, jexe = _jax()
    x = np.random.default_rng(5).integers(0, Q, 16, dtype=np.uint32)
    np.testing.assert_array_equal(executor.ntt_oracle(x, Q, _root(16)),
                                  jexe.ntt_oracle(x, Q, _root(16)))
    adj = _bfs_graph(9)
    np.testing.assert_array_equal(executor.bfs_oracle(adj),
                                  jexe.bfs_oracle(adj))
