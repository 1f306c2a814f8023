"""The grouped product over kept prefixes (``kernels/grouped_mm.py``) on the
CPU, where its wrappers run the plain versions (``ref.grouped_mm_ref``,
``ref.grouped_mm_wgrad_ref``).

The plain product in float64 against a loop over the experts and against
the reference's expert einsum (``src/repro/models/moe.py:74-77``) on an
(E, C, d) buffer built from the same kept set, at rtol 1e-6; both entry
points on ``chip_smoke.GMM_CASES`` (the card phase's edge cases: segments
of length 0 and 1, kept prefixes shorter than their segments, rows outside
every segment, every row dropped, a decode step) against a dense
formulation that gathers each row's expert weight; the ``GroupedMM``
autograd ``Function``'s gradients by ``gradcheck`` and against autograd of
the plain version, float64; the ops' fake implementations, FLOP formulas
and the wrappers' routing of fake inputs; the kernels' contract (widths,
layout, segments, dtype) enforced on the CPU too, DTensors refused.  The ``cuda``-marked tests hold
the kernels against the plain versions on the card and skip here; this
file imports JAX only inside the test that compares with it, so the card's
machine, which has none, can run them.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import grouped_mm as gm
from repro_torch.kernels import ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-6
# the card phase's tolerances (chip_smoke.GMM_TOL)
CARD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# the cases' widths on the CPU (the card runs their full widths)
CPU_K, CPU_N = 24, 16


@functools.cache
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CASES = list(_chip_smoke().GMM_CASES)


def _segments(counts, kept, lead=0, tail=0):
    counts = torch.tensor(counts, dtype=torch.int64)
    start = lead + torch.cumsum(counts, 0) - counts
    R = lead + int(counts.sum()) + tail
    return R, start, torch.tensor(kept, dtype=torch.int64)


def _rand(rng, *shape, dtype=torch.float64):
    return torch.tensor(rng.normal(size=shape), dtype=dtype)


def _row_expert(R, start, kept):
    """(R,) the expert whose kept prefix holds each row, -1 for none."""
    seg = torch.full((R,), -1, dtype=torch.int64)
    rows = torch.arange(R)
    for g, (s, n) in enumerate(zip(start.tolist(), kept.tolist())):
        seg = torch.where((rows >= s) & (rows < s + n), g, seg)
    return seg


def _dense(x, w, start, kept, transposed):
    """Each row times its own expert's weight, gathered (G, K, N) -> (R, K,
    N), masked where no segment keeps the row."""
    seg = _row_expert(x.shape[0], start, kept)
    wg = (w.transpose(1, 2) if transposed else w)[seg.clamp(min=0)]
    y = torch.einsum("rk,rkn->rn", x, wg)
    return y * (seg >= 0)[:, None]


def _dense_wgrad(a, b, start, kept):
    seg = _row_expert(a.shape[0], start, kept)
    onehot = (seg[:, None] == torch.arange(start.shape[0])).to(a.dtype)
    return torch.einsum("rg,rm,rn->gmn", onehot, a, b)


# ---- the plain version against the reference --------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_loop_and_reference_einsum(seed):
    """Tokens routed to E experts as the MoE layer routes them (a stable
    sort by expert, the first C of each kept): the plain grouped product
    over the kept prefixes equals a loop over the experts and the
    reference's ``einsum("ecd,edf->ecf")`` over the (E, C, d) buffer of
    the same kept set, row for row; dropped rows are zero."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    E, k, N_tok, d, f, C = 6, 2, 40, 16, 24, 9
    experts = torch.tensor(np.argsort(rng.random((N_tok, E)), axis=1)[:, :k])
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    se = flat[order]
    counts = torch.bincount(flat, minlength=E)
    start = torch.cumsum(counts, 0) - counts
    kept = counts.clamp(max=C)
    x = _rand(rng, N_tok, d)[order // k]
    w = _rand(rng, E, d, f)
    got = ref.grouped_mm_ref(x, w, start, kept)
    assert bool((counts > C).any()) and bool((kept == C).any())

    want = torch.zeros_like(got)
    for e in range(E):
        rows = (se == e).nonzero().flatten()[:C]
        want[rows] = x[rows] @ w[e]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL)

    buf = np.zeros((E, C, d))
    for e in range(E):
        s, n = int(start[e]), int(kept[e])
        buf[e, :n] = x[s:s + n].numpy()
    with jax.enable_x64(True):
        out_e = np.asarray(jnp.einsum("ecd,edf->ecf", jnp.asarray(buf),
                                      jnp.asarray(w.numpy())))
    for e in range(E):
        s, n = int(start[e]), int(kept[e])
        np.testing.assert_allclose(got[s:s + n].numpy(), out_e[e, :n],
                                   rtol=RTOL)
        assert not got[s + n:s + int(counts[e])].any()


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_card_cases_against_a_dense_form(case, transposed):
    """The card phase's cases at narrow widths: the wrapper (on the CPU,
    the plain version) against each row by its gathered expert weight; the
    weight gradient against a one-hot sum over the rows."""
    cs = _chip_smoke()
    c = cs.GMM_CASES[case]
    R, start, kept, cap = cs.gmm_segments(case)
    G = len(c["counts"])
    rng = np.random.default_rng(CASES.index(case))
    x = _rand(rng, R, CPU_K)
    w = _rand(rng, *((G, CPU_N, CPU_K) if transposed else (G, CPU_K, CPU_N)))
    got = gm.grouped_mm(x, w, start, kept, cap, transposed=transposed)
    np.testing.assert_allclose(got.numpy(), _dense(x, w, start, kept,
                                                   transposed).numpy(),
                               rtol=RTOL, atol=1e-12)
    dy = _rand(rng, R, CPU_N)
    dw = gm.grouped_mm_wgrad(x, dy, start, kept, cap)
    np.testing.assert_allclose(dw.numpy(),
                               _dense_wgrad(x, dy, start, kept).numpy(),
                               rtol=RTOL, atol=1e-12)
    if case == "all_dropped":
        assert not got.any() and not dw.any()
    if case == "ep":
        # the rows of the other experts, before and after the segments
        assert not got[:c["lead"]].any() and not got[R - c["tail"]:].any()
    assert int(kept.max()) <= cap


@pytest.mark.parametrize("case", CASES)
def test_plain_versions_ignore_rows_outside_the_kept_prefixes(case):
    """The card phase fills every row outside the kept prefixes of x and
    dy with NaN and holds the kernels to the plain versions there: the
    oracle itself must give the same output (zeros in those rows) whatever
    they hold, NaN or +-Inf, in both weight layouts and the weight
    gradient; ``chip_smoke.nan_outside`` and ``zero_outside`` mark exactly
    those rows."""
    cs = _chip_smoke()
    c = cs.GMM_CASES[case]
    R, start, kept, _ = cs.gmm_segments(case)
    G = len(c["counts"])
    rng = np.random.default_rng(100 + CASES.index(case))
    x, dy = _rand(rng, R, CPU_K), _rand(rng, R, CPU_N)
    outside = ~cs._kept_mask(R, start, kept)
    junk = torch.tensor([float("nan"), float("inf"), -float("inf")],
                        dtype=x.dtype)
    fill = junk[torch.arange(R) % 3][:, None]
    x_bad = torch.where(outside[:, None], fill, x)
    dy_bad = torch.where(outside[:, None], fill, dy)
    assert torch.equal(torch.isnan(cs.nan_outside(x, start, kept)).any(1),
                       outside)
    for transposed in (False, True):
        w = _rand(rng, *((G, CPU_N, CPU_K) if transposed
                         else (G, CPU_K, CPU_N)))
        want = ref.grouped_mm_ref(x, w, start, kept, transposed)
        got = ref.grouped_mm_ref(x_bad, w, start, kept, transposed)
        assert torch.equal(got, want) and cs.zero_outside(got, start, kept)
    assert torch.equal(ref.grouped_mm_wgrad_ref(x_bad, dy_bad, start, kept),
                       ref.grouped_mm_wgrad_ref(x, dy, start, kept))


def test_segments_of_the_card_cases():
    """``chip_smoke.gmm_segments``: segments in ascending order, disjoint,
    each kept prefix within its segment, lead and tail rows outside."""
    cs = _chip_smoke()
    for case, c in cs.GMM_CASES.items():
        R, start, kept, cap = cs.gmm_segments(case)
        counts = torch.tensor(c["counts"])
        assert bool((kept <= counts).all()) and bool((kept >= 0).all())
        assert int(start[0]) == c["lead"]
        assert int(start[-1] + counts[-1]) == R - c["tail"]
        assert bool((start[1:] == start[:-1] + counts[:-1]).all())
        assert cap == max(1, int(kept.max()))


# ---- the gradient ---------------------------------------------------------------

@pytest.mark.parametrize("transposed", [False, True])
def test_gradcheck(transposed):
    """``GroupedMM``'s backward (the dX form and the weight gradient)
    against finite differences, float64, on segments with an empty one, a
    dropped tail and rows outside every segment."""
    rng = np.random.default_rng(7)
    R, start, kept = _segments((3, 0, 5, 2), (2, 0, 5, 1), lead=1, tail=2)
    shape = (4, 8, 4) if transposed else (4, 4, 8)
    x = _rand(rng, R, 4).requires_grad_()
    w = _rand(rng, *shape).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: gm.grouped_mm(a, b, start, kept, 5,
                                   transposed=transposed), (x, w))


@pytest.mark.parametrize("transposed", [False, True])
def test_gradients_equal_autograd_of_the_plain_version(transposed):
    rng = np.random.default_rng(8)
    R, start, kept = _segments((4, 1, 0, 6), (3, 1, 0, 6), tail=3)
    shape = (4, 8, 12) if transposed else (4, 12, 8)
    x0, w0, cot = _rand(rng, R, 12), _rand(rng, *shape), _rand(rng, R, 8)
    got = torch.autograd.grad(
        (gm.grouped_mm(x0.requires_grad_(), w0.requires_grad_(), start,
                       kept, 6, transposed=transposed) * cot).sum(),
        [x0, w0])
    x1, w1 = x0.detach().requires_grad_(), w0.detach().requires_grad_()
    want = torch.autograd.grad(
        (ref.grouped_mm_ref(x1, w1, start, kept, transposed) * cot).sum(),
        [x1, w1])
    for g, v in zip(got, want):
        np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=RTOL,
                                   atol=1e-12)


def test_no_gradient_where_no_input_requires_one():
    """Outside grad mode (serving) the wrapper runs the plain call, not the
    ``Function``; under grad mode it is the ``Function``."""
    R, start, kept = _segments((2, 3), (2, 1))
    x, w = torch.ones(R, 4), torch.ones(2, 4, 8)
    with torch.no_grad():
        assert gm.grouped_mm(x, w, start, kept).grad_fn is None
    y = gm.grouped_mm(x, w.requires_grad_(), start, kept)
    assert type(y.grad_fn).__name__ == "GroupedMMBackward"


# ---- the ops: fake implementations and FLOP formulas ------------------------

def _op_args(transposed=False):
    rng = np.random.default_rng(3)
    R, start, kept = _segments((5, 0, 7), (3, 0, 7), tail=2)
    w = _rand(rng, *((3, 8, 4) if transposed else (3, 4, 8)),
              dtype=torch.float32)
    return (_rand(rng, R, 4, dtype=torch.float32), w, start, kept, 7,
            transposed)


@pytest.mark.parametrize("transposed", [False, True])
def test_ops_under_fake_tensors(transposed):
    """Each op's fake implementation gives its plain version's output
    shape and dtype; the wrappers send fake inputs to the ops, outside
    grad mode too, and never to code that reads ``data_ptr()``."""
    x, w, start, kept, cap, _ = _op_args(transposed)
    dy = torch.zeros(x.shape[0], 8)
    plain = ref.grouped_mm_ref(x, w, start, kept, transposed)
    plain_dw = ref.grouped_mm_wgrad_ref(x, dy, start, kept)
    mode = FakeTensorMode()
    with mode, torch.no_grad():
        fx, fw, fs, fk, fdy = (mode.from_tensor(t)
                               for t in (x, w, start, kept, dy))
        y = torch.ops.repro_torch.grouped_mm(fx, fw, fs, fk, cap,
                                             transposed)
        dw = torch.ops.repro_torch.grouped_mm_wgrad(fx, fdy, fs, fk, cap)
        y2 = gm.grouped_mm(fx, fw, fs, fk, cap, transposed=transposed)
        dw2 = gm.grouped_mm_wgrad(fx, fdy, fs, fk, cap)
    for got, want in ((y, plain), (y2, plain), (dw, plain_dw),
                      (dw2, plain_dw)):
        assert type(got).__name__ == "FakeTensor"
        assert (tuple(got.shape), got.dtype) == (tuple(want.shape),
                                                 want.dtype)


@pytest.mark.parametrize("cap,rows", [(7, 14), (3, 9), (0, 14)])
def test_flop_formulas(cap, rows):
    """2 R K N a product over the rows a call can keep: every row (R = 14
    here), or G x capacity where fewer (3 segments of at most 3); the
    backward adds the dX form and the weight gradient, the same count
    each."""
    x, w, start, kept, _, _ = _op_args()
    assert x.shape[0] == 14
    x.requires_grad_()
    w.requires_grad_()
    counter = FlopCounterMode(display=False)
    with counter:
        y = gm.grouped_mm(x, w, start, kept, cap)
    assert counter.get_total_flops() == 2 * rows * 4 * 8
    with counter:
        y.sum().backward()
    assert counter.get_total_flops() == 2 * 2 * rows * 4 * 8


def test_wrappers_refuse_dtensors():
    """The ops take local tensors: a DTensor is refused before any op
    runs (under a mesh ``models/moe.py`` hands them its shards)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch import dryrun

    x, w, start, kept, cap, _ = _op_args()
    dryrun.fake_world(2)
    try:
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
        dx = DTensor.from_local(x, mesh, [Replicate()], run_check=False)
        with pytest.raises(TypeError, match="local tensors"):
            gm.grouped_mm(dx, w, start, kept, cap)
        with pytest.raises(TypeError, match="local tensors"):
            gm.grouped_mm_wgrad(dx, x, start, kept, cap)
    finally:
        dist.destroy_process_group()


def _bad_layouts():
    """(what, x, w, start, kept): each breaks one rule of the kernels'
    contract on CPU tensors, float32."""
    x, w, start, kept, _, _ = _op_args()
    R = x.shape[0]
    many = torch.zeros(gm.MAX_GROUPS + 1, dtype=torch.int64)
    return {
        "width": (torch.ones(R, 6), torch.ones(3, 6, 8), start, kept),
        "strided": (torch.ones(8, R).t(), w, start, kept),
        "unaligned": (torch.ones(R * 4 + 1)[1:].view(R, 4), w, start, kept),
        "int32": (x, w, start.int(), kept.int()),
        "groups": (x, torch.ones(gm.MAX_GROUPS + 1, 4, 8), many, many),
        "float16": (x.half(), w.half(), start, kept),
    }


@pytest.mark.parametrize("case", ["width", "strided", "unaligned", "int32",
                                  "groups", "float16"])
def test_cpu_path_checks_the_kernels_contract(case):
    """On the CPU the wrappers refuse what the kernel would refuse (all
    but float64 for ``gradcheck``), so the gloo mesh tests show that every
    rank's shards meet the kernel's contract."""
    x, w, start, kept = _bad_layouts()[case]
    with torch.no_grad(), pytest.raises((ValueError, TypeError)):
        gm.grouped_mm(x, w, start, kept)
    dy = torch.ones(x.shape[0], 8, dtype=x.dtype)
    with pytest.raises((ValueError, TypeError)):
        gm.grouped_mm_wgrad(x, dy, start, kept)


def test_wrapper_refuses_an_unknown_device():
    x, w, start, kept, cap, _ = _op_args()
    with pytest.raises(ValueError, match="unsupported device"):
        with torch.no_grad():
            gm.grouped_mm(x.to("meta"), w.to("meta"), start.to("meta"),
                          kept.to("meta"), cap)


# ---- the kernels on the card --------------------------------------------------

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernels_match_plain_version(case, dtype):
    """Both entry points (both weight layouts) against the plain versions
    on the card phase's cases at their full widths, with its tolerances;
    two calls bit-identical."""
    _cuda_or_skip()
    cs = _chip_smoke()
    c = cs.GMM_CASES[case]
    R, start, kept, cap = cs.gmm_segments(case)
    start, kept = start.cuda(), kept.cuda()
    dt = getattr(torch, dtype)
    G, K, N = len(c["counts"]), c["K"], c["N"]
    gen = torch.Generator(device="cuda").manual_seed(CASES.index(case))
    x = torch.randn((R, K), generator=gen, device="cuda").to(dt)
    dy = torch.randn((R, N), generator=gen, device="cuda").to(dt)
    for transposed in (False, True):
        w = (torch.randn((G, N, K) if transposed else (G, K, N),
                         generator=gen, device="cuda") * K ** -0.5).to(dt)
        before = gm.grouped_mm.launches
        got = gm.grouped_mm(x, w, start, kept, cap, transposed=transposed)
        again = gm.grouped_mm(x, w, start, kept, cap, transposed=transposed)
        assert gm.grouped_mm.launches == before + 2
        want = ref.grouped_mm_ref(x, w, start, kept, transposed)
        torch.testing.assert_close(got.float(), want.float(),
                                   **CARD_TOL[dt])
        assert torch.equal(got, again)
    got = gm.grouped_mm_wgrad(x, dy, start, kept, cap)
    again = gm.grouped_mm_wgrad(x, dy, start, kept, cap)
    want = ref.grouped_mm_wgrad_ref(x, dy, start, kept)
    torch.testing.assert_close(got.float(), want.float(), **CARD_TOL[dt])
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_gradients_match_plain_version():
    """The ``Function`` on the card (the dX form and the weight gradient
    kernels) against autograd of the plain version, float32."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(5)
    R, start, kept = _segments((130, 0, 1, 257), (100, 0, 1, 257), lead=3,
                               tail=9)
    start, kept = start.cuda(), kept.cuda()
    x0 = torch.randn((R, 64), generator=gen, device="cuda")
    w0 = torch.randn((4, 64, 88), generator=gen, device="cuda") / 8
    cot = torch.randn((R, 88), generator=gen, device="cuda")
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    got = torch.autograd.grad((gm.grouped_mm(x, w, start, kept, 257)
                               * cot).sum(), [x, w])
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    want = torch.autograd.grad((ref.grouped_mm_ref(x, w, start, kept)
                                * cot).sum(), [x, w])
    for g, v in zip(got, want):
        torch.testing.assert_close(g, v, **CARD_TOL[torch.float32])


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """A width that is not a multiple of 16 bytes, a third dtype and
    int32 segments raise before any launch."""
    _cuda_or_skip()
    R, start, kept = _segments((4, 4), (4, 4))
    start, kept = start.cuda(), kept.cuda()
    before = gm.grouped_mm.launches
    with torch.no_grad():
        with pytest.raises(ValueError, match="16 bytes"):
            gm.grouped_mm(torch.ones(R, 12, device="cuda",
                                     dtype=torch.bfloat16),
                          torch.ones(2, 12, 8, device="cuda",
                                     dtype=torch.bfloat16), start, kept)
        with pytest.raises(TypeError):
            gm.grouped_mm(torch.ones(R, 8, device="cuda",
                                     dtype=torch.float16),
                          torch.ones(2, 8, 8, device="cuda",
                                     dtype=torch.float16), start, kept)
        with pytest.raises(TypeError, match="int64"):
            gm.grouped_mm(torch.ones(R, 8, device="cuda"),
                          torch.ones(2, 8, 8, device="cuda"), start.int(),
                          kept.int())
    assert gm.grouped_mm.launches == before
