"""The port's MoE layer under a ``DeviceMesh`` on the CPU: ``moe_block`` on a
2 x 4 ``("data", "model")`` mesh of spawned gloo ranks, under EP (the
experts over 'model') and under TP (the ffn over 'model',
``REPRO_MOE_TP=1``), on the ``tight`` (drops), ``decode`` (one slot an
expert) and ``shared`` cases of ``tests/test_torch_moe.py``, in float32:
its output against the JAX package's ``moe_block`` at ``MOE_TOL``, the kept
set its call ran (``moe.record_routing``) against the reference's bit for
bit, the gradient of every input and parameter against the port's without
a mesh at rtol 1e-4, and the collectives of one layer; the ``tight`` and
``decode`` cases again on a 2 x 2 x 2 ``("pod", "data", "model")`` mesh,
the batch sharded over two mesh dimensions, under both layouts; then one train step of reduced qwen2-moe (TP)
and of reduced llama4 (EP, a dense and an MoE layer under one remat
group) against the same step with no mesh, at ``test_torch_mesh.py``'s
tolerance; two 8-bit AdamW steps on DTensor parameters; and, in this
process on a mesh of one, a remat recompute run from another thread (as a
card's backward runs) and a nested ``use_mesh``, in one thread and across
two.

One module-scoped 8-rank job for each layout and one for the pod mesh; ranks are spawned as
``tests/test_torch_distributed.py`` spawns them (a 60 s group timeout,
every child joined within its limit).  JAX is imported inside the tests,
so the children import only the port.
"""

import dataclasses
import importlib
import math
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree
from repro_torch.configs import registry as treg
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.optim import adamw
from repro_torch.sharding import context, partition
from repro_torch.train import train_step as ts
from test_torch_distributed import _spawn

MOE_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/test_moe.py's
GRAD_RTOL = 1e-4
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)   # test_torch_mesh.py's for glm4
MESH = (2, 4)
POD_MESH = (2, 2, 2)
# tests/test_torch_moe.py's cases: experts, top-k, tokens (B, T), capacity
# factor, shared expert width
CASES = {
    "tight": dict(E=4, k=2, B=2, T=32, cf=0.25, shared=0),
    "decode": dict(E=8, k=2, B=4, T=1, cf=1.25, shared=0),
    "shared": dict(E=8, k=2, B=2, T=8, cf=100.0, shared=64),
}
# the pod mesh shards the batch 4 ways: ``tight`` with 4 rows of 16 tokens
# and a capacity (20) that each expert reaches in the third batch shard, so
# that the order of the middle two (the data rank inside the pod rank)
# decides what is dropped; ``decode`` as it is
POD_CASES = {"tight": dict(CASES["tight"], B=4, T=16, cf=0.625),
             "decode": CASES["decode"]}
D, F = 16, 32
# the reduced model of each layout's train step: qwen2-moe as the full
# config is sharded (TP: 60 experts do not divide 16), llama4 as its is (EP)
TRAIN_ARCH = {"tp": "qwen2-moe-a2.7b", "ep": "llama4-maverick-400b-a17b"}
OPT = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-2,
                        grad_clip=0.0)


def _layer_cfg(c, registry=treg):
    return dataclasses.replace(
        registry.get("qwen2-moe-a2.7b").reduced(), n_experts=c["E"],
        n_experts_active=c["k"], moe_d_ff=F, d_model=D,
        shared_expert_d_ff=c["shared"])


def _layer_inputs(case, c=None):
    """The layer's parameters (the reference's leaves), x and the output's
    cotangent, float32 from a seeded numpy generator (one seed a case
    name); ``c`` the case's sizes, ``CASES[case]`` by default."""
    c = CASES[case] if c is None else c
    rng = np.random.default_rng(list(CASES).index(case))

    def w(*shape, fan_in):
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    E, S = c["E"], c["shared"]
    p = {"router": w(D, E, fan_in=D), "wi_gate": w(E, D, F, fan_in=D),
         "wi_up": w(E, D, F, fan_in=D), "wo": w(E, F, D, fan_in=F)}
    if S:
        p["shared"] = {"wi_gate": w(D, S, fan_in=D),
                       "wi_up": w(D, S, fan_in=D), "wo": w(S, D, fan_in=S)}
    x = rng.normal(size=(c["B"], c["T"], D)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    return p, x, cot


def _torch_tree(p):
    return tree.map_leaves(lambda a: torch.from_numpy(np.array(a)), p)


class _Collectives(TorchDispatchMode):
    """Records (name, dtype, output elements) of every functional
    collective the local ops run."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace == "_c10d_functional" and \
                func._overloadpacket.__name__ in ("all_gather_into_tensor",
                                                  "all_reduce",
                                                  "reduce_scatter_tensor"):
            self.seen.append((func._overloadpacket.__name__,
                              str(out.dtype), out.numel()))
        return out


def _layer_on_mesh(case, mesh, c=None) -> dict:
    c = CASES[case] if c is None else c
    cfg = _layer_cfg(c)
    p, x, cot = _layer_inputs(case, c)
    params = {"moe": _torch_tree(p)}
    dp = partition.distribute(params, partition.param_shardings(params, mesh),
                              mesh)["moe"]
    leaves = [t.requires_grad_() for t in tree.leaves(dp)]
    inputs = {"x": torch.from_numpy(x), "cot": torch.from_numpy(cot)}
    di = partition.distribute(
        inputs, partition.batch_shardings(inputs, mesh, c["B"]), mesh)
    dx = di["x"].requires_grad_()
    out = {}
    with context.use_mesh(mesh):
        rec = _Collectives()
        with rec, tmoe.record_routing() as routing:
            y = tmoe.moe_block(dp, dx, cfg, capacity_factor=c["cf"])
        grads = torch.autograd.grad((y * di["cot"]).sum(), [dx] + leaves)
    # the routing the call ran, in this rank's flat (token, slot) order
    (experts, kept), = routing
    out["y"] = y.full_tensor().detach().numpy()
    out["experts"] = experts.numpy()
    out["keep"] = kept.numpy()
    out["x_local"] = dx.to_local().detach().numpy()
    out["layout"] = np.array(tmoe.expert_layout(dp["wi_gate"]))
    names = mesh.mesh_dim_names
    out["model_rank"] = np.array(mesh.get_coordinate()[names.index("model")])
    for i, (g, leaf) in enumerate(zip(grads, [dx] + leaves)):
        out[f"g{i}"] = g.full_tensor().numpy()
        out[f"same_layout{i}"] = np.array(
            tuple(g.placements) == tuple(leaf.placements))
    out["collectives"] = np.array([f"{n}|{dt}|{numel}"
                                   for n, dt, numel in rec.seen])
    return {f"{case}/{k}": v for k, v in out.items()}


def _train_cfg(arch, registry=treg):
    return dataclasses.replace(registry.get(arch).reduced(), dtype="float32")


def _tokens():
    return np.random.default_rng(0).integers(0, 256, (8, 32)).astype(
        np.int64)


def _train_on_mesh(arch, mesh) -> dict:
    """One train step of the reduced ``arch`` under the mesh against the
    same step with plain parameters and no mesh."""
    cfg = _train_cfg(arch)
    model = tmodel.build(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    init = [t.clone() for t in tree.leaves(params)]
    batch = {"tokens": torch.from_numpy(_tokens())}
    loss0, grads0 = ts._loss_and_grads(model, params, batch, 1)
    dparams = partition.distribute(
        params, partition.param_shardings(params, mesh), mesh)
    dbatch = partition.distribute(
        batch, partition.batch_shardings(batch, mesh, 8), mesh)
    with context.use_mesh(mesh):
        loss, grads = ts._loss_and_grads(model, dparams, dbatch, 1)
        state = {"params": dparams, "opt": adamw.init_state(OPT, dparams),
                 "step": torch.zeros((), dtype=torch.int32)}
        state, metrics = ts.make_train_step(model, OPT)(state, dbatch)
    plain = {"params": params, "opt": adamw.init_state(OPT, params),
             "step": torch.zeros((), dtype=torch.int32)}
    plain, _ = ts.make_train_step(model, OPT)(plain, batch)
    out = {"loss": loss.full_tensor().numpy(), "loss0": loss0.numpy(),
           "step_loss": metrics["loss"].full_tensor().numpy(),
           "n": np.array(len(init))}
    for i, (g, g0) in enumerate(zip(tree.leaves(grads), tree.leaves(grads0))):
        out[f"g{i}"], out[f"g0_{i}"] = g.full_tensor().numpy(), g0.numpy()
    for i, (p, p0) in enumerate(zip(tree.leaves(state["params"]),
                                    tree.leaves(plain["params"]))):
        out[f"p{i}"], out[f"p0_{i}"] = p.full_tensor().numpy(), p0.numpy()
        out[f"init{i}"] = init[i].numpy()
    out["expert_layout"] = np.array(tmoe.expert_layout(
        dparams["moe_blocks" if "moe_blocks" in dparams else "blocks"]
        ["moe"]["wi_gate"][0]))
    return {f"train/{k}": v for k, v in out.items()}


def _adamw8_on_mesh(mesh) -> dict:
    """Two 8-bit AdamW steps on DTensor parameters (as llama4's dry-run
    cells take them) against the same steps on plain ones: ``a`` (2, 8,
    512) sharded (data: dim 0, model: dim 1), whose shards' rows are whole
    blocks; ``b`` (6, 40) likewise, whose are not."""
    from torch.distributed.tensor import Shard

    rng = np.random.default_rng(7)
    shapes = {"a": (2, 8, 512), "b": (6, 40)}
    params = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for k, s in shapes.items()}
    grads = [{k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for k, s in shapes.items()} for _ in range(2)]
    pls = {k: (Shard(0), Shard(1)) for k in shapes}
    opt = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, grad_clip=0.0,
                            state_bits=8)
    plain = {k: v.clone() for k, v in params.items()}
    dparams = partition.distribute(params, pls, mesh)
    state, dstate = adamw.init_state(opt, plain), adamw.init_state(opt,
                                                                   dparams)
    for g in grads:
        _, state, _ = adamw.apply_updates(opt, plain, g, state)
        _, dstate, _ = adamw.apply_updates(
            opt, dparams, partition.distribute(g, pls, mesh), dstate)
    out = {f"adamw8/{k}": dparams[k].full_tensor().numpy() for k in shapes}
    out.update({f"adamw8/{k}0": plain[k].numpy() for k in shapes})
    out.update({f"adamw8/{k}_init": params[k].numpy() for k in shapes})
    out["adamw8/a_blocks"] = np.array(dstate["m"]["a"]["c"].to_local().shape)
    return out


def _job(layout):
    from torch.distributed.device_mesh import init_device_mesh

    if layout == "tp":
        os.environ["REPRO_MOE_TP"] = "1"
    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
    out = {}
    for case in CASES:
        out.update(_layer_on_mesh(case, mesh))
    out.update(_train_on_mesh(TRAIN_ARCH[layout], mesh))
    out.update(_adamw8_on_mesh(mesh))
    return out


def _job_ep(rank, world):
    return _job("ep")


def _job_tp(rank, world):
    return _job("tp")


def _job_pod(rank, world):
    """``POD_CASES`` on the 2 x 2 x 2 mesh, under EP and then under TP."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", POD_MESH,
                            mesh_dim_names=("pod", "data", "model"))
    out = {}
    for layout in ("ep", "tp"):
        if layout == "tp":
            os.environ["REPRO_MOE_TP"] = "1"
        for case, c in POD_CASES.items():
            out.update({f"{layout}/{k}": v for k, v in
                        _layer_on_mesh(case, mesh, c).items()})
    return out


@pytest.fixture(scope="module", params=["ep", "tp"])
def on_mesh(request, tmp_path_factory):
    job = {"ep": _job_ep, "tp": _job_tp}[request.param]
    res = _spawn(job, MESH[0] * MESH[1],
                 tmp_path_factory.mktemp(f"moe_{request.param}"))
    return request.param, res


@pytest.fixture(scope="module")
def on_pod_mesh(tmp_path_factory):
    return _spawn(_job_pod, math.prod(POD_MESH),
                  tmp_path_factory.mktemp("moe_pod"))


def _no_mesh(case, c=None):
    """The port's output and gradients without a mesh."""
    c = CASES[case] if c is None else c
    p, x, cot = _layer_inputs(case, c)
    params = _torch_tree(p)
    xt = torch.from_numpy(x).requires_grad_()
    leaves = [t.requires_grad_() for t in tree.leaves(params)]
    y = tmoe.moe_block(params, xt, _layer_cfg(c), capacity_factor=c["cf"])
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                                [xt] + leaves)
    return y.detach().numpy(), [g.numpy() for g in grads]


def _jax_moe_block(case, c):
    jnp = importlib.import_module("jax.numpy")
    jreg = importlib.import_module("repro.configs.registry")
    jmoe = importlib.import_module("repro.models.moe")
    p, x, _ = _layer_inputs(case, c)
    return np.asarray(jmoe.moe_block(
        {k: (jnp.asarray(v) if not isinstance(v, dict) else
             {kk: jnp.asarray(vv) for kk, vv in v.items()})
         for k, v in p.items()},
        jnp.asarray(x), _layer_cfg(c, jreg), capacity_factor=c["cf"]))


def _check_kept_set(res, case, c, layout, prefix=""):
    """The assignments each rank's ``moe_block`` call kept, put together in
    global (token, slot) order (each rank's tokens found in x, so the order
    is DTensor's own layout of the batch), equal the reference's kept set
    bit for bit: under TP every 'model' rank keeps the whole of its
    tokens' set, under EP each kept assignment on exactly one 'model'
    rank, the one that holds its expert.  The top-k choices equal the
    reference's too.  Returns the reference's kept set and capacity."""
    jnp = importlib.import_module("jax.numpy")
    jreg = importlib.import_module("repro.configs.registry")
    test_moe = importlib.import_module("test_torch_moe")
    p, x, _ = _layer_inputs(case, c)
    jp = {k: jnp.asarray(v) for k, v in p.items() if k != "shared"}
    ex, keep_sorted, C = test_moe._jax_routing(jp, x, _layer_cfg(c, jreg),
                                               c["cf"])
    ex = np.asarray(ex).reshape(-1)
    order = np.argsort(ex, kind="stable")
    want = np.empty_like(keep_sorted)
    want[order] = keep_sorted
    E, k, T = c["E"], c["k"], c["T"]
    n_model = len({int(r[f"{prefix}{case}/model_rank"]) for r in res})
    times = np.zeros(want.shape, dtype=int)
    covered = np.zeros(want.shape, dtype=bool)
    for r in res:
        xl = r[f"{prefix}{case}/x_local"]
        row = int(np.flatnonzero((x == xl[:1]).all(axis=(1, 2)))[0])
        np.testing.assert_array_equal(x[row:row + xl.shape[0]], xl)
        lo, hi = row * T * k, (row + xl.shape[0]) * T * k
        keep = r[f"{prefix}{case}/keep"]
        local_ex = r[f"{prefix}{case}/experts"].reshape(-1)
        np.testing.assert_array_equal(local_ex, ex[lo:hi])
        if layout == "tp":
            np.testing.assert_array_equal(keep, want[lo:hi])
        else:
            m = int(r[f"{prefix}{case}/model_rank"])
            mine = (local_ex // (E // n_model)) == m
            assert not (keep & ~mine).any()
            np.testing.assert_array_equal(keep, want[lo:hi] & mine)
        times[lo:hi] += keep
        covered[lo:hi] = True
    assert covered.all()
    per = n_model if layout == "tp" else 1
    np.testing.assert_array_equal(times, want * per)
    return want, C


@pytest.mark.parametrize("case", list(CASES))
def test_moe_block_on_mesh_matches_jax(on_mesh, case):
    """Every rank's output (gathered) against the JAX package's
    ``moe_block`` on the same numpy inputs, and the weights were sharded
    as the layout says."""
    layout, res = on_mesh
    want = _jax_moe_block(case, CASES[case])
    for r in res:
        assert str(r[f"{case}/layout"]) == layout
        np.testing.assert_allclose(r[f"{case}/y"], want, **MOE_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_kept_set_equals_the_reference(on_mesh, case):
    """The kept set each rank's ``moe_block`` call ran, put together, is the
    reference's bit for bit (its global capacity, its first-come order);
    the ``tight`` case drops, the ``decode`` case has one slot an
    expert."""
    layout, res = on_mesh
    want, C = _check_kept_set(res, case, CASES[case], layout)
    if case == "tight":
        assert not want.all()
    if case == "decode":
        assert C == 1


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_equal_no_mesh(on_mesh, case):
    """The gradient of x and of every parameter leaf (gathered) equals the
    port's without a mesh at rtol 1e-4, and keeps its input's
    placements."""
    _, res = on_mesh
    y, grads = _no_mesh(case)
    for r in res:
        np.testing.assert_allclose(r[f"{case}/y"], y, **MOE_TOL)
        for i, g in enumerate(grads):
            np.testing.assert_allclose(
                r[f"{case}/g{i}"], g, rtol=GRAD_RTOL,
                atol=GRAD_RTOL * np.abs(g).max(), err_msg=f"leaf {i}")
            assert bool(r[f"{case}/same_layout{i}"]), i


@pytest.mark.parametrize("case", ["tight", "decode"])
def test_collectives_of_one_moe_layer(on_mesh, case):
    """One forward of the layer (no shared expert) runs one all-gather of
    the (E,) int64 counts over the 2 batch ranks, one all-reduce of its
    (N_local, d) output over 'model', and the FSDP gathers of its four
    weights over 'data'; nothing else."""
    _, res = on_mesh
    c = CASES[case]
    n_local = c["B"] // MESH[0] * c["T"]
    for r in res:
        seen = sorted(str(s) for s in r[f"{case}/collectives"])
        counts = [s for s in seen if s.startswith("all_gather_into_tensor|"
                                                  "torch.int64")]
        assert counts == [f"all_gather_into_tensor|torch.int64|"
                          f"{MESH[0] * c['E']}"]
        assert [s for s in seen if s.startswith("all_reduce")] == \
            [f"all_reduce|torch.float32|{n_local * D}"]
        floats = [s for s in seen if s.startswith("all_gather_into_tensor|"
                                                  "torch.float32")]
        assert len(floats) == 4 and len(seen) == 6, seen


@pytest.mark.parametrize("layout", ["ep", "tp"])
@pytest.mark.parametrize("case", list(POD_CASES))
def test_pod_mesh_kept_set_and_output(on_pod_mesh, case, layout):
    """On the 2 x 2 x 2 ('pod', 'data', 'model') mesh the batch is sharded
    over two mesh dimensions (four shards): the kept set each rank's call
    ran is the reference's bit for bit, and the output equals the JAX
    package's at ``MOE_TOL``."""
    c = POD_CASES[case]
    res = on_pod_mesh
    want, C = _check_kept_set(res, case, c, layout, f"{layout}/")
    assert len({r[f"{layout}/{case}/x_local"].tobytes() for r in res}) == 4
    if case == "tight":
        assert not want.all()
    else:
        assert C == 1
    y = _jax_moe_block(case, c)
    for r in res:
        assert str(r[f"{layout}/{case}/layout"]) == layout
        np.testing.assert_allclose(r[f"{layout}/{case}/y"], y, **MOE_TOL)


@pytest.mark.parametrize("layout", ["ep", "tp"])
@pytest.mark.parametrize("case", list(POD_CASES))
def test_pod_mesh_gradients_equal_no_mesh(on_pod_mesh, case, layout):
    """On the pod mesh every gradient (gathered) equals the port's without a
    mesh at rtol 1e-4, on its input's placements."""
    _, grads = _no_mesh(case, POD_CASES[case])
    for r in on_pod_mesh:
        for i, g in enumerate(grads):
            np.testing.assert_allclose(
                r[f"{layout}/{case}/g{i}"], g, rtol=GRAD_RTOL,
                atol=GRAD_RTOL * np.abs(g).max(), err_msg=f"leaf {i}")
            assert bool(r[f"{layout}/{case}/same_layout{i}"]), i


def test_train_step_equals_no_mesh(on_mesh):
    """One train step of the layout's reduced model on the 2 x 4 mesh: the
    loss, every gradient leaf and every parameter after AdamW equal the
    same step's with plain parameters and no mesh; its experts were
    sharded by the layout."""
    layout, res = on_mesh
    for r in res:
        assert str(r["train/expert_layout"]) == layout
        np.testing.assert_allclose(r["train/loss"], r["train/loss0"],
                                   **TRAIN_TOL)
        np.testing.assert_allclose(r["train/step_loss"], r["train/loss0"],
                                   **TRAIN_TOL)
        for i in range(int(r["train/n"])):
            np.testing.assert_allclose(r[f"train/g{i}"], r[f"train/g0_{i}"],
                                       err_msg=f"grad leaf {i}", **TRAIN_TOL)
            np.testing.assert_allclose(r[f"train/p{i}"], r[f"train/p0_{i}"],
                                       err_msg=f"param leaf {i}",
                                       **TRAIN_TOL)
            assert np.abs(r[f"train/p{i}"] - r[f"train/init{i}"]).max() \
                > 1e-4, i


def test_train_loss_equals_jax(on_mesh):
    """The mesh step's loss against the JAX package's ``train_loss`` on the
    same parameters."""
    jax = importlib.import_module("jax")
    jnp = importlib.import_module("jax.numpy")
    jreg = importlib.import_module("repro.configs.registry")
    jmodel = importlib.import_module("repro.models.model")
    layout, res = on_mesh
    jm = jmodel.build(_train_cfg(TRAIN_ARCH[layout], jreg))
    shape = jax.eval_shape(jm.init, jax.random.key(0))
    r0 = res[0]
    n = len(jax.tree.leaves(shape))
    assert n == int(r0["train/n"])
    jparams = jax.tree.unflatten(jax.tree.structure(shape),
                                 [jnp.asarray(r0[f"train/init{i}"])
                                  for i in range(n)])
    want = float(jm.train_loss(jparams, {"tokens": jnp.asarray(
        _tokens().astype(np.int32))}))
    for r in res:
        np.testing.assert_allclose(float(r["train/loss"]), want, rtol=1e-4)


def test_adamw_8bit_on_dtensors(on_mesh):
    """8-bit moments of a DTensor parameter hold the blocks of each rank's
    shard: where those are the reference's blocks (``a``) two steps equal
    the plain ones; where a block would straddle two shards (``b``) the
    step differs by the quantization only."""
    _, res = on_mesh
    for r in res:
        assert tuple(r["adamw8/a_blocks"]) == (1 * 2 * 512 // 256, 256)
        np.testing.assert_allclose(r["adamw8/a"], r["adamw8/a0"],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r["adamw8/b"], r["adamw8/b0"], atol=1e-3)
        for k in ("a", "b"):
            assert np.abs(r[f"adamw8/{k}"] - r[f"adamw8/{k}_init"]).max() \
                > 1e-2, k


def test_remat_recompute_in_another_thread_keeps_the_mesh(tmp_path):
    """A card's backward runs in the autograd engine's own thread, where the
    caller's ``use_mesh`` is not set: a layer under ``maybe_remat`` must
    recompute under its mesh there too (``moe_block`` would otherwise take
    its plain path on DTensors).  The backward runs in a new thread here."""
    import threading

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import layers

    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        c = CASES["tight"]
        cfg = _layer_cfg(c)
        p, x, cot = _layer_inputs("tight")
        params = {"moe": _torch_tree(p)}
        dp = partition.distribute(
            params, partition.param_shardings(params, mesh), mesh)["moe"]
        leaves = [t.requires_grad_() for t in tree.leaves(dp)]
        inputs = {"x": torch.from_numpy(x), "cot": torch.from_numpy(cot)}
        di = partition.distribute(
            inputs, partition.batch_shardings(inputs, mesh, c["B"]), mesh)
        dx = di["x"].requires_grad_()
        got = {}
        with context.use_mesh(mesh):
            y = layers.maybe_remat(
                lambda a, q: tmoe.moe_block(q, a, cfg,
                                            capacity_factor=c["cf"]),
                "full")(dx, dp)
            loss = (y * di["cot"]).sum()

        def backward():
            try:
                got["grads"] = torch.autograd.grad(loss, [dx] + leaves)
            except Exception as e:          # surfaced below
                got["error"] = e

        t = threading.Thread(target=backward)
        t.start()
        t.join(60)
        assert "error" not in got, got.get("error")
        _, want = _no_mesh("tight")
        for i, (g, w) in enumerate(zip(got["grads"], want)):
            np.testing.assert_allclose(g.full_tensor().numpy(), w,
                                       rtol=GRAD_RTOL,
                                       atol=GRAD_RTOL * np.abs(w).max(),
                                       err_msg=f"leaf {i}")
    finally:
        dist.destroy_process_group()


def test_nested_use_mesh_keeps_implicit_replication(tmp_path):
    """``use_mesh`` inside ``use_mesh`` (a remat recompute enters one)
    leaves DTensor's implicit replication on for the rest of the outer
    one: a plain tensor still meets a DTensor after it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        d = DTensor.from_local(torch.ones(4), mesh, [Replicate()] * 2)
        with context.use_mesh(mesh):
            with context.use_mesh(mesh):
                inner = d * torch.full((4,), 2.0)
            outer = d * torch.full((4,), 3.0)
            assert context.current_mesh() is mesh
        assert isinstance(inner, DTensor) and isinstance(outer, DTensor)
        assert outer.full_tensor().tolist() == [3.0] * 4
        with pytest.raises(RuntimeError, match="mixed"):
            d * torch.full((4,), 3.0)
    finally:
        dist.destroy_process_group()


def test_use_mesh_in_another_thread_inside_an_open_one(tmp_path):
    """A ``use_mesh`` opened and closed in another thread while this
    thread's is open (a card's backward recomputing a remat layer) has
    implicit replication in that thread, leaves it off there once it
    closes, and leaves it on in this one until this one closes."""
    import threading

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        d = DTensor.from_local(torch.ones(4), mesh, [Replicate()] * 2)
        got = {}

        def inner():
            try:
                with context.use_mesh(mesh):
                    got["inner"] = (d * torch.full((4,), 2.0)).full_tensor()
                with pytest.raises(RuntimeError, match="mixed"):
                    d * torch.full((4,), 2.0)
            except BaseException as e:      # surfaced below
                got["error"] = e

        with context.use_mesh(mesh):
            t = threading.Thread(target=inner)
            t.start()
            t.join(60)
            outer = d * torch.full((4,), 3.0)
        assert "error" not in got, got.get("error")
        assert got["inner"].tolist() == [2.0] * 4
        assert outer.full_tensor().tolist() == [3.0] * 4
        with pytest.raises(RuntimeError, match="mixed"):
            d * torch.full((4,), 3.0)
    finally:
        dist.destroy_process_group()
