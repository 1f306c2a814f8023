"""The port's model under a ``DeviceMesh`` on the CPU: gradients through
the Shared-PIM rings, ``matmul_rs`` and the pipeline (spawned gloo ranks,
float64, against the unsharded product and the sequential stack at rtol
1e-4), the partition trees, and one train step of a reduced glm4 on a
2 x 4 ``("data", "model")`` mesh through ``overlapped_ffn`` (the reference's
``tests/distributed/check_overlap_train.py`` configuration), held to the
same step with plain parameters and no mesh, and to the JAX package's
loss.

Ranks are spawned as ``tests/test_torch_distributed.py`` spawns them: every
group has a 60 s timeout and every child is joined within a time limit.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.configs import registry as treg
from repro_torch.core.overlap import collective_matmul as cm
from repro_torch.core.overlap import sharedbus
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw
from repro_torch.sharding import context, partition
from repro_torch.train import pipeline as tpipe
from repro_torch.train import train_step as ts
from test_torch_distributed import _spawn

GRAD_RTOL = 1e-4
B, T, D, FF = 2, 16, 8, 12
N_STAGES, N_MICRO, MB, DP = 4, 6, 2, 8


# ---- gradients through the rings and the pipeline ---------------------------

def _ring_inputs():
    rng = np.random.default_rng(1)
    return {k: rng.normal(size=s) for k, s in (
        ("x", (B, T, D)), ("wg", (D, FF)), ("wu", (D, FF)), ("wo", (FF, D)),
        ("h", (B, T, FF)), ("g_ag", (B, T, FF)), ("g_rs", (B, T, D)))}


def _local_grads(fn, *inputs):
    ins = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
           for a in inputs]
    out, cot = fn(*ins)
    grads = torch.autograd.grad((out * cot).sum(), ins)
    return out.detach(), grads


def _job_ring_grads(rank, world):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    group = mesh.get_group("model")
    a = _ring_inputs()
    t, f = T // world, FF // world
    ts_, fs = slice(rank * t, (rank + 1) * t), slice(rank * f, (rank + 1) * f)
    g_ag = torch.from_numpy(a["g_ag"][:, :, fs])
    g_rs = torch.from_numpy(a["g_rs"][:, ts_])
    out = {}
    works_before = []
    real = sharedbus.shift_start

    def counting(*args, **kw):
        res = real(*args, **kw)
        works_before.append(len(res))
        return res

    sharedbus.shift_start = counting
    try:
        _, (out["ag_dx"], out["ag_dw"]) = _local_grads(
            lambda x, w: (cm.ag_matmul_body(x, w, group), g_ag),
            a["x"][:, ts_], a["wg"][:, fs])
        _, (out["rs_dx"], out["rs_dw"]) = _local_grads(
            lambda h, w: (cm.matmul_rs_body(h, w, group), g_rs),
            a["h"][:, :, fs], a["wo"][fs])
        y, (out["ffn_dx"], out["ffn_dwg"], out["ffn_dwu"],
            out["ffn_dwo"]) = _local_grads(
            lambda x, wg, wu, wo: (cm.overlapped_ffn(x, wg, wu, wo, mesh,
                                                     F.silu), g_rs),
            a["x"][:, ts_], a["wg"][:, fs], a["wu"][:, fs], a["wo"][fs])
    finally:
        sharedbus.shift_start = real
    out["ffn_y"] = y
    out["handoffs"] = np.array(sum(works_before))
    return {k: np.asarray(v) for k, v in out.items()}


def _unsharded_grads():
    a = _ring_inputs()

    def grads(fn, names, cot):
        ins = [torch.from_numpy(a[n]).requires_grad_() for n in names]
        y = fn(*ins)
        return y, torch.autograd.grad((y * torch.from_numpy(a[cot])).sum(),
                                      ins)

    _, (gx_ag, gw_ag) = grads(lambda x, w: x @ w, ["x", "wg"], "g_ag")
    _, (gh_rs, gw_rs) = grads(lambda h, w: h @ w, ["h", "wo"], "g_rs")
    y, (gx, gwg, gwu, gwo) = grads(
        lambda x, wg, wu, wo: (F.silu(x @ wg) * (x @ wu)) @ wo,
        ["x", "wg", "wu", "wo"], "g_rs")
    return {"ffn_dx": gx, "ffn_dwg": gwg, "ffn_dwu": gwu, "ffn_dwo": gwo,
            "ag_dx": gx_ag, "ag_dw": gw_ag, "rs_dx": gh_rs, "rs_dw": gw_rs,
            "ffn_y": y}


@pytest.mark.parametrize("world", [2, 4])
def test_ring_gradients_equal_unsharded(world, tmp_path):
    """x and w gradients of ``ag_matmul_body``, ``matmul_rs_body`` and
    ``overlapped_ffn`` on each rank equal the unsharded product's at the
    rank's chunk, in float64; the rings did hand chunks on."""
    res = _spawn(_job_ring_grads, world, tmp_path)
    want = {k: v.detach().numpy() for k, v in _unsharded_grads().items()}
    t, f = T // world, FF // world
    for r, got in enumerate(res):
        ts_, fs = slice(r * t, (r + 1) * t), slice(r * f, (r + 1) * f)
        chunks = {"ag_dx": (slice(None), ts_), "ag_dw": (slice(None), fs),
                  "rs_dx": (slice(None), slice(None), fs), "rs_dw": (fs,),
                  "ffn_dx": (slice(None), ts_),
                  "ffn_dwg": (slice(None), fs), "ffn_dwu": (slice(None), fs),
                  "ffn_dwo": (fs,), "ffn_y": (slice(None), ts_)}
        for name, idx in chunks.items():
            np.testing.assert_allclose(got[name], want[name][idx],
                                       rtol=GRAD_RTOL, atol=1e-10,
                                       err_msg=f"rank {r} {name}")
        assert int(got["handoffs"]) > 0


def _pipe_inputs():
    rng = np.random.default_rng(2)
    return (rng.normal(size=(N_STAGES, DP, DP)) * 0.3,
            rng.normal(size=(N_STAGES, DP)) * 0.1,
            rng.normal(size=(N_MICRO, MB, DP)),
            rng.normal(size=(N_MICRO, MB, DP)))


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _job_pipeline_grads(rank, world):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pipe",))
    w, b, xs, cot = (torch.from_numpy(a) for a in _pipe_inputs())
    p = {"w": w[rank].clone().requires_grad_(),
         "b": b[rank].clone().requires_grad_()}
    xs = xs.clone().requires_grad_()
    out = tpipe.pipeline(_stage_fn, p, xs, mesh)
    dw, db, dx = torch.autograd.grad((out * cot).sum(),
                                     [p["w"], p["b"], xs], allow_unused=True)
    return {"out": out.detach().numpy(), "dw": dw.numpy(), "db": db.numpy(),
            "dx": (np.zeros(0) if dx is None else dx.numpy())}


def test_pipeline_gradients_equal_sequential(tmp_path):
    """Each stage's parameter gradients, and stage 0's input gradient,
    equal the sequential stack's in float64 (4 stages, 6 microbatches)."""
    res = _spawn(_job_pipeline_grads, N_STAGES, tmp_path)
    w, b, xs, cot = (torch.from_numpy(a) for a in _pipe_inputs())
    ps = [{"w": w[s].clone().requires_grad_(),
           "b": b[s].clone().requires_grad_()} for s in range(N_STAGES)]
    x0 = xs.clone().requires_grad_()
    y = x0
    for p in ps:
        y = _stage_fn(p, y)
    leaves = [t for p in ps for t in (p["w"], p["b"])] + [x0]
    grads = torch.autograd.grad((y * cot).sum(), leaves)
    for s, r in enumerate(res):
        np.testing.assert_allclose(r["out"], y.detach().numpy(), rtol=1e-12)
        np.testing.assert_allclose(r["dw"], grads[2 * s].numpy(),
                                   rtol=GRAD_RTOL, atol=1e-12)
        np.testing.assert_allclose(r["db"], grads[2 * s + 1].numpy(),
                                   rtol=GRAD_RTOL, atol=1e-12)
    np.testing.assert_allclose(res[0]["dx"], grads[-1].numpy(),
                               rtol=GRAD_RTOL, atol=1e-12)


# ---- the model under a 2 x 4 mesh (check_overlap_train.py's configuration) --

OVERLAP_TOL = dict(rtol=1e-4, atol=1e-4)   # overlapped_ffn's, as elsewhere
# a large first step, so the parameters after it move by far more than the
# tolerance; eps keeps Adam's first step (g / (|g| + eps)) Lipschitz in g,
# so gradients equal to 1e-4 give parameters equal to it
OPT = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-2,
                        grad_clip=0.0)


def _overlap_cfg(overlap="shared_bus", cfg_registry=treg):
    return dataclasses.replace(
        cfg_registry.get("glm4-9b").reduced(), d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, overlap=overlap, constrain_activations=True,
        dtype="float32")


def _overlap_tokens():
    return np.random.default_rng(0).integers(0, 256, (8, 32)).astype(
        np.int64)


def _job_mesh_train(rank, world):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    cfg = _overlap_cfg()
    model = tmodel.build(cfg, "cpu")
    plain_model = tmodel.build(dataclasses.replace(cfg, overlap="none"),
                               "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    init = [p.clone() for p in tree.leaves(params)]
    batch = {"tokens": torch.from_numpy(_overlap_tokens())}
    loss0, grads0 = ts._loss_and_grads(plain_model, params, batch, 1)

    handoffs = []
    real = sharedbus.shift_start

    def counting(*args, **kw):
        res = real(*args, **kw)
        handoffs.append(len(res))
        return res

    dparams = partition.distribute(
        params, partition.param_shardings(params, mesh), mesh)
    dbatch = partition.distribute(
        batch, partition.batch_shardings(batch, mesh, 8), mesh)
    sharedbus.shift_start = counting
    try:
        with context.use_mesh(mesh):
            loss, grads = ts._loss_and_grads(model, dparams, dbatch, 1)
            state = {"params": dparams, "opt": adamw.init_state(OPT, dparams),
                     "step": torch.zeros((), dtype=torch.int32)}
            state, metrics = ts.make_train_step(model, OPT)(state, dbatch)
    finally:
        sharedbus.shift_start = real
    plain = {"params": params, "opt": adamw.init_state(OPT, params),
             "step": torch.zeros((), dtype=torch.int32)}
    plain, pmetrics = ts.make_train_step(plain_model, OPT)(plain, batch)
    out = {"loss": loss.full_tensor().numpy(), "loss0": loss0.numpy(),
           "step_loss": metrics["loss"].full_tensor().numpy(),
           "handoffs": np.array(sum(handoffs)),
           "local_embed": np.array(
               dparams["embed"].to_local().shape)}
    for i, (g, g0) in enumerate(zip(tree.leaves(grads), tree.leaves(grads0))):
        out[f"g{i}"], out[f"g0_{i}"] = g.full_tensor().numpy(), g0.numpy()
    for i, (p, p0) in enumerate(zip(tree.leaves(state["params"]),
                                    tree.leaves(plain["params"]))):
        out[f"p{i}"], out[f"p0_{i}"] = p.full_tensor().numpy(), p0.numpy()
        out[f"init{i}"] = init[i].numpy()
    out["n"] = np.array(len(tree.leaves(grads)))
    return out


@pytest.fixture(scope="module")
def mesh_train(tmp_path_factory):
    return _spawn(_job_mesh_train, 8, tmp_path_factory.mktemp("mesh"))


def test_overlap_train_equals_no_mesh(mesh_train):
    """The loss, every gradient leaf and the parameters after one AdamW
    step under the 2 x 4 mesh through ``overlapped_ffn`` equal the same
    step's with plain parameters, ``overlap="none"`` and no mesh; rings
    handed chunks on, and the parameters were sharded."""
    for r in mesh_train:
        np.testing.assert_allclose(r["loss"], r["loss0"], **OVERLAP_TOL)
        np.testing.assert_allclose(r["step_loss"], r["loss0"],
                                   **OVERLAP_TOL)
        for i in range(int(r["n"])):
            np.testing.assert_allclose(r[f"g{i}"], r[f"g0_{i}"],
                                       err_msg=f"grad leaf {i}",
                                       **OVERLAP_TOL)
            np.testing.assert_allclose(r[f"p{i}"], r[f"p0_{i}"],
                                       err_msg=f"param leaf {i}",
                                       **OVERLAP_TOL)
            assert np.abs(r[f"p{i}"] - r[f"init{i}"]).max() > 1e-4, i
        assert int(r["handoffs"]) > 0
        # (V, d) = (256, 64) sharded 4 x 2 ('model' on V, 'data' on d)
        assert tuple(r["local_embed"]) == (64, 32)


def test_overlap_train_loss_equals_jax(mesh_train):
    """The mesh step's loss against the JAX package's single-device
    ``train_loss`` on the same parameters."""
    jax = importlib.import_module("jax")
    jnp = importlib.import_module("jax.numpy")
    jreg = importlib.import_module("repro.configs.registry")
    jmodel = importlib.import_module("repro.models.model")
    jm = jmodel.build(_overlap_cfg("none", jreg))
    shape = jax.eval_shape(jm.init, jax.random.key(0))
    r0 = mesh_train[0]
    n = len(jax.tree.leaves(shape))
    jparams = jax.tree.unflatten(jax.tree.structure(shape),
                                 [jnp.asarray(r0[f"init{i}"])
                                  for i in range(n)])
    want = float(jm.train_loss(jparams, {"tokens": jnp.asarray(
        _overlap_tokens().astype(np.int32))}))
    for r in mesh_train:
        np.testing.assert_allclose(float(r["loss"]), want, rtol=1e-4)
