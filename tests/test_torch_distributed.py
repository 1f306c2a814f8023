"""The port's distributed layer on the CPU: the Shared-PIM rings
(``core/overlap/sharedbus.py``), the collective matmuls, the compressed
all-reduce, the pipeline and the compressed 'pod' train step, each run in
spawned processes over gloo (a ``FileStore`` in ``tmp_path``, so ranks
never share a port); and the sharding rules against the JAX package's.

Shapes are those of ``tests/distributed/check_overlap.py`` and
``check_pipeline.py``; tolerances: the collective matmuls against the
unsharded product at 1e-5 (all-gather) and 1e-4 (reduce-scatter, a
reassociated sum), the pipeline against the sequential oracle at 1e-5, the
compressed mean and error against the reference's formula replayed rank
by rank with the JAX quantizer at 1e-6 relative.  Every process group has
a 60 s timeout and every child is joined with a time limit, so a
deadlocked ring fails its test instead of hanging the suite.  JAX is
imported inside the tests that compare with it, so the children import
only the port.
"""

import dataclasses
import datetime
import importlib
import multiprocessing as mp
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.configs import registry as treg
from repro_torch.core.overlap import collective_matmul as cm
from repro_torch.core.overlap import compression, sharedbus
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw
from repro_torch.sharding import context, partition
from repro_torch.train import pipeline as tpipe
from repro_torch.train import train_step as ts

GROUP_TIMEOUT = datetime.timedelta(seconds=60)
JOIN_S = 50
B, T, D, FF = 2, 64, 32, 48                 # check_overlap.py's shapes
N_STAGES, N_MICRO, MB, DP = 4, 6, 2, 16     # check_pipeline.py's
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


# ---- spawning ranks ---------------------------------------------------------

def _child(target, rank, world, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    try:
        result = target(rank, world)
        np.savez(f"{out}/rank{rank}.npz", **result)
    finally:
        dist.destroy_process_group()


def _spawn(target, world, tmp_path) -> list[dict]:
    """Run ``target(rank, world)`` on ``world`` gloo ranks; each returns a
    dict of arrays.  A rank still running after ``JOIN_S`` is killed and
    the test fails."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(target, r, world,
                                              str(tmp_path / "store"),
                                              str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"exit codes {codes}"
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


# ---- the 8-rank job: rings, collective matmuls, compressed all-reduce -------

def _overlap_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    w1 = rng.normal(size=(D, FF)).astype(np.float32)
    w2 = rng.normal(size=(FF, D)).astype(np.float32)
    h = rng.normal(size=(B, T, FF)).astype(np.float32)
    g = rng.normal(size=(8, 128)).astype(np.float32)
    return x, w1, w2, h, g


def _ring_record(x, group, **kw):
    def consume(acc, chunk, src):
        return acc + [(src, chunk.clone())]

    if kw.pop("bidirectional", False):
        steps = sharedbus.bidirectional_stream(x, group, consume, [])
        return (np.array([s for s, _ in steps]),
                np.stack([c.numpy() for _, c in steps]))
    steps = sharedbus.stream_ring(x, group, consume, [], **kw)
    return (np.array([s for s, _ in steps]),
            np.stack([c.numpy() for _, c in steps]))


def _job_overlap(rank, world):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    group = mesh.get_group("model")
    x, w1, w2, h, g = (torch.from_numpy(a) for a in _overlap_inputs())
    t, f = T // world, FF // world
    xs, w1s = x[:, rank * t:(rank + 1) * t], w1[:, rank * f:(rank + 1) * f]
    hs, w2s = h[:, :, rank * f:(rank + 1) * f], w2[rank * f:(rank + 1) * f]
    out = {"ag": cm.ag_matmul(xs, w1s, mesh).numpy(),
           "rs": cm.matmul_rs(hs, w2s, mesh).numpy(),
           "ffn": cm.overlapped_ffn(xs, w1s, w1s, w2s, mesh, F.silu).numpy(),
           "x_local": xs.numpy().copy()}
    chunk = torch.full((4, 3), float(rank)) + torch.arange(12.).reshape(4, 3)
    for name, kw in (("fwd", {}), ("rev", {"reverse": True}),
                     ("bi", {"bidirectional": True})):
        out[f"{name}_src"], out[f"{name}_chunks"] = _ring_record(
            chunk, group, **kw)
    out["chunk_unchanged"] = np.array(torch.equal(
        chunk, torch.full((4, 3), float(rank)) + torch.arange(12.).reshape(
            4, 3)))

    # the compressed all-reduce: record what rides the link
    gathered = []
    real = dist.all_gather

    def recording(tensors, tensor, group=None, async_op=False):
        res = real(tensors, tensor, group=group, async_op=async_op)
        gathered.append([t.clone() for t in tensors])
        return res

    dist.all_gather = recording
    try:
        gl = g[rank:rank + 1]
        mean, err = compression.psum_compressed(gl, torch.zeros_like(gl),
                                                group)
    finally:
        dist.all_gather = real
    out.update(mean=mean.numpy(), err=err.numpy(),
               codes_on_link=torch.stack(gathered[0]).numpy(),
               scales_on_link=torch.stack(gathered[1]).numpy())
    # error feedback: the mean of 64 quantized streams -> the true mean
    acc, e = torch.zeros_like(gl), torch.zeros_like(gl)
    for _ in range(64):
        m, e = compression.psum_compressed(gl, e, group)
        acc += m
    out["ef_mean"] = (acc / 64).numpy()
    # constrain: a DTensor is redistributed to the cleaned spec
    from torch.distributed.tensor import Replicate, distribute_tensor

    full = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    dt = distribute_tensor(full, mesh, [Replicate()])
    plain = torch.ones(3)
    with context.use_mesh(mesh):
        got = context.constrain(dt, ("pod", "data"), "model")
        out["constrain_plain_same"] = np.array(
            context.constrain(plain, "model") is plain)
    out["constrain_local"] = got.to_local().numpy()
    out["constrain_full"] = got.full_tensor().numpy()
    out["constrain_shard_dim"] = np.array(got.placements[0].dim)
    return out


@pytest.fixture(scope="module")
def overlap_run(tmp_path_factory):
    return _spawn(_job_overlap, 8, tmp_path_factory.mktemp("overlap"))


def test_ag_matmul_equals_unsharded(overlap_run):
    x, w1, *_ = _overlap_inputs()
    want = x @ w1
    for r, res in enumerate(overlap_run):
        np.testing.assert_allclose(res["ag"], want[:, :, r * 6:(r + 1) * 6],
                                   rtol=1e-5, atol=1e-5)


def test_matmul_rs_equals_unsharded(overlap_run):
    _, _, w2, h, _ = _overlap_inputs()
    want = h @ w2
    for r, res in enumerate(overlap_run):
        np.testing.assert_allclose(res["rs"], want[:, r * 8:(r + 1) * 8],
                                   rtol=1e-4, atol=1e-4)


def test_overlapped_ffn_equals_unsharded(overlap_run):
    x, w1, w2, *_ = _overlap_inputs()
    a = torch.from_numpy(x @ w1)
    want = ((F.silu(a) * a).numpy() @ w2)
    for r, res in enumerate(overlap_run):
        np.testing.assert_allclose(res["ffn"], want[:, r * 8:(r + 1) * 8],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name, shift", [("fwd", 1), ("rev", -1)])
def test_stream_ring_visits_every_chunk_in_order(overlap_run, name, shift):
    """Step i consumes the chunk of rank (me - i * shift) mod n, unchanged,
    and the caller's chunk is never written."""
    n = len(overlap_run)
    chunks = [res[f"{name}_chunks"][0] for res in overlap_run]
    for me, res in enumerate(overlap_run):
        srcs = [(me - i * shift) % n for i in range(n)]
        np.testing.assert_array_equal(res[f"{name}_src"], srcs)
        for i, src in enumerate(srcs):
            np.testing.assert_array_equal(res[f"{name}_chunks"][i],
                                          chunks[src])
        assert res["chunk_unchanged"]


def test_bidirectional_stream(overlap_run):
    n = len(overlap_run)
    chunks = [res["bi_chunks"][0] for res in overlap_run]
    for me, res in enumerate(overlap_run):
        for i in range(n):
            sf, sb = (me - i) % n, (me + i) % n
            np.testing.assert_array_equal(res["bi_src"][i], [sf, sb])
            np.testing.assert_array_equal(res["bi_chunks"][i][:2],
                                          chunks[sf][:2])
            np.testing.assert_array_equal(res["bi_chunks"][i][2:],
                                          chunks[sb][2:])


def test_psum_compressed_codes_equal_jax_quantize(overlap_run):
    """The int8 codes and float32 scales on the link, byte for byte."""
    jnp = importlib.import_module("jax.numpy")
    jcomp = importlib.import_module("repro.core.overlap.compression")
    *_, g = _overlap_inputs()
    for res in overlap_run:
        for r in range(len(overlap_run)):
            codes, scale = jcomp.quantize(jnp.asarray(g[r:r + 1]))
            np.testing.assert_array_equal(res["codes_on_link"][r],
                                          np.asarray(codes))
            np.testing.assert_array_equal(res["scales_on_link"][r],
                                          np.asarray(scale))


def test_psum_compressed_equals_the_reference_formula(overlap_run):
    """Mean and new error against the reference's ``psum_compressed``
    replayed rank by rank with the JAX quantizer, at 1e-6 relative."""
    jnp = importlib.import_module("jax.numpy")
    jcomp = importlib.import_module("repro.core.overlap.compression")
    *_, g = _overlap_inputs()
    n = len(overlap_run)
    q = [jcomp.quantize(jnp.asarray(g[r:r + 1])) for r in range(n)]
    summed = jnp.einsum("rnb,rn->nb",
                        jnp.stack([c for c, _ in q]).astype(jnp.float32),
                        jnp.stack([s for _, s in q]))
    want_mean = np.asarray((summed / n).reshape(-1)[:128].reshape(1, 128))
    atol = 1e-6 * np.abs(g).max()
    for r, res in enumerate(overlap_run):
        np.testing.assert_allclose(res["mean"], want_mean, rtol=1e-6,
                                   atol=atol)
        want_err = g[r:r + 1] - np.asarray(jcomp.dequantize(
            *q[r], (1, 128), jnp.float32))
        np.testing.assert_allclose(res["err"], want_err, rtol=1e-6,
                                   atol=atol)
        # every rank's mean equals the global mean up to int8 quantization
        np.testing.assert_allclose(res["mean"][0], g.mean(0), rtol=0.05,
                                   atol=0.05)
        # error feedback converges to the true mean (check_overlap.py's)
        np.testing.assert_allclose(res["ef_mean"][0], g.mean(0), rtol=2e-3,
                                   atol=2e-3)


def test_constrain_redistributes_a_dtensor(overlap_run):
    """Under a 1-D 'model' mesh, ('pod', 'data') drops out and 'model'
    shards dim 1; a plain tensor passes through."""
    full = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    for r, res in enumerate(overlap_run):
        assert int(res["constrain_shard_dim"]) == 1
        np.testing.assert_array_equal(res["constrain_local"],
                                      full[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(res["constrain_full"], full)
        assert res["constrain_plain_same"]


# ---- the pipeline on 4 ranks ------------------------------------------------

def _pipe_inputs():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(N_STAGES, DP, DP)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(N_STAGES, DP)) * 0.1).astype(np.float32)
    xs = rng.normal(size=(N_MICRO, MB, DP)).astype(np.float32)
    return w, b, xs


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _job_pipeline(rank, world):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pipe",))
    w, b, xs = (torch.from_numpy(a) for a in _pipe_inputs())
    calls = []

    def f(p, x):
        calls.append(1)
        return _stage_fn(p, x)

    out = tpipe.pipeline(f, {"w": w[rank], "b": b[rank]}, xs, mesh)
    return {"out": out.numpy(), "calls": np.array(len(calls))}


def test_pipeline_equals_sequential(tmp_path):
    """4 stages x 6 microbatches against the sequential oracle at 1e-5;
    each stage computes each microbatch once."""
    res = _spawn(_job_pipeline, N_STAGES, tmp_path)
    w, b, xs = _pipe_inputs()
    want = torch.from_numpy(xs)
    for s in range(N_STAGES):
        want = _stage_fn({"w": torch.from_numpy(w[s]),
                          "b": torch.from_numpy(b[s])}, want)
    for r in res:
        np.testing.assert_allclose(r["out"], want.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert int(r["calls"]) == N_MICRO


# ---- the compressed 'pod' train step on 2 ranks -----------------------------

POD_OPT = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, grad_clip=0.0,
                            eps=1e-3)


def _pod_batch(rank, world):
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (4, 32)).astype(np.int64)
    per = tokens.shape[0] // world
    return {"tokens": tokens[rank * per:(rank + 1) * per]}


def _job_pod_step(rank, world):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
    cfg = dataclasses.replace(treg.get("granite-3-2b").reduced(),
                              dtype="float32")
    model = tmodel.build(cfg, "cpu")
    settings = ts.TrainSettings(compress_pod_grads=True)
    batch = _pod_batch(rank, world)
    state = ts.make_train_state(model, POD_OPT,
                                torch.Generator().manual_seed(0), settings)
    init = [p.clone() for p in tree.leaves(state["params"])]
    state, metrics = ts.make_train_step(model, POD_OPT, settings, mesh)(
        state, batch)
    # the same step with the gradients averaged uncompressed
    ref = ts.make_train_state(model, POD_OPT,
                              torch.Generator().manual_seed(0))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, grads = ts._loss_and_grads(model, ref["params"], tb, 1)
    for t in [loss, *tree.leaves(grads)]:
        dist.all_reduce(t)
        t.div_(world)
    adamw.apply_updates(POD_OPT, ref["params"], grads, ref["opt"])
    # |mean of dequantized - mean of true| <= mean over ranks of |residual|
    bound = [e.abs().float() for e in tree.leaves(state["grad_err"])]
    for t in bound:
        dist.all_reduce(t)
        t.div_(world)
    out = {"loss": metrics["loss"].numpy(), "loss_ref": loss.numpy(),
           "step": state["step"].numpy()}
    for i, (p, q, e, p0) in enumerate(zip(tree.leaves(state["params"]),
                                          tree.leaves(ref["params"]), bound,
                                          init)):
        out[f"p{i}"], out[f"q{i}"], out[f"e{i}"] = p.numpy(), q.numpy(), \
            e.numpy()
        out[f"moved{i}"] = np.array(not torch.equal(p, p0))
    out["n"] = np.array(len(bound))
    return out


def test_compressed_pod_step_matches_the_uncompressed_one(tmp_path):
    """Loss equal; every parameter within the int8 error: Adam's first
    step moves p by lr * g / (|g| + eps), which is 1/eps-Lipschitz in g,
    so |p - p_ref| <= lr * |g_hat - g| / eps, and |g_hat - g| is at most
    the ranks' mean |residual| (the error-feedback state)."""
    res = _spawn(_job_pod_step, 2, tmp_path)
    for r in res:
        assert float(r["loss"]) == float(r["loss_ref"])
        assert int(r["step"]) == 1
        for i in range(int(r["n"])):
            diff = np.abs(r[f"p{i}"] - r[f"q{i}"])
            lim = POD_OPT.lr * r[f"e{i}"] / POD_OPT.eps + 1e-6
            assert (diff <= lim).all(), (i, diff.max())
            assert r[f"moved{i}"], i
        # some residual is nonzero: the codes did lose precision
        assert any(np.abs(r[f"e{i}"]).max() > 0 for i in range(int(r["n"])))
    for i in range(int(res[0]["n"])):
        np.testing.assert_array_equal(res[0][f"p{i}"], res[1][f"p{i}"])


def test_pod_step_raises_without_a_pod_mesh():
    """The state is built with its error feedback (the reference's
    ``make_train_state`` needs no mesh); the step refuses."""
    tm = tmodel.build(treg.get("granite-3-2b").reduced(), "cpu")
    settings = ts.TrainSettings(compress_pod_grads=True)
    state = ts.make_train_state(tm, POD_OPT, torch.Generator().manual_seed(0),
                                settings)
    assert "grad_err" in state
    for e, p in zip(tree.leaves(state["grad_err"]),
                    tree.leaves(state["params"])):
        assert e.shape == p.shape and not e.any()
    with pytest.raises(ValueError, match="pod"):
        ts.make_train_step(tm, POD_OPT, settings, mesh=None)


# ---- sharding rules against the JAX package ---------------------------------

def _abstract(build):
    """What ``build()`` makes, as tensors without storage (full width costs
    nothing: llama4-maverick has 400 B parameters)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return build()


def _jax_specs(tree_shape, spec_fn):
    jax = importlib.import_module("jax")
    out = []

    def visit(path, leaf):
        key = "/" + "/".join(str(e.key) for e in path)
        out.append((key, tuple(spec_fn(path, leaf.shape))))
        return leaf

    jax.tree_util.tree_map_with_path(visit, tree_shape)
    return out


def _jax_mesh(sizes):
    jax = importlib.import_module("jax")
    devs = np.array(jax.devices() * int(np.prod(list(sizes.values()))))
    return jax.sharding.Mesh(devs.reshape(tuple(sizes.values())),
                             tuple(sizes))


def _jax_model(arch):
    jax = importlib.import_module("jax")
    jreg = importlib.import_module("repro.configs.registry")
    jmodel = importlib.import_module("repro.models.model")
    return jax, jmodel.build(jreg.get(arch))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(treg.ARCHS))
def test_param_spec_equals_jax(arch, mesh_name):
    sizes = MESHES[mesh_name]
    jpart = importlib.import_module("repro.sharding.partition")
    jax, jm = _jax_model(arch)
    jmesh = _jax_mesh(sizes)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    want = _jax_specs(shapes,
                      lambda p, s: jpart.param_spec(p, s, jmesh))
    tm = tmodel.build(treg.get(arch), "cpu")
    params = _abstract(lambda: tm.init(torch.Generator().manual_seed(0)))
    got = [(path, partition.param_spec(path, leaf.shape, sizes))
           for path, leaf in tree.items(params)]
    assert got == want


@pytest.mark.parametrize("batch", [32, 1])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(treg.ARCHS))
def test_cache_spec_equals_jax(arch, mesh_name, batch):
    sizes = MESHES[mesh_name]
    jpart = importlib.import_module("repro.sharding.partition")
    jax, jm = _jax_model(arch)
    jmesh = _jax_mesh(sizes)
    shapes = jax.eval_shape(lambda: jm.init_cache(batch, 4096))
    want = _jax_specs(
        shapes, lambda p, s: jpart.cache_spec(p, s, jmesh, batch))
    tm = tmodel.build(treg.get(arch), "cpu")
    cache = _abstract(lambda: tm.init_cache(batch, 4096))
    got = [(path, partition.cache_spec(path, tuple(getattr(leaf, "shape", ())),
                                       sizes, batch))
           for path, leaf in tree.items(cache)]
    assert got == want


@pytest.mark.parametrize("moe_tp", ["", "1"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_tp_rule_equals_jax(arch, moe_tp, monkeypatch):
    """``REPRO_MOE_TP`` forces TP on the ffn dim in both packages."""
    monkeypatch.setenv("REPRO_MOE_TP", moe_tp)
    test_param_spec_equals_jax(arch, "16x16")


@pytest.mark.parametrize("mesh_name", list(MESHES) + ["model-only"])
def test_batch_and_activation_specs_equal_jax(mesh_name):
    jpart = importlib.import_module("repro.sharding.partition")
    sizes = MESHES.get(mesh_name, {"model": 8})
    jmesh = _jax_mesh(sizes)
    assert partition.batch_axes(sizes) == jpart.batch_axes(jmesh)
    for gb in (1, 16, 32, 256, 48):
        assert partition.batch_spec(sizes, gb) == tuple(
            jpart.batch_spec(jmesh, gb)), gb
    assert partition.activation_spec(sizes) == tuple(
        jpart.activation_spec(jmesh))


def test_specs_from_a_device_mesh_equal_the_mapping():
    """A ``DeviceMesh`` is read as its dimension names and sizes (a fake
    one: no process group is needed for the rules)."""
    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    path = "/blocks/mlp/wi_gate"
    assert partition.param_spec(path, (40, 2048, 8192), Mesh()) == \
        partition.param_spec(path, (40, 2048, 8192), MESHES["2x16x16"]) == \
        (None, "data", "model")
    assert partition.param_spec(("blocks", "mlp", "wi_gate"),
                                (40, 2048, 8192), Mesh()) == \
        (None, "data", "model")


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    sizes = MESHES["2x16x16"]
    assert partition.to_placements((("pod", "data"), None, "model"),
                                   sizes) == (Shard(0), Shard(0), Shard(2))
    assert partition.to_placements((None, "data"), sizes) == (
        Replicate(), Shard(1), Replicate())
    assert partition.to_placements((), sizes) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="twice"):
        partition.to_placements(("data", "data"), sizes)


def test_constrain_without_a_mesh_is_the_identity():
    x = torch.ones(4)
    assert context.current_mesh() is None
    assert context.constrain(x, "data") is x
    with context.use_mesh(MESHES["16x16"]) as m:
        assert context.current_mesh() is m
        assert context.constrain(x, "data") is x       # a plain tensor
    assert context.current_mesh() is None
