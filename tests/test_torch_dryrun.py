"""The port's dry-run planner (``launch/{mesh,specs,dryrun}.py``) on the
CPU: the shapes and their skip rules, the scan groups and the input specs
against the JAX package's; the planner's collective accounting on a known
redistribute; reduced-width cells on a fake 2 x 4 mesh (argument bytes
against the partition specs) and on a mesh of one (FLOPs against
``FlopCounterMode`` over the plain step); the kernels' custom ops under
``FakeTensorMode`` against their plain versions; and the local shards of
``sharding/partition.py`` against DTensor's own.

A ``fake`` process group lives only inside a test, and is destroyed in a
``finally`` (workers are reused across test files).  JAX is imported inside
the tests that compare with it.
"""

import contextlib
import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tree
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ref
from repro_torch.launch import dryrun, specs
from repro_torch.models import model as tmodel
from repro_torch.sharding import partition


@contextlib.contextmanager
def fake_group(size):
    """A fake default process group of ``size`` ranks, this process rank
    0, torn down on exit."""
    assert not dist.is_initialized()
    dryrun.fake_world(size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape, names=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=names)


@pytest.fixture
def jdryrun(monkeypatch):
    """The reference's dry-run module; its import sets XLA_FLAGS, which is
    put back after the test."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    return importlib.import_module("repro.launch.dryrun")


# ---- shapes, groups and specs against the reference -------------------------

def test_shapes_equal_the_reference():
    jbase = importlib.import_module("repro.configs.base")
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}


@pytest.mark.parametrize("arch", treg.ARCHS)
def test_shape_applicable_and_layer_group_equal_the_reference(arch,
                                                              jdryrun):
    jbase = importlib.import_module("repro.configs.base")
    jreg = importlib.import_module("repro.configs.registry")
    cfg, jcfg = treg.get(arch), jreg.get(arch)
    for name in SHAPES:
        assert shape_applicable(cfg, SHAPES[name]) == \
            jbase.shape_applicable(jcfg, jbase.SHAPES[name]), name
    assert dryrun.layer_group(cfg) == jdryrun.layer_group(jcfg)


def _jax_leaves(x):
    jax = importlib.import_module("jax")
    out = []
    jax.tree_util.tree_map_with_path(
        lambda p, leaf: out.append(("/" + "/".join(str(e.key) for e in p),
                                    tuple(leaf.shape), str(leaf.dtype))), x)
    return sorted(out)


def _torch_leaves(x):
    return sorted((path, tuple(leaf.shape), str(leaf.dtype).split(".")[-1])
                  for path, leaf in tree.items(x)
                  if isinstance(leaf, torch.Tensor))


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", treg.ARCHS)
def test_specs_equal_the_reference(arch, shape_name):
    """Every leaf of the inputs (the train batch, or the cache and the
    tokens and media) in shape and dtype; the cache's ``pos`` is the port's
    int where the reference has an int32 scalar."""
    jreg = importlib.import_module("repro.configs.registry")
    jspecs = importlib.import_module("repro.launch.specs")
    jbase = importlib.import_module("repro.configs.base")
    jmodel = importlib.import_module("repro.models.model")
    cfg, shape = treg.get(arch), SHAPES[shape_name]
    jcfg, jshape = jreg.get(arch), jbase.SHAPES[shape_name]
    model = tmodel.Model(cfg, torch.device("cpu"))
    with FakeTensorMode():
        if shape.kind == "train":
            got = specs.train_batch_specs(cfg, shape, "cpu")
            want = jspecs.train_batch_specs(jcfg, jshape)
            assert _torch_leaves(got) == _jax_leaves(want)
            assert all(t.device.type == "cpu" for t in got.values())
            return
        fn = (specs.prefill_input_specs if shape.kind == "prefill"
              else specs.decode_input_specs)
        jfn = (jspecs.prefill_input_specs if shape.kind == "prefill"
               else jspecs.decode_input_specs)
        cache, inputs = fn(cfg, model, shape)
        jcache, jinputs = jfn(jcfg, jmodel.build(jcfg), jshape)
    assert isinstance(cache["pos"], int)
    jcache = {k: v for k, v in jcache.items() if k != "pos"}
    assert _torch_leaves(cache) == _jax_leaves(jcache)
    inputs = {k: v for k, v in inputs.items() if v is not None}
    jinputs = {k: v for k, v in jinputs.items() if v is not None}
    assert _torch_leaves(inputs) == _jax_leaves(jinputs)


# ---- the planner's accounting -----------------------------------------------

def test_planner_counts_a_known_redistribute():
    """(8, 16) float32 sharded (data: dim 0, model: dim 1) on 2 x 4: the
    gather over 'model' is one all-gather whose output is (4, 16); a
    partial sum made replicated is one all-reduce of its (4, 4) shard; the
    DTensor-level matmul counts its local FLOPs only."""
    with fake_group(8):
        mesh = _mesh((2, 4))
        _redistribute_under_planner(mesh)


def _redistribute_under_planner(mesh):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(4, 4), mesh, [Shard(0), Shard(1)],
                               run_check=False)
        p = DTensor.from_local(torch.empty(4, 4), mesh,
                               [Shard(0), Partial()], run_check=False)
        w = DTensor.from_local(torch.empty(16, 8), mesh,
                               [Replicate(), Replicate()], run_check=False)
        planner = dryrun.Planner()
        with planner:
            y = x.redistribute(mesh, [Shard(0), Replicate()])
            z = p.redistribute(mesh, [Shard(0), Replicate()])
            y @ w
    assert y.to_local().shape == (4, 16) and z.to_local().shape == (4, 4)
    assert planner.collectives == {
        "all-gather": {"count": 1, "bytes": 4 * 16 * 4},
        "all-reduce": {"count": 1, "bytes": 4 * 4 * 4}}
    assert planner.flops == 2 * 4 * 16 * 8          # the local (4, 16) @ w


def _largest_shard_blocks(t, placements, mesh) -> int:
    size = list(t.shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            size[p.dim] = -(-size[p.dim] // mesh.size(i))
    return -(-int(np.prod(size)) // 256)


def _local_bytes(t, placements, mesh) -> int:
    shape, _ = partition.local_shape_and_offset(t.shape, mesh, placements)
    return int(np.prod(shape)) * t.element_size()


def _opt_cfg(cfg):
    """The optimizer ``dryrun.build_cell`` gives ``cfg``."""
    from repro_torch.optim import adamw

    return adamw.AdamWConfig(
        state_bits=8 if cfg.name.startswith("llama4") else 32)


# the MoE archs under EP on the 2 x 4 mesh (reduced: 8 experts over 4)
MOE_ARCHS = ["qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "falcon-mamba-7b",
                                  *MOE_ARCHS])
def test_run_cell_on_a_fake_2x4_mesh(arch, shape_name, monkeypatch):
    """A reduced-width cell runs ``ok``; its argument bytes are the local
    shards' bytes from the partition specs; the step moved data across
    ranks and did work."""
    _cell_on_a_fake_2x4_mesh(arch, shape_name, monkeypatch)


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
def test_run_cell_moe_tp_on_a_fake_2x4_mesh(shape_name, monkeypatch):
    """As above for reduced qwen2-moe with ``REPRO_MOE_TP=1``: its experts
    split over the ffn (TP), not over the experts."""
    monkeypatch.setenv("REPRO_MOE_TP", "1")
    cfg = treg.get("qwen2-moe-a2.7b").reduced()
    with fake_group(8):
        spec = partition.param_spec("/blocks/moe/wi_gate",
                                    (cfg.n_layers, cfg.n_experts, cfg.d_model,
                                     cfg.moe_d_ff), _mesh((2, 4)))
    assert spec == (None, None, "data", "model")
    _cell_on_a_fake_2x4_mesh("qwen2-moe-a2.7b", shape_name, monkeypatch)


def _cell_on_a_fake_2x4_mesh(arch, shape_name, monkeypatch):
    cfg = treg.get(arch).reduced()
    monkeypatch.setattr(dryrun.registry, "get", lambda a: cfg)
    with fake_group(8):
        mesh = _mesh((2, 4))
        res = dryrun.run_cell(arch, shape_name, "single", "cpu", mesh=mesh)
        shape = SHAPES[shape_name]
        model = tmodel.Model(cfg, torch.device("cpu"))
        extra = 0
        with FakeTensorMode():
            if shape.kind == "train":
                from repro_torch.train import train_step as ts

                opt = _opt_cfg(cfg)
                state = ts.make_train_state(
                    model, opt, torch.Generator().manual_seed(0))
                if opt.state_bits == 8:
                    # each rank's 8-bit moments: the blocks of its largest
                    # shard of the parameter, codes and scales, m and v,
                    # and the optimizer's step count
                    del state["opt"]
                    extra = 4 + sum(
                        2 * _largest_shard_blocks(leaf, pl, mesh) * (256 + 4)
                        for (_, leaf), (_, pl) in zip(
                            tree.items(state["params"]),
                            tree.items(partition.param_shardings(
                                state["params"], mesh))))
                batch = specs.train_batch_specs(cfg, shape, "cpu")
                trees = [(state, partition.param_shardings(state, mesh)),
                         (batch, partition.batch_shardings(
                             batch, mesh, shape.global_batch))]
            else:
                params = model.init(torch.Generator().manual_seed(0))
                cache, inputs = specs.decode_input_specs(cfg, model, shape)
                inputs = {"tokens": inputs["tokens"]}
                trees = [(params, partition.param_shardings(params, mesh)),
                         (cache, partition.cache_shardings(
                             cache, mesh, shape.global_batch)),
                         (inputs, partition.batch_shardings(
                             inputs, mesh, shape.global_batch))]
            want = sum(_local_bytes(leaf, pl, mesh) for t, pls in trees
                       for (_, leaf), (_, pl) in zip(tree.items(t),
                                                     tree.items(pls))
                       if isinstance(leaf, torch.Tensor)) + extra
    assert res["status"] == "ok" and res["devices"] == 8
    pd = res["per_device"]
    assert pd["argument_bytes"] == want
    assert pd["peak_hbm_bytes"] >= pd["argument_bytes"]
    assert pd["peak_hbm_bytes"] == (pd["argument_bytes"] + pd["output_bytes"]
                                    + pd["temp_bytes"] - pd["alias_bytes"])
    assert res["raw_cost"]["flops"] > 0
    assert res["raw_cost"]["bytes_accessed"] > 0
    assert res["raw_cost"]["collective_bytes"] > 0
    assert res["per_device_cost"]["flops"] == res["raw_cost"]["flops"]


def test_ring_handoffs_count_as_collective_permute(monkeypatch):
    """Reduced granite with ``overlap="shared_bus"`` on a 2 x 4 mesh: each
    layer's FFN posts 3 rings (two all-gather matmuls, one reduce-scatter
    matmul) of tp - 1 = 3 hand-offs, each a ``collective-permute``."""
    cfg = dataclasses.replace(treg.get("granite-3-2b").reduced(),
                              overlap="shared_bus")
    monkeypatch.setattr(dryrun.registry, "get", lambda a: cfg)
    with fake_group(8):
        res = dryrun.run_cell("granite-3-2b", "prefill_32k", "single", "cpu",
                              mesh=_mesh((2, 4)))
    permute = res["raw_cost"]["collectives"]["collective-permute"]
    assert permute["count"] == cfg.n_layers * 3 * 3
    # every hand-off a (B / dp, T / tp, d_model) bf16 chunk: x in the
    # all-gather rings, the partial sums in the reduce-scatter one
    B, T = SHAPES["prefill_32k"].global_batch, SHAPES["prefill_32k"].seq_len
    chunk = (B // 2) * (T // 4) * cfg.d_model * 2
    assert permute["bytes"] == permute["count"] * chunk


@pytest.mark.parametrize("arch", ["granite-3-2b", "falcon-mamba-7b",
                                  *MOE_ARCHS])
def test_run_cell_flops_on_a_mesh_of_one_equal_flop_counter(arch,
                                                            monkeypatch):
    """On a 1 x 1 mesh the planner's FLOPs equal ``FlopCounterMode`` over
    the same train step on plain fake tensors."""
    _flops_on_a_mesh_of_one(arch, monkeypatch)


def test_run_cell_flops_moe_tp_on_a_mesh_of_one(monkeypatch):
    """As above for reduced qwen2-moe with ``REPRO_MOE_TP=1``."""
    monkeypatch.setenv("REPRO_MOE_TP", "1")
    _flops_on_a_mesh_of_one("qwen2-moe-a2.7b", monkeypatch)


def _flops_on_a_mesh_of_one(arch, monkeypatch):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.train import train_step as ts

    cfg = treg.get(arch).reduced()
    monkeypatch.setattr(dryrun.registry, "get", lambda a: cfg)
    with fake_group(1):
        res = dryrun.run_cell(arch, "train_4k", "single", "cpu",
                              mesh=_mesh((1, 1)))
    model = tmodel.Model(cfg, torch.device("cpu"))
    opt = _opt_cfg(cfg)
    with FakeTensorMode():
        state = ts.make_train_state(model, opt,
                                    torch.Generator().manual_seed(0))
        batch = specs.train_batch_specs(cfg, SHAPES["train_4k"], "cpu")
        counter = FlopCounterMode(display=False)
        with counter:
            ts.make_train_step(model, opt)(state, batch)
    assert res["raw_cost"]["flops"] == counter.get_total_flops() > 0


# ---- the kernels' ops on fake tensors -----------------------------------------

def _meta(ts_):
    return [(tuple(t.shape), t.dtype) for t in ts_]


def _op_cases():
    g = torch.Generator().manual_seed(0)

    def r(*s, dtype=torch.float32):
        return torch.randn(*s, generator=g).to(dtype)

    B, T, H, K, D = 2, 16, 4, 2, 64
    q, k, v = r(B, T, H, D), r(B, T, K, D), r(B, T, K, D)
    o, lse = ref.flash_attention_gqa_ref(q, k, v, return_lse=True)
    Ds, N = 8, 4
    sel = (r(B, T, Ds).abs(), r(B, T, Ds, dtype=torch.bfloat16),
           r(B, T, N, dtype=torch.bfloat16), r(B, T, N, dtype=torch.bfloat16),
           -r(Ds, N).abs(), r(B, Ds, N))
    Hm, P = 2, 4
    m2 = (r(B, T, Hm).abs(), r(B, T, Hm, P), r(B, T, N), r(B, T, N),
          -r(Hm).abs(), r(B, Hm, P, N))
    return {
        "flash_attn": ((q, k, v, True, 0, 0.0),
                       ref.flash_attention_gqa_ref(q, k, v, return_lse=True)),
        "flash_attn_bwd": ((q, k, v, o, lse, o, True, 0, 0.0),
                           ref.flash_attention_bwd_ref(q, k, v, o, lse, o)),
        "selective_scan": (sel, ref.selective_scan_ref(*sel)),
        "selective_scan_bwd": (
            (*sel, r(B, T, Ds), r(B, Ds, N)),
            ref.selective_scan_bwd_ref(*sel, r(B, T, Ds), r(B, Ds, N))),
        "mamba2_scan": (m2, ref.mamba2_scan_ref(*m2)),
        "mamba2_scan_bwd": (
            (*m2, r(B, T, Hm, P), r(B, Hm, P, N)),
            ref.mamba2_scan_bwd_ref(*m2, r(B, T, Hm, P), r(B, Hm, P, N))),
    }


@pytest.mark.parametrize("name", ["flash_attn", "flash_attn_bwd",
                                  "selective_scan", "selective_scan_bwd",
                                  "mamba2_scan", "mamba2_scan_bwd"])
def test_custom_op_under_fake_tensors(name):
    """Each op's fake implementation gives its plain version's output
    shapes and dtypes, and the wrappers send fake inputs to the ops."""
    args, plain = _op_cases()[name]
    mode = FakeTensorMode()
    with mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                for a in args]
        got = getattr(torch.ops.repro_torch, name)(*fake)
    assert _meta(got) == _meta(plain)
    assert all(type(t).__name__ == "FakeTensor" for t in got)


def test_wrappers_route_fake_inputs_to_the_ops():
    """No wrapper reaches code that reads ``data_ptr()``: fake CPU inputs
    outside grad mode run the op too (its fake implementation)."""
    cases = _op_cases()
    mode = FakeTensorMode()
    with mode, torch.no_grad():
        q, k, v = (mode.from_tensor(a) for a in cases["flash_attn"][0][:3])
        o = fa.flash_attention_gqa(q, k, v)
        sel = [mode.from_tensor(a) for a in cases["selective_scan"][0]]
        y, h = ms.selective_scan(*sel)
        m2 = [mode.from_tensor(a) for a in cases["mamba2_scan"][0]]
        y2, h2 = ms.mamba2_scan(*m2)
    assert o.shape == q.shape and y.shape == sel[0].shape
    assert y2.shape == m2[1].shape and h2.shape == m2[5].shape


# ---- local shards ---------------------------------------------------------------

@pytest.mark.parametrize("rank", [0, 5, 7])
@pytest.mark.parametrize("shape", [(8, 16), (7, 5), (3, 17), (2, 1)])
def test_local_shape_and_offset_equal_dtensor(shape, rank):
    """The plain-int shard layout equals DTensor's on several ranks,
    uneven and empty shards and a dimension sharded over both mesh
    dimensions included."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=8)
    try:
        mesh = _mesh((2, 4))
        for pl in ([Shard(0), Shard(1)], [Shard(1), Shard(0)],
                   [Shard(0), Shard(0)], [Replicate(), Shard(1)],
                   [Shard(1), Replicate()]):
            got = partition.local_shape_and_offset(shape, mesh, pl)
            want = compute_local_shape_and_global_offset(shape, mesh, pl)
            assert tuple(got[0]) == tuple(want[0]), pl
            assert tuple(got[1]) == tuple(want[1]), pl
    finally:
        dist.destroy_process_group()
