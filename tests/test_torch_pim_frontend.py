"""The port's model-inference frontend (``repro_torch.frontend``) against
the reference package: every registry arch lowers to the same structural
graph in both phases, array by array and tag by tag; the archs register as
apps beside the Fig-8 builtins; placed, leased, optimised and materialized
model graphs equal the reference's, and a single-job engine session on the
device model equals the offline schedule.

Mirrors ``tests/test_frontend.py`` but its serving-runtime tests, which
``tests/test_torch_pim_runtime.py`` holds (``TestModelFleet``).  The
port's config registry lists the archs in another order than the
reference's, so the two ``MODEL_APPS`` and ``known_apps()`` are compared
as sets and everything else by name.
The reference package is imported only inside the tests.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch import frontend, passes
from repro_torch.configs import registry
from repro_torch.core import ir, taskgraph
from repro_torch.core.engine import EngineSession
from repro_torch.core.pluto import Interconnect
from repro_torch.device import DeviceGeometry, DeviceModel, partition
from repro_torch.device import batch as dbatch
from repro_torch.device import scheduler as dev_sched
from repro_torch.frontend import (MODEL_APPS, MODEL_PHASES, decode_step,
                                  kv_tiles_for, lower, model_struct)

GEOM = DeviceGeometry(channels=1, banks_per_channel=4)
MODES = pytest.mark.parametrize("mode", list(Interconnect),
                                ids=lambda m: m.value)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run thousands of tiny tensor ops: one intra-op thread is
    faster than a pool, and leaves the cores to the tests beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref(name):
    return importlib.import_module(f"repro.{name}")


def _rmode(mode):
    return _ref("core.pluto").Interconnect(mode.value)


def _rgeom(geom):
    return _ref("device").DeviceGeometry(**dataclasses.asdict(geom))


def _same_graph(got, want):
    """Every array field equal in value and dtype, and the tags."""
    for f in ir.ARRAY_FIELDS:
        a, b = getattr(got, f).numpy(), getattr(want, f)
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f
    assert got.tags == want.tags


class TestLowering:
    @pytest.mark.parametrize("arch", sorted(MODEL_APPS))
    @pytest.mark.parametrize("phase", MODEL_PHASES)
    def test_every_arch_lowers_as_the_reference(self, arch, phase):
        g = model_struct(arch, phase=phase, n_pes=32, n_layers=2)
        g.validate()
        assert g.n > 0
        assert bool((g.op_class[g.kinds == ir.OP] >= 0).all())
        assert bool((g.duration == 0.0).all())
        _same_graph(g, _ref("frontend").model_struct(
            arch, phase=phase, n_pes=32, n_layers=2))

    @pytest.mark.parametrize("arch,kw", [
        ("gemma3-1b", dict(phase="prefill", n_pes=48, seq_tiles=3,
                           kv_tiles=2)),
        ("zamba2-2.7b", dict(phase="decode", n_pes=16, kv_tiles=5)),
        ("llama-3.2-vision-11b", dict(phase="prefill", n_pes=64,
                                      n_layers=5)),
        ("falcon-mamba-7b", dict(phase="prefill", n_pes=8, n_layers=3,
                                 seq_tiles=3)),
        ("qwen2-moe-a2.7b", dict(phase="prefill", n_pes=4096))])
    def test_shapes_and_depths_equal_the_reference(self, arch, kw):
        _same_graph(model_struct(arch, **kw),
                    _ref("frontend").model_struct(arch, **kw))

    @pytest.mark.parametrize("kv_len", [0, 1, 256, 257, 5000])
    def test_decode_step_equals_the_reference(self, kv_len):
        assert kv_tiles_for(kv_len) == \
            _ref("frontend").kv_tiles_for(kv_len)
        _same_graph(decode_step("granite-3-2b", n_pes=32, kv_len=kv_len,
                                n_layers=2),
                    _ref("frontend").decode_step(
                        "granite-3-2b", n_pes=32, kv_len=kv_len,
                        n_layers=2))

    def test_decode_is_narrower_than_prefill(self):
        for arch in ("gemma3-1b", "qwen2-moe-a2.7b", "falcon-mamba-7b"):
            dec = model_struct(arch, phase="decode", n_pes=32, n_layers=2)
            pre = model_struct(arch, phase="prefill", n_pes=32, n_layers=2)
            assert dec.n < pre.n

    def test_depth_scales_and_is_memoized(self):
        a = model_struct("gemma3-1b", phase="decode", n_pes=32, n_layers=2)
        b = model_struct("gemma3-1b", phase="decode", n_pes=32, n_layers=4)
        assert a.n < b.n
        assert a is model_struct("gemma3-1b", phase="decode", n_pes=32,
                                 n_layers=2)

    def test_default_layer_count_is_the_configs(self):
        cfg = registry.get("gemma3-1b")
        assert lower(cfg, "decode", n_pes=32).n == \
            lower(cfg, "decode", n_pes=32, n_layers=cfg.n_layers).n

    def test_moe_layers_fan_out_to_experts(self):
        cfg = registry.get("qwen2-moe-a2.7b")
        tags = set(lower(cfg, "prefill", n_pes=32, n_layers=1,
                         seq_tiles=1).tags)
        for e in range(cfg.n_experts_active):
            assert any(f".exp{e}." in t for t in tags)
        assert any(".shexp." in t for t in tags)
        assert any(".combine." in t for t in tags)

    def test_ssm_and_hybrid_layers(self):
        tags = lower(registry.get("falcon-mamba-7b"), "prefill", n_pes=32,
                     n_layers=1, seq_tiles=3).tags
        assert any(".ssm.scan" in t for t in tags)
        assert any(".ssm.carry" in t for t in tags)
        cfg = registry.get("zamba2-2.7b")
        tags = lower(cfg, "decode", n_pes=32, n_layers=cfg.attn_every).tags
        assert any(".ssm." in t for t in tags)
        assert any(".qkv." in t for t in tags)

    def test_rejects_bad_inputs(self):
        for call, match in (
                (lambda: model_struct("gemma3-1b", phase="train"), "phase"),
                (lambda: model_struct("not-a-model"), "arch"),
                (lambda: model_struct("gemma3-1b", n_layers=0), "n_layers"),
                (lambda: model_struct("gemma3-1b", seq_tiles=0),
                 "seq_tiles"),
                (lambda: model_struct("gemma3-1b", kv_tiles=9), "kv_tiles"),
                (lambda: decode_step("gemma3-1b", kv_len=-1), "kv_len"),
                (lambda: lower(registry.get("gemma3-1b"), "decode",
                               n_pes=0), "n_pes")):
            with pytest.raises(ValueError, match=match):
                call()


class TestRegistration:
    def test_registered_alongside_builtin_apps(self):
        known = taskgraph.known_apps()
        assert set(taskgraph.APPS) <= set(known)
        assert set(MODEL_APPS) <= set(known)
        # the same apps as the reference, in the port's registry order
        assert set(MODEL_APPS) == set(_ref("frontend").MODEL_APPS)
        assert MODEL_APPS == registry.ARCHS
        assert set(known) == set(_ref("core.taskgraph").known_apps())
        assert frontend.MODEL_PARAMS == _ref("frontend").MODEL_PARAMS
        assert frontend.MODEL_PHASES == _ref("frontend").MODEL_PHASES

    def test_structural_dispatches_model_apps(self):
        g = taskgraph.structural("gemma3-1b", phase="decode", n_pes=32,
                                 n_layers=2)
        assert g is model_struct("gemma3-1b", phase="decode", n_pes=32,
                                 n_layers=2)

    def test_registry_guards(self):
        with pytest.raises(ValueError, match="unknown app"):
            taskgraph.structural("not-an-app")
        with pytest.raises(ValueError, match="builtin"):
            taskgraph.register_app("mm", lambda: None, ())
        with pytest.raises(ValueError, match="cache_clear"):
            taskgraph.register_app("some-model", lambda: None, ())

        def fn(**kw):
            return None
        fn.cache_clear = lambda: None
        with pytest.raises(ValueError, match="already registered"):
            taskgraph.register_app("gemma3-1b", fn, ())

    def test_register_is_idempotent(self):
        before = taskgraph.known_apps()
        frontend.register()
        assert taskgraph.known_apps() == before

    def test_clear_caches_covers_model_builders(self):
        g = model_struct("gemma3-1b", phase="decode", n_pes=32, n_layers=2)
        dbatch.clear_caches()
        assert model_struct("gemma3-1b", phase="decode", n_pes=32,
                            n_layers=2) is not g

    @MODES
    def test_materialize_prices_both_modes(self, mode):
        g = model_struct("granite-3-2b", phase="decode", n_pes=32,
                         n_layers=2)
        m = ir.materialize(g, mode)
        assert bool((m.duration[g.kinds == ir.OP] > 0).all())
        _same_graph(m, _ref("core.ir").materialize(
            _ref("frontend").model_struct("granite-3-2b", phase="decode",
                                          n_pes=32, n_layers=2),
            _rmode(mode)))


class TestModelPlacement:
    def test_lease_confines_model_graph(self):
        g = taskgraph.structural("gemma3-1b", phase="decode",
                                 n_pes=2 * GEOM.pes_per_bank, n_layers=2)
        placed = partition.place_on_banks(g, GEOM, (1, 3))
        ppb = GEOM.pes_per_bank
        pes = set(placed.pe[placed.pe >= 0].tolist()) \
            | set(placed.src[placed.src >= 0].tolist()) \
            | set(placed.dst_flat.tolist())
        assert {p // ppb for p in pes} <= {1, 3}
        _same_graph(placed, _ref("device.partition").place_on_banks(
            _ref("frontend").model_struct("gemma3-1b", phase="decode",
                                          n_pes=2 * GEOM.pes_per_bank,
                                          n_layers=2),
            _rgeom(GEOM), (1, 3)))

    @pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "zamba2-2.7b",
                                      "llama4-maverick-400b-a17b"])
    @pytest.mark.parametrize("policy", partition.POLICIES)
    def test_optimized_model_graphs_equal_the_reference(self, arch, policy):
        kw = dict(phase="prefill", n_layers=2, seq_tiles=2)
        got = partition.optimized_struct(arch, GEOM, policy=policy, **kw)
        rp = _ref("device.partition")
        _same_graph(got, rp.optimized_struct(arch, _rgeom(GEOM),
                                             policy=policy, **kw))
        log = partition.optimization_log(arch, GEOM, policy=policy, **kw)
        rlog = rp.optimization_log(arch, _rgeom(GEOM), policy=policy, **kw)
        assert [dataclasses.astuple(e) for e in log.entries] == \
            [dataclasses.astuple(e) for e in rlog.entries]

    def test_full_depth_moe_prefill_on_the_hbm_device(self):
        """The chip phase's passes case: qwen2-moe-a2.7b prefill at full
        depth on 4,096 PEs, 291 rewrites, its fingerprint the reference's."""
        hbm = DeviceGeometry(channels=16, banks_per_channel=16,
                             bank_groups_per_channel=4, pes_per_bank=16)
        log = partition.optimization_log("qwen2-moe-a2.7b", hbm,
                                         phase="prefill")
        assert log.summary() == {"eliminated": 0, "coalesced": 291,
                                 "fused": 0, "total": 291}
        g = partition.optimized_struct("qwen2-moe-a2.7b", hbm,
                                       phase="prefill")
        assert g.n == 10329
        assert partition.partitioned_struct("qwen2-moe-a2.7b", hbm,
                                            phase="prefill").n == 10620
        pipe = passes.optimization_pipeline(
            passes.DEFAULT_OPT, pes_per_bank=hbm.pes_per_bank,
            total_pes=hbm.total_pes)
        assert pipe.fingerprint() == _ref("passes").optimization_pipeline(
            _ref("passes").DEFAULT_OPT, pes_per_bank=hbm.pes_per_bank,
            total_pes=hbm.total_pes).fingerprint()

    @MODES
    def test_single_job_session_matches_offline(self, mode):
        g = ir.materialize(
            partition.partitioned_struct("gemma3-1b", GEOM, phase="decode",
                                         n_layers=2), mode)
        offline = dev_sched.schedule(g, mode, GEOM, device="cpu")
        session = EngineSession(DeviceModel(mode, GEOM), device="cpu")
        session.admit(g)
        session.advance()
        stats = session.stats()
        for f in ("makespan_ns", "op_busy_ns", "move_busy_ns", "stall_ns",
                  "n_ops", "n_moves", "n_rows_moved", "finish_times"):
            assert getattr(stats, f) == getattr(offline, f), f
        want = _ref("device.scheduler").schedule(
            _ref("core.ir").materialize(_ref("device.partition")
                                        .partitioned_struct(
                                            "gemma3-1b", _rgeom(GEOM),
                                            phase="decode", n_layers=2),
                                        _rmode(mode)),
            _rmode(mode), _rgeom(GEOM))
        for f in ("makespan_ns", "stall_ns", "transfer_energy_j",
                  "rows_by_route", "bus_busy_ns", "finish_times"):
            assert getattr(offline, f) == getattr(want, f), f
