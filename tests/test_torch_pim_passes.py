"""The port's pass pipeline (``repro_torch.passes``) and its use by the
partitioner, the batch runner and ``taskgraph.build_ir`` against the
reference package, bit for bit: every rewritten graph equal array by array
(values and dtypes) and tag by tag, every rewrite log equal entry by
entry, every ``Pipeline.fingerprint`` equal, and every schedule of a
rewritten graph equal to the reference's and to the golden schedules.

Mirrors ``tests/test_passes.py`` (its unit, mechanics, pipeline-off
golden, property, benchmark-cell, lease and legacy-placement tests; the
serving-runtime test waits for the port's runtime), with hypothesis at a
bounded number of examples.  The search-driven place stage builds and
raises until the search layer is ported.  The reference package is
imported only inside the tests.
"""

import dataclasses
import importlib
import json
import pathlib

import numpy as np
import pytest
import torch

from _hypothesis_compat import hypothesis, st  # noqa: F401

from capture_goldens import (APP_KW, GEOMETRIES, SYNTH, core_record,
                             device_record)
from repro_torch import convert, passes
from repro_torch.core import ir, taskgraph
from repro_torch.core import scheduler as core_sched
from repro_torch.core.pluto import Interconnect
from repro_torch.core.scheduler import Task
from repro_torch.device import DeviceGeometry, partition
from repro_torch.device import scheduler as dev_sched
from repro_torch.device.batch import BatchRunner, SweepConfig
from repro_torch.passes import graphs_equal

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = json.loads((ROOT / "tests" / "golden_schedules.json").read_text())
BIG = DeviceGeometry(**GEOMETRIES["2ch_4banks_2groups"])
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


def _rgraph(g):
    return _ref("core.ir").TaskGraph(**convert.taskgraph_to_numpy(g))


def _same_graph(got, want):
    """Every array field equal in value and dtype, and the tags."""
    for f in ir.ARRAY_FIELDS:
        a, b = getattr(got, f).numpy(), getattr(want, f)
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f
    assert (got.tags or ("",) * got.n) == (want.tags or ("",) * want.n)


def _same_log(got, want):
    assert [dataclasses.astuple(e) for e in got.entries] == \
        [dataclasses.astuple(e) for e in want.entries]
    assert str(got) == str(want) and got.summary() == want.summary()


def run_default(tasks_or_graph, pes_per_bank=None, total_pes=None):
    """The default optimization pipeline through the port and through the
    reference package, held equal; the port's (graph, log)."""
    g = tasks_or_graph if isinstance(tasks_or_graph, ir.TaskGraph) \
        else ir.from_tasks(tasks_or_graph)
    pipe = passes.optimization_pipeline(passes.DEFAULT_OPT,
                                        pes_per_bank=pes_per_bank,
                                        total_pes=total_pes)
    rpipe = _ref("passes").optimization_pipeline(
        _ref("passes").DEFAULT_OPT, pes_per_bank=pes_per_bank,
        total_pes=total_pes)
    assert pipe.describe() == rpipe.describe()
    assert pipe.fingerprint() == rpipe.fingerprint()
    out, log = pipe.run(g)
    rout, rlog = rpipe.run(_rgraph(g))
    _same_graph(out, rout)
    _same_log(log, rlog)
    return out, log


class TestSelfMoveElimination:
    def test_drops_and_rewires(self):
        g, log = run_default([
            Task(0, "op", pe=1, duration=5.0),
            Task(1, "move", deps=(0,), src=3, dst=3, rows=2),
            Task(2, "op", deps=(1,), pe=3, duration=1.0),
        ])
        assert log.summary()["eliminated"] == 1
        out = ir.to_tasks(g)
        assert [t.uid for t in out] == [0, 2]
        assert out[1].deps == (0,)

    def test_broadcast_to_self_only(self):
        g, log = run_default([
            Task(0, "op", pe=0, duration=1.0),
            Task(1, "move", deps=(0,), src=2, dst=(2, 2), rows=1),
            Task(2, "op", deps=(1,), pe=2, duration=1.0),
        ])
        assert log.summary()["eliminated"] == 1 and g.n == 2

    def test_chain_of_self_moves(self):
        g, log = run_default([
            Task(0, "op", pe=0, duration=1.0),
            Task(1, "move", deps=(0,), src=1, dst=1),
            Task(2, "move", deps=(1,), src=1, dst=1),
            Task(3, "op", deps=(2,), pe=1, duration=1.0),
        ])
        assert log.summary()["eliminated"] == 2
        assert ir.to_tasks(g)[1].deps == (0,)

    def test_mixed_dst_broadcast_survives(self):
        g, log = run_default([
            Task(0, "op", pe=0, duration=1.0),
            Task(1, "move", deps=(0,), src=2, dst=(2, 5), rows=1),
        ])
        assert log.summary()["eliminated"] == 0 and g.n == 2


class TestBroadcastCoalesce:
    def tasks(self, dst_a, dst_b, rows_b=1):
        return [
            Task(0, "op", pe=0, duration=10.0),
            Task(1, "move", deps=(0,), src=0, dst=dst_a, rows=1),
            Task(2, "move", deps=(0,), src=0, dst=dst_b, rows=rows_b),
            Task(3, "op", deps=(1,), pe=4, duration=1.0),
            Task(4, "op", deps=(2,), pe=5, duration=1.0),
        ]

    def test_same_bank_handoffs_merge(self):
        g, log = run_default(self.tasks(4, 5), pes_per_bank=16)
        assert log.summary()["coalesced"] == 1
        out = ir.to_tasks(g)
        assert out[1].dst == (4, 5)
        assert out[2].deps == (1,) and out[3].deps == (1,)

    def test_cross_bank_handoffs_stay_separate(self):
        g, log = run_default(self.tasks(4, 20), pes_per_bank=16)
        assert log.summary()["coalesced"] == 0 and g.n == 5

    def test_single_bank_view_merges_everything(self):
        g, log = run_default(self.tasks(4, 20), pes_per_bank=None)
        assert log.summary()["coalesced"] == 1

    def test_different_rows_stay_separate(self):
        g, log = run_default(self.tasks(4, 5, rows_b=3), pes_per_bank=16)
        assert log.summary()["coalesced"] == 0

    def test_different_deps_stay_separate(self):
        g, log = run_default([
            Task(0, "op", pe=0, duration=1.0),
            Task(1, "op", pe=0, duration=1.0),
            Task(2, "move", deps=(0,), src=0, dst=4),
            Task(3, "move", deps=(1,), src=0, dst=5),
        ], pes_per_bank=16)
        assert log.summary()["coalesced"] == 0

    def test_existing_cross_bank_broadcast_untouched(self):
        g, log = run_default([
            Task(0, "op", pe=0, duration=1.0),
            Task(1, "move", deps=(0,), src=0, dst=(4, 20), rows=1),
            Task(2, "move", deps=(0,), src=0, dst=5, rows=1),
            Task(3, "move", deps=(0,), src=0, dst=6, rows=1),
        ], pes_per_bank=16)
        assert log.summary()["coalesced"] == 1
        dsts = sorted(tuple(g.dsts_of(i).tolist()) for i in range(g.n)
                      if g.kinds[i] == ir.MOVE)
        assert dsts == [(4, 20), (5, 6)]


class TestMoveFusion:
    def test_two_leg_chain_fuses(self):
        g, log = run_default([
            Task(0, "op", pe=0, duration=1.0),
            Task(1, "move", deps=(0,), src=0, dst=3, rows=2),
            Task(2, "move", deps=(1,), src=3, dst=7, rows=2),
            Task(3, "op", deps=(2,), pe=7, duration=1.0),
        ])
        assert log.summary()["fused"] == 1
        fused = ir.to_tasks(g)[1]
        assert (fused.src, fused.dst, fused.deps) == (0, 7, (0,))

    def test_three_leg_chain_fuses_to_one(self):
        g, log = run_default([
            Task(0, "op", pe=0, duration=1.0),
            Task(1, "move", deps=(0,), src=0, dst=3),
            Task(2, "move", deps=(1,), src=3, dst=7),
            Task(3, "move", deps=(2,), src=7, dst=9),
            Task(4, "op", deps=(3,), pe=9, duration=1.0),
        ])
        assert log.summary()["fused"] == 2 and g.n == 3

    def test_intermediate_with_second_reader_blocks_fusion(self):
        g, log = run_default([
            Task(0, "op", pe=0, duration=1.0),
            Task(1, "move", deps=(0,), src=0, dst=3),
            Task(2, "move", deps=(1,), src=3, dst=7),
            Task(3, "op", deps=(1,), pe=3, duration=1.0),
        ])
        assert log.summary()["fused"] == 0

    def test_row_mismatch_blocks_fusion(self):
        g, log = run_default([
            Task(0, "op", pe=0, duration=1.0),
            Task(1, "move", deps=(0,), src=0, dst=3, rows=2),
            Task(2, "move", deps=(1,), src=3, dst=7, rows=1),
        ])
        assert log.summary()["fused"] == 0

    def test_round_trip_chain_is_dead(self):
        g, log = run_default([
            Task(0, "op", pe=2, duration=1.0),
            Task(1, "move", deps=(0,), src=2, dst=5),
            Task(2, "move", deps=(1,), src=5, dst=2),
            Task(3, "op", deps=(2,), pe=2, duration=1.0),
        ])
        assert log.summary()["eliminated"] == 2
        out = ir.to_tasks(g)
        assert [t.uid for t in out] == [0, 3] and out[1].deps == (0,)


class TestPipelineMechanics:
    def test_stage_order_enforced(self):
        with pytest.raises(ValueError, match="stage order"):
            passes.Pipeline([passes.LegalizePass(), passes.ValidatePass()])

    def test_unknown_pass_name(self):
        with pytest.raises(ValueError, match="unknown optimization pass"):
            passes.optimization_passes(("no_such_pass",))

    def test_fingerprint_tracks_configuration(self):
        a = passes.optimization_pipeline(passes.DEFAULT_OPT)
        b = passes.optimization_pipeline(passes.DEFAULT_OPT)
        c = passes.optimization_pipeline(("self_move_elim",))
        d = passes.optimization_pipeline(passes.DEFAULT_OPT, pes_per_bank=8)
        assert a.fingerprint() == b.fingerprint()
        assert a.fingerprint() != c.fingerprint()
        assert a.fingerprint() != d.fingerprint()

    @pytest.mark.parametrize("which", ["opt", "device", "lease"])
    def test_descriptors_and_fingerprints_equal_the_reference(self, which):
        rp = _ref("passes")
        for geom in (BIG, DeviceGeometry(channels=16, banks_per_channel=16,
                                         bank_groups_per_channel=4)):
            rgeom = _rgeom(geom)
            for opt in ((), passes.DEFAULT_OPT, ("fuse_moves",)):
                if which == "opt":
                    pairs = [(passes.optimization_pipeline(
                        opt, pes_per_bank=ppb, total_pes=tp),
                        rp.optimization_pipeline(
                            opt, pes_per_bank=ppb, total_pes=tp))
                        for ppb, tp in ((None, None), (16, 4096), (8, None))]
                elif which == "device":
                    pairs = [(passes.device_pipeline(geom, pol, opt=opt),
                              rp.device_pipeline(rgeom, pol, opt=opt))
                             for pol in partition.POLICIES]
                else:
                    pairs = [(passes.lease_pipeline(geom, (1, 3), opt=opt),
                              rp.lease_pipeline(rgeom, (1, 3), opt=opt))]
                for p, r in pairs:
                    assert p.describe() == r.describe()
                    assert p.fingerprint() == r.fingerprint()
                    assert repr(p) == repr(r)

    def test_noop_run_returns_input_unchanged(self):
        g = partition.partitioned_struct("mm", BIG, n=20)
        out, log = passes.optimization_pipeline(()).run(g)
        assert out is g and len(log) == 0

    def test_passes_do_not_mutate_input(self):
        g = ir.from_tasks([Task(0, "op", pe=0, duration=1.0),
                           Task(1, "move", deps=(0,), src=1, dst=1),
                           Task(2, "move", deps=(1,), src=1, dst=4)])
        snapshot = {f: getattr(g, f).clone()
                    for f in ("uids", "kinds", "dep_pos", "src", "dst_flat")}
        run_default(g)
        for f, arr in snapshot.items():
            assert torch.equal(getattr(g, f), arr)

    def test_legalize_rejects_out_of_range_endpoints(self):
        for tasks in ([Task(0, "op", pe=99, duration=1.0)],
                      [Task(0, "move", src=1, dst=(2, 40))]):
            g = ir.from_tasks(tasks)
            with pytest.raises(ValueError, match="outside") as e:
                passes.LegalizePass(total_pes=16).run(g, passes.RewriteLog())
            with pytest.raises(ValueError) as r:
                _ref("passes").LegalizePass(total_pes=16).run(
                    _rgraph(g), _ref("passes").RewriteLog())
            assert str(e.value) == str(r.value)

    def test_graphs_equal_and_rebuild(self):
        g = ir.from_tasks([Task(0, "op", pe=0, duration=1.0),
                           Task(1, "move", deps=(0,), src=1, dst=1),
                           Task(2, "move", deps=(1,), src=1, dst=(4, 5))])
        assert graphs_equal(g, g)
        out = passes.rebuild(g, drop=[1], dep_subst={1: (0,)},
                             new_src={2: 0}, new_dsts={2: (6,)})
        want = _ref("passes").rebuild(_rgraph(g), drop=[1],
                                      dep_subst={1: (0,)}, new_src={2: 0},
                                      new_dsts={2: (6,)})
        _same_graph(out, want)
        assert not graphs_equal(out, g)
        assert out.dst_is_tuple.tolist() == [False, False]
        back = convert.taskgraph_from_numpy(convert.taskgraph_to_numpy(out))
        assert graphs_equal(back, out) and back.tags == out.tags


class TestSearchPlaceStage:
    """The search-driven place stage builds; it raises only when run."""

    def test_search_pipelines_build_and_refuse_to_run(self):
        for pipe in (passes.search_pipeline(BIG, Interconnect.LISA,
                                            opt=passes.DEFAULT_OPT),
                     passes.lease_search_pipeline(
                         BIG, (0, 2), Interconnect.SHARED_PIM)):
            stage = pipe.passes[1]
            assert isinstance(stage, passes.SearchPlacePass)
            assert stage.stage == "place"
            assert stage.describe().startswith("search_place[")
            assert len(pipe.fingerprint()) == 12
            g = taskgraph.structural("mm", n_pes=BIG.total_pes, n=8)
            with pytest.raises(NotImplementedError, match="item 17"):
                pipe.run(g)


class TestBuildIrWithPasses:
    @pytest.mark.parametrize("app", sorted(APP_KW))
    @MODES
    def test_build_ir_opt_equals_the_reference(self, app, mode):
        got = taskgraph.build_ir(app, mode, opt=passes.DEFAULT_OPT,
                                 **APP_KW[app])
        want = _ref("core.taskgraph").build_ir(
            app, _rmode(mode), opt=_ref("passes").DEFAULT_OPT,
            **APP_KW[app])
        _same_graph(got, want)
        assert core_record(core_sched.schedule(got, mode, device="cpu")) \
            == core_record(_ref("core.scheduler").schedule(want,
                                                           _rmode(mode)))

    def test_build_ir_opt_rewrites_a_model_graph(self):
        kw = dict(phase="decode", n_pes=32, n_layers=2)
        got = taskgraph.build_ir("qwen2-moe-a2.7b", Interconnect.SHARED_PIM,
                                 opt=passes.DEFAULT_OPT, **kw)
        import repro.frontend  # noqa: F401  (registers the model apps)
        want = _ref("core.taskgraph").build_ir(
            "qwen2-moe-a2.7b", _rmode(Interconnect.SHARED_PIM),
            opt=_ref("passes").DEFAULT_OPT, **kw)
        _same_graph(got, want)
        assert got.n < taskgraph.structural("qwen2-moe-a2.7b", **kw).n


class TestPipelineOffGoldens:
    """A no-op pipeline reproduces the golden schedules bit-for-bit."""

    @pytest.mark.parametrize("app", sorted(APP_KW))
    @MODES
    def test_core_pipeline_off(self, app, mode):
        g = taskgraph.build_ir(app, mode, opt=(), **APP_KW[app])
        rec = core_record(core_sched.schedule(g, mode, device="cpu"))
        assert rec == GOLDEN["core"][f"{app}/{mode.value}"]

    @pytest.mark.parametrize("gname", sorted(GEOMETRIES))
    @pytest.mark.parametrize("app", sorted(APP_KW))
    def test_device_pipeline_off(self, gname, app):
        geom = DeviceGeometry(**GEOMETRIES[gname])
        for scaling in ("strong", "weak"):
            policies = (("locality_first", "round_robin",
                         "bandwidth_balanced")
                        if scaling == "strong" and geom.n_banks > 1
                        else ("locality_first",))
            for policy in policies:
                off = partition.optimized_struct(
                    app, geom, policy=policy, scaling=scaling, opt=(),
                    **APP_KW[app])
                assert graphs_equal(off, partition.partitioned_struct(
                    app, geom, policy=policy, scaling=scaling,
                    **APP_KW[app]))
                _same_graph(off, _ref("device.partition").optimized_struct(
                    app, _rgeom(geom), policy=policy, scaling=scaling,
                    opt=(), **APP_KW[app]))
                for mode in Interconnect:
                    rec = device_record(dev_sched.schedule(off, mode, geom,
                                                           device="cpu"))
                    key = f"{app}/{mode.value}/{gname}/{scaling}/{policy}"
                    assert rec == GOLDEN["device"][key], key

    @pytest.mark.parametrize("name", sorted(SYNTH))
    @MODES
    def test_synth_pipeline_off(self, name, mode):
        tasks = [Task(**dataclasses.asdict(t)) for t in SYNTH[name]]
        g, log = passes.optimization_pipeline(
            (), total_pes=BIG.total_pes).run(ir.from_tasks(tasks))
        assert len(log) == 0
        rec = device_record(dev_sched.schedule(g, mode, BIG, device="cpu"))
        assert rec == GOLDEN["synth"][f"{name}/{mode.value}"]


# --- property tests ----------------------------------------------------------


@st.composite
def random_logical_dag(draw):
    """Random graphs rich in self-moves, duplicate hand-offs, and chains."""
    n = draw(st.integers(3, 28))
    total = BIG.total_pes
    tasks = []
    for i in range(n):
        deps = tuple(d for d in range(max(0, i - 4), i)
                     if draw(st.booleans()))
        kind = draw(st.integers(0, 3))
        if kind == 0:
            tasks.append(Task(i, "op", deps=deps,
                              pe=draw(st.integers(0, total - 1)),
                              duration=draw(st.floats(1.0, 1e3))))
        elif kind == 1:
            pe = draw(st.integers(0, total - 1))
            tasks.append(Task(i, "move", deps=deps, src=pe, dst=pe,
                              rows=draw(st.integers(1, 4))))
        elif kind == 2 and i > 0 and tasks[i - 1].kind == "move" \
                and not isinstance(tasks[i - 1].dst, tuple):
            tasks.append(Task(i, "move", deps=(i - 1,),
                              src=tasks[i - 1].dst,
                              dst=draw(st.integers(0, total - 1)),
                              rows=tasks[i - 1].rows))
        else:
            tasks.append(Task(i, "move", deps=deps,
                              src=draw(st.integers(0, total - 1)),
                              dst=draw(st.integers(0, total - 1)),
                              rows=draw(st.integers(1, 4))))
    return tasks


def _schedule_pair(tasks):
    g = ir.from_tasks(tasks)
    out, log = run_default(g, BIG.pes_per_bank, BIG.total_pes)
    return g, out, log


class TestPassProperties:
    @hypothesis.given(random_logical_dag())
    @hypothesis.settings(max_examples=25, deadline=None)
    def test_validity_and_shrinkage(self, tasks):
        g, out, log = _schedule_pair(tasks)
        out.validate()
        assert out.n == g.n - log.count("eliminate") \
            - log.count("coalesce") - log.count("fuse")
        assert set(out.uids.tolist()) <= set(g.uids.tolist())

    @hypothesis.given(random_logical_dag(),
                      st.sampled_from(list(Interconnect)))
    @hypothesis.settings(max_examples=25, deadline=None)
    def test_interconnect_demand_never_increases(self, tasks, mode):
        g, out, _log = _schedule_pair(tasks)
        before = dev_sched.schedule(g, mode, BIG, device="cpu")
        after = dev_sched.schedule(out, mode, BIG, device="cpu")
        assert after.move_busy_ns <= before.move_busy_ns + 1e-6
        assert after.op_busy_ns == pytest.approx(before.op_busy_ns)
        assert after.n_rows_moved <= before.n_rows_moved
        want = _ref("device.scheduler").schedule(_rgraph(out), _rmode(mode),
                                                 _rgeom(BIG))
        assert device_record(after) == device_record(want)

    @hypothesis.given(random_logical_dag())
    @hypothesis.settings(max_examples=25, deadline=None)
    def test_idempotent(self, tasks):
        _g, out, _log = _schedule_pair(tasks)
        out2, log2 = run_default(out, BIG.pes_per_bank)
        assert len(log2) == 0 and graphs_equal(out, out2)

    #: the move-heavy cells improve under Shared-PIM; ordinary Fig-8 cells
    #: are left alone
    CELLS = [
        ("gemma3-1b", DeviceGeometry(channels=1, banks_per_channel=4),
         dict(phase="prefill", n_layers=4, seq_tiles=4), "improves"),
        ("qwen2-moe-a2.7b",
         DeviceGeometry(channels=1, banks_per_channel=4, pes_per_bank=8),
         dict(phase="prefill", n_layers=2, seq_tiles=2), "improves"),
        ("mm", DeviceGeometry(channels=1, banks_per_channel=4),
         dict(n=20), "unchanged"),
        ("ntt", DeviceGeometry(channels=1, banks_per_channel=4),
         dict(n=32), "unchanged"),
    ]

    @pytest.mark.parametrize("app,geom,kw,expect",
                             CELLS, ids=[c[0] for c in CELLS])
    def test_benchmark_cells_makespan(self, app, geom, kw, expect):
        off = partition.partitioned_struct(app, geom, **kw)
        on = partition.optimized_struct(app, geom, **kw)
        log = partition.optimization_log(app, geom, **kw)
        import repro.frontend  # noqa: F401  (registers the model apps)
        rp = _ref("device.partition")
        _same_graph(on, rp.optimized_struct(app, _rgeom(geom), **kw))
        _same_log(log, rp.optimization_log(app, _rgeom(geom), **kw))
        sp_off = dev_sched.schedule(off, Interconnect.SHARED_PIM, geom,
                                    device="cpu")
        sp_on = dev_sched.schedule(on, Interconnect.SHARED_PIM, geom,
                                   device="cpu")
        if expect == "improves":
            assert len(log) > 0
            assert sp_on.makespan_ns < sp_off.makespan_ns
        else:
            assert len(log) == 0 and graphs_equal(off, on)
            assert sp_on.makespan_ns == sp_off.makespan_ns


class TestLeaseValidation:
    GEOM = DeviceGeometry(channels=1, banks_per_channel=4)

    def test_duplicates_named(self):
        with pytest.raises(ValueError) as e:
            partition.lease_pe_map(self.GEOM, [1, 2, 1, 3, 3])
        assert "[1, 3]" in str(e.value)

    def test_out_of_range_named(self):
        with pytest.raises(ValueError) as e:
            partition.lease_pe_map(self.GEOM, [0, 7, -2])
        assert "[-2, 7]" in str(e.value) and "[0, 4)" in str(e.value)

    def test_place_on_banks_validates_too(self):
        g = taskgraph.structural("mm", n_pes=self.GEOM.pes_per_bank, n=8)
        with pytest.raises(ValueError, match="duplicate banks"):
            partition.place_on_banks(g, self.GEOM, (2, 2))
        with pytest.raises(ValueError, match="out of range"):
            partition.place_on_banks(g, self.GEOM, (0, 9))

    @pytest.mark.parametrize("policy", partition.POLICIES)
    def test_lease_placement_equals_the_reference(self, policy):
        g = taskgraph.structural("pmm", n_pes=2 * self.GEOM.pes_per_bank,
                                 n=12)
        got = partition.place_on_banks(g, self.GEOM, (3, 1), policy)
        _same_graph(got, _ref("device.partition").place_on_banks(
            _rgraph(g), _rgeom(self.GEOM), (3, 1), policy))
        out, log = passes.lease_pipeline(self.GEOM, (3, 1), policy,
                                         opt=passes.DEFAULT_OPT).run(g)
        rout, rlog = _ref("passes").lease_pipeline(
            _rgeom(self.GEOM), (3, 1), policy,
            opt=_ref("passes").DEFAULT_OPT).run(_rgraph(g))
        _same_graph(out, rout)
        _same_log(log, rlog)


class TestLegacyPlaceViaIR:
    def test_place_task_list_matches_ir_path(self):
        geom = DeviceGeometry(channels=2, banks_per_channel=2)
        tasks = taskgraph.build("pmm", Interconnect.LISA, n=16,
                                n_pes=geom.total_pes)
        for policy in partition.POLICIES:
            placed = partition.place(tasks, geom, policy)
            via_ir = ir.to_tasks(partition.place_ir(ir.from_tasks(tasks),
                                                    geom, policy))
            assert placed == via_ir
            _same_graph(partition.place_ir(ir.from_tasks(tasks), geom,
                                           policy),
                        _ref("device.partition").place_ir(
                            _rgraph(ir.from_tasks(tasks)), _rgeom(geom),
                            policy))

    def test_cross_traffic_rows_agrees_across_representations(self):
        geom = DeviceGeometry(channels=1, banks_per_channel=4)
        tasks = taskgraph.build("ntt", Interconnect.LISA, n=32,
                                n_pes=geom.total_pes)
        g = ir.from_tasks(tasks)
        assert partition.cross_traffic_rows(tasks, geom) == \
            partition.cross_traffic_rows(g, geom) == \
            _ref("device.partition").cross_traffic_rows(_rgraph(g),
                                                        _rgeom(geom))


class TestPipelineThroughStack:
    def test_sweep_config_opt_matches_direct_and_the_reference(self):
        geom = DeviceGeometry(channels=1, banks_per_channel=4)
        cfgs = [SweepConfig.make("qwen2-moe-a2.7b", mode, geom,
                                 opt=passes.DEFAULT_OPT, phase="decode",
                                 n_layers=2)
                for mode in Interconnect]
        results = BatchRunner(device="cpu").run(cfgs)
        import repro.frontend  # noqa: F401  (registers the model apps)
        rb = _ref("device.batch")
        want = rb.BatchRunner().run([rb.SweepConfig.make(
            c.app, _rmode(c.mode), _rgeom(geom),
            opt=_ref("passes").DEFAULT_OPT, **c.kwargs) for c in cfgs])
        for cfg, r, w in zip(cfgs, results, want):
            g = partition.optimized_struct(cfg.app, geom,
                                           opt=passes.DEFAULT_OPT,
                                           **cfg.kwargs)
            direct = dev_sched.schedule(g, cfg.mode, geom, device="cpu")
            assert r.makespan_ns == direct.makespan_ns
            assert r.finish_times == direct.finish_times
            assert device_record(r) == device_record(w)
