"""The port's device-scale simulator (``repro_torch.device``: geometry,
interconnect, resources, scheduler, partition, reference, batch) against
the reference package and the golden schedules, bit for bit (no
tolerance): every float accumulator, count, route and bus breakdown and
finish time must be identical.

* all 104 ``device`` and ``synth`` goldens of ``tests/golden_schedules.json``
  by the port's vector engine, its scalar engine and its
  ``device/reference.py``; seeded random device graphs through all three
  and the reference package's scheduler;
* ``tests/test_device.py``: geometry and routing, single-bank equivalence,
  cross-bank moves, partitioning and its edge cases, each result also held
  to the reference package's;
* ``DeviceModel.compile`` equal to the reference's, its token names,
  refresh units, bus classes and the lexicographic order of its move
  signatures included;
* ``tests/test_batch.py`` but its search-layer tests (the port's runner
  refuses them until the search layer is ported);
* the HBM-scale and fleet classes of ``tests/test_engine_vector.py``;
* imports (the lazy ``repro_torch.device`` package in fresh interpreters),
  entry points that default to ``cuda`` and raise without a card,
  ``chip_smoke.py``'s copies of the golden grid, and ``cuda``-marked cases
  that repeat goldens and the HBM case on the card.

The reference package is imported only inside the tests.
"""

import dataclasses
import importlib
import importlib.util
import json
import pathlib
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import capture_goldens
from capture_goldens import (APP_KW, GEOMETRIES, SYNTH, device_record)
from repro_torch import convert
from repro_torch import device as pdevice
from repro_torch.core import engine, ir, pluto, taskgraph
from repro_torch.core import scheduler as core_sched
from repro_torch.core.pluto import Interconnect
from repro_torch.core.scheduler import Task
from repro_torch.device import (POLICIES, BatchRunner, DeviceGeometry,
                                DeviceModel, SweepConfig, build_partitioned,
                                build_partitioned_ir, cross_traffic_rows,
                                partition, pe_map, place)
from repro_torch.device import batch as dbatch
from repro_torch.device import interconnect as xbar
from repro_torch.device import reference as dev_ref
from repro_torch.device import scheduler as dev_sched
from repro_torch.device.geometry import SINGLE_BANK

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = json.loads((ROOT / "tests" / "golden_schedules.json").read_text())
BIG = DeviceGeometry(**GEOMETRIES["2ch_4banks_2groups"])
SMALL = APP_KW
MODES = pytest.mark.parametrize("mode", list(Interconnect),
                                ids=lambda m: m.value)

CORE_FIELDS = ("makespan_ns", "op_busy_ns", "move_busy_ns", "stall_ns",
               "n_ops", "n_moves", "n_rows_moved", "finish_times")
DEVICE_FIELDS = CORE_FIELDS + ("transfer_energy_j", "n_cross_moves",
                               "rows_by_route", "bus_busy_ns")
STAT_FIELDS = CORE_FIELDS + ("n_cross_moves", "energy_j", "rows_by_route",
                             "bus_busy_ns", "op_energy_j", "move_energy_j")


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


def _rtasks(tasks):
    T = _ref("core.scheduler").Task
    return [T(**dataclasses.asdict(t)) for t in tasks]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_same(got, want, fields):
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f


def assert_same_tasks(got, want):
    """A port task list equal to a reference one, field for field."""
    assert [dataclasses.asdict(t) for t in got] == \
        [dataclasses.asdict(t) for t in want]


def _same_graph(got, want):
    """Every array field equal in value and dtype, and the tags."""
    for f in ir.ARRAY_FIELDS:
        a, b = getattr(got, f).numpy(), getattr(want, f)
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f
    assert got.tags == want.tags


def _scalar_result(g, mode, geom):
    """The device schedule by the scalar engine, wrapped as
    ``device.scheduler.schedule`` wraps the vector engine's."""
    g = ir.materialize(core_sched.as_graph(g), mode)
    st = engine.run(g, DeviceModel(mode, geom), engine="scalar",
                    device="cpu")
    e_row = pluto.E_MOVE_LISA if mode is Interconnect.LISA \
        else pluto.E_MOVE_BUS
    return dev_sched.DeviceScheduleResult(
        mode, geom, st.makespan_ns, st.op_busy_ns, st.move_busy_ns,
        st.stall_ns, st.n_ops, st.n_moves, st.n_rows_moved, st.finish_times,
        st.energy_j + sum(st.rows_by_route.values()) * e_row,
        st.n_cross_moves, st.rows_by_route, st.bus_busy_ns)


def _device_cases():
    for gname in GEOMETRIES:
        geom = DeviceGeometry(**GEOMETRIES[gname])
        for app in APP_KW:
            for scaling in ("strong", "weak"):
                policies = (("locality_first", "round_robin",
                             "bandwidth_balanced")
                            if scaling == "strong" and geom.n_banks > 1
                            else ("locality_first",))
                for policy in policies:
                    yield gname, app, scaling, policy


DEVICE_CASES = sorted(set(_device_cases()))


# --- the goldens -------------------------------------------------------------


def test_golden_grid_size():
    assert len(DEVICE_CASES) * 2 == len(GOLDEN["device"]) == 100
    assert len(SYNTH) * 2 == len(GOLDEN["synth"]) == 4


@pytest.mark.parametrize("gname,app,scaling,policy", DEVICE_CASES)
@pytest.mark.parametrize("eng", ["vector", "scalar", "reference"])
def test_device_goldens(gname, app, scaling, policy, eng):
    geom = DeviceGeometry(**GEOMETRIES[gname])
    for mode in Interconnect:
        key = f"{app}/{mode.value}/{gname}/{scaling}/{policy}"
        if eng == "reference":
            tasks = dev_ref.build_partitioned(app, mode, geom, policy=policy,
                                              scaling=scaling, **APP_KW[app])
            r = dev_ref.schedule(tasks, mode, geom)
        else:
            g = build_partitioned_ir(app, mode, geom, policy=policy,
                                     scaling=scaling, **APP_KW[app])
            r = dev_sched.schedule(g, mode, geom, device="cpu") \
                if eng == "vector" else _scalar_result(g, mode, geom)
        assert device_record(r) == GOLDEN["device"][key], key


@pytest.mark.parametrize("name", sorted(SYNTH))
@MODES
@pytest.mark.parametrize("eng", ["vector", "scalar", "reference"])
def test_synth_goldens(name, mode, eng):
    tasks = [Task(**dataclasses.asdict(t)) for t in SYNTH[name]]
    r = dev_sched.schedule(tasks, mode, BIG, device="cpu") \
        if eng == "vector" else _scalar_result(tasks, mode, BIG) \
        if eng == "scalar" else dev_ref.schedule(tasks, mode, BIG)
    assert device_record(r) == GOLDEN["synth"][f"{name}/{mode.value}"]


def random_device_tasks(rng, total=BIG.total_pes):
    """A random DAG over every PE of a device: ops, single moves and
    broadcasts of 2-5 destinations, the golden suite's generator."""
    tasks = []
    for i in range(rng.randint(2, 30)):
        deps = tuple(d for d in range(max(0, i - 4), i) if rng.random() < .5)
        if rng.random() < 0.5:
            tasks.append(Task(i, "op", deps=deps, pe=rng.randrange(total),
                              duration=rng.uniform(1.0, 1e4)))
            continue
        src = rng.randrange(total)
        others = [d for d in range(total) if d != src]
        dst = rng.choice(others) if rng.random() < 0.5 \
            else tuple(rng.sample(others, rng.randint(2, 5)))
        tasks.append(Task(i, "move", deps=deps, src=src, dst=dst,
                          rows=rng.randint(1, 8)))
    return tasks


@pytest.mark.parametrize("seed", range(12))
@MODES
def test_random_device_graphs_all_agree(seed, mode):
    rng = random.Random(4099 * seed + 3)
    tasks = random_device_tasks(rng)
    vec = dev_sched.schedule(tasks, mode, BIG, device="cpu")
    for other in (_scalar_result(tasks, mode, BIG),
                  dev_ref.schedule(tasks, mode, BIG),
                  _ref("device.scheduler").schedule(
                      _rtasks(tasks), _rmode(mode), _rgeom(BIG))):
        assert_same(vec, other, DEVICE_FIELDS)


# --- geometry and routing ----------------------------------------------------


class TestGeometry:
    def test_defaults_single_bank(self):
        g = DeviceGeometry()
        assert g.n_banks == 1 and g.total_pes == 16
        assert g.route(0, 0) == "intra"
        assert g == SINGLE_BANK

    @pytest.mark.parametrize("bad", [
        dict(channels=0), dict(banks_per_channel=-1), dict(pes_per_bank=0),
        dict(banks_per_channel=3, bank_groups_per_channel=2),
    ])
    def test_validation(self, bad):
        with pytest.raises(ValueError):
            DeviceGeometry(**bad)

    def test_addressing_roundtrip(self):
        g = DeviceGeometry(channels=2, banks_per_channel=4,
                           bank_groups_per_channel=2, pes_per_bank=8)
        assert g.n_banks == 8 and g.total_pes == 64
        for pe in range(g.total_pes):
            assert g.pe(g.bank_of(pe), g.local_of(pe)) == pe
        assert g.channel_of_bank(5) == 1
        assert g.group_of_bank(0) == g.group_of_bank(1) == 0
        assert g.group_of_bank(2) == 1
        assert g.group_of_bank(4) == 2

    @pytest.mark.parametrize("kw", [
        GEOMETRIES["2ch_4banks_2groups"],
        dict(channels=3, banks_per_channel=10, bank_groups_per_channel=5,
             pes_per_bank=8),
        dict(channels=2, banks_per_channel=4, bank_groups_per_channel=2,
             pes_per_bank=8, devices=2)])
    def test_routes_and_addresses_equal_the_reference(self, kw):
        g, rg = DeviceGeometry(**kw), _ref("device").DeviceGeometry(**kw)
        assert g.describe() == rg.describe()
        nb = g.n_banks
        assert [g.route(a, b) for a in range(nb) for b in range(nb)] == \
            [rg.route(a, b) for a in range(nb) for b in range(nb)]
        assert [(g.group_of_bank(b), g.channel_of_bank(b),
                 g.device_of_bank(b)) for b in range(nb)] == \
            [(rg.group_of_bank(b), rg.channel_of_bank(b),
              rg.device_of_bank(b)) for b in range(nb)]

    def test_route_classes(self):
        g = BIG
        assert [g.route(0, b) for b in (0, 1, 2, 4)] == \
            ["intra", "group", "channel", "device"]

    def test_transit_costs_equal_the_reference(self):
        rx = _ref("device.interconnect")
        routes = ("group", "channel", "device", "fleet")
        got = [xbar.transit_ns_per_row(r) for r in routes]
        assert got == [rx.transit_ns_per_row(r) for r in routes]
        assert got == sorted(got) and got[0] > 0
        assert [xbar.transit_energy_per_row(r) for r in routes] == \
            [rx.transit_energy_per_row(r) for r in routes]
        with pytest.raises(ValueError):
            xbar.transit_ns_per_row("intra")
        for mode in Interconnect:
            for s, d in ((5, 20), (5, 40), (3, 70), (15, 127)):
                assert dataclasses.astuple(xbar.plan(mode, BIG, s, d)) == \
                    dataclasses.astuple(rx.plan(_rmode(mode), _rgeom(BIG),
                                                s, d))


# --- the resource model ------------------------------------------------------


def _compile_pair(g, mode, geom):
    got = DeviceModel(mode, geom).compile(g)
    rg = _ref("core.ir").TaskGraph(**convert.taskgraph_to_numpy(g))
    want = _ref("device.resources").DeviceModel(
        _rmode(mode), _rgeom(geom)).compile(rg)
    return got, want


@pytest.mark.parametrize("case", ["pmm-rr", "ntt-bw", "mm-weak", "fleet",
                                  "random"])
@MODES
def test_compile_equals_the_reference(case, mode):
    fleet = DeviceGeometry(channels=2, banks_per_channel=4,
                           bank_groups_per_channel=2, pes_per_bank=8,
                           devices=2)
    if case == "random":
        geom = BIG
        g = ir.from_tasks(random_device_tasks(random.Random(11)))
    else:
        geom = fleet if case == "fleet" else BIG
        app, policy, scaling, kw = {
            "pmm-rr": ("pmm", "round_robin", "strong", dict(n=30)),
            "ntt-bw": ("ntt", "bandwidth_balanced", "strong", dict(n=64)),
            "mm-weak": ("mm", "locality_first", "weak", dict(n=20)),
            "fleet": ("mm", "round_robin", "strong", dict(n=20))}[case]
        g = build_partitioned_ir(app, mode, geom, policy=policy,
                                 scaling=scaling, **kw)
    got, want = _compile_pair(g, mode, geom)
    assert got.exec_plan == want.exec_plan
    assert got.prio_dur == want.prio_dur
    assert got.task_energy_j == want.task_energy_j
    # the signature order fixes energy_move's float sum and the route
    # dict's insertion order: both must be the reference's exactly
    assert list(got.rows_by_route.items()) == \
        list(want.rows_by_route.items())
    assert (got.n_resources, got.n_ops, got.n_moves, got.n_rows,
            got.n_cross, got.energy_op_j, got.energy_move_j) == \
        (want.n_resources, want.n_ops, want.n_moves, want.n_rows,
         want.n_cross, want.energy_op_j, want.energy_move_j)


def test_move_signatures_visit_in_lexicographic_order():
    # single-destination moves whose (src, dst, rows) rows sort differently
    # by any one column: torch.unique(dim=0) must order them as
    # np.unique(axis=0) does
    rng = random.Random(5)
    sig = [(rng.randrange(64), rng.randrange(64), rng.randint(1, 4))
           for _ in range(300)]
    t = torch.tensor(sig, dtype=torch.int64)
    uniq, inv = torch.unique(t, dim=0, sorted=True, return_inverse=True)
    nuniq, ninv = np.unique(np.asarray(sig), axis=0, return_inverse=True)
    assert uniq.tolist() == nuniq.tolist()
    assert inv.tolist() == ninv.reshape(-1).tolist()
    tasks = [Task(i, "move", src=s, dst=d, rows=r)
             for i, (s, d, r) in enumerate(sig)]
    for mode in Interconnect:
        got, want = _compile_pair(ir.from_tasks(tasks), mode, BIG)
        assert got.energy_move_j == want.energy_move_j
        assert list(got.rows_by_route) == list(want.rows_by_route)


@pytest.mark.parametrize("kw", [
    GEOMETRIES["1ch_4banks"], GEOMETRIES["2ch_4banks_2groups"],
    dict(channels=3, banks_per_channel=10, bank_groups_per_channel=5,
         pes_per_bank=8),
    dict(channels=2, banks_per_channel=4, bank_groups_per_channel=2,
         pes_per_bank=8, devices=2)])
def test_model_tokens_equal_the_reference(kw):
    for mode in Interconnect:
        m = DeviceModel(mode, DeviceGeometry(**kw))
        r = _ref("device.resources").DeviceModel(
            _rmode(mode), _ref("device").DeviceGeometry(**kw))
        assert m.n_resources() == r.n_resources() == len(m.token_names())
        assert m.token_names() == r.token_names()
        assert m.refresh_units() == r.refresh_units()
        assert m.refresh_unit_names() == r.refresh_unit_names()
        assert m.bus_classes() == r.bus_classes()
        assert m.token_power_groups() == r.token_power_groups()
    assert ("d2d" in m.bus_classes()) == (kw.get("devices", 1) > 1)


# --- tests/test_device.py ----------------------------------------------------


class TestSingleBankEquivalence:
    @pytest.mark.parametrize("app", sorted(taskgraph.APPS))
    @MODES
    def test_apps_identical(self, app, mode):
        tasks = taskgraph.build(app, mode, **SMALL[app])
        a = core_sched.schedule(tasks, mode, device="cpu")
        b = dev_sched.schedule(tasks, mode, SINGLE_BANK, device="cpu")
        assert_same(b, a, CORE_FIELDS + ("transfer_energy_j",))
        assert b.cross_rows == 0 and b.n_cross_moves == 0
        want = _ref("device.scheduler").schedule(_rtasks(tasks),
                                                 _rmode(mode))
        assert_same(b, want, DEVICE_FIELDS)

    def test_compare_improvement_api(self):
        tasks = taskgraph.build("mm", Interconnect.LISA, n=20)
        res = dev_sched.compare(tasks, SINGLE_BANK, device="cpu")
        core = core_sched.compare(tasks, device="cpu")
        assert dev_sched.improvement(res) == core_sched.improvement(core)
        rs = _ref("device.scheduler")
        assert dev_sched.improvement(res) == \
            rs.improvement(rs.compare(_rtasks(tasks)))

    def test_empty_graph_zero_improvement(self):
        assert dev_sched.improvement(
            dev_sched.compare([], SINGLE_BANK, device="cpu")) == 0.0


class TestCrossBankMoves:
    GEOM = BIG

    def _both(self, tasks, mode, geom=None):
        geom = geom or self.GEOM
        got = dev_sched.schedule(tasks, mode, geom, device="cpu")
        want = _ref("device.scheduler").schedule(
            _rtasks(tasks), _rmode(mode), _rgeom(geom))
        assert_same(got, want, DEVICE_FIELDS)
        return got

    def test_routes_priced_and_counted(self):
        for dst, route in [(20, "group"), (40, "channel"), (70, "device")]:
            tasks = [Task(0, "move", src=5, dst=dst, rows=4)]
            for mode in Interconnect:
                r = self._both(tasks, mode)
                assert r.rows_by_route == {route: 4}
                assert r.n_cross_moves == 1

    def test_farther_routes_cost_more(self):
        for mode in Interconnect:
            spans = [self._both([Task(0, "move", src=5, dst=d, rows=4)],
                                mode).makespan_ns for d in (20, 40, 70)]
            assert spans[0] < spans[1] < spans[2]

    def test_lisa_stalls_both_banks_sharedpim_neither(self):
        tasks = [Task(0, "move", src=5, dst=19, rows=4),
                 Task(1, "op", pe=2, duration=100.0),
                 Task(2, "op", pe=17, duration=100.0)]
        lisa = self._both(tasks, Interconnect.LISA)
        sp = self._both(tasks, Interconnect.SHARED_PIM)
        assert lisa.stall_ns > 0 and sp.stall_ns == 0
        assert sp.finish_times[1] == 100.0 and sp.finish_times[2] == 100.0
        assert lisa.finish_times[1] > 100.0

    def test_shared_bus_contention_serializes(self):
        g = DeviceGeometry(channels=1, banks_per_channel=2)
        one = [Task(0, "move", src=1, dst=17, rows=8)]
        two = one + [Task(1, "move", src=20, dst=2, rows=8)]
        for mode in Interconnect:
            assert self._both(two, mode, g).makespan_ns > \
                self._both(one, mode, g).makespan_ns

    def test_cross_bank_sharedpim_still_wins(self):
        tasks = taskgraph.build("mm", Interconnect.LISA, n=20,
                                n_pes=self.GEOM.total_pes)
        res = dev_sched.compare(tasks, self.GEOM, device="cpu")
        assert dev_sched.improvement(res) > 0
        for mode in Interconnect:
            self._both(tasks, mode)

    def test_broadcast_split_across_banks(self):
        tasks = [Task(0, "move", src=0, dst=(1, 17, 18), rows=2)]
        r = self._both(tasks, Interconnect.SHARED_PIM)
        assert r.rows_by_route == {"intra": 2, "group": 4}
        assert r.n_rows_moved == 6


class TestPartitioning:
    GEOM = DeviceGeometry(channels=2, banks_per_channel=2)

    @pytest.mark.parametrize("policy", POLICIES)
    def test_pe_map_is_the_references_permutation(self, policy):
        tasks = taskgraph.build("mm", Interconnect.LISA, n=20,
                                n_pes=self.GEOM.total_pes)
        m = pe_map(self.GEOM, policy, tasks)
        assert sorted(m) == list(range(self.GEOM.total_pes))
        assert m == _ref("device").pe_map(_rgeom(self.GEOM), policy,
                                          _rtasks(tasks))
        assert m == pe_map(self.GEOM, policy, ir.from_tasks(tasks))

    def test_round_robin_scatters_locality_preserves(self):
        tasks = taskgraph.build("mm", Interconnect.LISA, n=20,
                                n_pes=self.GEOM.total_pes)
        rr = place(tasks, self.GEOM, "round_robin")
        loc = place(tasks, self.GEOM, "locality_first")
        assert cross_traffic_rows(rr, self.GEOM) > \
            cross_traffic_rows(loc, self.GEOM)
        rtasks, rgeom = _rtasks(tasks), _rgeom(self.GEOM)
        for got, pol in ((rr, "round_robin"), (loc, "locality_first")):
            assert_same_tasks(got, _ref("device").place(rtasks, rgeom, pol))
            assert cross_traffic_rows(got, self.GEOM) == \
                _ref("device").cross_traffic_rows(
                    _ref("device").place(rtasks, rgeom, pol), rgeom)

    @pytest.mark.parametrize("policy", POLICIES)
    @pytest.mark.parametrize("app", sorted(taskgraph.APPS))
    def test_end_to_end_partitioned_schedule(self, policy, app):
        res = {}
        rgeom = _rgeom(self.GEOM)
        for mode in Interconnect:
            tasks = build_partitioned(app, mode, self.GEOM, policy=policy,
                                      **SMALL[app])
            rtasks = _ref("device").build_partitioned(
                app, _rmode(mode), rgeom, policy=policy, **SMALL[app])
            assert_same_tasks(tasks, rtasks)
            r = dev_sched.schedule(tasks, mode, self.GEOM, device="cpu")
            assert_same(r, _ref("device.scheduler").schedule(
                rtasks, _rmode(mode), rgeom), DEVICE_FIELDS)
            for t in tasks:
                for d in t.deps:
                    assert r.finish_times[d] <= r.finish_times[t.uid] + 1e-9
            res[mode] = r
        assert res[Interconnect.SHARED_PIM].makespan_ns <= \
            res[Interconnect.LISA].makespan_ns + 1e-6

    def test_weak_scaling_adds_reduction_traffic(self):
        tasks = build_partitioned("mm", Interconnect.LISA, self.GEOM,
                                  scaling="weak", n=20)
        assert cross_traffic_rows(tasks, self.GEOM) == \
            (self.GEOM.n_banks - 1) * taskgraph.SLICES_32
        assert_same_tasks(tasks, _ref("device").build_partitioned(
            "mm", _rmode(Interconnect.LISA), _rgeom(self.GEOM),
            scaling="weak", n=20))

    def test_weak_scaling_advantage_grows_with_banks(self):
        gaps = []
        for nb in (1, 2, 4):
            g = DeviceGeometry(channels=1, banks_per_channel=nb)
            res = {mode.value: dev_sched.schedule(
                build_partitioned("mm", mode, g, scaling="weak", n=20),
                mode, g, device="cpu") for mode in Interconnect}
            gaps.append(res["lisa"].makespan_ns
                        - res["shared_pim"].makespan_ns)
        assert gaps[0] <= gaps[1] <= gaps[2]

    def test_bfs_striping_requires_divisibility(self):
        with pytest.raises(ValueError):
            taskgraph.bfs(n_nodes=10, n_pes=16, n_stripes=5)
        with pytest.raises(ValueError):
            taskgraph.bfs(n_nodes=10, n_pes=16, n_stripes=8)

    def test_bad_scaling_and_policy_rejected(self):
        with pytest.raises(ValueError, match="scaling"):
            partition.partitioned_struct("mm", self.GEOM, scaling="x", n=8)
        with pytest.raises(ValueError, match="policy"):
            pe_map(self.GEOM, "nearest")
        with pytest.raises(ValueError, match="traffic"):
            pe_map(self.GEOM, "bandwidth_balanced")


class TestPartitionEdgeCases:
    @pytest.mark.parametrize("policy", POLICIES)
    def test_single_bank_every_policy_is_identity(self, policy):
        g = SINGLE_BANK
        tasks = taskgraph.build("mm", Interconnect.LISA, n=10)
        assert pe_map(g, policy, tasks) == list(range(g.total_pes))
        placed = place(tasks, g, policy)
        assert placed == tasks
        assert cross_traffic_rows(placed, g) == 0

    @pytest.mark.parametrize("policy", POLICIES)
    def test_single_bank_end_to_end_matches_core(self, policy):
        for mode in Interconnect:
            tasks = build_partitioned("ntt", mode, SINGLE_BANK,
                                      policy=policy, n=64)
            r = dev_sched.schedule(tasks, mode, SINGLE_BANK, device="cpu")
            c = core_sched.schedule(tasks, mode, device="cpu")
            assert r.makespan_ns == c.makespan_ns and r.cross_rows == 0

    def test_workload_smaller_than_bank_count(self):
        g = DeviceGeometry(channels=1, banks_per_channel=8)
        tasks = [Task(0, "op", pe=0, duration=10.0),
                 Task(1, "move", deps=(0,), src=0, dst=1, rows=2),
                 Task(2, "op", deps=(1,), pe=1, duration=10.0),
                 Task(3, "move", deps=(2,), src=1, dst=2, rows=2)]
        rr = place(tasks, g, "round_robin")
        assert len({g.bank_of(t.pe) for t in rr if t.kind == "op"}) == 2
        assert cross_traffic_rows(rr, g) == 4
        assert cross_traffic_rows(place(tasks, g, "locality_first"), g) == 0
        for mode in Interconnect:
            r = dev_sched.schedule(rr, mode, g, device="cpu")
            assert len(r.finish_times) == len(tasks)
            assert r.n_cross_moves == 2

    def test_weak_scaling_more_banks_than_replica_sinks(self):
        g = DeviceGeometry(channels=1, banks_per_channel=4)
        tasks = build_partitioned("bfs", Interconnect.LISA, g,
                                  scaling="weak", n_nodes=4)
        assert cross_traffic_rows(tasks, g) == \
            (g.n_banks - 1) * taskgraph.SLICES_32
        r = dev_sched.schedule(tasks, Interconnect.LISA, g, device="cpu")
        assert len(r.finish_times) == len(tasks)
        _same_graph(ir.from_tasks(tasks), _ref("core.ir").from_tasks(
            _ref("device").build_partitioned(
                "bfs", _rmode(Interconnect.LISA), _rgeom(g), scaling="weak",
                n_nodes=4)))

    def test_bandwidth_balanced_all_equal_weights(self):
        g = DeviceGeometry(channels=2, banks_per_channel=2)
        ppb = g.pes_per_bank
        tasks = [Task(b, "move", src=b * ppb,
                      dst=((b + 1) % g.n_banks) * ppb, rows=3)
                 for b in range(g.n_banks)]
        w = partition._block_weights(tasks, g)
        assert len(set(w)) == 1 and w[0] > 0
        assert w == _ref("device.partition")._block_weights(_rtasks(tasks),
                                                            _rgeom(g))
        m1 = pe_map(g, "bandwidth_balanced", tasks)
        assert m1 == pe_map(g, "bandwidth_balanced", list(tasks))
        assert sorted(m1) == list(range(g.total_pes))
        order = partition._spread_bank_order(g)
        for blk in range(g.n_banks):
            assert m1[blk * ppb] == order[blk] * ppb

    def test_bandwidth_balanced_ir_and_task_weights_agree(self):
        g = DeviceGeometry(channels=2, banks_per_channel=2)
        tasks = taskgraph.build("pmm", Interconnect.LISA, n=20,
                                n_pes=g.total_pes)
        w = partition._block_weights(tasks, g)
        assert w == partition._block_weights(ir.from_tasks(tasks), g)
        assert w == _ref("device.partition")._block_weights(_rtasks(tasks),
                                                            _rgeom(g))
        assert pe_map(g, "bandwidth_balanced", tasks) == \
            pe_map(g, "bandwidth_balanced", ir.from_tasks(tasks))


# --- tests/test_batch.py -----------------------------------------------------

GEOM = DeviceGeometry(channels=2, banks_per_channel=2)
BATCH_FIELDS = ("makespan_ns", "op_busy_ns", "move_busy_ns", "stall_ns",
                "n_ops", "n_moves", "n_rows_moved", "n_cross_moves",
                "transfer_energy_j", "rows_by_route", "bus_busy_ns",
                "finish_times")


def small_grid(geom=GEOM):
    cfgs = []
    for app, kw in (("mm", dict(n=20)), ("bfs", dict(n_nodes=40))):
        for policy in POLICIES:
            for mode in Interconnect:
                cfgs.append(SweepConfig.make(app, mode, geom, policy=policy,
                                             **kw))
        for mode in Interconnect:
            cfgs.append(SweepConfig.make(app, mode, geom, scaling="weak",
                                         **kw))
    return cfgs


class Metrics:
    """A duck-typed metrics registry: counters and histograms by name."""

    def __init__(self):
        self.counts, self.samples = {}, {}

    def counter(self, name):
        reg = self

        class C:
            def inc(self):
                reg.counts[name] = reg.counts.get(name, 0) + 1
        return C()

    def histogram(self, name):
        reg = self

        class H:
            def observe(self, x):
                reg.samples.setdefault(name, []).append(x)
        return H()


class TestBatchRunner:
    def test_matches_both_reference_loops_bit_for_bit(self):
        cfgs = small_grid()
        batch = BatchRunner(device="cpu").run(cfgs)
        rb = _ref("device.batch")
        rcfgs = [rb.SweepConfig.make(c.app, _rmode(c.mode),
                                     _rgeom(c.geometry), policy=c.policy,
                                     scaling=c.scaling, **c.kwargs)
                 for c in cfgs]
        for cfg, got, want in zip(cfgs, batch, rb.BatchRunner().run(rcfgs)):
            tasks = dev_ref.build_partitioned(
                cfg.app, cfg.mode, cfg.geometry, policy=cfg.policy,
                scaling=cfg.scaling, **cfg.kwargs)
            legacy = dev_ref.schedule(tasks, cfg.mode, cfg.geometry)
            for f in BATCH_FIELDS:
                assert getattr(got, f) == getattr(legacy, f), (cfg, f)
                assert getattr(got, f) == getattr(want, f), (cfg, f)

    def test_results_align_with_config_order(self):
        cfgs = small_grid()
        res = BatchRunner(device="cpu").run(cfgs)
        assert len(res) == len(cfgs)
        for cfg, r in zip(cfgs, res):
            assert r.mode is cfg.mode and r.geometry == cfg.geometry

    def test_run_one_equals_plain_schedule(self):
        cfg = SweepConfig.make("ntt", Interconnect.SHARED_PIM, GEOM,
                               policy="round_robin", n=64)
        got = BatchRunner(device="cpu").run_one(cfg)
        tasks = partition.build_partitioned(cfg.app, cfg.mode, cfg.geometry,
                                            policy=cfg.policy, **cfg.kwargs)
        assert_same(got, dev_sched.schedule(tasks, cfg.mode, cfg.geometry,
                                            device="cpu"), BATCH_FIELDS)

    def test_callback_and_metrics_see_every_config(self):
        cfgs = small_grid()[:4]
        seen = []
        metrics = Metrics()
        res = BatchRunner(metrics, device="cpu").run(
            cfgs, callback=lambda c, r: seen.append(c))
        assert seen == cfgs
        assert metrics.counts == {"model_cache_misses": 2,
                                  "cells_scheduled": 4}
        assert metrics.samples == {
            f"makespan_ns/{m.value}": [r.makespan_ns for c, r in
                                       zip(cfgs, res) if c.mode is m]
            for m in Interconnect}

    def test_model_reuse_across_configs(self):
        runner = BatchRunner(device="cpu")
        runner.run(small_grid())
        assert len(runner._models) == 2
        assert runner.device == torch.device("cpu")

    def test_clear_caches_resets_structural_memos(self):
        BatchRunner(device="cpu").run(small_grid()[:2])
        assert partition._partitioned_struct.cache_info().currsize > 0
        dbatch.clear_caches()
        assert partition._partitioned_struct.cache_info().currsize == 0
        assert partition._optimized_struct.cache_info().currsize == 0
        assert taskgraph._matmul_struct.cache_info().currsize == 0

    def test_search_layers_refuse_until_ported(self):
        cfg = SweepConfig.make("mm", Interconnect.LISA, GEOM, n=12)
        runner = BatchRunner(device="cpu")
        for call in (runner.placement_oracle, runner.search_placement):
            with pytest.raises(NotImplementedError, match="item 17"):
                call(cfg)


class TestBatchEdgeCases:
    def test_empty_config_list_returns_empty(self):
        seen = []
        assert BatchRunner(device="cpu").run(
            [], callback=lambda c, r: seen.append(c)) == []
        assert dbatch.run_grid([], device="cpu") == [] and seen == []

    def test_duplicate_configs_share_caches(self):
        dbatch.clear_caches()
        cfg = SweepConfig.make("mm", Interconnect.SHARED_PIM, GEOM, n=12)
        runner = BatchRunner(device="cpu")
        res = runner.run([cfg, cfg, cfg])
        for f in BATCH_FIELDS:
            assert getattr(res[1], f) == getattr(res[0], f) == \
                getattr(res[2], f), f
        assert partition._partitioned_struct.cache_info().currsize == 1
        assert taskgraph._matmul_struct.cache_info().currsize == 1
        assert len(runner._models) == 1

    def test_sweep_config_hashable_and_kwargs_roundtrip(self):
        a = SweepConfig.make("mm", Interconnect.LISA, GEOM, n=10, out_rows=4)
        b = SweepConfig.make("mm", Interconnect.LISA, GEOM, out_rows=4, n=10)
        assert a == b and hash(a) == hash(b)
        assert a.kwargs == {"n": 10, "out_rows": 4}

    def test_bad_scaling_rejected_at_build(self):
        cfg = SweepConfig.make("mm", Interconnect.LISA, GEOM,
                               scaling="sideways", n=10)
        with pytest.raises(ValueError, match="scaling"):
            BatchRunner(device="cpu").run_one(cfg)


# --- the HBM-scale device and the fleet (tests/test_engine_vector.py) --------

HBM = DeviceGeometry(channels=16, banks_per_channel=16,
                     bank_groups_per_channel=4, pes_per_bank=16)


class TestHBMGeometry:
    def test_hbm_shape_totals(self):
        assert (HBM.n_banks, HBM.n_groups, HBM.banks_per_group,
                HBM.total_pes) == (256, 64, 4, 4096)
        m = DeviceModel(Interconnect.SHARED_PIM, HBM)
        assert m.n_resources() == 256 * 49 + 64 + 16 == 12624

    def test_single_bank_per_group(self):
        g = DeviceGeometry(channels=4, banks_per_channel=4,
                           bank_groups_per_channel=4)
        assert g.banks_per_group == 1
        assert {g.route(a, b) for a in range(g.n_banks)
                for b in range(g.n_banks) if a != b} == {"channel", "device"}

    def test_asymmetric_channel_counts(self):
        g = DeviceGeometry(channels=3, banks_per_channel=10,
                           bank_groups_per_channel=5, pes_per_bank=8)
        assert g.n_banks == 30 and g.banks_per_group == 2
        for b in range(g.n_banks):
            assert g.channel_of_bank(b) == b // 10
            assert g.bank_of(g.pe(b, 0)) == b
        m = DeviceModel(Interconnect.SHARED_PIM, g)
        assert len(m.token_names()) == m.n_resources()
        assert len(m.refresh_units()) == g.n_banks

    @pytest.mark.parametrize("field,bad", [
        ("channels", 0), ("banks_per_channel", -1),
        ("bank_groups_per_channel", 0), ("pes_per_bank", 0),
        ("devices", 0), ("channels", 2.0),
    ])
    def test_validation_names_offending_dimension(self, field, bad):
        with pytest.raises(ValueError, match=field):
            DeviceGeometry(**{field: bad})

    def test_indivisible_groups_names_both_dimensions(self):
        with pytest.raises(ValueError) as ei:
            DeviceGeometry(banks_per_channel=10, bank_groups_per_channel=4)
        assert "banks_per_channel" in str(ei.value)
        assert "bank_groups_per_channel" in str(ei.value)

    @MODES
    def test_hbm_schedule_vector_equals_scalar_and_reference(self, mode):
        g = build_partitioned_ir("pmm", mode, HBM, policy="round_robin",
                                 n=32)
        v = engine.run(g, DeviceModel(mode, HBM), device="cpu")
        s = engine.run(g, DeviceModel(mode, HBM), engine="scalar",
                       device="cpu")
        assert_same(v, s, STAT_FIELDS)
        rg = _ref("device").build_partitioned_ir(
            "pmm", _rmode(mode), _rgeom(HBM), policy="round_robin", n=32)
        _same_graph(g, rg)
        want = _ref("core.engine").run(rg, _ref("device").DeviceModel(
            _rmode(mode), _rgeom(HBM)))
        assert_same(v, want, STAT_FIELDS)


class TestFleetLlama4:
    FLEET = DeviceGeometry(channels=2, banks_per_channel=4,
                           bank_groups_per_channel=2, pes_per_bank=8,
                           devices=2)

    def test_llama4_spans_devices_and_sharedpim_wins(self):
        geom = self.FLEET
        results = {}
        for mode in Interconnect:
            g = build_partitioned_ir("llama4-maverick-400b-a17b", mode, geom,
                                     policy="round_robin", phase="decode",
                                     n_layers=2)
            banks = {geom.bank_of(pe) for pe in g.pe.tolist()}
            assert {geom.device_of_bank(b) for b in banks} == {0, 1}
            results[mode] = engine.run(g, DeviceModel(mode, geom),
                                       device="cpu")
            import repro.frontend  # noqa: F401  (registers the model apps)
            rg = _ref("device").build_partitioned_ir(
                "llama4-maverick-400b-a17b", _rmode(mode), _rgeom(geom),
                policy="round_robin", phase="decode", n_layers=2)
            _same_graph(g, rg)
            assert_same(results[mode], _ref("core.engine").run(
                rg, _ref("device").DeviceModel(_rmode(mode), _rgeom(geom))),
                STAT_FIELDS)
        sp = results[Interconnect.SHARED_PIM]
        li = results[Interconnect.LISA]
        assert sp.rows_by_route.get("fleet", 0) > 0
        assert sp.bus_busy_ns["d2d"] > 0.0
        assert sp.makespan_ns < li.makespan_ns

    def test_single_device_has_no_fleet_accounting(self):
        g = build_partitioned_ir("pmm", Interconnect.SHARED_PIM, GEOM,
                                 policy="round_robin", n=20)
        r = engine.run(g, DeviceModel(Interconnect.SHARED_PIM, GEOM),
                       device="cpu")
        assert "fleet" not in r.rows_by_route
        assert "d2d" not in r.bus_busy_ns


# --- imports, entry points, chip_smoke's copies ------------------------------


def test_lazy_package_exports_the_references_names():
    ref_names = {n for n in dir(_ref("device")) if not n.startswith("_")}
    ref_names -= {"annotations", "batch", "geometry", "interconnect",
                  "partition", "resources", "scheduler", "reference"}
    assert ref_names == set(pdevice._EXPORTS)
    for name in ref_names:
        assert getattr(pdevice, name) is not None
    assert pdevice.resolve("cpu") == torch.device("cpu")
    with pytest.raises(AttributeError):
        pdevice.no_such_name


@pytest.mark.parametrize("first", ["repro_torch.core.engine",
                                   "repro_torch.models.model"])
def test_fresh_interpreter_imports(first):
    """Each module imported first in a fresh interpreter: the engine and the
    device package import each other, so neither order may fail, and the
    model's import stays off the simulator."""
    code = (f"import sys, {first}\n"
            "import repro_torch.core.engine, repro_torch.models.model\n"
            "from repro_torch import device\n"
            "assert device.DeviceGeometry().total_pes == 16\n"
            "print(sorted(m for m in sys.modules if m.startswith("
            "('repro_torch.device.', 'repro_torch.passes', "
            "'repro_torch.frontend'))))\n")
    if first == "repro_torch.models.model":
        code = ("import sys, repro_torch.models.model\n"
                "assert 'repro_torch.device.partition' not in sys.modules\n"
                "assert 'repro_torch.core.engine' not in sys.modules\n"
                + code)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**__import__("os").environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "repro_torch.device.geometry" in out.stdout


def test_dispatch_counters_agree_with_the_profile_hook():
    """``engine_vec.advance.batches`` counts what the profile hook's
    ``batches`` sums, ``wide_batches`` the batches past ``SCALAR_K``."""
    from repro_torch.core import engine_vec

    class Prof:
        def record_admit(self, **kw):
            pass

        def record_advance(self, **kw):
            self.batches = getattr(self, "batches", 0) + kw["batches"]
            self.probes = getattr(self, "probes", 0) + kw["vector_probes"]

    geom = DeviceGeometry(channels=2, banks_per_channel=8,
                          bank_groups_per_channel=2)
    g = build_partitioned_ir("mm", Interconnect.LISA, geom,
                             policy="round_robin", n=32)
    engine_vec.advance.batches = engine_vec.advance.wide_batches = 0
    prof = Prof()
    s = engine.EngineSession(DeviceModel(Interconnect.LISA, geom),
                             profile=prof, device="cpu")
    s.admit(g)
    s.advance(until=1e5)
    s.advance()
    assert engine_vec.advance.batches == prof.batches > 0
    assert 0 < engine_vec.advance.wide_batches < prof.batches
    assert prof.probes > 0


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    g = build_partitioned_ir("mm", Interconnect.LISA, GEOM, n=8)
    for call in (lambda: BatchRunner(),
                 lambda: dbatch.run_grid([]),
                 lambda: dev_sched.schedule(g, Interconnect.LISA, GEOM),
                 lambda: dev_sched.compare(g, GEOM)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_chip_smoke_keeps_the_golden_grid():
    cs = _chip_smoke()
    assert cs.GOLDEN_APP_KW == capture_goldens.APP_KW
    assert cs.GOLDEN_GEOMETRIES == capture_goldens.GEOMETRIES
    assert {k: [dataclasses.asdict(t) for t in v]
            for k, v in cs.GOLDEN_SYNTH.items()} == \
        {k: [dataclasses.asdict(t) for t in v]
         for k, v in capture_goldens.SYNTH.items()}
    assert cs.pim_device_record is not None
    assert cs.PIM_HBM == dict(channels=16, banks_per_channel=16,
                              bank_groups_per_channel=4, pes_per_bank=16)


# --- the card ----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("gname,app,scaling,policy",
                         [c for c in DEVICE_CASES if c[1] in ("pmm", "bfs")])
def test_device_goldens_on_the_card(gname, app, scaling, policy):
    _need_cuda()
    geom = DeviceGeometry(**GEOMETRIES[gname])
    for mode in Interconnect:
        g = build_partitioned_ir(app, mode, geom, policy=policy,
                                 scaling=scaling, **APP_KW[app])
        r = dev_sched.schedule(g, mode, geom, device="cuda")
        key = f"{app}/{mode.value}/{gname}/{scaling}/{policy}"
        assert device_record(r) == GOLDEN["device"][key], key


@pytest.mark.cuda
@MODES
def test_hbm_schedule_on_the_card(mode):
    _need_cuda()
    cfg = SweepConfig.make("pmm", mode, HBM, policy="round_robin", n=32)
    got = BatchRunner().run([cfg])[0]
    assert_same(got, BatchRunner(device="cpu").run([cfg])[0], BATCH_FIELDS)
    assert_same(got, _scalar_result(partition.partitioned_struct(
        "pmm", HBM, policy="round_robin", n=32), mode, HBM), BATCH_FIELDS)
