"""The port's resource-token engine and single-bank scheduler
(``repro_torch.core.{engine, engine_vec, scheduler, reference}``) against
the reference package and the golden schedules, bit for bit (no
tolerance): every float accumulator, count and finish time must be
identical.

* the ten ``core`` entries of ``tests/golden_schedules.json`` by the vector
  engine (the session default) and by the scalar oracle;
* seeded random graphs, one generator feeding both packages: the port's
  vector and scalar engines, its ``reference`` scheduler and the reference
  package's ``scheduler`` all equal; sessions with refresh, horizons,
  mid-flight admits and stop-on-completion equal to the reference's scalar
  engine; wide banks whose frontiers take the batched tensor path;
* the observability hooks (a recorder and a profile, duck-typed) record
  what the reference's record;
* the slice as a whole: every row of ``benchmarks.paper_tables.run_all()``
  but its wall-clock rows, recomputed from the port at the paper's sizes
  (``chip_smoke.pim_paper_rows``), equal to the reference's;
* entry points default to ``cuda`` and raise without a card; ``cuda``-marked
  cases repeat the goldens and a paper-size app on the card.

The reference package is imported only inside the tests.
"""

import dataclasses
import importlib
import importlib.util
import json
import pathlib
import random

import pytest
import torch

from capture_goldens import APP_KW, core_record
from repro_torch.core import engine, engine_vec, ir, reference, scheduler
from repro_torch.core import taskgraph
from repro_torch.core.engine import BankModel, EngineSession, RefreshSpec
from repro_torch.core.pluto import Interconnect
from repro_torch.core.scheduler import Task

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = json.loads((ROOT / "tests" / "golden_schedules.json").read_text())

STAT_FIELDS = ("makespan_ns", "op_busy_ns", "move_busy_ns", "stall_ns",
               "n_ops", "n_moves", "n_rows_moved", "n_cross_moves",
               "energy_j", "rows_by_route", "bus_busy_ns", "finish_times",
               "refresh_ns", "n_refresh_windows", "op_energy_j",
               "move_energy_j", "refresh_energy_j", "total_energy_j")
RESULT_FIELDS = ("makespan_ns", "op_busy_ns", "move_busy_ns", "stall_ns",
                 "n_ops", "n_moves", "n_rows_moved", "finish_times",
                 "transfer_energy_j", "compute_energy_j")
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
    return importlib.import_module(f"repro.core.{name}")


def _rmode(mode):
    return _ref("pluto").Interconnect(mode.value)


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


def _result(st, mode):
    """An ``EngineStats`` as the scheduler's ``ScheduleResult``."""
    return scheduler.ScheduleResult(
        mode, st.makespan_ns, st.op_busy_ns, st.move_busy_ns, st.stall_ns,
        st.n_ops, st.n_moves, st.n_rows_moved, st.finish_times)


def _rgraph(g):
    """The port's graph as the reference's, field for field."""
    rir = _ref("ir")
    return rir.TaskGraph(**{f: getattr(g, f).numpy().copy()
                            for f in ir.ARRAY_FIELDS}, tags=g.tags)


def seeded_tasks(rng, n, n_pes=16, bcast=True):
    """A random DAG of ops and moves (some broadcasts) on ``n_pes`` PEs."""
    tasks = []
    for i in range(n):
        deps = tuple(d for d in range(max(0, i - 4), i)
                     if rng.random() < 0.5)
        if rng.random() < 0.5:
            tasks.append(Task(i, "op", deps=deps, pe=rng.randrange(n_pes),
                              duration=rng.uniform(1.0, 1e4)))
        else:
            src = rng.randrange(n_pes)
            others = [d for d in range(n_pes) if d != src]
            dst = tuple(rng.sample(others, rng.randint(2, 6))) \
                if bcast and rng.random() < 0.25 else rng.choice(others)
            tasks.append(Task(i, "move", deps=deps, src=src, dst=dst,
                              rows=rng.randint(1, 8)))
    return tasks


def wide_tasks(rng, width, depth, n_pes, p_move=0.2):
    """Independent per-PE chains over ``n_pes`` PEs, a share of them moves
    to a near PE: frontiers wide enough that batches exceed ``SCALAR_K``
    and run on tensors."""
    tasks = []
    uid = 0
    for w in range(width):
        prev = None
        for _ in range(depth):
            deps = (prev,) if prev is not None else ()
            if rng.random() < p_move:
                src = w % n_pes
                tasks.append(Task(uid, "move", deps=deps, src=src,
                                  dst=(src + rng.randint(1, 3)) % n_pes,
                                  rows=rng.randint(1, 4)))
            else:
                tasks.append(Task(uid, "op", deps=deps, pe=w % n_pes,
                                  duration=10.0 + w + rng.random()))
            prev = uid
            uid += 1
    return tasks


# --- goldens ---------------------------------------------------------------------


@pytest.mark.parametrize("app", sorted(APP_KW))
@MODES
@pytest.mark.parametrize("eng", ["vector", "scalar"])
def test_golden_core_schedules(app, mode, eng):
    tasks = taskgraph.build(app, mode, **APP_KW[app])
    if eng == "vector":
        r = scheduler.schedule(tasks, mode, device="cpu")
    else:
        r = _result(engine.run(ir.from_tasks(tasks), BankModel(mode),
                               engine="scalar", device="cpu"), mode)
    assert core_record(r) == GOLDEN["core"][f"{app}/{mode.value}"]
    assert core_record(reference.schedule(tasks, mode)) == \
        GOLDEN["core"][f"{app}/{mode.value}"]


# --- one-shot schedules on random graphs -----------------------------------------


@pytest.mark.parametrize("seed", range(16))
@MODES
def test_random_graphs_all_agree(seed, mode):
    rng = random.Random(7919 * seed + 1)
    tasks = seeded_tasks(rng, rng.randint(2, 50))
    g = ir.from_tasks(tasks)
    vec = scheduler.schedule(g, mode, device="cpu")
    sca = _result(engine.run(g, BankModel(mode), engine="scalar",
                             device="cpu"), mode)
    ref = reference.schedule(tasks, mode)
    rtasks = [_ref("scheduler").Task(**dataclasses.asdict(t))
              for t in tasks]
    jax_pkg = _ref("scheduler").schedule(rtasks, _rmode(mode))
    for other in (sca, ref, jax_pkg):
        assert_same(vec, other, RESULT_FIELDS)


@pytest.mark.parametrize("case", ["mm", "chains", "chains+moves"])
@MODES
def test_wide_banks_take_the_tensor_path(case, mode):
    rng = random.Random(len(case))
    if case == "mm":
        n_pes = 128
        g = taskgraph.build_ir("mm", mode, n=32, n_pes=n_pes)
    else:
        n_pes = 256 if case == "chains" else 128
        g = ir.from_tasks(wide_tasks(rng, 256, 4, n_pes,
                                     0.0 if case == "chains" else 0.2))

    class Prof:
        def record_admit(self, **kw):
            pass

        def record_advance(self, **kw):
            self.kw = kw

    prof = Prof()
    s = EngineSession(BankModel(mode, n_pes), profile=prof, device="cpu")
    s.admit(g)
    s.advance()
    # under Shared-PIM every move claims the bus, so moves cut batches
    if case != "chains+moves" or mode is Interconnect.LISA:
        assert prof.kw["vector_probes"] > 0
    want = _ref("engine").run(_rgraph(g), _ref("engine").BankModel(
        _rmode(mode), n_pes))
    assert_same(s.stats(), want, STAT_FIELDS)
    assert_same(s.stats(), engine.run(g, BankModel(mode, n_pes),
                                      engine="scalar", device="cpu"),
                STAT_FIELDS)


@MODES
def test_paper_size_app_vector_equals_scalar(mode):
    g = taskgraph.build_ir("ntt", mode, n=512, n_pes=64)
    v = engine.run(g, BankModel(mode, 64), device="cpu")
    s = engine.run(g, BankModel(mode, 64), engine="scalar", device="cpu")
    assert_same(v, s, STAT_FIELDS)
    assert engine.oracle_makespan(g, BankModel(mode, 64),
                                  device="cpu") == v.makespan_ns


# --- sessions: refresh, horizons, mid-flight admits, early stops -----------------


def _drive_both(model_of, drive, refresh=None, **kw):
    """``drive`` on the port's vector and scalar sessions and on the
    reference's scalar session; their stats and ``drive``'s returns."""
    out = []
    for pkg, eng in (("port", "vector"), ("port", "scalar"),
                     ("ref", "scalar")):
        if pkg == "port":
            s = EngineSession(model_of(engine), refresh=refresh, engine=eng,
                              device="cpu", **kw)
        else:
            rspec = None if refresh is None else \
                _ref("engine").RefreshSpec(**dataclasses.asdict(refresh))
            s = _ref("engine").EngineSession(model_of(_ref("engine")),
                                             refresh=rspec, engine=eng, **kw)
        ret = drive(s, pkg)
        out.append((s.stats(), ret))
    return out


@pytest.mark.parametrize("seed", range(12))
@MODES
def test_refresh_horizons_midflight(seed, mode):
    rng = random.Random(1000 * seed + 7)
    t1 = seeded_tasks(rng, rng.randint(2, 40))
    t2 = seeded_tasks(rng, rng.randint(2, 40))
    at = rng.uniform(1.0, 5e4)
    spec = RefreshSpec(interval_ns=rng.uniform(500.0, 9000.0),
                       duration_ns=50.0, stagger=bool(seed % 2)) \
        if seed % 3 else None
    gs = {"port": [ir.from_tasks(t) for t in (t1, t2)]}
    gs["ref"] = [_rgraph(g) for g in gs["port"]]

    def drive(s, pkg):
        g1, g2 = gs[pkg]
        s.admit(g1)
        s.advance(until=at)
        s.admit(g2, at=at)
        horizon = at
        while s.n_pending_tasks:
            horizon *= 1.7
            s.advance(until=horizon)
        s.advance()
        return [s.job(j) for j in range(s.n_jobs)]

    out = _drive_both(lambda m: m.BankModel(_pmode(m, mode)), drive,
                      refresh=spec)
    (v, vj), (sc, sj), (ref, rj) = out
    assert_same(v, sc, STAT_FIELDS)
    assert_same(v, ref, STAT_FIELDS)
    assert [dataclasses.astuple(j) for j in vj] == \
        [dataclasses.astuple(j) for j in sj] == \
        [dataclasses.astuple(j) for j in rj]


@pytest.mark.parametrize("seed", range(12))
@MODES
def test_stop_on_completion(seed, mode):
    rng = random.Random(31 * seed + 5)
    wide = seed % 3 == 2
    n_pes = 64 if wide else 16
    parts = [wide_tasks(rng, 80, 3, n_pes) if wide else
             seeded_tasks(rng, rng.randint(2, 30)) for _ in range(3)]
    gs = {"port": [ir.from_tasks(t) for t in parts]}
    gs["ref"] = [_rgraph(g) for g in gs["port"]]

    def drive(s, pkg):
        for g in gs[pkg]:
            s.admit(g)
        order = []
        while s.n_pending_tasks:
            order.extend(s.advance(stop_on_completion=True))
        return order

    out = _drive_both(lambda m: m.BankModel(_pmode(m, mode), n_pes), drive)
    (v, vo), (sc, so), (ref, ro) = out
    assert_same(v, sc, STAT_FIELDS)
    assert_same(v, ref, STAT_FIELDS)
    assert vo == so == ro


def _pmode(m, mode):
    """``mode`` in engine module ``m``'s package."""
    pkg = m.__name__.rsplit(".", 1)[0]
    return importlib.import_module(f"{pkg}.pluto").Interconnect(mode.value)


def test_stop_on_completion_keeps_the_frontier_sorted():
    # two jobs whose first completion leaves successor pushes appended but
    # not yet sorted into the frontier: the next advance must re-sort them
    # (the reference's vector engine lost that flag and ran out of
    # priority order; its scalar engine is the oracle here)
    rng = random.Random(4)
    found = 0
    for trial in range(200):
        parts = [seeded_tasks(rng, rng.randint(8, 30), bcast=False)
                 for _ in range(2)]
        mode = Interconnect.SHARED_PIM if trial % 2 else Interconnect.LISA
        gp = [ir.from_tasks(t) for t in parts]
        gr = [_rgraph(g) for g in gp]

        def drive(s, gs):
            for g in gs:
                s.admit(g)
            order = []
            while s.n_pending_tasks:
                order.extend(s.advance(stop_on_completion=True))
            return order, s.stats()

        want = drive(_ref("engine").EngineSession(
            _ref("engine").BankModel(_rmode(mode)), engine="scalar"), gr)
        got = drive(EngineSession(BankModel(mode), device="cpu"), gp)
        assert got[0] == want[0]
        assert_same(got[1], want[1], STAT_FIELDS)
        ref_vec = drive(_ref("engine").EngineSession(
            _ref("engine").BankModel(_rmode(mode))), gr)
        found += ref_vec[1].finish_times != want[1].finish_times
    # the seeds include schedules the flag changes
    assert found > 0


# --- general (multi-segment) moves ----------------------------------------------


def toy_cross_model(m, mode_value, n_banks=32, pes=4):
    """A resource model with cross-bank moves in engine module ``m``: PEs
    in banks of ``pes``, a tx and an rx token a PE, one bus token a pair
    of banks.  A move inside a bank is one CIRCUIT claim of the PEs it
    spans; a move across banks is a general plan of two segments, a CIRCUIT
    claim of the source bank's span, then a store-and-forward hop (source
    tx, the pair's bus, destination rx).  It stands in for the device
    models, whose general plans take the per-member path inside a batch."""
    n_pe = n_banks * pes
    tx0, rx0, bus0 = n_pe, 2 * n_pe, 3 * n_pe

    class Toy(m.ResourceModel):
        mode = importlib.import_module(
            m.__name__.rsplit(".", 1)[0] + ".pluto").Interconnect(mode_value)

        def n_resources(self):
            return bus0 + n_banks // 2

        def refresh_units(self):
            return tuple(tuple(range(b * pes, (b + 1) * pes))
                         + (tx0 + b * pes, rx0 + b * pes)
                         for b in range(n_banks))

        def compile(self, g):
            kinds = g.kinds.tolist()
            pe = g.pe.tolist()
            src = g.src.tolist()
            dsts = g.dst_flat.tolist()
            dip = g.dst_indptr.tolist()
            rows = g.rows.tolist()
            dur = g.duration.tolist()
            plan, prio, energy = [], [], []
            n_rows = n_cross = 0
            for i in range(g.n):
                if kinds[i] == 0:
                    plan.append((pe[i] % n_pe, dur[i]))
                    prio.append(dur[i])
                    energy.append(1e-9)
                    continue
                s, d, r = src[i] % n_pe, dsts[dip[i]] % n_pe, rows[i]
                n_rows += r
                lo, hi = min(s, d), max(s, d)
                if s // pes == d // pes:
                    lat = 50.0 * r * (hi - lo + 1)
                    plan.append((tuple(range(lo, hi + 1)), (hi - lo + 1,),
                                 lat))
                    prio.append(lat)
                    energy.append(2e-9 * r)
                    continue
                n_cross += 1
                b0 = s // pes * pes
                span = tuple(range(b0, b0 + pes))
                seg1 = (m.CIRCUIT, span, (pes,), 20.0 * r, ("bank_group",),
                        1e-9 * r)
                drain, transit, fill = 10.0 * r, 30.0 * r, 12.0 * r
                seg2 = (m.SAF, (tx0 + s,), (bus0 + (s // pes) // 2,),
                        (rx0 + d,), drain, transit, fill, 10.0, 30.0, 12.0,
                        drain + transit + fill, ("channel",), 3e-9 * r)
                plan.append(((seg1, seg2),))
                prio.append(20.0 * r + drain + transit + fill)
                energy.append(4e-9 * r)
            n_moves = sum(kinds)
            return m.Compiled(self.n_resources(), plan, prio,
                              n_ops=g.n - n_moves, n_moves=n_moves,
                              n_rows=n_rows, n_cross=n_cross,
                              rows_by_route={"cross": n_cross},
                              task_energy_j=energy,
                              energy_op_j=sum(e for e, k in zip(energy, kinds)
                                              if k == 0),
                              energy_move_j=sum(e for e, k in
                                                zip(energy, kinds) if k))

    return Toy()


@pytest.mark.parametrize("seed", range(6))
@MODES
def test_general_moves_in_batches(seed, mode):
    rng = random.Random(100 + seed)
    n_pe = 128
    tasks = wide_tasks(rng, 160, 4, n_pe, 0.0)
    for t in tasks:
        if rng.random() < 0.3:
            t.kind, t.src = "move", t.pe
            t.dst = (t.pe + rng.choice((1, 2, 5, 9, 40))) % n_pe
            t.pe, t.rows = None, rng.randint(1, 3)
    g = ir.from_tasks(tasks)
    spec = RefreshSpec(interval_ns=900.0, duration_ns=40.0,
                       stagger=bool(seed % 2)) if seed % 3 else None
    until = rng.uniform(200.0, 2000.0)

    def drive(s, pkg):
        s.admit(g if pkg == "port" else _rgraph(g))
        s.advance(until=until)
        s.advance()
        return None

    out = _drive_both(lambda m: toy_cross_model(m, mode.value), drive,
                      refresh=spec)
    (v, _), (sc, _), (ref, _) = out
    assert v.n_cross_moves > 0
    assert_same(v, sc, STAT_FIELDS)
    assert_same(v, ref, STAT_FIELDS)


# --- observability hooks ---------------------------------------------------------


@MODES
@pytest.mark.parametrize("eng", ["vector", "scalar"])
def test_recorder_and_profile_match_reference(mode, eng):
    """The port's recorder and profile on the port's session, the
    reference's on the reference's: the same raw stores and counters."""
    from repro_torch import obs
    robs = importlib.import_module("repro.obs")
    rng = random.Random(3)
    tasks = seeded_tasks(rng, 40)
    spec = RefreshSpec(interval_ns=2000.0, duration_ns=100.0)
    g = ir.from_tasks(tasks)
    recs = []
    for pkg in ("port", "ref"):
        lib = obs if pkg == "port" else robs
        rec, prof = lib.Recorder(), lib.EngineProfile()
        if pkg == "port":
            s = EngineSession(BankModel(mode), refresh=spec, recorder=rec,
                              profile=prof, engine=eng, device="cpu")
            s.admit(g)
        else:
            re_ = _ref("engine")
            s = re_.EngineSession(
                re_.BankModel(_rmode(mode)),
                refresh=re_.RefreshSpec(**dataclasses.asdict(spec)),
                recorder=rec, profile=prof, engine=eng)
            s.admit(_rgraph(g))
        s.advance(until=5000.0)
        s.advance()
        summ = prof.summary()
        recs.append(((rec._tasks, rec._segs, rec._refresh, rec._jobdone,
                      rec._admits),
                     {k: v for k, v in summ.items()
                      if k not in ("wall_s", "events_per_sec",
                                   "admit_energy_wall_s")}))
    assert recs[0][0] == recs[1][0]
    assert recs[0][1] == recs[1][1]


# --- the critical path and the formation bound -----------------------------------


@pytest.mark.parametrize("app,kw", [("mm", dict(n=30)), ("ntt", dict(n=64)),
                                    ("bfs", dict(n_nodes=60)),
                                    ("pmm", dict(n=40, n_pes=32))])
@MODES
def test_critical_path_and_bound(app, kw, mode):
    g = taskgraph.build_ir(app, mode, **kw)
    n_pes = kw.get("n_pes", 16)
    comp = BankModel(mode, n_pes).compile(g)
    cp = engine.critical_path(g, comp.prio_dur, "cpu")
    rg = _ref("taskgraph").build_ir(app, _rmode(mode), **kw)
    rcomp = _ref("engine").BankModel(_rmode(mode), n_pes).compile(rg)
    want = _ref("engine").critical_path(rg, rcomp.prio_dur)
    assert cp.dtype == torch.float64 and cp.tolist() == want.tolist()
    assert comp.exec_plan == rcomp.exec_plan
    assert comp.prio_dur == rcomp.prio_dur
    assert comp.task_energy_j == rcomp.task_energy_j
    assert (comp.n_ops, comp.n_moves, comp.n_rows, comp.rows_by_route,
            comp.energy_op_j, comp.energy_move_j) == \
        (rcomp.n_ops, rcomp.n_moves, rcomp.n_rows, rcomp.rows_by_route,
         rcomp.energy_op_j, rcomp.energy_move_j)
    si, sf = g.successors()
    m = engine_vec.min_succ_neg_cp(si, sf, -cp)
    rsi, rsf = rg.successors()
    rm = importlib.import_module("repro.core.engine_vec").min_succ_neg_cp(
        rsi, rsf, -want)
    assert m.tolist() == rm.tolist()
    # a graph wide for its depth takes the levelized sweep, whose plan is
    # cached under its device
    if g.n >= 8 * (int(g.levels().max()) + 1):
        assert ("cp_plan", "cpu") in g._derived


def test_session_api():
    g = ir.from_tasks([Task(0, "op", pe=0, duration=10.0),
                       Task(1, "op", deps=(0,), pe=0, duration=5.0)])
    s = EngineSession(BankModel(Interconnect.LISA), device="cpu")
    assert isinstance(s.free, torch.Tensor) and s.free.dtype == torch.float64
    assert s.free.device.type == "cpu" and s.device.type == "cpu"
    assert s.admit(g) == 0
    assert s.admit(g, at=3.0) == 1
    assert s.job(1).uid_offset == 2 and s.n_jobs == 2
    # the second job's first op waits for the PE; a horizon of 12 ns
    # defers only the task ready at 20 ns
    assert s.advance(until=12.0) == [0]
    assert s.n_pending_tasks == 1 and not s.job(1).done
    assert s.advance() == [1]
    assert s.job(1).finish_ns == 30.0
    assert s.makespan() == s.stats().makespan_ns == 30.0
    with pytest.raises(ValueError, match="engine"):
        EngineSession(BankModel(Interconnect.LISA), engine="simd",
                      device="cpu")
    with pytest.raises(ValueError, match="interval_ns"):
        RefreshSpec(interval_ns=0.0)


# --- the slice as a whole: the paper's tables ------------------------------------


def test_paper_tables_from_the_port():
    """Every row of ``benchmarks.paper_tables.run_all()`` but the seven
    wall-clock rows, from the port at the paper's sizes, equal to the
    reference's: name, value, paper value and verdict."""
    paper_tables = importlib.import_module("benchmarks.paper_tables")
    want = [r for r in paper_tables.run_all()
            if not r[0].endswith(".bench_wall_us")]
    cs = _chip_smoke()
    got = cs.pim_paper_rows("cpu")
    assert len(got) == len(want) == cs.PIM_ROWS
    assert sum(r[2] is not None for r in got) == cs.PIM_PAPER_ROWS
    assert got == want
    assert all(r[3] for r in got)


# --- the card ---------------------------------------------------------------------


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    g = taskgraph.build_ir("ntt", Interconnect.LISA, n=16)
    for call in (lambda: scheduler.schedule(g, Interconnect.LISA),
                 lambda: scheduler.compare(g),
                 lambda: engine.run(g, BankModel(Interconnect.LISA)),
                 lambda: engine.oracle_makespan(g, BankModel(
                     Interconnect.LISA)),
                 lambda: EngineSession(BankModel(Interconnect.LISA)),
                 lambda: EngineSession(BankModel(Interconnect.LISA),
                                       engine="scalar")):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


@pytest.mark.cuda
@pytest.mark.parametrize("app", sorted(APP_KW))
@MODES
def test_golden_core_schedules_on_the_card(app, mode):
    _need_cuda()
    g = taskgraph.build_ir(app, mode, **APP_KW[app])
    # the host first, then the card, then the host: caches keyed by device
    for dev in ("cpu", "cuda", "cpu"):
        s = EngineSession(BankModel(mode), device=dev)
        assert s.free.device.type == dev
        s.admit(g)
        s.advance()
        assert core_record(_result(s.stats(), mode)) == \
            GOLDEN["core"][f"{app}/{mode.value}"]


@pytest.mark.cuda
@MODES
def test_paper_size_app_on_the_card(mode):
    _need_cuda()
    g = taskgraph.build_ir("pmm", mode, n=300)
    got = scheduler.schedule(g, mode, device="cuda")
    want = _result(engine.run(g, BankModel(mode), engine="scalar",
                              device="cpu"), mode)
    assert_same(got, want, RESULT_FIELDS)
    wide = taskgraph.build_ir("mm", mode, n=64, n_pes=256)
    assert_same(engine.run(wide, BankModel(mode, 256), device="cuda"),
                engine.run(wide, BankModel(mode, 256), engine="scalar",
                           device="cpu"), STAT_FIELDS)
