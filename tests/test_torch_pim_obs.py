"""The port's observability layer (``repro_torch.obs``: metrics, profile,
trace, viewer) against the reference package, bit for bit and byte for
byte.

Mirrors ``tests/test_obs.py`` and the recorder, attribution, power and
serving-energy tests of ``tests/test_energy.py``.  Each case runs the same
graph, refresh spec and trace through both packages and holds every
scheduled float, every utilization and attribution value, every power bin,
every metrics snapshot and the Chrome trace JSON's bytes to the
reference's.  ``cuda``-marked cases record on the card and hold its trace
to the host's; they skip where there is no card.  The reference package is
imported only inside the tests.
"""

import dataclasses
import importlib
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import ir, taskgraph
from repro_torch.core.engine import BankModel, EngineSession, RefreshSpec
from repro_torch.core.pluto import Interconnect
from repro_torch.device import DeviceGeometry
from repro_torch.device.batch import SweepConfig
from repro_torch.device.partition import build_partitioned_ir
from repro_torch.device.resources import DeviceModel
from repro_torch.obs.metrics import energy_attribution
from repro_torch.obs.trace import Recorder, record_sweep
from repro_torch.runtime import ServingRuntime, open_loop_trace, summarize

ROOT = Path(__file__).resolve().parents[1]
GEOM = DeviceGeometry(channels=1, banks_per_channel=4)
EGEOM = DeviceGeometry(channels=1, banks_per_channel=4,
                       bank_groups_per_channel=2)
REFRESH = RefreshSpec(interval_ns=3900.0, duration_ns=350.0)
MODES = pytest.mark.parametrize("mode", list(Interconnect),
                                ids=lambda m: m.value)
STAT_FIELDS = ("makespan_ns", "op_busy_ns", "move_busy_ns", "stall_ns",
               "n_ops", "n_moves", "n_rows_moved", "n_cross_moves",
               "energy_j", "rows_by_route", "bus_busy_ns", "finish_times",
               "refresh_ns", "n_refresh_windows", "op_energy_j",
               "move_energy_j", "refresh_energy_j")
ENERGY_FIELDS = ("op_energy_j", "move_energy_j", "refresh_energy_j")
#: profile summary keys that are wall clocks (differ run to run)
WALL_KEYS = ("wall_s", "events_per_sec", "admit_energy_wall_s")


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


def _rspec(spec):
    return _ref("core.engine").RefreshSpec(**dataclasses.asdict(spec))


def _rgraph(g):
    """The port's graph as the reference's, field for field."""
    return _ref("core.ir").TaskGraph(
        **{f: getattr(g, f).numpy().copy() for f in ir.ARRAY_FIELDS},
        tags=g.tags)


def _rcfg(cfg):
    _ref("frontend")                      # registers the model apps
    return _ref("device.batch").SweepConfig.make(
        cfg.app, _rmode(cfg.mode), _rgeom(cfg.geometry), **cfg.kwargs)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def device_graph(mode, app="pmm", geom=GEOM, **kw):
    return build_partitioned_ir(app, mode, geom, **(kw or dict(n=16)))


def _trace_bytes(rec, metadata=None) -> bytes:
    return json.dumps(rec.chrome_trace(metadata), sort_keys=True,
                      separators=(",", ":")).encode()


def _both_sessions(mode, graphs, *, geom=GEOM, refresh=REFRESH,
                   engine="vector"):
    """The graphs admitted at t=0 to a recorded session of each package;
    returns ((port session, recorder), (reference session, recorder))."""
    out = []
    for pkg in ("port", "ref"):
        if pkg == "port":
            rec = obs.Recorder()
            s = EngineSession(DeviceModel(mode, geom), refresh=refresh,
                              recorder=rec, engine=engine, device="cpu")
            for g in graphs:
                s.admit(g)
        else:
            rec = _ref("obs").Recorder()
            s = _ref("core.engine").EngineSession(
                _ref("device.resources").DeviceModel(_rmode(mode),
                                                     _rgeom(geom)),
                refresh=None if refresh is None else _rspec(refresh),
                recorder=rec)
            for g in graphs:
                s.admit(_rgraph(g))
        s.advance()
        out.append((s, rec))
    return out


def assert_stats(got, want, fields=STAT_FIELDS):
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f


# --- recording is observational ---------------------------------------------------


class TestRecordingChangesNothing:
    @MODES
    @pytest.mark.parametrize("engine", ["vector", "scalar"])
    def test_recorded_stats_equal_plain_and_reference(self, mode, engine):
        g = device_graph(mode)
        plain = EngineSession(DeviceModel(mode, GEOM), refresh=REFRESH,
                              engine=engine, device="cpu")
        plain.admit(g)
        plain.advance()
        rec = obs.Recorder()
        prof = obs.EngineProfile()
        observed = EngineSession(DeviceModel(mode, GEOM), refresh=REFRESH,
                                 recorder=rec, profile=prof, engine=engine,
                                 device="cpu")
        observed.admit(g)
        observed.advance()
        assert observed.stats() == plain.stats()
        (_, _), (rs, rrec) = _both_sessions(mode, [g])
        assert_stats(observed.stats(), rs.stats())
        assert (rec._tasks, rec._segs, rec._refresh, rec._admits,
                rec._jobdone) == (rrec._tasks, rrec._segs, rrec._refresh,
                                  rrec._admits, rrec._jobdone)

    def test_recorder_rejects_second_session(self):
        rec = obs.Recorder()
        EngineSession(BankModel(Interconnect.LISA), recorder=rec,
                      device="cpu")
        with pytest.raises(ValueError, match="already attached"):
            EngineSession(BankModel(Interconnect.LISA), recorder=rec,
                          device="cpu")

    def test_record_sweep_defaults_to_the_card(self):
        cfg = SweepConfig.make("mm", Interconnect.LISA, GEOM, n=8)
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default runs there")
        with pytest.raises(RuntimeError, match="cuda"):
            record_sweep(cfg)


# --- trace structure --------------------------------------------------------------


class TestChromeTrace:
    @pytest.fixture(scope="class")
    def recorded(self):
        cfg = SweepConfig.make("mm", Interconnect.SHARED_PIM, GEOM, n=16)
        return (record_sweep(cfg, refresh=REFRESH, device="cpu"),
                _ref("obs").record_sweep(_rcfg(cfg), refresh=_rspec(REFRESH)))

    def test_events_well_formed(self, recorded):
        rec = recorded[0]
        doc = rec.chrome_trace()
        assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
        makespan_us = rec._session.stats().makespan_ns / 1e3
        for e in doc["traceEvents"]:
            assert e["ph"] in ("X", "i", "C", "M")
            if e["ph"] == "X":
                assert e["dur"] >= 0.0
                assert 0.0 <= e["ts"] <= e["ts"] + e["dur"] <= makespan_us

    def test_every_token_has_a_named_track(self, recorded):
        rec = recorded[0]
        doc = rec.chrome_trace()
        names = {(e["pid"], e.get("tid")): e["args"]["name"]
                 for e in doc["traceEvents"]
                 if e["ph"] == "M" and e["name"] == "thread_name"}
        model = rec._session.model
        for tid, want in enumerate(model.token_names()):
            assert names[(0, tid)] == want
        n_res = len(model.token_names())
        for u, want in enumerate(model.refresh_unit_names()):
            assert names[(0, n_res + u)] == want
        for e in doc["traceEvents"]:
            if e["ph"] == "X" and e["pid"] == 0:
                assert (0, e["tid"]) in names

    def test_metadata_carries_provenance(self, recorded):
        rec = recorded[0]
        other = rec.chrome_trace({"extra": 1})["otherData"]
        assert other["interconnect"] == "shared_pim"
        assert other["extra"] == 1
        (job,) = other["jobs"]
        assert job["n_tasks"] == rec._session.job(0).n_tasks
        assert len(job["graph_fingerprint"]) == 16

    def test_refresh_tracks_present(self, recorded):
        rec = recorded[0]
        doc = rec.chrome_trace()
        n_res = len(rec._session.model.token_names())
        refresh_events = [e for e in doc["traceEvents"]
                          if e["ph"] == "X" and e["pid"] == 0
                          and e["tid"] >= n_res]
        assert len(refresh_events) == len(rec._refresh) > 0

    def test_utilization_fractions_equal_the_reference(self, recorded):
        rec, rrec = recorded
        util = obs.utilization(rec)
        assert util
        for name, frac in util.items():
            assert 0.0 <= frac <= 1.0, name
        assert any(frac > 0.0 for frac in util.values())
        assert util == _ref("obs").utilization(rrec)
        span = rec._session.stats().makespan_ns * 2.0
        assert obs.utilization(rec, span_ns=span) == \
            _ref("obs").utilization(rrec, span_ns=span)

    def test_trace_bytes_equal_the_reference(self, recorded):
        rec, rrec = recorded
        meta = {"cell": "mm", "n": 16}
        assert _trace_bytes(rec, meta) == _trace_bytes(rrec, meta)
        assert rec.n_events == rrec.n_events
        for windows in (7, 120):
            assert rec.power_series(windows=windows) == \
                rrec.power_series(windows=windows)
        assert rec.chrome_trace(power_windows=0) == \
            rrec.chrome_trace(power_windows=0)

    def test_utilization_needs_a_session(self):
        with pytest.raises(ValueError, match="never attached"):
            obs.utilization(obs.Recorder())
        with pytest.raises(ValueError, match="never attached"):
            obs.Recorder().chrome_trace()


@pytest.mark.parametrize("app,kw", [
    ("mm", dict(n=16)), ("ntt", dict(n=32)),
    ("qwen2-moe-a2.7b", dict(phase="decode", n_layers=2))])
@MODES
def test_record_sweep_equals_the_reference(app, kw, mode):
    """Every recorded cell (refresh on, two- and three-leg moves) exports
    the reference's bytes, with the reference's rewrite-log metadata."""
    geom = DeviceGeometry(channels=1, banks_per_channel=4,
                          bank_groups_per_channel=2, pes_per_bank=8)
    cfg = SweepConfig.make(app, mode, geom, **kw)
    rec = record_sweep(cfg, refresh=REFRESH, device="cpu")
    rrec = _ref("obs").record_sweep(_rcfg(cfg), refresh=_rspec(REFRESH))
    assert _trace_bytes(rec) == _trace_bytes(rrec)
    assert energy_attribution(rec) == _ref("obs").energy_attribution(rrec)


class TestGraphFingerprint:
    def test_stable_and_sensitive(self):
        a = taskgraph.build_ir("mm", Interconnect.LISA, n=8)
        b = taskgraph.build_ir("mm", Interconnect.LISA, n=8)
        c = taskgraph.build_ir("mm", Interconnect.SHARED_PIM, n=8)
        assert obs.graph_fingerprint(a) == obs.graph_fingerprint(b)
        assert obs.graph_fingerprint(a) != obs.graph_fingerprint(c)

    def test_one_definition_equal_to_the_reference(self):
        assert obs.graph_fingerprint is ir.graph_fingerprint
        for mode in Interconnect:
            g = device_graph(mode, app="bfs", n_nodes=40)
            assert obs.graph_fingerprint(g) == \
                _ref("obs").graph_fingerprint(_rgraph(g))


# --- byte determinism -------------------------------------------------------------


def _serving_tenants(pkg):
    return [pkg.TenantSpec.make("a", "mm", rate_jps=2e5, banks=2, n=12),
            pkg.TenantSpec.make("b", "mm", rate_jps=1e5, banks=1, n=8)]


class TestDeterminism:
    def test_record_sweep_twice_byte_identical(self, tmp_path):
        cfg = SweepConfig.make("qwen2-moe-a2.7b", Interconnect.LISA,
                               DeviceGeometry(channels=1, banks_per_channel=4,
                                              pes_per_bank=8),
                               phase="decode", n_layers=2)
        pa = record_sweep(cfg, refresh=REFRESH,
                          device="cpu").dump(tmp_path / "a.json")
        pb = record_sweep(cfg, refresh=REFRESH,
                          device="cpu").dump(tmp_path / "b.json")
        pr = _ref("obs").record_sweep(
            _rcfg(cfg), refresh=_rspec(REFRESH)).dump(tmp_path / "r.json")
        assert pa.read_bytes() == pb.read_bytes() == pr.read_bytes()
        json.loads(pa.read_text())

    def test_serving_trace_byte_identical(self, tmp_path):
        reqs = open_loop_trace(_serving_tenants(
            importlib.import_module("repro_torch.runtime")),
            jobs_per_tenant=3, seed=3)

        def one(path):
            rt = ServingRuntime(Interconnect.SHARED_PIM, GEOM,
                                recorder=obs.Recorder(), refresh=REFRESH,
                                device="cpu")
            rt.run(reqs)
            return rt.export_trace(path)

        pa = one(tmp_path / "a.json")
        pb = one(tmp_path / "b.json")
        rrt = _ref("runtime")
        rt = rrt.ServingRuntime(_rmode(Interconnect.SHARED_PIM),
                                _rgeom(GEOM), recorder=_ref("obs").Recorder(),
                                refresh=_rspec(REFRESH))
        rt.run(rrt.open_loop_trace(_serving_tenants(rrt), jobs_per_tenant=3,
                                   seed=3))
        pr = rt.export_trace(tmp_path / "r.json")
        assert pa.read_bytes() == pb.read_bytes() == pr.read_bytes()
        other = json.loads(pa.read_text())["otherData"]
        assert other["admission"] == "fifo"
        assert "rewrite_logs" in other

    def test_export_trace_needs_a_recorder(self, tmp_path):
        rt = ServingRuntime(Interconnect.LISA, GEOM, device="cpu")
        with pytest.raises(ValueError, match="no recorder"):
            rt.export_trace(tmp_path / "x.json")

    def test_rewrite_log_metadata_equals_the_reference(self):
        from repro_torch import passes
        g = taskgraph.structural("qwen2-moe-a2.7b", n_pes=GEOM.total_pes,
                                 phase="decode", n_layers=2)
        _, log = passes.device_pipeline(GEOM, opt=passes.DEFAULT_OPT).run(g)
        rp = _ref("passes")
        _, rlog = rp.device_pipeline(_rgeom(GEOM),
                                     opt=rp.DEFAULT_OPT).run(_rgraph(g))
        assert obs.rewrite_log_metadata({("moe", 2): log}) == \
            _ref("obs").rewrite_log_metadata({("moe", 2): rlog})


# --- metric primitives ------------------------------------------------------------


class TestMetricPrimitives:
    def test_counter_monotonic(self):
        c = obs.Counter()
        c.inc()
        c.inc(4)
        assert c.value == 5
        with pytest.raises(ValueError):
            c.inc(-1)

    def test_gauge_series_and_time_weighted_mean(self):
        g = obs.Gauge()
        assert g.last is None and g.peak is None
        assert g.time_weighted_mean() == 0.0
        g.record(0.0, 2.0)
        g.record(10.0, 4.0)
        assert g.last == 4.0 and g.peak == 4.0
        assert g.time_weighted_mean() == 2.0
        assert g.series() == [(0.0, 2.0), (10.0, 4.0)]

    def test_histogram_summary(self):
        h = obs.Histogram()
        assert h.summary() == {"n": 0, "reliable": False}
        for v in (1.0, 2.0, 3.0, 4.0):
            h.observe(v)
        s = h.summary(percentiles=(50.0,))
        assert s["n"] == 4 and s["mean"] == 2.5
        assert s["min"] == 1.0 and s["max"] == 4.0 and s["p50"] == 2.5
        assert s["reliable"] is True

    def test_histogram_percentile_guards(self):
        h = obs.Histogram()
        assert h.percentile(99.0) == (None, False)
        h.observe(7.0)
        v, reliable = h.percentile(99.0)
        assert v == 7.0 and reliable is False
        h.observe(9.0)
        v, reliable = h.percentile(50.0)
        assert v == 8.0 and reliable is True

    def test_registry_create_on_first_use_and_snapshot(self):
        m = obs.MetricsRegistry()
        m.counter("x").inc()
        assert m.counter("x").value == 1
        m.gauge("g").record(0.0, 1.0)
        m.histogram("h").observe(2.0)
        snap = m.snapshot()
        assert snap["counters"] == {"x": 1}
        assert snap["gauges"]["g"]["last"] == 1.0
        assert snap["histograms"]["h"]["n"] == 1

    @pytest.mark.parametrize("seed", range(4))
    def test_seeded_series_equal_the_reference(self, seed):
        """Gauges, histograms and percentiles of irregular float series,
        to the last bit (the weighted mean sums pairwise, as NumPy does)."""
        rng = np.random.default_rng(seed)
        ts = np.cumsum(rng.exponential(1e3, 257)).tolist()
        vs = rng.normal(5.0, 3.0, 257).tolist()
        ports, refs = obs.MetricsRegistry(), _ref("obs").MetricsRegistry()
        for m in (ports, refs):
            for t, v in zip(ts, vs):
                m.gauge("depth").record(t, v)
                m.histogram("lat").observe(v * 1e4)
                m.counter("n").inc(abs(v))
            for p in (0.0, 33.3, 50.0, 99.0, 100.0):
                m.histogram(f"p{p}").observe(p)
        assert ports.snapshot() == refs.snapshot()
        for p in (1.0, 50.0, 99.9):
            assert ports.histogram("lat").percentile(p) == \
                refs.histogram("lat").percentile(p)

    def test_slo_attainment(self):
        rows = [dataclasses.make_dataclass("R", ["tenant", "latency_ns"])(t, v)
                for t, v in [("a", 5.0), ("a", 15.0), ("b", 1.0)]]
        att = obs.slo_attainment(rows, slo_ns=10.0)
        assert att["a"] == {"n_jobs": 2, "attained": 1, "attainment": 0.5}
        assert att["b"]["attainment"] == 1.0
        assert att == _ref("obs").slo_attainment(rows, slo_ns=10.0)
        with pytest.raises(ValueError):
            obs.slo_attainment(rows, slo_ns=0.0)


# --- self-profiling ---------------------------------------------------------------


class TestEngineProfile:
    @pytest.mark.parametrize("engine", ["vector", "scalar"])
    def test_counts_match_graph_and_the_reference(self, engine):
        mode = Interconnect.SHARED_PIM
        g = device_graph(mode)
        prof = obs.EngineProfile()
        s = EngineSession(DeviceModel(mode, GEOM), profile=prof,
                          engine=engine, device="cpu")
        s.admit(g)
        s.advance()
        assert prof.n_advances == 1
        assert prof.n_exec == g.n
        summary = prof.summary()
        assert summary["heap_pops"] == g.n
        n_sources = int((g.dep_indptr[1:] == g.dep_indptr[:-1]).sum())
        assert summary["heap_pushes"] == g.n - n_sources
        assert summary["token_probes"] > 0
        assert prof.events_per_sec > 0.0
        assert summary["refresh_windows"] == 0
        rprof = _ref("obs").EngineProfile()
        rs = _ref("core.engine").EngineSession(
            _ref("device.resources").DeviceModel(_rmode(mode), _rgeom(GEOM)),
            profile=rprof, engine=engine)
        rs.admit(_rgraph(g))
        rs.advance()
        want = rprof.summary()
        assert list(summary) == list(want)
        assert {k: v for k, v in summary.items() if k not in WALL_KEYS} == \
            {k: v for k, v in want.items() if k not in WALL_KEYS}

    def test_empty_profile(self):
        prof = obs.EngineProfile()
        assert prof.events_per_sec == 0.0
        assert prof.summary()["token_probes_per_task"] == 0.0
        assert list(prof.summary()) == \
            list(_ref("obs").EngineProfile().summary())

    def test_oracle_counters(self):
        prof = obs.EngineProfile()
        prof.record_oracle(evals=3, memo_hits=1, prunes=2, workers=4)
        prof.record_oracle(evals=1, cache_hits=5, cache_misses=1)
        assert prof.oracle_counters == {
            "oracle_evals": 4, "oracle_memo_hits": 1, "oracle_cache_hits": 5,
            "oracle_cache_misses": 1, "surrogate_prunes": 2,
            "oracle_batches": 2, "oracle_workers": 4}
        assert obs.EngineProfile.ORACLE_KEYS == \
            _ref("obs").EngineProfile.ORACLE_KEYS


# --- serving summary hardening ----------------------------------------------------


class FakeResult:
    def __init__(self, tenant, arrival, finish, admit=None):
        self.tenant = tenant
        self.arrival_ns = arrival
        self.admit_ns = arrival if admit is None else admit
        self.finish_ns = finish
        self.latency_ns = finish - arrival
        self.queue_ns = self.admit_ns - arrival


def _both_summaries(rows, **kw):
    got = summarize(rows, **kw)
    assert got == _ref("runtime").summarize(rows, **kw)
    return got


class TestSummarizePerTenant:
    def test_zero_samples(self):
        s = _both_summaries([])
        assert s["per_tenant"] == {} and s["n_jobs"] == 0
        assert s["percentile_min_samples"] == 2

    def test_one_sample_flagged_unreliable(self):
        s = _both_summaries([FakeResult("t", 0.0, 10.0)])
        row = s["per_tenant"]["t"]
        assert row["n_jobs"] == 1 and row["mean_ns"] == 10.0
        assert row["p99_ns"] == 10.0 and row["p99_reliable"] is False

    def test_two_samples_reliable_at_default_threshold(self):
        s = _both_summaries([FakeResult("t", 0.0, 10.0),
                             FakeResult("t", 0.0, 20.0)])
        row = s["per_tenant"]["t"]
        assert row["n_jobs"] == 2 and row["p99_reliable"] is True
        assert row["mean_ns"] == 15.0

    def test_min_samples_validation_and_threshold(self):
        with pytest.raises(ValueError):
            summarize([], min_samples=0)
        s = _both_summaries([FakeResult("t", 0.0, 10.0),
                             FakeResult("t", 0.0, 20.0)], min_samples=3)
        assert s["per_tenant"]["t"]["p99_reliable"] is False

    def test_seeded_rows_equal_the_reference(self):
        rng = np.random.default_rng(5)
        rows = [FakeResult(f"t{i % 3}", float(a), float(a + d),
                           admit=float(a + d * 0.3))
                for i, (a, d) in enumerate(zip(
                    np.cumsum(rng.exponential(1e4, 61)),
                    rng.exponential(3e5, 61)))]
        _both_summaries(rows, percentiles=(50.0, 90.0, 99.0, 99.9))


# --- module entry point -----------------------------------------------------------


def test_obs_module_entry_smoke(tmp_path):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "--out-dir", str(tmp_path),
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "ui.perfetto.dev" in proc.stdout
    written = sorted(p.name for p in tmp_path.glob("*.trace.json"))
    assert len(written) == 4 and "moe-decode.lisa.trace.json" in written
    viewer = _ref("obs.viewer")
    for name, (app, kw) in viewer.CELLS.items():
        for mode in Interconnect:
            geom = DeviceGeometry(channels=1, banks_per_channel=4,
                                  pes_per_bank=8)
            cfg = SweepConfig.make(app, mode, geom, **kw)
            rec = _ref("obs").record_sweep(_rcfg(cfg))
            stats = rec._session.stats()
            want = _trace_bytes(rec, {
                "cell": name, "app": app, "kw": dict(kw),
                "geometry": geom.describe(),
                "makespan_ns": stats.makespan_ns,
                "energy_j": stats.total_energy_j})
            got = (tmp_path / f"{name}.{mode.value}.trace.json").read_bytes()
            assert got == want, (name, mode)


# --- energy: attribution, power, serving (tests/test_energy.py) -------------------


class TestEnergyAttributionAndPower:
    @MODES
    def test_recorder_does_not_perturb_energy(self, mode):
        out = {}
        for rec_on in (False, True):
            s = EngineSession(DeviceModel(mode, EGEOM), refresh=RefreshSpec(),
                              recorder=Recorder() if rec_on else None,
                              device="cpu")
            s.admit(device_graph(mode, app="mm", geom=EGEOM))
            s.advance()
            out[rec_on] = s.stats()
        for f in ENERGY_FIELDS:
            assert getattr(out[True], f) == getattr(out[False], f), f

    @MODES
    def test_attribution_reconciles_and_equals_the_reference(self, mode):
        graphs = [device_graph(mode, app="mm", geom=EGEOM),
                  device_graph(mode, app="ntt", geom=EGEOM, n=16)]
        (s, rec), (_, rrec) = _both_sessions(mode, graphs, geom=EGEOM,
                                             refresh=RefreshSpec())
        st = s.stats()
        att = energy_attribution(rec)
        assert set(att["per_job_j"]) == {0, 1}
        assert all(v > 0 for v in att["per_job_j"].values())
        recon = sum(att["per_job_j"].values()) + att["unattributed_j"]
        assert att["total_j"] == pytest.approx(recon, rel=1e-12)
        assert att["refresh_j"] == pytest.approx(st.refresh_energy_j,
                                                 rel=1e-12)
        assert att["total_j"] == pytest.approx(st.total_energy_j, rel=1e-9)
        assert att == _ref("obs").energy_attribution(rrec)

    def test_attribution_per_tenant(self):
        mode = Interconnect.SHARED_PIM
        graphs = [device_graph(mode, app="mm", geom=EGEOM),
                  device_graph(mode, app="ntt", geom=EGEOM, n=16)]
        (_, rec), (_, rrec) = _both_sessions(mode, graphs, geom=EGEOM,
                                             refresh=None)
        tenants = {0: "alice", 1: "bob"}
        att = energy_attribution(rec, job_tenants=tenants)
        per_tenant = att["per_tenant_j"]
        assert set(per_tenant) == {"alice", "bob"}
        assert sum(per_tenant.values()) == pytest.approx(
            sum(att["per_job_j"].values()), rel=1e-12)
        assert att == _ref("obs").energy_attribution(rrec,
                                                     job_tenants=tenants)

    @MODES
    def test_power_series_conserves_energy(self, mode):
        (s, rec), (_, rrec) = _both_sessions(
            mode, [device_graph(mode, app="mm", geom=EGEOM)], geom=EGEOM,
            refresh=RefreshSpec())
        st = s.stats()
        ps = rec.power_series(windows=64)
        assert ps["n_windows"] == 64
        integral = sum(ps["total_w"]) * ps["window_ns"] * 1e-9
        assert integral == pytest.approx(st.total_energy_j, rel=1e-9)
        by_group = [sum(col) for col in zip(*ps["groups"].values())]
        for got, want in zip(by_group, ps["total_w"]):
            assert got == pytest.approx(want, rel=1e-9)
        assert all(math.isfinite(w) and w >= 0 for w in ps["total_w"])
        assert ps == rrec.power_series(windows=64)
        wns = ps["window_ns"] * 0.37
        assert rec.power_series(window_ns=wns) == \
            rrec.power_series(window_ns=wns)

    def test_power_series_empty_recorder(self):
        with pytest.raises(ValueError, match="never attached"):
            Recorder().power_series()
        rec = Recorder()
        EngineSession(BankModel(Interconnect.SHARED_PIM), recorder=rec,
                      device="cpu")
        assert rec.power_series() == {"window_ns": 0.0, "n_windows": 0,
                                      "groups": {}, "total_w": []}

    def test_chrome_trace_power_counters(self):
        mode = Interconnect.SHARED_PIM
        (_, rec), _ = _both_sessions(
            mode, [device_graph(mode, app="mm", geom=EGEOM)], geom=EGEOM,
            refresh=None)
        ev = rec.chrome_trace()["traceEvents"]
        counters = [e for e in ev if e.get("ph") == "C"]
        assert counters and all(e["pid"] == 3 for e in counters)
        assert all(e["args"]["W"] >= 0 for e in counters)
        assert "power" in {e["name"] for e in counters}


def _energy_tenants(pkg):
    return [pkg.TenantSpec.make("mm", "mm", n=16, banks=2, rate_jps=2000.0),
            pkg.TenantSpec.make("ntt", "ntt", n=16, rate_jps=2000.0)]


class TestServingEnergy:
    def _both(self, seed, jobs, metrics=False):
        prt = importlib.import_module("repro_torch.runtime")
        rrt = _ref("runtime")
        m = obs.MetricsRegistry() if metrics else None
        rm = _ref("obs").MetricsRegistry() if metrics else None
        rt = ServingRuntime(Interconnect.SHARED_PIM, EGEOM, metrics=m,
                            device="cpu")
        got = rt.run(prt.open_loop_trace(_energy_tenants(prt),
                                         jobs_per_tenant=jobs, seed=seed))
        want = rrt.ServingRuntime(_rmode(Interconnect.SHARED_PIM),
                                  _rgeom(EGEOM), metrics=rm).run(
            rrt.open_loop_trace(_energy_tenants(rrt), jobs_per_tenant=jobs,
                                seed=seed))
        assert [dataclasses.astuple(r) for r in got] == \
            [dataclasses.astuple(r) for r in want]
        return rt, got, m, rm

    def test_job_results_carry_energy(self):
        rt, results, _, _ = self._both(0, 4)
        assert results and all(r.energy_nj > 0 for r in results)
        st = rt.session.stats()
        assert sum(r.energy_nj for r in results) * 1e-9 == pytest.approx(
            st.op_energy_j + st.move_energy_j, rel=1e-9)

    def test_summarize_reports_energy(self):
        _, results, _, _ = self._both(0, 4)
        s = summarize(results)
        assert s["energy_nj"] > 0
        per_tenant = {name: s["per_tenant"][name]["energy_nj"]
                      for name in ("mm", "ntt")}
        assert all(v > 0 for v in per_tenant.values())
        assert sum(per_tenant.values()) == pytest.approx(s["energy_nj"])
        assert summarize([])["energy_nj"] == 0.0

    def test_energy_counters_in_metrics(self):
        _, results, m, rm = self._both(1, 3, metrics=True)
        total = m.counter("energy_nj").value
        assert total == pytest.approx(sum(r.energy_nj for r in results))
        assert m.counter("energy_nj/mm").value > 0
        assert m.snapshot() == rm.snapshot()


# --- on the card -----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("app,kw", [
    ("mm", dict(n=24)), ("qwen2-moe-a2.7b", dict(phase="decode", n_layers=2))])
@MODES
def test_card_trace_equals_host(app, kw, mode):
    _need_cuda()
    cfg = SweepConfig.make(app, mode, DeviceGeometry(
        channels=1, banks_per_channel=4, pes_per_bank=8), **kw)
    card = record_sweep(cfg, refresh=REFRESH)
    host = record_sweep(cfg, refresh=REFRESH, device="cpu")
    assert card._session.device.type == "cuda"
    assert card._session.stats() == host._session.stats()
    assert _trace_bytes(card) == _trace_bytes(host)
    assert obs.utilization(card) == obs.utilization(host)
    assert energy_attribution(card) == energy_attribution(host)
