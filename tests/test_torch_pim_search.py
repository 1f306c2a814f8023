"""The port's placement search (``repro_torch.search``: oracle, surrogate,
cache, beam + annealing search, autotuner) against the reference package,
bit for bit.

Mirrors ``tests/test_search.py`` (its oracle, surrogate, search-property,
cache, autotuner and pipeline tests, the ``BatchRunner`` search layers
among them), and holds each result to the reference's: the same graphs and
seeds give equal makespans, lower bounds, digests, maps, oracle counters
and rewrite logs.  Searched maps are held with 1 and 2 spawned workers;
``chip_smoke.py`` holds 1 and 4 on the card.  Where the reference's test
assumes the default worker count is one (``test_profile_counters_surface``)
the port's passes ``n_workers`` explicitly.  ``cuda``-marked cases search
on the card and hold it to the host; they skip where there is no card.
The reference package is imported only inside the tests.
"""

import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

from _hypothesis_compat import hypothesis, st  # noqa: F401

from repro_torch import passes, search
from repro_torch.core import engine, ir, taskgraph
from repro_torch.core.pluto import Interconnect
from repro_torch.device import DeviceGeometry, batch, partition
from repro_torch.device import scheduler as dev_sched
from repro_torch.device.resources import DeviceModel
from repro_torch.obs.profile import EngineProfile
from repro_torch.search import (LowerBoundModel, OracleCache, PlacementOracle,
                                SearchConfig, placement_digest, search_pe_map)

GEOM = DeviceGeometry(channels=1, banks_per_channel=4)
MODE = Interconnect.SHARED_PIM

#: small enough for per-test searches, move-heavy enough to be non-trivial
CELLS = {
    "mm": ("mm", dict(n=24)),
    "moe": ("qwen2-moe-a2.7b", dict(phase="decode", n_layers=2)),
}

#: a tiny search budget: every test below runs the full beam + SA loop
SMALL_KW = dict(seed=0, beam_width=2, beam_rounds=2, neighbors_per_state=4,
                sa_rounds=3, sa_proposals=4)
SMALL = SearchConfig(**SMALL_KW, n_workers=1, device="cpu")

RESULT_FIELDS = ("makespan_ns", "digest", "incumbent_policy",
                 "incumbent_makespan_ns", "greedy", "n_candidates", "stats")


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
    return _ref("core.ir").TaskGraph(
        **{f: getattr(g, f).numpy().copy() for f in ir.ARRAY_FIELDS},
        tags=g.tags)


def _rconfig(cfg):
    kw = dataclasses.asdict(cfg)
    kw.pop("device")
    return _ref("search").SearchConfig(**kw)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def struct_of(name, geom=GEOM):
    app, kw = CELLS[name]
    return taskgraph.structural(app, n_pes=geom.total_pes, **kw)


def random_maps(geom, n, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.permutation(geom.total_pes).astype(np.int64)
            for _ in range(n)]


def ref_search(struct, geom=GEOM, mode=MODE, config=SMALL, **kw):
    """The reference's search of the same graph (one worker)."""
    _ref("frontend")
    return _ref("search").search_pe_map(
        _rgraph(struct), _rmode(mode), _rgeom(geom),
        config=dataclasses.replace(_rconfig(config), n_workers=1), **kw)


def assert_same_result(got, want):
    for f in RESULT_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if f == "stats":
            g = {k: v for k, v in g.items() if k != "n_workers"}
            w = {k: v for k, v in w.items() if k != "n_workers"}
        assert g == w, f
    assert isinstance(got.pe_map, torch.Tensor)
    assert got.pe_map.dtype == torch.int64
    np.testing.assert_array_equal(got.pe_map.numpy(), want.pe_map)


class TestOracle:
    def test_oracle_makespan_matches_scheduler(self):
        """The oracle entry point IS the engine: same number as schedule(),
        and as the reference's."""
        for name in CELLS:
            for policy in partition.POLICIES:
                g = partition.partitioned_struct(
                    CELLS[name][0], GEOM, policy=policy, **CELLS[name][1])
                want = dev_sched.schedule(g, MODE, GEOM,
                                          device="cpu").makespan_ns
                got = engine.oracle_makespan(
                    ir.materialize(g, MODE), DeviceModel(MODE, GEOM),
                    device="cpu")
                assert got == want
                rref = _ref("core.engine").oracle_makespan(
                    _ref("core.ir").materialize(_rgraph(g), _rmode(MODE)),
                    _ref("device.resources").DeviceModel(_rmode(MODE),
                                                         _rgeom(GEOM)))
                assert got == rref

    def test_scalar_vector_oracle_identical(self):
        struct = struct_of("mm")
        o_s = PlacementOracle(struct, MODE, GEOM, engine_kind="scalar",
                              n_workers=1, device="cpu")
        o_v = PlacementOracle(struct, MODE, GEOM, engine_kind="vector",
                              n_workers=1, device="cpu")
        maps = random_maps(GEOM, 4)
        assert o_s.evaluate(maps) == o_v.evaluate(maps)
        r = _ref("search").PlacementOracle(_rgraph(struct), _rmode(MODE),
                                           _rgeom(GEOM), n_workers=1)
        assert o_s.key_prefix == r.key_prefix
        assert o_s.engine_kind == r.engine_kind
        assert o_s.evaluate(maps) == r.evaluate(maps)

    def test_memo_and_dedup_accounting(self):
        o = PlacementOracle(struct_of("mm"), MODE, GEOM, n_workers=1,
                            device="cpu")
        m = random_maps(GEOM, 1)[0]
        r1 = o.evaluate([m, m.copy()])
        assert r1[0] == r1[1]
        assert o.stats.engine_evals == 1
        r2 = o.evaluate_one(torch.from_numpy(m))   # a tensor digests alike
        assert r2 == r1[0]
        assert o.stats.engine_evals == 1
        assert o.stats.memo_hits >= 1

    def test_worker_count_determinism(self):
        """1-worker and 2-worker (spawned) oracles agree bit for bit with
        each other and the reference, and the search trajectory is
        identical at any worker count."""
        struct = struct_of("moe")
        maps = random_maps(GEOM, 6)
        o1 = PlacementOracle(struct, MODE, GEOM, n_workers=1, device="cpu")
        o2 = PlacementOracle(struct, MODE, GEOM, n_workers=2, device="cpu")
        try:
            got = o2.evaluate(maps)
            assert got == o1.evaluate(maps)
            assert o2.stats.n_workers == 2 and o2.pool_start_s > 0.0
            assert got == _ref("search").PlacementOracle(
                _rgraph(struct), _rmode(MODE), _rgeom(GEOM),
                n_workers=1).evaluate(maps)
        finally:
            o2.close()
        r1 = search_pe_map(struct, MODE, GEOM, config=SMALL)
        r2 = search_pe_map(struct, MODE, GEOM,
                           config=dataclasses.replace(SMALL, n_workers=2))
        assert r2.stats["n_workers"] == 2
        want = ref_search(struct)
        assert_same_result(r1, want)
        assert_same_result(r2, want)

    def test_pool_that_cannot_start_raises(self):
        """No serial or host fallback: a pool whose workers cannot start
        (here they are asked for a card this host lacks) raises."""
        if torch.cuda.is_available():
            pytest.skip("a card is present: the workers would start")
        o = PlacementOracle(struct_of("mm"), MODE, GEOM, n_workers=2,
                            device="cpu")
        o.device = torch.device("cuda")
        try:
            with pytest.raises(RuntimeError, match="did not start"):
                o.evaluate(random_maps(GEOM, 3))
        finally:
            o.close()
        assert o._pool is None and o.stats.engine_evals == 0

    def test_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default runs there")
        assert SearchConfig().device == "cuda"
        with pytest.raises(RuntimeError, match="cuda"):
            PlacementOracle(struct_of("mm"), MODE, GEOM)
        with pytest.raises(RuntimeError, match="cuda"):
            search_pe_map(struct_of("mm"), MODE, GEOM,
                          config=SearchConfig(n_workers=1))

    def test_surrogate_prune_never_decides(self):
        struct = struct_of("moe")
        o = PlacementOracle(struct, MODE, GEOM, n_workers=1, device="cpu")
        maps = random_maps(GEOM, 8)
        base = min(v for v in o.evaluate(maps[:2]))
        out = o.evaluate(maps[2:], prune_at=base)
        for m, v in zip(maps[2:], out):
            if v is not None:
                assert v == o.evaluate_one(m)
        r = _ref("search").PlacementOracle(_rgraph(struct), _rmode(MODE),
                                           _rgeom(GEOM), n_workers=1)
        r.evaluate(maps[:2])
        assert r.evaluate(maps[2:], prune_at=base) == out

    def test_helpers_equal_the_reference(self):
        rs = _ref("search")
        for m in random_maps(GEOM, 3):
            assert placement_digest(m) == rs.placement_digest(m)
            assert placement_digest(torch.from_numpy(m)) == \
                rs.placement_digest(m)
        for geom in (GEOM, DeviceGeometry(channels=2, banks_per_channel=4,
                                          bank_groups_per_channel=2,
                                          pes_per_bank=8, devices=2)):
            assert search.geometry_key(geom) == rs.geometry_key(_rgeom(geom))
        for n in (None, 0, 3):
            assert search.resolve_workers(n) == rs.resolve_workers(n)
        assert search.SCALAR_ORACLE_CUTOVER == rs.SCALAR_ORACLE_CUTOVER
        assert search.OracleStats().as_dict() == rs.OracleStats().as_dict()


GEOMS = [
    GEOM,
    DeviceGeometry(channels=1, banks_per_channel=4, pes_per_bank=8),
    DeviceGeometry(channels=2, banks_per_channel=4,
                   bank_groups_per_channel=2),
]


class TestSurrogateAdmissible:
    @pytest.mark.parametrize("mode", list(Interconnect),
                             ids=lambda m: m.value)
    @pytest.mark.parametrize("geom", GEOMS, ids=lambda g: g.describe())
    def test_lower_bound_below_engine_and_equal_the_reference(self, mode,
                                                               geom):
        for name in CELLS:
            app, kw = CELLS[name]
            struct = taskgraph.structural(app, n_pes=geom.total_pes, **kw)
            base = ir.materialize(struct, mode)
            lbm = LowerBoundModel(base, geom)
            rlbm = _ref("search").LowerBoundModel(_rgraph(base), _rgeom(geom))
            assert lbm.op_lb == rlbm.op_lb
            model = DeviceModel(mode, geom)
            for m in random_maps(geom, 6, seed=11):
                lb = lbm.lower_bound(m)
                assert lb == rlbm.lower_bound(m)
                mk = engine.oracle_makespan(
                    partition._remap_ir(base, torch.from_numpy(m)), model,
                    device="cpu")
                assert lb <= mk + 1e-9, \
                    f"{name}/{mode.value}: lb {lb} > engine {mk}"

    @hypothesis.given(st.integers(min_value=0, max_value=2 ** 31 - 1))
    @hypothesis.settings(max_examples=25, deadline=None)
    def test_lower_bound_admissible_drawn(self, seed):
        struct = struct_of("moe")
        base = ir.materialize(struct, MODE)
        lbm = LowerBoundModel(base, GEOM)
        model = DeviceModel(MODE, GEOM)
        m = np.random.default_rng(seed).permutation(
            GEOM.total_pes).astype(np.int64)
        mk = engine.oracle_makespan(
            partition._remap_ir(base, torch.from_numpy(m)), model,
            device="cpu")
        assert lbm.lower_bound(m) <= mk + 1e-9
        assert lbm.lower_bound(m) == _ref("search").LowerBoundModel(
            _rgraph(base), _rgeom(GEOM)).lower_bound(m)


def assert_legal_and_never_worse(res, struct, geom):
    m = res.pe_map
    assert tuple(m.shape) == (geom.total_pes,)
    assert int(m.min()) >= 0 and int(m.max()) < geom.total_pes
    assert len(torch.unique(m)) == len(m)
    g = partition._remap_ir(struct, m)
    g.validate()
    assert res.makespan_ns <= res.incumbent_makespan_ns
    assert res.makespan_ns == dev_sched.schedule(g, MODE, geom,
                                                 device="cpu").makespan_ns


class TestSearchProperties:
    @pytest.mark.parametrize("name", list(CELLS))
    def test_legal_never_worse_and_equal_the_reference(self, name):
        struct = struct_of(name)
        res = search_pe_map(struct, MODE, GEOM, config=SMALL)
        assert_legal_and_never_worse(res, struct, GEOM)
        assert res.digest == placement_digest(res.pe_map)
        assert_same_result(res, ref_search(struct))
        assert res.improvement == ref_search(struct).improvement

    @hypothesis.given(st.integers(min_value=0, max_value=2 ** 16))
    @hypothesis.settings(max_examples=10, deadline=None)
    def test_legal_and_never_worse_drawn_seed(self, seed):
        struct = struct_of("mm")
        cfg = dataclasses.replace(SMALL, seed=seed)
        res = search_pe_map(struct, MODE, GEOM, config=cfg)
        assert_legal_and_never_worse(res, struct, GEOM)
        assert_same_result(res, ref_search(struct, config=cfg))

    def test_same_seed_same_result(self):
        struct = struct_of("mm")
        r1 = search_pe_map(struct, MODE, GEOM, config=SMALL)
        r2 = search_pe_map(struct, MODE, GEOM, config=SMALL)
        assert r1.digest == r2.digest
        assert r1.makespan_ns == r2.makespan_ns
        assert r1.n_candidates == r2.n_candidates

    @pytest.mark.parametrize("mode", list(Interconnect),
                             ids=lambda m: m.value)
    def test_leased_banks_and_no_prune_equal_the_reference(self, mode):
        """A lease's slot set (two banks of the two-channel device, so
        every neighbourhood move is drawn) with pruning on and off."""
        geom = GEOMS[2]
        banks = (1, 6)
        struct = taskgraph.structural("mm", n_pes=2 * geom.pes_per_bank,
                                      n=16)
        for prune in (True, False):
            cfg = dataclasses.replace(SMALL, prune=prune, seed=3)
            got = search_pe_map(struct, mode, geom, banks=banks, config=cfg)
            want = ref_search(struct, geom=geom, mode=mode, config=cfg,
                              banks=banks)
            assert_same_result(got, want)
            assert {int(p) // geom.pes_per_bank
                    for p in got.pe_map.tolist()} == set(banks)

    def test_config_descriptor_equals_the_reference(self):
        for cfg in (SearchConfig(), SMALL,
                    SearchConfig(seed=5, sa_temp=0.125, prune=False)):
            assert cfg.describe() == _rconfig(cfg).describe()
        assert dataclasses.replace(SMALL, device="cuda").describe() == \
            SMALL.describe()


class TestOracleCache:
    def test_corrupt_and_truncated_lines_skipped(self, tmp_path):
        p = tmp_path / "cache.jsonl"
        good1 = json.dumps({"k": "a", "v": 1.5})
        good2 = json.dumps({"k": "b", "v": 2.5})
        p.write_text("not json at all\n"
                     + good1 + "\n"
                     + '{"wrong": "schema"}\n'
                     + '{"k": "c", "v": {"not": "a number is fine too"}}\n'
                     + good2 + "\n"
                     + '{"k": "d", "v": 9.9')
        c = OracleCache(p)
        assert c.get("a") == 1.5
        assert c.get("b") == 2.5
        assert c.get("d") is None
        assert c.n_bad_lines == 3
        c.put("e", 3.5)
        assert OracleCache(p).get("e") == 3.5
        r = _ref("search").OracleCache(p)
        assert (r.get("a"), r.get("e"), r.n_bad_lines) == (1.5, 3.5, 3)

    def test_missing_file_is_empty(self, tmp_path):
        c = OracleCache(tmp_path / "nope.jsonl")
        assert len(c) == 0
        assert c.get("x") is None
        c.clear()
        assert not (tmp_path / "nope.jsonl").exists()

    def test_oracle_skips_corrupt_entry(self, tmp_path):
        struct = struct_of("mm")
        m = random_maps(GEOM, 1)[0]
        o = PlacementOracle(struct, MODE, GEOM,
                            cache=OracleCache(tmp_path / "c.jsonl"),
                            n_workers=1, device="cpu")
        key = f"{o.key_prefix}/{placement_digest(m)}"
        o.cache.put(key, "corrupted-by-hand")
        assert o.evaluate_one(m) == engine.oracle_makespan(
            partition._remap_ir(o.base, torch.from_numpy(m)), o.model,
            device="cpu")
        assert o.stats.engine_evals == 1

    def test_warm_cache_zero_engine_evals(self, tmp_path):
        struct = struct_of("moe")
        path = tmp_path / "oracle.jsonl"
        o1 = PlacementOracle(struct, MODE, GEOM, cache=OracleCache(path),
                             n_workers=1, device="cpu")
        r1 = search_pe_map(struct, MODE, GEOM, config=SMALL, oracle=o1)
        assert o1.stats.engine_evals > 0
        o2 = PlacementOracle(struct, MODE, GEOM, cache=OracleCache(path),
                             n_workers=1, device="cpu")
        r2 = search_pe_map(struct, MODE, GEOM, config=SMALL, oracle=o2)
        assert o2.stats.engine_evals == 0
        assert o2.stats.cache_hits > 0
        assert r2.digest == r1.digest
        assert r2.makespan_ns == r1.makespan_ns

    def test_reference_cache_file_answers_the_port(self, tmp_path):
        """The keys are the reference's (graph fingerprint, geometry key,
        mode, map digest): a cache file the reference wrote warms the
        port's search to zero engine evals, and the port's file warms the
        reference's."""
        struct = struct_of("moe")
        rs = _ref("search")
        ref_path, port_path = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
        ro = rs.PlacementOracle(_rgraph(struct), _rmode(MODE), _rgeom(GEOM),
                                cache=rs.OracleCache(ref_path), n_workers=1)
        want = rs.search_pe_map(_rgraph(struct), _rmode(MODE), _rgeom(GEOM),
                                config=_rconfig(SMALL), oracle=ro)
        o = PlacementOracle(struct, MODE, GEOM, cache=OracleCache(ref_path),
                            n_workers=1, device="cpu")
        got = search_pe_map(struct, MODE, GEOM, config=SMALL, oracle=o)
        assert o.stats.engine_evals == 0
        assert o.stats.cache_hits == ro.stats.engine_evals
        assert got.digest == want.digest
        assert got.makespan_ns == want.makespan_ns
        o3 = PlacementOracle(struct, MODE, GEOM,
                             cache=OracleCache(port_path), n_workers=1,
                             device="cpu")
        search_pe_map(struct, MODE, GEOM, config=SMALL, oracle=o3)
        assert port_path.read_text() == ref_path.read_text()


class TestAutotuner:
    def test_choice_cached_never_worse_and_equal_the_reference(self,
                                                               tmp_path):
        tuner = search.Autotuner(MODE, GEOM,
                                 cache=OracleCache(tmp_path / "t.jsonl"),
                                 config=SMALL)
        struct = struct_of("mm")
        c1 = tuner.choose(struct)
        assert not c1.from_cache
        assert c1.makespan_ns <= c1.greedy_makespan_ns
        c2 = tuner.choose(struct)
        assert c2.from_cache
        assert c2.as_value() == c1.as_value()
        g, _log = tuner.pipeline(struct).run(struct)
        assert dev_sched.schedule(g, MODE, GEOM, device="cpu").makespan_ns \
            == c1.makespan_ns
        rs = _ref("search")
        rtuner = rs.Autotuner(_rmode(MODE), _rgeom(GEOM),
                              cache=rs.OracleCache(tmp_path / "r.jsonl"),
                              config=_rconfig(SMALL))
        assert rtuner.choose(_rgraph(struct)).as_value() == c1.as_value()
        assert tuner._key(struct) == rtuner._key(_rgraph(struct))
        assert (tmp_path / "t.jsonl").read_text() == \
            (tmp_path / "r.jsonl").read_text()


class TestPipelineIntegration:
    def test_search_place_pass_runs_and_logs(self):
        struct = struct_of("moe")
        pipe = passes.search_pipeline(GEOM, MODE, config=SMALL)
        g, log = pipe.run(struct)
        entries = [e for e in log.entries if e.pass_name == "search_place"]
        assert len(entries) == 1 and entries[0].action == "place"
        greedy_best = min(
            dev_sched.schedule(
                partition.partitioned_struct(CELLS["moe"][0], GEOM,
                                             policy=p, **CELLS["moe"][1]),
                MODE, GEOM, device="cpu").makespan_ns
            for p in partition.POLICIES)
        assert dev_sched.schedule(g, MODE, GEOM,
                                  device="cpu").makespan_ns <= greedy_best
        rp = _ref("passes")
        rg, rlog = rp.search_pipeline(_rgeom(GEOM), _rmode(MODE),
                                      config=_rconfig(SMALL)).run(
            _rgraph(struct))
        assert [str(e) for e in log.entries] == [str(e) for e in rlog.entries]
        assert ir.graph_fingerprint(g) == _ref("obs").graph_fingerprint(rg)

    def test_profile_counters_surface(self):
        prof = EngineProfile()
        search_pe_map(struct_of("mm"), MODE, GEOM, config=SMALL,
                      profile=prof)
        c = prof.oracle_counters
        assert c["oracle_evals"] > 0
        assert c["oracle_workers"] == 1
        assert set(EngineProfile.ORACLE_KEYS) <= set(prof.summary())
        rprof = _ref("obs").EngineProfile()
        ref_search(struct_of("mm"), profile=rprof)
        assert rprof.oracle_counters == c

    def test_batch_runner_search_and_clear_caches(self, tmp_path):
        runner = batch.BatchRunner(device="cpu")
        cfg = batch.SweepConfig.make(CELLS["mm"][0], MODE, GEOM,
                                     **CELLS["mm"][1])
        res = runner.search_placement(cfg, config=SMALL,
                                      cache=tmp_path / "b.jsonl",
                                      n_workers=1)
        assert res.makespan_ns <= res.incumbent_makespan_ns
        rres = _ref("device.batch").BatchRunner().search_placement(
            _ref("device.batch").SweepConfig.make(
                CELLS["mm"][0], _rmode(MODE), _rgeom(GEOM), **CELLS["mm"][1]),
            config=_rconfig(SMALL), cache=tmp_path / "r.jsonl", n_workers=1)
        assert_same_result(res, rres)
        o = runner.placement_oracle(cfg, cache=tmp_path / "b.jsonl")
        assert o.device == torch.device("cpu")
        assert o.model is runner._model(MODE, GEOM)
        m = random_maps(GEOM, 1)[0]
        o.evaluate_one(m)
        batch.clear_caches()
        assert o.stats.engine_evals in (0, 1)
        o.evaluate_one(m)
        assert o.stats.cache_hits + o.stats.engine_evals >= 2
        assert (tmp_path / "b.jsonl").exists()

    @pytest.mark.parametrize("opt", [(), passes.DEFAULT_OPT])
    def test_search_pipeline_fingerprints_equal_the_reference(self, opt):
        """The repaired descriptor: with no config the pass describes the
        default ``SearchConfig``, as the reference's does, so every search
        pipeline fingerprints as the reference's."""
        rp = _ref("passes")
        big = DeviceGeometry(channels=2, banks_per_channel=4,
                             bank_groups_per_channel=2)
        for config in (None, SMALL):
            rcfg = None if config is None else _rconfig(config)
            pairs = [
                (passes.search_pipeline(big, MODE, config=config, opt=opt),
                 rp.search_pipeline(_rgeom(big), _rmode(MODE), config=rcfg,
                                    opt=opt)),
                (passes.lease_search_pipeline(big, (0, 2), Interconnect.LISA,
                                              config=config, opt=opt),
                 rp.lease_search_pipeline(_rgeom(big), (0, 2),
                                          _rmode(Interconnect.LISA),
                                          config=rcfg, opt=opt))]
            for got, want in pairs:
                assert got.describe() == want.describe()
                assert got.fingerprint() == want.fingerprint()
                assert got.passes[1].config.describe() == \
                    want.passes[1].config.describe()


# --- on the card -----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CELLS))
def test_card_search_equals_host(name):
    _need_cuda()
    struct = struct_of(name)
    host = search_pe_map(struct, MODE, GEOM, config=SMALL)
    for n_workers in (1, 2):
        card = search_pe_map(struct, MODE, GEOM, config=dataclasses.replace(
            SMALL, device="cuda", n_workers=n_workers))
        assert card.digest == host.digest
        assert card.makespan_ns == host.makespan_ns
        assert torch.equal(card.pe_map, host.pe_map)
        assert {k: v for k, v in card.stats.items() if k != "n_workers"} == \
            {k: v for k, v in host.stats.items() if k != "n_workers"}
