"""The port's serving runtime (``repro_torch.runtime``: traces, the bank
allocators, ``ServingRuntime``, ``ContinuousRuntime``, ``summarize``)
against the reference package, bit for bit.

Mirrors ``tests/test_runtime.py`` and ``tests/test_continuous.py``, the
serving test of ``tests/test_passes.py`` and the serving tests of
``tests/test_frontend.py``.  Each runtime case replays the same arrival
trace through both packages and holds every ``JobResult`` and
``SessionResult`` (arrival, admit and finish times, banks, token times,
migrations, preemptions, energy) and every summary to the reference's;
the arrival traces themselves (NumPy's PCG64 streams) are held sample for
sample.  ``chip_smoke.py``'s ``pim-runtime`` constants (it may import
nothing of the reference) are held to the reference's benchmark scripts
here.  ``cuda``-marked cases serve on the card and hold it to the host;
they skip where there is no card.  The reference package is imported
only inside the tests.
"""

import dataclasses
import importlib
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from _hypothesis_compat import hypothesis, st  # noqa: F401

from repro_torch import passes
from repro_torch import runtime as prt
from repro_torch.core import taskgraph
from repro_torch.core.engine import RefreshSpec
from repro_torch.core.pluto import Interconnect
from repro_torch.device import DeviceGeometry
from repro_torch.device.partition import lease_pe_map, place_on_banks
from repro_torch.runtime import (ADMISSION_POLICIES, BankAllocator,
                                 ContinuousAllocator, ContinuousRuntime,
                                 MultiTurnSource,
                                 ServingRuntime, SessionResult, SessionSpec,
                                 TenantSpec, open_loop_trace, session_trace,
                                 summarize)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GEOM = DeviceGeometry(channels=1, banks_per_channel=4)
#: 16 banks in 4 groups of 4 — group structure visible to the picker
CGEOM = DeviceGeometry(channels=1, banks_per_channel=16,
                       bank_groups_per_channel=4, pes_per_bank=2)
#: small device for allocator-level tests: 8 banks in 4 groups of 2
SMALL = DeviceGeometry(channels=1, banks_per_channel=8,
                       bank_groups_per_channel=4)
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


def _rrt():
    _ref("frontend")                      # registers the model apps
    return _ref("runtime")


def _rmode(mode):
    return _ref("core.pluto").Interconnect(mode.value)


def _rgeom(geom):
    return _ref("device").DeviceGeometry(**dataclasses.asdict(geom))


def _rspec(spec):
    return _ref("core.engine").RefreshSpec(**dataclasses.asdict(spec))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def rows(results):
    return [dataclasses.astuple(r) for r in results]


def tenants(pkg=prt, rate=2000.0):
    return [
        pkg.TenantSpec.make("mm", "mm", n=16, banks=2, rate_jps=rate),
        pkg.TenantSpec.make("bfs", "bfs", n_nodes=30, priority=2,
                            rate_jps=rate),
        pkg.TenantSpec.make("ntt", "ntt", n=16, rate_jps=rate),
    ]


def specs(pkg=prt, decode_tokens=8, turns=1, think_ns=0.0, rate=2000.0):
    return [
        pkg.SessionSpec.make("chat", "gemma3-1b", n_layers=2,
                             prompt_tokens=512, decode_tokens=decode_tokens,
                             turns=turns, think_ns=think_ns, rate_sps=rate),
        pkg.SessionSpec.make("agent", "granite-3-2b", n_layers=2,
                             prompt_tokens=256, decode_tokens=decode_tokens,
                             turns=turns, think_ns=think_ns, rate_sps=rate),
    ]


def serve_both(make_tenants, mode=Interconnect.SHARED_PIM, geom=GEOM, *,
               jobs=6, seed=0, load=1.0, refresh=None, **kw):
    """The same open-loop trace through both packages' ServingRuntime;
    returns (port runtime, port results, reference results)."""
    rrt = _rrt()
    tr = open_loop_trace(make_tenants(prt), jobs_per_tenant=jobs, seed=seed,
                         load=load)
    rtr = rrt.open_loop_trace(make_tenants(rrt), jobs_per_tenant=jobs,
                              seed=seed, load=load)
    assert [r.sort_key for r in tr] == [r.sort_key for r in rtr]
    rt = ServingRuntime(mode, geom, refresh=refresh, device="cpu", **kw)
    got = rt.run(tr)
    want = rrt.ServingRuntime(
        _rmode(mode), _rgeom(geom),
        refresh=None if refresh is None else _rspec(refresh), **kw).run(rtr)
    assert rows(got) == rows(want)
    assert summarize(got) == rrt.summarize(want)
    return rt, got, want


# --- traces ----------------------------------------------------------------------


class TestTrace:
    def test_deterministic_in_seed_and_equal_the_reference(self):
        a = open_loop_trace(tenants(), jobs_per_tenant=5, seed=3)
        b = open_loop_trace(tenants(), jobs_per_tenant=5, seed=3)
        c = open_loop_trace(tenants(), jobs_per_tenant=5, seed=4)
        assert [r.sort_key for r in a] == [r.sort_key for r in b]
        assert [r.sort_key for r in a] != [r.sort_key for r in c]
        rrt = _rrt()
        for seed, load in ((3, 1.0), (4, 0.37), (11, 2.5)):
            got = open_loop_trace(tenants(), jobs_per_tenant=9, seed=seed,
                                  load=load)
            want = rrt.open_loop_trace(tenants(rrt), jobs_per_tenant=9,
                                       seed=seed, load=load)
            assert [r.sort_key for r in got] == [r.sort_key for r in want]

    def test_sorted_and_counted(self):
        tr = open_loop_trace(tenants(), jobs_per_tenant=7, seed=0)
        assert len(tr) == 21
        arrivals = [r.arrival_ns for r in tr]
        assert arrivals == sorted(arrivals)
        for name in ("mm", "bfs", "ntt"):
            assert sum(r.tenant.name == name for r in tr) == 7

    def test_load_scales_rates(self):
        slow = open_loop_trace(tenants(), jobs_per_tenant=20, seed=0,
                               load=0.5)
        fast = open_loop_trace(tenants(), jobs_per_tenant=20, seed=0,
                               load=2.0)
        assert fast[-1].arrival_ns < slow[-1].arrival_ns

    def test_horizon_bound(self):
        tr = open_loop_trace(tenants(), horizon_ns=1e6, seed=0)
        assert all(r.arrival_ns < 1e6 for r in tr)
        rrt = _rrt()
        assert [r.sort_key for r in tr] == [
            r.sort_key for r in rrt.open_loop_trace(
                tenants(rrt), horizon_ns=1e6, seed=0)]

    def test_exactly_one_bound_required(self):
        with pytest.raises(ValueError):
            open_loop_trace(tenants(), seed=0)
        with pytest.raises(ValueError):
            open_loop_trace(tenants(), jobs_per_tenant=2, horizon_ns=1.0)

    def test_zero_rate_under_job_bounding_raises(self):
        zero = [TenantSpec.make("idle", "mm", n=16, rate_jps=0.0)]
        with pytest.raises(ValueError, match="idle"):
            open_loop_trace(zero, jobs_per_tenant=3, seed=0)
        with pytest.raises(ValueError, match="load"):
            open_loop_trace(tenants(), jobs_per_tenant=3, seed=0, load=0.0)
        assert open_loop_trace(zero, horizon_ns=1e6, seed=0) == []

    def test_closed_loop_budget_and_determinism(self):
        rrt = _rrt()
        seen = {}
        for pkg in (prt, rrt):
            ts = [pkg.TenantSpec.make("mm", "mm", n=16, concurrency=2,
                                      think_ns=50.0)]
            src = pkg.ClosedLoopSource(ts, jobs_per_tenant=5, seed=1)
            first = src.initial()
            assert len(first) == 2 and all(r.arrival_ns == 0.0
                                           for r in first)
            got = list(first)
            while True:
                nxt = src.on_complete(got[-1], got[-1].arrival_ns + 100.0)
                if nxt is None:
                    break
                got.append(nxt)
            assert len(got) == 5
            assert [r.seq for r in got] == list(range(5))
            seen[pkg] = [r.sort_key for r in got]
        assert seen[prt] == seen[rrt]

    def test_tenant_spec_validation_and_known_apps(self):
        with pytest.raises(ValueError, match="unknown app"):
            TenantSpec.make("x", "nope")
        with pytest.raises(ValueError, match="invalid tenant"):
            TenantSpec.make("x", "mm", banks=0)
        assert set(prt.known_apps()) == set(_rrt().known_apps())
        assert prt.TRACE_APPS == _rrt().TRACE_APPS
        t = TenantSpec.make("a", "mm", n=8, out_rows=2, rate_jps=10.0)
        assert t.kwargs == {"n": 8, "out_rows": 2}
        assert t.scaled(3.0).rate_jps == 30.0


class TestLeaseMap:
    def test_identity_on_full_contiguous_lease(self):
        m = lease_pe_map(GEOM, range(GEOM.n_banks))
        assert m == list(range(GEOM.total_pes))

    def test_maps_into_leased_banks_only(self):
        banks = (1, 3)
        m = lease_pe_map(GEOM, banks)
        ppb = GEOM.pes_per_bank
        assert {p // ppb for p in m} == set(banks)
        assert len(set(m)) == len(m) == len(banks) * ppb

    def test_rejects_bad_leases(self):
        with pytest.raises(ValueError):
            lease_pe_map(GEOM, [])
        with pytest.raises(ValueError):
            lease_pe_map(GEOM, [0, 0])
        with pytest.raises(ValueError):
            lease_pe_map(GEOM, [99])

    def test_place_on_banks_confines_graph(self):
        g = taskgraph.structural("mm", n_pes=2 * GEOM.pes_per_bank, n=12)
        placed = place_on_banks(g, GEOM, (2, 3))
        ppb = GEOM.pes_per_bank
        pes = set(placed.pe[placed.pe >= 0].tolist()) \
            | set(placed.src[placed.src >= 0].tolist()) \
            | set(placed.dst_flat.tolist())
        assert {p // ppb for p in pes} <= {2, 3}


# --- the allocators --------------------------------------------------------------


class TestAllocator:
    def test_grant_release_roundtrip(self):
        al = BankAllocator(GEOM, "fifo")
        leases = al.request(3, payload="a")
        assert len(leases) == 1 and leases[0].banks == (0, 1, 2)
        assert al.n_free == 1
        assert al.request(2, payload="b") == []
        granted = al.release(leases[0])
        assert [ls.payload for ls in granted] == ["b"]
        assert al.n_free == 2

    def test_contiguous_preference(self):
        al = BankAllocator(GEOM, "fifo")
        a = al.request(1)[0]
        b = al.request(1)[0]
        assert (a.banks, b.banks) == ((0,), (1,))
        al.release(a)
        c = al.request(2)[0]
        assert c.banks == (2, 3)

    def test_fifo_head_of_line_blocks(self):
        al = BankAllocator(GEOM, "fifo")
        big = al.request(4)[0]
        assert al.request(4, payload="jumbo") == []
        assert al.request(1, payload="tiny") == []
        granted = al.release(big)
        assert [ls.payload for ls in granted] == ["jumbo"]

    def test_sjf_reorders_by_cost(self):
        al = BankAllocator(GEOM, "sjf")
        lease = al.request(4, cost=1.0)[0]
        al.request(2, cost=50.0, payload="slow")
        al.request(2, cost=5.0, payload="quick")
        granted = al.release(lease)
        assert [ls.payload for ls in granted] == ["quick", "slow"]

    def test_priority_order_then_fifo(self):
        al = BankAllocator(GEOM, "priority")
        lease = al.request(4, priority=0)[0]
        al.request(1, priority=0, payload="low")
        al.request(1, priority=5, payload="hi")
        al.request(1, priority=5, payload="hi2")
        granted = al.release(lease)
        assert [ls.payload for ls in granted] == ["hi", "hi2", "low"]

    def test_rejects_oversized_and_double_release(self):
        al = BankAllocator(GEOM, "fifo")
        with pytest.raises(ValueError):
            al.request(5)
        lease = al.request(1)[0]
        al.release(lease)
        with pytest.raises(ValueError):
            al.release(lease)
        with pytest.raises(ValueError):
            BankAllocator(GEOM, "lifo")

    def test_stale_lease_cannot_free_released_banks(self):
        al = BankAllocator(GEOM, "fifo")
        stale = al.request(2, payload="a")[0]
        al.release(stale)
        fresh = al.request(2, payload="b")[0]
        assert fresh.banks == stale.banks
        with pytest.raises(ValueError, match="already-released"):
            al.release(stale)
        assert al.n_free == GEOM.n_banks - 2
        assert al.n_leased == 1
        al.release(fresh)
        assert al.n_free == GEOM.n_banks and al.n_leased == 0

    def test_foreign_and_tampered_leases_rejected(self):
        from repro_torch.runtime.allocator import Lease
        al = BankAllocator(GEOM, "fifo")
        lease = al.request(2)[0]
        with pytest.raises(ValueError, match="unknown"):
            al.release(Lease(ticket=999, banks=(0, 1)))
        with pytest.raises(ValueError, match="granted banks"):
            al.release(Lease(ticket=lease.ticket, banks=(2, 3)))
        assert al.n_leased == 1
        al.release(lease)

    def test_occupancy_and_queue_pressure(self):
        al = BankAllocator(GEOM, "fifo")
        al.request(3)
        al.request(2)
        al.request(4)
        assert (al.n_banks_leased, al.occupancy, al.queued_bank_demand,
                al.free_banks()) == (3, 0.75, 6, (3,))


class TestGroupAlignedPicks:
    def test_prefers_group_aligned_run(self):
        alloc = BankAllocator(SMALL)
        alloc.request(8)
        alloc._active.clear()
        alloc._free = {1, 2, 4, 5}
        assert alloc._pick_banks(2) == (4, 5)

    def test_prefers_fewer_groups_spanned(self):
        alloc = BankAllocator(SMALL)
        alloc._free = {1, 2, 3, 5, 6, 7}
        assert alloc._pick_banks(3) == (1, 2, 3)
        alloc._free = {1, 2, 3, 4, 5}
        assert alloc._pick_banks(2) == (2, 3)
        assert alloc._pick_banks(4) == (2, 3, 4, 5)

    def test_single_group_degenerates_to_lowest_run(self):
        alloc = BankAllocator(DeviceGeometry(channels=1,
                                             banks_per_channel=8))
        alloc._free = {1, 2, 4, 5}
        assert alloc._pick_banks(2) == (1, 2)

    def test_fallback_scatter_when_no_run(self):
        alloc = BankAllocator(SMALL)
        alloc._free = {0, 2, 4, 6}
        assert alloc._pick_banks(3) == (0, 2, 4)


class TestContinuousAllocator:
    def make(self, **kw):
        kw.setdefault("decode_reserve", 4)
        kw.setdefault("tokens_per_bank", 100)
        return ContinuousAllocator(SMALL, **kw)

    def test_banks_for_quantization(self):
        alloc = self.make()
        assert [alloc.banks_for(k) for k in (0, 1, 100, 101, 10_000)] == \
            [1, 1, 1, 2, SMALL.n_banks]

    def test_prefill_pool_cap(self):
        alloc = self.make()
        assert alloc.prefill_pool == 4
        got = alloc.request(3, payload="a")
        assert len(got) == 1
        assert alloc.request(2, payload="b") == []
        assert alloc.n_queued == 1
        with pytest.raises(ValueError):
            alloc.request(5)
        granted = alloc.release(got[0])
        assert [lease.payload for lease in granted] == ["b"]

    def test_admission_pause_gates_drain(self):
        alloc = self.make()
        alloc.admission_paused = True
        assert alloc.request(1, payload="x") == []
        assert alloc.n_queued == 1
        assert alloc.drain() == []
        alloc.admission_paused = False
        assert [lease.payload for lease in alloc.drain()] == ["x"]

    def test_preempt_requeues_ahead_and_does_not_drain(self):
        alloc = self.make()
        (first,) = alloc.request(2, payload="victim")
        alloc.request(3, payload="waiter")
        alloc.preempt(first)
        assert alloc.n_free == SMALL.n_banks and alloc.n_queued == 2
        granted = alloc.drain()
        assert [lease.payload for lease in granted] == ["victim"]
        regrant = alloc.release(granted[0])
        assert [lease.payload for lease in regrant] == ["waiter"]

    def test_preempt_rejects_stale_lease(self):
        alloc = self.make()
        (lease,) = alloc.request(1)
        alloc.release(lease)
        with pytest.raises(ValueError):
            alloc.preempt(lease)

    def test_acquire_grow_and_extend(self):
        alloc = self.make()
        res = alloc.acquire("t", kv_tokens=150)
        assert res is not None and len(res.banks) == 2
        assert alloc.n_banks_resident == 2
        assert alloc.grow(res, 50) is True
        assert len(res.banks) == 2
        assert alloc.grow(res, 100) is True
        assert len(res.banks) == 3
        other = alloc.acquire("u", kv_tokens=100 * (SMALL.n_banks - 3))
        assert other is not None and alloc.n_free == 0
        assert alloc.grow(res, 100) is False
        assert alloc.release_residency(other) == []
        assert alloc.grow(res, 0) is True

    def test_adopt_in_place_keeps_and_frees(self):
        alloc = self.make()
        (lease,) = alloc.request(3, payload="s")
        res = alloc.adopt(lease, "s", kv_tokens=120)
        assert res.banks == lease.banks[:2]
        assert alloc.n_banks_prefill == 0
        assert alloc.n_free == SMALL.n_banks - 2
        with pytest.raises(ValueError):
            alloc.release(lease)

    def test_adopt_extends_when_kv_outgrew_lease(self):
        alloc = self.make()
        (lease,) = alloc.request(1, payload="s")
        res = alloc.adopt(lease, "s", kv_tokens=250)
        assert len(res.banks) == 3 and res.banks[0] == lease.banks[0]

    def test_grant_step_sequence(self):
        alloc = self.make()
        res = alloc.acquire("t")
        g0, g1 = alloc.grant_step(res), alloc.grant_step(res)
        assert (g0.step, g1.step) == (0, 1)
        assert g0.rid == res.rid and g0.banks == res.banks
        assert res.steps_granted == 2

    def test_migration_holds_both_sets_until_commit(self):
        alloc = self.make()
        res = alloc.acquire("t", kv_tokens=150)
        src = res.banks
        dst = alloc.begin_migration(res)
        assert dst is not None and set(dst).isdisjoint(src)
        assert alloc.n_banks_resident == 4
        assert set(src).isdisjoint(alloc._free)
        assert set(dst).isdisjoint(alloc._free)
        alloc.commit_migration(res)
        assert res.banks == dst and res.migrating_to is None
        assert set(src) <= alloc._free
        assert alloc.n_banks_resident == 2

    def test_abort_and_release_mid_migration(self):
        alloc = self.make()
        res = alloc.acquire("t")
        before = alloc.n_free
        alloc.begin_migration(res)
        alloc.abort_migration(res)
        assert alloc.n_free == before and res.migrating_to is None
        res = alloc.acquire("u", kv_tokens=150)
        alloc.begin_migration(res)
        alloc.release_residency(res)
        assert alloc.n_free == SMALL.n_banks - 1

    def test_stale_residency_rejected(self):
        alloc = self.make()
        res = alloc.acquire("t")
        alloc.release_residency(res)
        for call in (lambda: alloc.grow(res, 1),
                     lambda: alloc.grant_step(res),
                     lambda: alloc.begin_migration(res),
                     lambda: alloc.release_residency(res)):
            with pytest.raises(ValueError):
                call()


def _conservation(alloc) -> None:
    held: list[int] = []
    for lease in alloc._active.values():
        held.extend(lease.banks)
    for res in alloc._resident.values():
        held.extend(res.banks)
        held.extend(res.migrating_to or ())
    assert len(held) == len(set(held)), "bank double-leased"
    assert set(held).isdisjoint(alloc._free), "held bank marked free"
    assert len(held) + alloc.n_free == alloc.geom.n_banks


def _interleave(pkg, seed: int, n_ops: int = 120) -> list:
    """A random request/grant/release/preempt/migrate interleave on one
    package's allocator, its invariants checked after every op; returns
    the event log."""
    rng = np.random.default_rng(seed)
    geom = SMALL if pkg is prt else _rgeom(SMALL)
    alloc = pkg.ContinuousAllocator(geom, decode_reserve=3,
                                    tokens_per_bank=50)
    log, leases, rezs = [], [], []
    payload = 0
    for _ in range(n_ops):
        op = int(rng.integers(0, 8))
        if op == 0:
            banks = int(rng.integers(1, alloc.prefill_pool + 1))
            leases.extend(alloc.request(banks, payload=payload))
            log.append(("req", payload, banks))
            payload += 1
        elif op == 1 and leases:
            lease = leases.pop(int(rng.integers(0, len(leases))))
            leases.extend(alloc.release(lease))
            log.append(("rel", lease.ticket))
        elif op == 2 and leases:
            lease = leases.pop(int(rng.integers(0, len(leases))))
            alloc.preempt(lease)
            log.append(("pre", lease.ticket))
        elif op == 3:
            res = alloc.acquire(f"t{payload}",
                                kv_tokens=int(rng.integers(0, 120)))
            if res is not None:
                rezs.append(res)
            log.append(("acq", res.rid if res else None))
        elif op == 4 and rezs:
            res = rezs[int(rng.integers(0, len(rezs)))]
            if res.migrating_to is None:
                log.append(("grow", res.rid,
                            alloc.grow(res, int(rng.integers(1, 80)))))
        elif op == 5 and rezs:
            res = rezs[int(rng.integers(0, len(rezs)))]
            if res.migrating_to is None:
                log.append(("mig", res.rid, alloc.begin_migration(res)))
            elif rng.integers(0, 2):
                alloc.commit_migration(res)
                log.append(("commit", res.rid))
            else:
                alloc.abort_migration(res)
                log.append(("abort", res.rid))
        elif op == 6 and rezs:
            res = rezs.pop(int(rng.integers(0, len(rezs))))
            leases.extend(alloc.release_residency(res))
            log.append(("relres", res.rid))
        elif op == 7:
            alloc.admission_paused = bool(rng.integers(0, 2)) \
                and alloc.admission_paused
            leases.extend(alloc.drain())
            log.append(("drain",))
        _conservation(alloc)
        assert alloc.n_banks_prefill == \
            sum(len(lease.banks) for lease in alloc._active.values())
    alloc.admission_paused = False
    for res in rezs:
        leases.extend(alloc.release_residency(res))
    while leases or alloc.n_queued:
        if not leases:
            granted = alloc.drain()
            assert granted, "queued work stuck with free banks"
            leases.extend(granted)
            continue
        leases.extend(alloc.release(leases.pop()))
        _conservation(alloc)
    assert alloc.n_free == alloc.geom.n_banks
    log.append(("free", alloc.free_banks()))
    return log


class TestInterleaveInvariants:
    @pytest.mark.parametrize("seed", range(8))
    def test_seeded_interleaves_equal_the_reference(self, seed):
        assert _interleave(prt, seed) == _interleave(_rrt(), seed)

    @hypothesis.given(st.integers(min_value=0, max_value=10_000))
    @hypothesis.settings(max_examples=25, deadline=None)
    def test_property_interleaves(self, seed):
        assert _interleave(prt, seed, n_ops=60) == \
            _interleave(_rrt(), seed, n_ops=60)


# --- the serving runtime ----------------------------------------------------------


class TestServingRuntime:
    @MODES
    def test_serves_every_job_causally(self, mode):
        _, res, _ = serve_both(tenants, mode)
        assert len(res) == 18
        for r in res:
            assert r.finish_ns >= r.admit_ns >= r.arrival_ns
            assert set(r.banks) <= set(range(GEOM.n_banks))

    def test_deterministic_replay(self):
        tr = open_loop_trace(tenants(), jobs_per_tenant=6, seed=0)
        a = ServingRuntime(Interconnect.SHARED_PIM, GEOM,
                           device="cpu").run(tr)
        b = ServingRuntime(Interconnect.SHARED_PIM, GEOM,
                           device="cpu").run(tr)
        assert a == b

    @pytest.mark.parametrize("policy", ADMISSION_POLICIES)
    def test_policies_serve_identical_job_sets(self, policy):
        _, res, _ = serve_both(lambda p: tenants(p, rate=50000.0), jobs=5,
                               seed=2, admission=policy)
        tr = open_loop_trace(tenants(rate=50000.0), jobs_per_tenant=5,
                             seed=2)
        assert sorted((r.tenant, r.seq) for r in res) \
            == sorted((r.tenant.name, r.seq) for r in tr)

    def test_shared_pim_latency_beats_lisa(self):
        lat = {}
        for mode in Interconnect:
            _, res, _ = serve_both(tenants, mode, jobs=8)
            lat[mode] = summarize(res)["latency_ns"]["p99"]
        assert lat[Interconnect.SHARED_PIM] < lat[Interconnect.LISA]

    def test_refresh_only_adds_latency(self):
        tr = open_loop_trace(tenants(), jobs_per_tenant=4, seed=0)
        base = summarize(ServingRuntime(Interconnect.SHARED_PIM, GEOM,
                                        device="cpu").run(tr))
        spec = RefreshSpec(interval_ns=3000.0, duration_ns=500.0)
        rt, res, _ = serve_both(tenants, jobs=4, refresh=spec)
        assert rt.session.stats().refresh_ns > 0.0
        assert summarize(res)["mean_latency_ns"] >= base["mean_latency_ns"]

    def test_priority_admission_helps_urgent_tenant_under_load(self):
        by = {}
        for policy in ("fifo", "priority"):
            _, res, _ = serve_both(lambda p: tenants(p, rate=50000.0),
                                   jobs=10, seed=2, admission=policy)
            by[policy] = summarize(res)["per_tenant"]["bfs"]["p99_ns"]
        assert by["priority"] < by["fifo"]

    def test_closed_loop_self_limits(self):
        rrt = _rrt()
        got = {}
        for pkg in (prt, rrt):
            ts = [pkg.TenantSpec.make("mm", "mm", n=16, banks=1,
                                      concurrency=2)]
            src = pkg.ClosedLoopSource(ts, jobs_per_tenant=6, seed=0)
            if pkg is prt:
                rt = ServingRuntime(Interconnect.SHARED_PIM, GEOM,
                                    device="cpu")
            else:
                rt = rrt.ServingRuntime(_rmode(Interconnect.SHARED_PIM),
                                        _rgeom(GEOM))
            got[pkg] = rt.run((), closed=src)
        res = got[prt]
        assert rows(res) == rows(got[rrt])
        assert len(res) == 6
        events = [(r.admit_ns, 1) for r in res] + \
                 [(r.finish_ns, -1) for r in res]
        live = peak = 0
        for _, d in sorted(events):
            live += d
            peak = max(peak, live)
        assert peak <= 2

    def test_oversized_tenant_rejected(self):
        bad = [TenantSpec.make("big", "mm", n=16, banks=GEOM.n_banks + 1)]
        tr = open_loop_trace(bad, jobs_per_tenant=1, seed=0)
        with pytest.raises(ValueError, match="banks"):
            ServingRuntime(Interconnect.LISA, GEOM, device="cpu").run(tr)

    def test_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default runs there")
        for make in (lambda: ServingRuntime(Interconnect.LISA, GEOM),
                     lambda: ContinuousRuntime(Interconnect.LISA, CGEOM)):
            with pytest.raises(RuntimeError, match="cuda"):
                make()

    def test_summary_shape(self):
        s = summarize([])
        assert s["n_jobs"] == 0 and s["throughput_jps"] == 0.0
        assert s["makespan_ns"] == s["t_start_ns"] == s["t_end_ns"] == 0.0
        assert s == _rrt().summarize([])
        _, res, _ = serve_both(tenants, Interconnect.LISA, jobs=3)
        s = summarize(res)
        assert s["n_jobs"] == len(res)
        assert set(s["latency_ns"]) == {"p50", "p95", "p99"}
        assert s["latency_ns"]["p50"] <= s["latency_ns"]["p99"]

    def test_summary_makespan_is_the_span(self):
        from repro_torch.runtime.serve import JobResult
        res = [JobResult("t", "mm", 0, 1000.0, 1100.0, 2000.0, (0,), 5),
               JobResult("t", "mm", 1, 1500.0, 1600.0, 3500.0, (0,), 5)]
        s = summarize(res)
        assert s["makespan_ns"] == 2500.0
        assert s["t_start_ns"] == 1000.0 and s["t_end_ns"] == 3500.0
        assert s["throughput_jps"] == pytest.approx(2 / 2500.0 * 1e9)

    def test_metrics_and_slo_attainment_equal_the_reference(self):
        from repro_torch import obs
        rrt = _rrt()
        m = obs.MetricsRegistry()
        rm = _ref("obs").MetricsRegistry()
        res = ServingRuntime(Interconnect.SHARED_PIM, GEOM, metrics=m,
                             device="cpu").run(open_loop_trace(
                                 tenants(), jobs_per_tenant=5, seed=0))
        want = rrt.ServingRuntime(_rmode(Interconnect.SHARED_PIM),
                                  _rgeom(GEOM), metrics=rm).run(
            rrt.open_loop_trace(tenants(rrt), jobs_per_tenant=5, seed=0))
        assert rows(res) == rows(want)
        assert m.snapshot() == rm.snapshot()
        assert obs.slo_attainment(res, 2e5) == \
            _ref("obs").slo_attainment(want, 2e5)


class TestJobCostMemoized:
    def test_one_structural_build_per_key(self, monkeypatch):
        rt = ServingRuntime(Interconnect.SHARED_PIM, GEOM, admission="sjf",
                            device="cpu")
        calls = []
        real = taskgraph.structural

        def counting(app, **kw):
            calls.append(app)
            return real(app, **kw)

        monkeypatch.setattr(taskgraph, "structural", counting)
        t = TenantSpec.make("mm", "mm", n=16, banks=2)
        for r in open_loop_trace([t], jobs_per_tenant=4, seed=0):
            rt.job_cost(r)
        assert calls == ["mm"]
        t2 = TenantSpec.make("mm2", "mm", n=24, banks=2)
        rt.job_cost(open_loop_trace([t2], jobs_per_tenant=1, seed=0)[0])
        assert calls == ["mm", "mm"]


class TestServingWithPassesAndSearch:
    def test_serving_runtime_with_passes_completes(self):
        """``tests/test_passes.py``'s serving case, held to the
        reference."""
        geom = DeviceGeometry(channels=1, banks_per_channel=4,
                              pes_per_bank=8)

        def moe(pkg):
            return [pkg.TenantSpec.make("moe", "qwen2-moe-a2.7b", banks=2,
                                        phase="prefill", n_layers=2,
                                        seq_tiles=2, rate_jps=2000.0)]

        off, r_off, _ = serve_both(moe, geom=geom, jobs=3)
        on, r_on, _ = serve_both(moe, geom=geom, jobs=3,
                                 opt=passes.DEFAULT_OPT)
        assert len(r_on) == len(r_off) == 3
        assert all(len(log) > 0 for log in on.rewrite_logs.values())
        assert all(len(log) == 0 for log in off.rewrite_logs.values())
        assert max(r.finish_ns for r in r_on) <= \
            max(r.finish_ns for r in r_off)

    def test_search_placement_serves_and_equals_the_reference(self):
        """``placement="search"``: each lease shape's graph is searched on
        the runtime's device with the given budget."""
        from repro_torch.search import SearchConfig
        cfg = SearchConfig(seed=1, beam_width=2, beam_rounds=1,
                           neighbors_per_state=3, sa_rounds=2,
                           sa_proposals=3, n_workers=1, device="cuda")
        rcfg = _ref("search").SearchConfig(
            seed=1, beam_width=2, beam_rounds=1, neighbors_per_state=3,
            sa_rounds=2, sa_proposals=3, n_workers=1)

        def two(pkg):
            return [pkg.TenantSpec.make("mm", "mm", n=12, banks=2,
                                        rate_jps=4000.0),
                    pkg.TenantSpec.make("ntt", "ntt", n=16, banks=1,
                                        rate_jps=4000.0)]

        rrt = _rrt()
        tr = open_loop_trace(two(prt), jobs_per_tenant=3, seed=0)
        rt = ServingRuntime(Interconnect.SHARED_PIM, GEOM,
                            placement="search", search=cfg, device="cpu")
        assert rt.search.device == "cpu" and rt.search.seed == 1
        got = rt.run(tr)
        want_rt = rrt.ServingRuntime(_rmode(Interconnect.SHARED_PIM),
                                     _rgeom(GEOM), placement="search",
                                     search=rcfg)
        want = want_rt.run(rrt.open_loop_trace(two(rrt), jobs_per_tenant=3,
                                               seed=0))
        assert rows(got) == rows(want)
        assert {k: [str(e) for e in log.entries]
                for k, log in rt.rewrite_logs.items()} == \
            {k: [str(e) for e in log.entries]
             for k, log in want_rt.rewrite_logs.items()}


# --- model apps as tenants (tests/test_frontend.py) -------------------------------


def model_tenants(pkg):
    return [
        pkg.TenantSpec.make("chat", "gemma3-1b", phase="decode", n_layers=2,
                            banks=1, rate_jps=2000.0, priority=2),
        pkg.TenantSpec.make("bulk", "qwen2-moe-a2.7b", phase="prefill",
                            n_layers=2, seq_tiles=2, banks=2,
                            rate_jps=500.0),
        pkg.TenantSpec.make("mamba", "falcon-mamba-7b", phase="decode",
                            n_layers=2, banks=1, rate_jps=1500.0),
    ]


class TestModelFleet:
    def test_tenant_spec_accepts_model_apps(self):
        t = TenantSpec.make("chat", "gemma3-1b", phase="decode", n_layers=2)
        assert t.app == "gemma3-1b"
        with pytest.raises(ValueError, match="unknown app"):
            TenantSpec.make("x", "gpt-99")

    @MODES
    def test_serves_model_fleet_to_completion(self, mode):
        _, res, _ = serve_both(model_tenants, mode, jobs=4)
        assert len(res) == 12
        for r in res:
            assert r.finish_ns >= r.admit_ns >= r.arrival_ns

    def test_shared_pim_beats_lisa_on_model_fleet(self):
        p99 = {}
        for mode in Interconnect:
            _, res, _ = serve_both(model_tenants, mode, jobs=5, seed=1)
            p99[mode] = summarize(res)["latency_ns"]["p99"]
        assert p99[Interconnect.SHARED_PIM] < p99[Interconnect.LISA]


# --- summarize(): TTFT / TPOT sections --------------------------------------------


def _session(tenant="s", seq=0, arrival=0.0, token_ns=(), turn_start=(0.0,),
             turn_first=(), tokens_per_turn=4):
    return SessionResult(tenant, "gemma3-1b", seq, arrival, arrival,
                         token_ns[-1] if token_ns else arrival,
                         tuple(token_ns), tuple(turn_start),
                         tuple(turn_first), tokens_per_turn, 1, 0, 0, 0)


def _summaries(rows_, **kw):
    got = summarize(rows_, **kw)
    rsr = _rrt().SessionResult
    want = _rrt().summarize([rsr(*dataclasses.astuple(r)) for r in rows_],
                            **kw)
    assert got == want
    return got


class TestSummarizeStreams:
    def test_job_only_batches_keep_empty_stream_sections(self):
        s = _summaries([])
        assert s["ttft_ns"] == {"n": 0, "p99_reliable": False}
        assert s["tpot_ns"] == {"n": 0, "p99_reliable": False}
        assert s["decode_tps"] == 0.0

    def test_zero_one_two_tpot_samples(self):
        s = _summaries([_session(token_ns=(10.0,), turn_first=(10.0,))])
        assert s["tpot_ns"] == {"n": 0, "p99_reliable": False}
        s = _summaries([_session(token_ns=(10.0, 14.0), turn_first=(10.0,))])
        assert s["tpot_ns"]["n"] == 1
        assert s["tpot_ns"]["p99"] == 4.0 and s["tpot_ns"]["mean"] == 4.0
        assert s["tpot_ns"]["p99_reliable"] is False
        s = _summaries([_session(token_ns=(10.0, 14.0, 20.0),
                                 turn_first=(10.0,))])
        assert s["tpot_ns"]["n"] == 2 and s["tpot_ns"]["p99_reliable"]
        assert s["tpot_ns"]["mean"] == 5.0

    def test_min_samples_threshold_applies_to_streams(self):
        r = _session(token_ns=(10.0, 14.0, 20.0), turn_first=(10.0,))
        s = _summaries([r], min_samples=3)
        assert s["tpot_ns"]["n"] == 2
        assert s["tpot_ns"]["p99_reliable"] is False

    def test_ttft_one_sample_per_turn(self):
        r = _session(token_ns=(10.0, 12.0, 110.0, 115.0),
                     turn_start=(0.0, 100.0), turn_first=(10.0, 110.0),
                     tokens_per_turn=2)
        s = _summaries([r])
        assert s["ttft_ns"]["n"] == 2
        assert s["ttft_ns"]["mean"] == 10.0
        assert s["ttft_ns"]["p99_reliable"] is True
        assert r.tpot_samples == (2.0, 5.0)

    def test_decode_tps_counts_tokens_over_span(self):
        r = _session(token_ns=(5e8, 1e9), turn_first=(5e8,),
                     tokens_per_turn=2)
        assert _summaries([r])["decode_tps"] == pytest.approx(2.0)

    def test_ttft_property_includes_queueing(self):
        r = SessionResult("s", "gemma3-1b", 0, arrival_ns=0.0,
                          admit_ns=3.0, finish_ns=20.0,
                          token_ns=(12.0, 20.0), turn_start_ns=(0.0,),
                          turn_first_ns=(12.0,), tokens_per_turn=2,
                          banks_resident=1, n_migrations=0,
                          n_preemptions=0, n_tasks=0)
        assert r.ttft_ns == 12.0 and r.queue_ns == 3.0


# --- the iteration scheduler end to end -------------------------------------------


def sessions_both(mode, *, turns=1, think_ns=0.0, slo=2e5, per_spec=3,
                  seed=0, **kw):
    """The same session trace through both packages' ContinuousRuntime."""
    rrt = _rrt()
    rt = ContinuousRuntime(mode, CGEOM, chunk_tokens=128,
                           tokens_per_bank=256, tpot_slo_ns=slo,
                           device="cpu", **kw)
    got = rt.run_sessions(session_trace(
        specs(turns=turns, think_ns=think_ns), sessions_per_spec=per_spec,
        seed=seed))
    rtr = rrt.session_trace(specs(rrt, turns=turns, think_ns=think_ns),
                            sessions_per_spec=per_spec, seed=seed)
    want = rrt.ContinuousRuntime(_rmode(mode), _rgeom(CGEOM),
                                 chunk_tokens=128, tokens_per_bank=256,
                                 tpot_slo_ns=slo, **kw).run_sessions(rtr)
    assert rows(got) == rows(want)
    assert summarize(got) == rrt.summarize(want)
    return rt, got


class TestContinuousRuntime:
    def test_session_trace_equals_the_reference(self):
        rrt = _rrt()
        for load in (0.5, 1.0, 3.0):
            got = session_trace(specs(), sessions_per_spec=4, seed=2,
                                load=load)
            want = rrt.session_trace(specs(rrt), sessions_per_spec=4,
                                     seed=2, load=load)
            assert [r.sort_key for r in got] == [r.sort_key for r in want]
        with pytest.raises(ValueError):
            session_trace(specs(), sessions_per_spec=0)
        with pytest.raises(ValueError, match="registered model"):
            SessionSpec.make("x", "mm")

    @MODES
    def test_every_token_lands_once(self, mode):
        rt, res = sessions_both(mode, turns=2, think_ns=5e5)
        assert len(res) == 6
        for r in res:
            assert len(r.token_ns) == r.tokens_per_turn * 2
            assert list(r.token_ns) == sorted(r.token_ns)
            assert len(r.turn_first_ns) == len(r.turn_start_ns) == 2
        assert rt.allocator.n_free == CGEOM.n_banks
        assert rt.allocator.n_resident == 0 and rt.allocator.n_queued == 0

    def test_shared_pim_beats_lisa_tpot(self):
        s = {mode: summarize(sessions_both(mode, turns=2, think_ns=5e5,
                                           per_spec=2)[1])
             for mode in Interconnect}
        ssp, sli = s[Interconnect.SHARED_PIM], s[Interconnect.LISA]
        assert ssp["tpot_ns"]["p99"] < sli["tpot_ns"]["p99"]
        assert ssp["decode_tps"] > sli["decode_tps"]

    def test_preemption_fires_under_tight_slo(self):
        _, tight = sessions_both(Interconnect.SHARED_PIM, turns=2,
                                 think_ns=5e5, slo=1e4)
        _, loose = sessions_both(Interconnect.SHARED_PIM, turns=2,
                                 think_ns=5e5, slo=None, per_spec=2)
        assert sum(r.n_preemptions for r in tight) > 0
        assert sum(r.n_preemptions for r in loose) == 0
        assert all(len(r.token_ns) == r.tokens_per_turn * 2 for r in tight)

    def test_migration_defragments_growth(self):
        rrt = _rrt()
        out = {}
        for pkg in (prt, rrt):
            spec = pkg.SessionSpec.make(
                "chat", "gemma3-1b", n_layers=2, prompt_tokens=64,
                decode_tokens=40, turns=2, think_ns=1e5, rate_sps=3000.0,
                concurrency=2)
            kw = dict(chunk_tokens=64, tokens_per_bank=16, tpot_slo_ns=1e6)
            if pkg is prt:
                rt = ContinuousRuntime(Interconnect.SHARED_PIM, CGEOM,
                                       device="cpu", **kw)
            else:
                rt = rrt.ContinuousRuntime(_rmode(Interconnect.SHARED_PIM),
                                           _rgeom(CGEOM), **kw)
            out[pkg] = (rt, rt.run_sessions(source=pkg.MultiTurnSource(
                [spec], sessions_per_spec=4, seed=0)))
        rt, res = out[prt]
        assert rows(res) == rows(out[rrt][1])
        assert sum(r.n_migrations for r in res) > 0
        assert all(len(r.token_ns) == 80 for r in res)
        assert rt.allocator.n_free == CGEOM.n_banks

    def test_closed_loop_source_completes_budget(self):
        rrt = _rrt()
        got = ContinuousRuntime(Interconnect.SHARED_PIM, CGEOM,
                                chunk_tokens=128, tokens_per_bank=256,
                                device="cpu").run_sessions(
            source=MultiTurnSource([specs()[0]], sessions_per_spec=5,
                                   seed=1))
        want = rrt.ContinuousRuntime(
            _rmode(Interconnect.SHARED_PIM), _rgeom(CGEOM),
            chunk_tokens=128, tokens_per_bank=256).run_sessions(
            source=rrt.MultiTurnSource([specs(rrt)[0]], sessions_per_spec=5,
                                       seed=1))
        assert rows(got) == rows(want)
        assert len(got) == 5
        assert sorted(r.seq for r in got) == list(range(5))

    def test_run_sessions_requires_continuous(self):
        rt = ContinuousRuntime(Interconnect.SHARED_PIM, CGEOM,
                               continuous=False, device="cpu")
        with pytest.raises(ValueError):
            rt.run_sessions(session_trace(specs(), sessions_per_spec=1,
                                          seed=0))
        with pytest.raises(ValueError, match="chunk_tokens"):
            ContinuousRuntime(Interconnect.LISA, CGEOM, chunk_tokens=0,
                              device="cpu")

    @MODES
    def test_continuous_off_is_bitforbit_whole_job(self, mode):
        def two(pkg):
            return [pkg.TenantSpec.make("mm", "mm", n=16, banks=2,
                                        rate_jps=2000.0),
                    pkg.TenantSpec.make("bfs", "bfs", n_nodes=30, banks=2,
                                        priority=2, rate_jps=2000.0)]

        tr = open_loop_trace(two(prt), jobs_per_tenant=6, seed=0)
        _, base, _ = serve_both(two, mode, geom=CGEOM)
        cont = ContinuousRuntime(mode, CGEOM, continuous=False,
                                 device="cpu").run(tr)
        assert cont == base


# --- on the card -----------------------------------------------------------------


@pytest.mark.cuda
@MODES
def test_card_serving_and_sessions_equal_host(mode):
    _need_cuda()
    tr = open_loop_trace(tenants(), jobs_per_tenant=6, seed=0)
    card = ServingRuntime(mode, GEOM, refresh=RefreshSpec()).run(tr)
    host = ServingRuntime(mode, GEOM, refresh=RefreshSpec(),
                          device="cpu").run(tr)
    assert card == host
    str_ = session_trace(specs(turns=2, think_ns=5e5), sessions_per_spec=2,
                         seed=0)
    kw = dict(chunk_tokens=128, tokens_per_bank=256, tpot_slo_ns=1e4)
    card = ContinuousRuntime(mode, CGEOM, **kw).run_sessions(str_)
    host = ContinuousRuntime(mode, CGEOM, device="cpu",
                             **kw).run_sessions(str_)
    assert card == host


# --- chip_smoke.py's pim-runtime constants ---------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("part", ["obs", "search", "slo", "serving",
                                  "continuous"])
def test_chip_smoke_pim_runtime_constants_are_the_reference(part):
    """The figures ``chip_smoke.py`` holds the card to are the reference's
    benchmark scripts' own: the recorder and search cells whole, the SLO
    calibrations, one serving cell and the continuous cells at load 1.0
    (the card's phase runs every cell)."""
    cs = _chip_smoke()
    rrt = _rrt()
    rd, rengine = _ref("device"), _ref("core.engine")
    ri = _ref("core.pluto").Interconnect
    if part == "obs":
        for (name, mode), want in cs.PIM_RT_OBS_REF.items():
            app, gkw, kw = cs.PIM_RT_OBS[name]
            rec = _ref("obs").record_sweep(
                _ref("device.batch").SweepConfig.make(
                    app, ri(mode), rd.DeviceGeometry(**gkw), **kw),
                refresh=rengine.RefreshSpec())
            assert (rec._session.job(0).n_tasks,
                    rec._session.stats().makespan_ns, rec.n_events) == want
    elif part == "search":
        rs = _ref("search")
        for name, want in cs.PIM_RT_SEARCH_REF.items():
            app, gkw, kw = cs.PIM_RT_SEARCH[name]
            geom = rd.DeviceGeometry(**gkw)
            res = rs.search_pe_map(
                _ref("core.taskgraph").structural(app, n_pes=geom.total_pes,
                                                  **kw),
                ri.SHARED_PIM, geom,
                config=rs.SearchConfig(seed=0, n_workers=1))
            assert (res.incumbent_makespan_ns, res.incumbent_policy,
                    res.makespan_ns, res.digest, res.stats["engine_evals"],
                    res.stats["surrogate_prunes"]) == want
    else:
        geom, tenants, slo = _ref_serving(cs, rrt, rd, ri)
        cgeom = rd.DeviceGeometry(**cs.PIM_RT_CONT_GEOM)
        specs_ = [rrt.SessionSpec.make(**x) for x in cs.PIM_RT_SESSIONS]
        if part == "slo":
            lower = _ref("frontend.lower")
            steps = []
            for spec in specs_:
                kv = spec.prompt_tokens + spec.decode_tokens
                nb = min(cgeom.n_banks, max(1, -(-kv // 256)))
                g = lower.decode_step(spec.app, n_pes=nb * cgeom.pes_per_bank,
                                      kv_len=kv, **spec.kwargs)
                steps.append(_ref("device.scheduler").schedule(
                    _ref("device.partition").place_on_banks(
                        g, cgeom, tuple(range(nb))),
                    ri.LISA, cgeom).makespan_ns)
            assert (slo, 6.0 * max(steps)) == (cs.PIM_RT_SLO_REF,
                                               cs.PIM_RT_TPOT_SLO_REF)
        elif part == "serving":
            s = rrt.summarize(rrt.ServingRuntime(
                ri.SHARED_PIM, geom, admission="fifo",
                refresh=rengine.RefreshSpec()).run(rrt.open_loop_trace(
                    tenants, jobs_per_tenant=40, seed=0, load=0.9)))
            assert (s["latency_ns"]["p50"], s["latency_ns"]["p99"],
                    s["throughput_jps"]) == \
                cs.PIM_RT_SERVE_REF[(0.9, "shared_pim")]
        else:
            for mode in ri:
                res = rrt.ContinuousRuntime(
                    mode, cgeom, chunk_tokens=128, tokens_per_bank=256,
                    tpot_slo_ns=cs.PIM_RT_TPOT_SLO_REF).run_sessions(
                    rrt.session_trace(specs_, sessions_per_spec=8, seed=0,
                                      load=1.0))
                s = rrt.summarize(res)
                assert (s["decode_tps"], s["tpot_ns"]["p99"],
                        s["ttft_ns"]["p99"], s["makespan_ns"],
                        sum(r.n_preemptions for r in res),
                        sum(r.n_migrations for r in res)) == \
                    cs.PIM_RT_CONT_REF[(1.0, mode.value)]


def _ref_serving(cs, rrt, rd, ri):
    """The reference's serving device, calibrated tenants and p99 SLO, as
    ``benchmarks/serving.py`` builds them from ``chip_smoke.py``'s mix."""
    geom = rd.DeviceGeometry(**cs.PIM_RT_SERVE_GEOM)
    tenants, s_max = [], 0.0
    for name, app, banks, prio, kw in cs.PIM_RT_TENANTS:
        struct = _ref("core.taskgraph").structural(
            app, n_pes=banks * geom.pes_per_bank, **kw)
        s = _ref("device.scheduler").schedule(
            _ref("device.partition").place_on_banks(struct, geom,
                                                    tuple(range(banks))),
            ri.LISA, geom).makespan_ns
        s_max = max(s_max, s)
        tenants.append(rrt.TenantSpec.make(
            name, app, rate_jps=geom.n_banks / (len(cs.PIM_RT_TENANTS) * s
                                                * banks) * 1e9,
            priority=prio, banks=banks, **kw))
    return geom, tenants, 4.0 * s_max
