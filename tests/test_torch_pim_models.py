"""The port's simulator models (``repro_torch.core.{timing, copy_models,
pluto, energy, area, nonpim}``) against the reference package, equal bit for
bit (tolerance 0): Table II, every copy model and its command timeline, the
pLUTo op latencies and Fig 7, the energy price list and ``move_energy``,
Table III and Fig 9.  These modules are plain Python floats in both
packages, so ``==`` on every float is the contract.  The reference package
is imported only inside the tests.
"""

import dataclasses
import importlib

import pytest

from repro_torch.core import area, copy_models, energy, nonpim, pluto, timing
from repro_torch.core.pluto import Interconnect


def _ref(name):
    return importlib.import_module(f"repro.core.{name}")


def _same_copy(got, want):
    """Every field of two ``CopyResult``s, the timeline command by command."""
    assert got.mechanism == want.mechanism
    assert got.latency_ns == want.latency_ns
    assert got.energy_j == want.energy_j
    assert got.stalled_subarrays == want.stalled_subarrays
    assert got.occupies_bus == want.occupies_bus
    assert got.occupies_channel == want.occupies_channel
    assert len(got.timeline) == len(want.timeline)
    for a, b in zip(got.timeline, want.timeline):
        assert (a.name, a.start_ns, a.duration_ns, a.end_ns) == \
            (b.name, b.start_ns, b.duration_ns, b.end_ns)


def _ref_timing(t):
    return getattr(_ref("timing"), "DDR3_1600" if "DDR3" in t.name
                   else "DDR4_2400")


NODES = [timing.DDR3_1600, timing.DDR4_2400]


@pytest.mark.parametrize("node", NODES, ids=lambda t: t.name.split()[0])
def test_timing_nodes(node):
    want = _ref_timing(node)
    assert dataclasses.asdict(node) == dataclasses.asdict(want)
    for prop in ("tRC", "bursts_per_row", "grb_stream_ns",
                 "channel_stream_ns"):
        assert getattr(node, prop) == getattr(want, prop), prop


def test_timing_constants():
    rt = _ref("timing")
    for name in ("E_ACT_ROW", "E_BKSA_SEGMENT_ROW", "E_CHANNEL_PER_BYTE",
                 "E_GRB_PER_BYTE", "MEMCPY_ENERGY_8KB",
                 "RC_INTERSA_ENERGY_8KB", "LISA_ENERGY_8KB",
                 "SHAREDPIM_ENERGY_8KB"):
        assert getattr(timing, name) == getattr(rt, name), name
    geo = timing.DEFAULT_GEOMETRY
    assert dataclasses.asdict(geo) == dataclasses.asdict(rt.DEFAULT_GEOMETRY)
    assert geo.total_subarrays == rt.DEFAULT_GEOMETRY.total_subarrays


def test_table2():
    got = copy_models.table2()
    want = _ref("copy_models").table2()
    assert list(got) == list(want)
    assert got == want


@pytest.mark.parametrize("node", NODES, ids=lambda t: t.name.split()[0])
@pytest.mark.parametrize("src,dst", [(0, 1), (3, 0), (2, 9), (5, 5)])
def test_copy_models(node, src, dst):
    rc = _ref("copy_models")
    rt = _ref_timing(node)
    _same_copy(copy_models.memcpy_copy(node, src=src, dst=dst),
               rc.memcpy_copy(rt, src=src, dst=dst))
    _same_copy(copy_models.rc_intersa_copy(node, src=src, dst=dst),
               rc.rc_intersa_copy(rt, src=src, dst=dst))
    _same_copy(copy_models.rc_intrasa_copy(node, subarray=src),
               rc.rc_intrasa_copy(rt, subarray=src))
    if src != dst:
        _same_copy(copy_models.lisa_copy(node, src=src, dst=dst),
                   rc.lisa_copy(rt, src=src, dst=dst))
    for staged in (True, False):
        for restore in (True, False):
            _same_copy(copy_models.sharedpim_copy(node, src=src, dst=dst,
                                                  staged=staged,
                                                  restore=restore),
                       rc.sharedpim_copy(rt, src=src, dst=dst, staged=staged,
                                         restore=restore))


@pytest.mark.parametrize("distance", [1, 2, 3, 4, 7, 15])
def test_lisa_distances(distance):
    _same_copy(copy_models.lisa_copy(distance=distance),
               _ref("copy_models").lisa_copy(distance=distance))


def test_lisa_rejects_zero_distance():
    with pytest.raises(ValueError, match="distance >= 1"):
        copy_models.lisa_copy(distance=0)


@pytest.mark.parametrize("dests", [(1,), (1, 2), (3, 7, 9), (1, 2, 3, 4)])
def test_broadcast(dests):
    _same_copy(copy_models.sharedpim_broadcast(dests=dests),
               _ref("copy_models").sharedpim_broadcast(dests=dests))


def test_broadcast_cap():
    with pytest.raises(ValueError, match="fan-out 5"):
        copy_models.sharedpim_broadcast(dests=(1, 2, 3, 4, 5))


def test_pluto_constants_and_ops():
    rp = _ref("pluto")
    for name in ("T_MOVE_LISA", "T_MOVE_BUS", "T_ADD4", "T_SEL", "T_MUL4",
                 "T_TREEADD", "E_MOVE_LISA", "E_MOVE_BUS", "E_LUT_PASS"):
        assert getattr(pluto, name) == getattr(rp, name), name
    assert [m.value for m in Interconnect] == [m.value for m in rp.Interconnect]
    assert [m.name for m in Interconnect] == [m.name for m in rp.Interconnect]
    for bits in (4, 8, 12, 16, 32, 64, 128):
        assert pluto.nibbles(bits) == rp.nibbles(bits)
        for m in Interconnect:
            rm = rp.Interconnect(m.value)
            assert pluto.add_latency_ns(bits, m) == rp.add_latency_ns(bits, rm)
            assert pluto.mul_latency_ns(bits, m) == rp.mul_latency_ns(bits, rm)
        for op in ("add", "mul"):
            assert pluto.improvement(bits, op) == rp.improvement(bits, op)
    for op in ("add", "mul"):
        for m in Interconnect:
            assert pluto.op32_latency_ns(op, m) == rp.op32_latency_ns(
                op, rp.Interconnect(m.value))


@pytest.mark.parametrize("bits", [0, 3, 6, -4])
def test_pluto_rejects_widths(bits):
    with pytest.raises(ValueError, match="multiple of 4"):
        pluto.nibbles(bits)


def test_fig7_table():
    got = pluto.fig7_table()
    want = _ref("pluto").fig7_table()
    assert list(got) == list(want)
    assert got == want


def test_energy_table():
    re = _ref("energy")
    assert dataclasses.asdict(energy.DEFAULT_TABLE) == \
        dataclasses.asdict(re.DEFAULT_TABLE)
    assert energy.DEFAULT_TABLE.per_bit_pj() == re.DEFAULT_TABLE.per_bit_pj()
    assert energy.ROW_BITS == re.ROW_BITS
    assert energy.E_REFRESH_WINDOW == re.E_REFRESH_WINDOW
    assert energy.EnergyTable().per_bit_pj() == re.EnergyTable().per_bit_pj()
    with pytest.raises(dataclasses.FrozenInstanceError):
        energy.DEFAULT_TABLE.op_j = 0.0


MOVES = ([(0, [d], r) for d in (1, 2, 3, 4) for r in (1, 8)]
         + [(5, [5], 2), (3, [0], 1), (0, [1, 2], 1), (0, [1, 2, 3, 4], 1),
            (0, [1, 2, 3, 4], 16), (2, [1, 3, 5, 7, 9, 11], 3)])


@pytest.mark.parametrize("src,dsts,rows", MOVES)
def test_move_energy(src, dsts, rows):
    re = _ref("energy")
    rp = _ref("pluto")
    for m in Interconnect:
        assert energy.move_energy(m, src, dsts, rows) == re.move_energy(
            rp.Interconnect(m.value), src, dsts, rows)


def test_move_energy_reproduces_copy_models():
    # one row, one destination at distances 1-4, and a 4-way broadcast
    for d in (1, 2, 3, 4):
        assert energy.move_energy(Interconnect.LISA, 0, [d], 1) == \
            copy_models.lisa_copy(distance=d).energy_j
    assert energy.move_energy(Interconnect.SHARED_PIM, 0, [1], 1) == \
        copy_models.sharedpim_copy().energy_j
    assert energy.move_energy(Interconnect.SHARED_PIM, 0, [1, 2, 3, 4], 1) \
        == copy_models.sharedpim_broadcast(dests=(1, 2, 3, 4)).energy_j


def test_area():
    ra = _ref("area")
    assert area.TABLE_III == ra.TABLE_III
    for col in (0, 1, 2):
        assert area.total(col) == ra.total(col)
    assert area.sharedpim_overhead_pct() == ra.sharedpim_overhead_pct()
    # the paper's 7.16%, within paper_tables' 0.02
    assert abs(area.sharedpim_overhead_pct() - 7.16) <= 0.02


def test_nonpim():
    rn = _ref("nonpim")
    for name in ("T_MEMCPY", "T_LISA", "T_SHAREDPIM", "COPY_FRACTION"):
        assert getattr(nonpim, name) == getattr(rn, name), name
    assert nonpim.fig9_table() == rn.fig9_table()
    for app in nonpim.COPY_FRACTION:
        for m in ("memcpy", "lisa", "shared_pim"):
            assert nonpim.normalized_ipc(app, m) == rn.normalized_ipc(app, m)
