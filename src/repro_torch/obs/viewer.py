"""Record paper-workload schedules and emit Perfetto-loadable traces
(PyTorch port of ``repro/obs/viewer.py``).

``python -m repro_torch.obs`` records the two workloads the paper's timeline argument lives on — a tiled matmul and an
MoE decode step — under both interconnects, dumps each schedule as Chrome
trace-event JSON, and prints where to load them.  Opening the Shared-PIM
trace next to the LISA trace of the same cell shows Fig. 1 as actual
tracks: the Shared-PIM bank PEs keep their op spans flowing while rows
drain through the tx/rx tracks, where the LISA trace shows the same PEs
gapped for every inter-bank span.

Each trace also carries the ``power`` process: one windowed counter track
per bank and bus plus the device total, derived from the same claim
windows the resource tracks render — the LISA trace burns more joules
over a longer makespan, and the per-cell summary line prints both totals
so the paper's 1.2x transfer-energy claim is visible next to its speedup.

The schedules run on ``--device`` (``cuda`` unless the caller asks for the
CPU; there is no fallback); the traces are the same bytes on either.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import torch

from repro_torch.core.engine import RefreshSpec
from repro_torch.core.pluto import Interconnect
from repro_torch.device.batch import SweepConfig
from repro_torch.device.geometry import DeviceGeometry
from repro_torch.obs.trace import record_sweep

#: the recorded cells: name -> (app, app kwargs); one op-dominated, one
#: move-dominated, both small enough that the traces open instantly
CELLS = {
    "matmul": ("mm", dict(n=24)),
    "moe-decode": ("qwen2-moe-a2.7b", dict(phase="decode", n_layers=2)),
}


def record_all(out_dir: Path, *, refresh: RefreshSpec | None = None,
               geom: DeviceGeometry | None = None,
               device: str | torch.device = "cuda") -> list[Path]:
    """Record every cell under both interconnects; returns written paths."""
    if geom is None:
        geom = DeviceGeometry(channels=1, banks_per_channel=4,
                              pes_per_bank=8)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, (app, kw) in CELLS.items():
        makespans = {}
        energies = {}
        for mode in Interconnect:
            cfg = SweepConfig.make(app, mode, geom, **kw)
            rec = record_sweep(cfg, refresh=refresh, device=device)
            stats = rec._session.stats()
            makespans[mode] = stats.makespan_ns
            energies[mode] = stats.total_energy_j
            power = rec.power_series()
            peak_w = max(power["total_w"], default=0.0)
            path = out_dir / f"{name}.{mode.value}.trace.json"
            rec.dump(path, {"cell": name, "app": app, "kw": dict(kw),
                            "geometry": geom.describe(),
                            "makespan_ns": stats.makespan_ns,
                            "energy_j": stats.total_energy_j})
            paths.append(path)
            print(f"{name:12s} {mode.value:10s} "
                  f"makespan {stats.makespan_ns:10.1f} ns  "
                  f"energy {stats.total_energy_j * 1e6:8.2f} uJ  "
                  f"peak {peak_w:6.2f} W  "
                  f"{rec.n_events:6d} events  -> {path}")
        sp, li = (makespans[Interconnect.SHARED_PIM],
                  makespans[Interconnect.LISA])
        esp, eli = (energies[Interconnect.SHARED_PIM],
                    energies[Interconnect.LISA])
        print(f"{name:12s} shared-pim is {li / sp:.2f}x faster and spends "
              f"{eli / esp:.2f}x less energy — compare the PE tracks and "
              f"the power counters to see why")
    return paths


def report_search(geom: DeviceGeometry | None = None, *,
                  device: str | torch.device = "cuda") -> dict:
    """Run the placement search on every viewer cell and print the oracle
    counters (evals / surrogate prunes / cache hits / workers) the search
    satellite surfaces — the human-readable view of
    :attr:`repro_torch.obs.profile.EngineProfile.oracle_counters`."""
    from repro_torch.core import taskgraph
    from repro_torch.obs.profile import EngineProfile
    from repro_torch.search import SearchConfig, search_pe_map

    if geom is None:
        geom = DeviceGeometry(channels=1, banks_per_channel=4,
                              pes_per_bank=8)
    out = {}
    for name, (app, kw) in CELLS.items():
        prof = EngineProfile()
        struct = taskgraph.structural(app, n_pes=geom.total_pes, **kw)
        res = search_pe_map(struct, Interconnect.SHARED_PIM, geom,
                            config=SearchConfig(device=str(device)),
                            profile=prof)
        c = prof.oracle_counters
        print(f"{name:12s} search     "
              f"greedy {res.incumbent_makespan_ns:10.1f} ns "
              f"({res.incumbent_policy}) -> {res.makespan_ns:10.1f} ns "
              f"({res.improvement * 100:+.2f}%)")
        print(f"{'':12s} oracle     "
              f"{c['oracle_evals']} engine evals, "
              f"{c['surrogate_prunes']} surrogate prunes, "
              f"{c['oracle_cache_hits']} cache hits / "
              f"{c['oracle_cache_misses']} misses, "
              f"{c['oracle_memo_hits']} memo hits, "
              f"{c['oracle_workers']} worker(s)  "
              f"digest={res.digest}")
        out[name] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out-dir", default=None,
                    help="where to write the .trace.json files "
                         "(default: a fresh temp directory)")
    ap.add_argument("--refresh", action="store_true",
                    help="enable DDR4 refresh (adds per-bank refresh tracks)")
    ap.add_argument("--search", action="store_true",
                    help="also run the cost-driven placement search on "
                         "each cell and print the oracle counters")
    ap.add_argument("--device", default="cuda",
                    help="where the schedules run: cuda (default) or cpu")
    args = ap.parse_args(argv)

    out_dir = Path(args.out_dir) if args.out_dir else Path(
        tempfile.mkdtemp(prefix="repro-traces-"))
    paths = record_all(out_dir,
                       refresh=RefreshSpec() if args.refresh else None,
                       device=args.device)
    if args.search:
        print()
        report_search(device=args.device)
    print(f"\n{len(paths)} traces in {out_dir}")
    print("open https://ui.perfetto.dev and drag a .trace.json in; "
          "one track per bank PE / bus / shared row, plus windowed "
          "power counters per bank/bus under the 'power' process")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
