"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration (``bench/configs/<config>.json`` and the plain reference the
file names beside it), its traffic mix (``bench/traffic/<traffic>.json``),
its correctness limits (``bench/limits/<cell>.json``) and the reader of
each per-layer metric (``bench/metrics/<metric>.py``, a ``read(record)``
that returns a number or None).  A later change adds a configuration, a
mix, a cell or a metric as new files and entries, and edits none of these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from types import ModuleType

BENCH = pathlib.Path(__file__).resolve().parents[1]


def load_module(path: pathlib.Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    reference: ModuleType
    end_to_end: list[dict]          # this cell's end-to-end metrics
    per_layer: list[dict]           # this cell's per-layer metrics
    bench: pathlib.Path

    @property
    def model(self) -> dict:
        return self.config["model"]

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.bench / "metrics" / f"{metric}.py",
                           f"bench_metric_{metric.replace('.', '_')}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, benchmark: pathlib.Path,
         bench: pathlib.Path = BENCH) -> Cell:
    """The cell ``name`` of the benchmark file ``benchmark``."""
    spec = json.loads(benchmark.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {benchmark}; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    config = json.loads((bench / "configs" / f"{w['config']}.json")
                        .read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((bench / "limits" / f"{name}.json").read_text())
    ref = load_module(bench / "configs" / config["reference"],
                      f"bench_ref_{config['reference'][:-3]}")
    return Cell(name, w["chips"], config, traffic, limits, ref,
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)], bench)
