"""Run one cell of the benchmark once, from the root of a checkout:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is one entry of ``workloads`` in ``BENCHMARK.json``: one model
configuration under one traffic mix.  The run drives the PyTorch port
(``src/repro_torch``) on one CUDA card and prints, as its last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with the plain
reference, beside its limit (also the last lines of standard error).

It exits without a result where there is no CUDA card, or fewer than the
cell asks for, and where JAX or the JAX package was loaded.  Build and
kernel caches stay under ``build/`` in the checkout.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def _environment() -> None:
    """Caches at fixed paths inside the checkout; no library loads JAX."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the run may not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from yardstick import cell as cell_lib

    cell = cell_lib.load(args.workload, ROOT / "BENCHMARK.json")
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found {n}",
              file=sys.stderr)
        return 2
    from yardstick import drivers

    dev = torch.device("cuda", 0)
    out = drivers.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           dev, T0)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark runs the PyTorch port "
              "alone", file=sys.stderr)
        return 3
    rec = out["record"]
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["values"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown()
    result["checks"] = out["checks"]
    print(f"card: {_power_limit()}; setup_s {out['values']['setup_s']}",
          file=sys.stderr)
    if args.trace:
        from yardstick import trace

        kinds = {k: rec.trace.seconds(k) for k in [*trace.KINDS, "eager"]}
        print(f"traced {len(rec.traced)} units, device seconds by kind "
              f"{json.dumps(kinds)}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"check failed_requests {out['failed']} limit 0", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
