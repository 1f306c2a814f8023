"""Read a cell's sound runs, its control and its faults on the card, at the
cell's own size, for the limits of ``bench/limits/<cell>.json``:

    python3 bench/controls.py --workload <cell> --seeds 11 12 13 \\
        --control-seeds 11 12 --seconds 22 --out <file>

Each seed runs the cell as ``bench/run.py`` does, in this one process:
set-up, a window of ``--seconds`` at the cell's load (long enough for the
sample the check compares), the comparison with the float32 reference.
Those are the sound readings.  The seeds in ``--control-seeds`` also give
the control's and the faults' readings against the same reference, on the
same weights, tokens and compared rows.

The control is the plain reference put in the program's place and
computed one precision below the configuration's bfloat16: every weight
product in float8 e4m3 (``plain.to_fp8``).  The faults are planted in the
reference put in the program's place: for a training cell half of each
batch left out (the mean taken over the rest) and the smallest leaves
(under a hundredth of the median leaf's size: the norms' weights, a
Mamba-2 layer's ``A_log``, ``D`` and ``dt_bias``) never updated; a state
left unchanged reads 1 by the change's measure and needs no run.  For a
scoring cell each served token altered (the reference's best plus one).
The benchmark's own runs never run this; ``bench/tests/
test_bench_control.py`` runs one seed of it.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def small_leaves(m: dict) -> frozenset:
    """Paths of the leaves under a hundredth of the median leaf's size."""
    from yardstick import weights

    size = {lf.path: math.prod(lf.shape) for lf in weights.leaves(m)}
    med = statistics.median(size.values())
    return frozenset(p for p, n in size.items() if n < med / 100)


def train_faults(cell, seed: int, dev, detail: dict) -> dict:
    from yardstick import compare, drivers

    runs = {"control_fp8": {"fp8": True},
            "fault_half_batch": {"half": True},
            "fault_frozen_small": {"frozen": small_leaves(cell.model)}}
    return {what: compare.train_numbers(drivers.reference_train(
                cell, seed, dev, **kw), detail["ref"])
            for what, kw in runs.items()}


def score_faults(cell, seed: int, dev, detail: dict) -> dict:
    from yardstick import compare, drivers

    ref = detail["ref_logits"]
    fp8 = drivers.reference_score(cell, seed, dev, detail["rows"], fp8=True)
    V = cell.model["vocab_size"]
    return {"control_fp8": {
                "logit_gap": max(compare.logit_gap(r, int(f.argmax()))
                                 for r, f in zip(ref, fp8)),
                "logit_err": max(compare.logit_err(f, r)
                                 for r, f in zip(ref, fp8))},
            "fault_altered_token": {
                "logit_gap": max(compare.logit_gap(
                    r, (int(r.argmax()) + 1) % V) for r in ref)}}


def readings(cell, seed: int, dev, seconds: float,
             control: bool = True) -> dict:
    """One seed's sound run and, with ``control``, the control's and the
    faults' numbers: {"correct", "sound", ["leaves"], what: numbers}."""
    from yardstick import compare, drivers

    out = drivers.run_cell(cell, seed, seconds, False, dev,
                           time.perf_counter())
    res = {"correct": out["correct"],
           "sound": {k: c["value"] for k, c in out["checks"].items()}}
    train = cell.traffic["kind"] == "train"
    if train:
        res["leaves"] = compare.leaf_gaps(out["detail"]["prog"],
                                          out["detail"]["ref"])
    if control:
        res.update((train_faults if train else score_faults)(
            cell, seed, dev, out["detail"]))
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", type=pathlib.Path, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]
    import torch

    from yardstick import cell as cell_lib

    if not torch.cuda.is_available():
        print("the controls are read on a CUDA card", file=sys.stderr)
        return 2
    cell = cell_lib.load(args.workload, ROOT / "BENCHMARK.json")
    dev = torch.device("cuda", 0)
    out = {"workload": cell.name, "limits": cell.limits, "seeds": {}}
    for seed in args.seeds:
        got = readings(cell, seed, dev, args.seconds,
                       control=seed in args.control_seeds)
        out["seeds"][str(seed)] = got
        print(json.dumps({"seed": seed, **got}), flush=True)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
