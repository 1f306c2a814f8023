"""Variant sweep of the selective-scan kernel on one NVIDIA card.

    python3 benchmarks/selective_scan_sweep.py [--baseline OLD.cu] [--out F]

Builds ``src/repro_torch/kernels/csrc/mamba_scan.cu`` once for each set of
values of the ring path's constants (``TS`` steps a ring stage, ``STAGES``
stages, ``NC`` consumer threads a block, ``S_SMALL`` states a lane at
N <= 16), written into a copy under ``build/sweep/``, one ``nvcc`` each, all
started together, and ``--baseline``, an older source with the same C
interface, beside them.  Each library is held
against ``ref.selective_scan_ref`` at the serving prefill shape (B=4,
T=1100, D=8192, N=16, bf16 x/b/c, b and c slices of one projection) under
``chip_smoke.SCAN_TOL``, then all are timed in turns (three rounds) as
device time from a CUDA graph of 20 launches, at that shape and at the
decode step's (T=1).  Prints one line a variant and writes the records as
JSON.  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402

VARIANTS = {                     # the source's constants: S, TS, STAGES, NC
    "s8_ts32_st3_nc256": {},     # as the source has them
    "s4_ts32_st3_nc256": {"S_SMALL": 4},
    "s4_ts32_st3_nc512": {"S_SMALL": 4, "NC": 512},
    "s16_ts32_st3_nc256": {"S_SMALL": 16},
    "s8_ts16_st4_nc256": {"TS": 16, "STAGES": 4},
    "s8_ts32_st2_nc256": {"STAGES": 2},
    "s8_ts64_st2_nc256": {"TS": 64, "STAGES": 2},
    "s8_ts32_st3_nc128": {"NC": 128},
    "s8_ts32_st3_nc512": {"NC": 512},
}
SHAPES = ((4, 1100, 8192, 16), (4, 1, 8192, 16))


def variant_source(values: dict[str, int], out_dir) -> pathlib.Path:
    """A copy of the source with its constants set to ``values``."""
    src = (_build.CSRC / "mamba_scan.cu").read_text()
    for name, value in values.items():
        line = re.search(rf"constexpr int {name} = \d+;", src)
        if line is None:
            raise ValueError(f"no constant {name} in mamba_scan.cu")
        src = src.replace(line.group(0), f"constexpr int {name} = {value};")
    tag = "_".join(f"{k}{v}" for k, v in sorted(values.items())) or "as_is"
    path = out_dir / f"mamba_scan_{tag}.cu"
    path.write_text(src)
    return path


def build(name: str, src: pathlib.Path, out_dir):
    out = out_dir / f"libscan_{name}.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.selective_scan_fwd.argtypes = [p] * 8 + [i] * 5 + [ll] * 8 + [p]
    lib.selective_scan_fwd.restype = i
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "spill" in ln or "registers" in ln]
    return lib, ptxas


def caller(lib, args):
    dt = args[0]
    B, T, D = dt.shape
    y = torch.empty((B, T, D), device="cuda")
    h = torch.empty_like(args[5])

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.selective_scan_fwd(
            *ms._selective_args(*args, y, h), stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return y, h
    return call


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=pathlib.Path, default=None,
                    help="an older mamba_scan.cu to time beside")
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "build" / "selective_scan_sweep.json")
    args = ap.parse_args(argv)
    smi = chip_smoke.phase_card()
    out_dir = ROOT / "build" / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {n: variant_source(v, out_dir) for n, v in VARIANTS.items()}
    if args.baseline is not None:
        jobs["baseline"] = args.baseline.resolve()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futs = {n: pool.submit(build, n, src, out_dir)
                for n, src in jobs.items()}
        libs = {n: f.result() for n, f in futs.items()}
    gen = torch.Generator(device="cuda").manual_seed(1234)
    records = {n: {"name": n, "constants": VARIANTS.get(n, {}),
                   "ptxas": libs[n][1]} for n in jobs}
    for B, T, D, N in SHAPES:
        inputs = chip_smoke._selective_inputs(gen, B, T, D, N,
                                              torch.bfloat16, offset=256)
        wy, wh = ref.selective_scan_ref(*inputs)
        calls = {n: caller(lib, inputs) for n, (lib, _) in libs.items()}
        for n, call in calls.items():
            y, h = call()
            torch.cuda.synchronize()
            err = max(chip_smoke._close(y, wy, **chip_smoke.SCAN_TOL)[0],
                      chip_smoke._close(h, wh, **chip_smoke.SCAN_TOL)[0])
            ok = all(chip_smoke._close(g, w, **chip_smoke.SCAN_TOL)[1]
                     for g, w in ((y, wy), (h, wh)))
            records[n][f"T{T}_max_abs_err"] = err
            records[n][f"T{T}_within_tol"] = ok
        times = {n: [] for n in calls}
        for _ in range(3):
            for n, call in calls.items():
                times[n].append(chip_smoke.graph_ms(call))
        for n, ts in times.items():
            records[n][f"T{T}_ms"] = statistics.median(ts)
            records[n][f"T{T}_ms_range"] = [min(ts), max(ts)]
        del wy, wh, inputs, calls
    for r in records.values():
        print("VARIANT " + json.dumps(r), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi,
                                    "variants": list(records.values())},
                                   indent=1))
    if not all(r[f"T{s[1]}_within_tol"] for r in records.values()
               for s in SHAPES):
        raise SystemExit("a variant is off its plain version")


if __name__ == "__main__":
    main()
