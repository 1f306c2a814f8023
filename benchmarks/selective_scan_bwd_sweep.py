"""Variant sweep of the selective scan's backward kernel on one NVIDIA card.

    python3 benchmarks/selective_scan_bwd_sweep.py [--baseline OLD.cu]
        [--diagnose] [--out F]

Builds ``src/repro_torch/kernels/csrc/mamba_scan.cu`` once for each set of
values of the backward's constants (``SB_Q`` steps a chunk, the ring's
stage and the first recompute level; ``SB_SC`` steps a sub-chunk, the
last level; ``SB_DEPTH``, the ring's stages at most; ``SB_MINB`` blocks an
SM its launch bounds ask for, which caps the registers and sizes the
ring), written into a copy under ``build/sweep_bwd/`` by
``selective_scan_sweep.variant_source``, one ``nvcc`` each, all started
together, and ``--baseline``, an older source with the same C entry point
``selective_scan_bwd`` (its plan entry point may differ: the scratch is
allocated for chunks of 4 steps, enough for any of them), beside them;
with ``--diagnose`` also the ``DIAGNOSTICS`` copies, each with one part of
the work taken out (timed only).  Each library's ``selective_scan_bwd``
but those is held against ``ref.selective_scan_bwd_ref`` at
falcon-mamba-7b's training shape (B=4, T=2048, D=8192, N=16, bf16 x/b/c,
b and c slices of one projection at falcon's 16-byte aligned column, so
every operand goes through TMA) under ``chip_smoke``'s limits, then all
are timed in turns (three rounds) as device time from a CUDA graph of 5
calls.  Prints each variant's ptxas lines (registers, spills) and one
line a variant, and writes the records as JSON.  Needs a card and
``nvcc``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "benchmarks"))

import chip_smoke  # noqa: E402
import selective_scan_sweep  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402

VARIANTS = {    # the constants SB_Q, SB_SC, SB_DEPTH and SB_MINB
    "q16_sc4_d3_b4": {},         # as the source has them (at N = 16 the
                                 # ring is two stages of 16 steps)
    "q8_sc4_d3_b4": {"SB_Q": 8},
    "q8_sc4_d2_b4": {"SB_Q": 8, "SB_DEPTH": 2},
    "q16_sc4_d3_b3": {"SB_MINB": 3},     # three stages, 512 blocks in two
                                         # waves
    "q16_sc2_d3_b4": {"SB_SC": 2},   # eight slots: the chunk falls to 8
}
_SUMS = ("channel_sums<P>(v, red + (s * SB_NW + pw.warp) * O, pw.lane, pw.q,"
         "\n                        hi ? S : 0);")
# --diagnose: copies of the source as it is with one part of the backward
# kernel's work taken out, so that their times show what that part costs;
# they no longer compute the function and are timed, not held
DIAGNOSTICS = {
    "no_loads": [("      if (bytes == 0) {", "      if (1) {"),
                 ("    if (!a.tma_dt)\n      sb_fill<Q, CH>",
                  "    if (i >= 0) return;\n    if (!a.tma_dt)\n"
                  "      sb_fill<Q, CH>")],
    "no_channel_sums": [
        ("v[jj] = (hi ? tc : tb) + __shfl_xor_sync(FULL, hi ? tb : tc, 16);",
         "v[jj] = tc + tb;"),
        (_SUMS, "red[(s * SB_NW + pw.warp) * O + pw.lane] = v[0] + v[3]"
                " + v[6];")],
    "no_exp": [("hopper::ex2(dt * A2[j])", "(dt * A2[j])"),
               ("hopper::ex2(dt * A2[jj])", "(dt * A2[jj])")],
    # level 1 and its loads taken out (the walk starts at the last chunk
    # from h0 and reads chunk states no one wrote): what a forward that
    # stored the chunk states would save the backward
    "no_level1": [
        ("const int items = 2 * nch - 1;", "const int items = nch;"),
        ("return i < nch - 1 ? i : 2 * nch - 2 - i;", "return nch - 1 - i;"),
        ("const bool rev = i >= nch - 1;", "const bool rev = true;"),
        ("if (i >= nch) flush(chunk_of(i - 1), pc);",
         "if (i >= 1) flush(chunk_of(i - 1), pc);"),
        ("if (i >= nch) sb_wait(red_free, (i - nch) & 1);",
         "if (i >= 1) sb_wait(red_free, (i - 1) & 1);")],
}


def diagnostic_source(patches, out_dir, name) -> pathlib.Path:
    """A copy of the source with ``patches`` applied to its backward
    section (after the marker line), nothing else changed."""
    src = (_build.CSRC / "mamba_scan.cu").read_text()
    cut = src.index("// ---- selective_scan_bwd: the backward")
    head, bwd = src[:cut], src[cut:]
    for old, new in patches:
        if old not in bwd:
            raise ValueError(f"{name}: {old!r} not in the backward section")
        bwd = bwd.replace(old, new)
    path = out_dir / f"mamba_scan_{name}.cu"
    path.write_text(head + bwd)
    return path


def build(name: str, src: pathlib.Path, out_dir):
    out = out_dir / f"libscan_{name}.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.selective_scan_bwd.argtypes = ([p] * 15 + [ll] + [i] * 5 + [ll] * 8
                                       + [p])
    lib.selective_scan_bwd.restype = i
    # each backward kernel's entry: its name, stack and spills, registers
    lines = (proc.stdout + proc.stderr).splitlines()
    ptxas = [" | ".join(ln.strip() for ln in lines[k:k + 4])
             for k, ln in enumerate(lines)
             if "Compiling entry" in ln and "selective_bwd_kernel" in ln]
    return lib, ptxas


def caller(lib, args):
    """One call of ``lib``'s backward on ``args``, its outputs and scratch
    allocated once; the scratch as the plan sizes it for chunks of 4
    steps, at least what any of the sources needs."""
    dt, x, b, c, A, h0, dy, dh = args
    B, T, D = dt.shape
    N = b.shape[2]
    plan = ms.selective_scan_bwd_plan(B, T, D, N, x.dtype)
    scratch_floats = (plan.scratch + B * plan.channel_blocks
                      * (-(-T // 4) - plan.chunks) * 8 * 128)
    f32 = dict(dtype=torch.float32, device="cuda")
    outs = (torch.empty((B, T, D), **f32),
            torch.empty((B, T, D), dtype=x.dtype, device="cuda"),
            torch.empty((B, T, N), dtype=b.dtype, device="cuda"),
            torch.empty((B, T, N), dtype=c.dtype, device="cuda"),
            torch.empty((D, N), **f32), torch.empty((B, D, N), **f32))
    scratch = torch.empty((scratch_floats,), **f32)
    sel = ms._selective_args(dt, x, b, c, A, h0, outs[0], outs[5])

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.selective_scan_bwd(
            *sel[:6], dy.data_ptr(), dh.data_ptr(),
            *(o.data_ptr() for o in outs), scratch.data_ptr(),
            scratch_floats, *sel[8:], stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return outs
    return call


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=pathlib.Path, default=None,
                    help="an older mamba_scan.cu to time beside")
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "build" / "selective_scan_bwd_sweep.json")
    ap.add_argument("--diagnose", action="store_true",
                    help="also time the DIAGNOSTICS copies")
    args = ap.parse_args(argv)
    smi = chip_smoke.phase_card()
    out_dir = ROOT / "build" / "sweep_bwd"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {n: selective_scan_sweep.variant_source(v, out_dir)
            for n, v in VARIANTS.items()}
    if args.baseline is not None:
        jobs["baseline"] = args.baseline.resolve()
    if args.diagnose:
        jobs.update({n: diagnostic_source(p, out_dir, n)
                     for n, p in DIAGNOSTICS.items()})
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futs = {n: pool.submit(build, n, src, out_dir)
                for n, src in jobs.items()}
        libs = {n: f.result() for n, f in futs.items()}
    records = {n: {"name": n, "constants": VARIANTS.get(n, {}),
                   "diagnostic": n in DIAGNOSTICS, "ptxas": libs[n][1]}
               for n in jobs}
    for n, r in records.items():
        for ln in r["ptxas"]:
            print(f"PTXAS {n}: {ln}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    B, T, D, N = chip_smoke.FALCON_TRAIN_SCAN
    inputs = chip_smoke._sel_bwd_inputs(gen, B, T, D, N, torch.bfloat16,
                                        offset=256)
    calls = {n: caller(lib, inputs) for n, (lib, _) in libs.items()}
    for n, call in calls.items():
        got = call()
        torch.cuda.synchronize()
        if n in DIAGNOSTICS:
            continue
        try:
            records[n]["max_abs_err"] = chip_smoke._hold_sel_bwd(
                (B, T, D, N, "bfloat16", n), got, inputs)
            records[n]["within_tol"] = True
        except AssertionError as e:
            records[n]["within_tol"] = False
            records[n]["error"] = str(e)
    times = {n: [] for n in calls}
    for _ in range(3):
        for n, call in calls.items():
            times[n].append(chip_smoke.graph_ms(call, iters=5, replays=3))
    for n, ts in times.items():
        records[n]["ms"] = statistics.median(ts)
        records[n]["ms_range"] = [min(ts), max(ts)]
    for r in records.values():
        print("VARIANT " + json.dumps(r), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi, "shape": [B, T, D, N],
                                    "variants": list(records.values())},
                                   indent=1))
    if not all(r["within_tol"] for r in records.values()
               if not r["diagnostic"]):
        raise SystemExit("a variant is off its plain version")


if __name__ == "__main__":
    main()
