"""The Mamba-2 scan kernel against an older source, on one card.

    python3 tools/mamba2_scan_baseline.py --baseline OLD.cu [OLD2.cu ...]
        [--heads 8 20 40] [--out F]

Builds ``src/repro_torch/kernels/csrc/mamba_scan.cu`` (through
``repro_torch.kernels._build``, as the port does) and each ``--baseline``,
an older source with the same ``mamba2_scan_fwd`` C interface (e.g. ``git
show <commit>:src/repro_torch/kernels/csrc/mamba_scan.cu``, written into
the git-ignored ``build/``; a baseline is named by its directory), one
``nvcc`` each, started together, and prints each library's ptxas lines for
its Mamba-2 kernels (registers, spills, serialized wgmma).  Each library is
held against ``ref.mamba2_scan_ref`` under ``chip_smoke.SCAN_TOL`` at
zamba2-2.7b's prefill and decode shapes, and the current one also on
``chip_smoke.MAMBA2_CHUNKED_CASES``.  Then all are timed in turns
(baselines, current, current, baselines reversed; three rounds) as device
time from a CUDA graph of their launches (``chip_smoke.graph_ms``) at
zamba2-2.7b's prefill (B=4, T=1100, H=80, P=N=64, bf16 x/b/c, b and c
slices of one projection) and decode (T=1) shapes, beside the function's
bound and the current path's own bound.  The backward
(``mamba2_scan_bwd``), where a library has it, is held against
``ref.mamba2_scan_bwd_ref`` under ``chip_smoke._hold_scan_bwd``'s limits
and timed the same way at zamba2-2.7b's training shape (B=4, T=2048),
beside its bound and each form's own (``chip_smoke._mamba2_bwd_cost``);
``--heads`` adds copies of the current source with another number of
heads a block of the chunked backward's tile kernel (its ``CB_HEADS``
rewritten in a copy under ``build/``), held and timed with the rest.
Prints one JSON line a library and writes the records to ``--out``.
Needs a card and ``nvcc``.
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

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402


def _ptxas(log: str) -> list[str]:
    """ptxas's lines for the entry functions named mamba2, and every line
    about wgmma."""
    out, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            keep = "mamba2" in ln
        if "wgmma" in ln or (keep and any(
                w in ln for w in ("spill", "registers", "entry function"))):
            out.append(ln.strip())
    return out


HEADS_LINE = "constexpr int CB_HEADS = "


def heads_variant(n: int, out_dir: pathlib.Path) -> pathlib.Path:
    """A copy of the current source with ``CB_HEADS`` set to ``n``."""
    src = (_build.CSRC / "mamba_scan.cu").read_text()
    start = src.index(HEADS_LINE) + len(HEADS_LINE)
    end = src.index(";", start)
    path = out_dir / f"heads{n}" / "mamba_scan.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src[:start] + str(n) + src[end:])
    return path


def build_baseline(src: pathlib.Path, out_dir: pathlib.Path, name: str):
    out = out_dir / f"libmamba_scan_{name}.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{src}: nvcc failed\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mamba2_scan_fwd.argtypes = [p] * 8 + [i] * 6 + [ll] * 9 + [p]
    lib.mamba2_scan_fwd.restype = i
    if hasattr(lib, "mamba2_scan_bwd"):       # sources from the backward on
        lib.mamba2_scan_bwd.argtypes = ms._lib().mamba2_scan_bwd.argtypes
        lib.mamba2_scan_bwd.restype = i
    return lib, _ptxas(proc.stdout + proc.stderr)


def baseline_call(lib, dt, x, b, c, A, h0):
    """The baseline's ``mamba2_scan_fwd`` with the wrapper's outputs."""
    B, T, H, P = x.shape
    y = torch.empty((B, T, H, P), dtype=torch.float32, device=x.device)
    h_last = torch.empty_like(h0)
    err = lib.mamba2_scan_fwd(*ms._mamba2_args(dt, x, b, c, A, h0, y, h_last),
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"baseline launch failed: cudaError {err}")
    return y, h_last


def baseline_bwd_call(lib, dt, x, b, c, A, h0, dy, dh, heads=None):
    """The baseline's ``mamba2_scan_bwd`` with the wrapper's outputs and
    scratch: the CUDA-core form's (the only form of the sources before the
    chunked one), or the chunked form's with ``heads`` heads a block (the
    library refuses scratch below its own plan's)."""
    B, T, H, P = x.shape
    N = b.shape[2]
    plan = ms.mamba2_bwd_plan(B, T, H, P, N, torch.float32)
    scratch_floats = plan.scratch
    if heads is not None:
        K, RB = -(-T // 64), -(-P // 64)
        scratch_floats = (2 * B * K * H * P * N
                          + 2 * B * T * -(-H // heads) * RB * N
                          + 2 * B * T * H * RB)
    f32 = torch.float32
    ddt = torch.empty((B, T, H), dtype=f32, device=x.device)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    db = torch.empty((B, T, N), dtype=b.dtype, device=x.device)
    dc = torch.empty_like(db)
    dA = torch.empty((H,), dtype=f32, device=x.device)
    dh0 = torch.empty_like(h0)
    scratch = torch.empty((scratch_floats,), dtype=f32, device=x.device)
    args = ms._mamba2_args(dt, x, b, c, A, h0, ddt, dh0)
    err = lib.mamba2_scan_bwd(
        *args[:6], dy.data_ptr(), dh.data_ptr(), ddt.data_ptr(),
        dx.data_ptr(), db.data_ptr(), dc.data_ptr(), dA.data_ptr(),
        dh0.data_ptr(), scratch.data_ptr(), scratch_floats, *args[8:],
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"baseline backward launch failed: cudaError "
                           f"{err}")
    return ddt, dx, db, dc, dA, dh0


def hold(name, fn, args, case, records) -> None:
    y, h = fn(*args)
    wy, wh = ref.mamba2_scan_ref(*args)
    torch.cuda.synchronize()
    res = [chip_smoke._close(g, w, **chip_smoke.SCAN_TOL)
           for g, w in ((y, wy), (h, wh))]
    records[name].setdefault("cases", []).append(
        {"case": list(case), "max_abs_err": max(e for e, _ in res),
         "ok": all(ok for _, ok in res)})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=pathlib.Path, nargs="+", required=True,
                    help="older mamba_scan.cu sources to time beside")
    ap.add_argument("--heads", type=int, nargs="*", default=[],
                    help="heads a tile block of the chunked backward, each "
                         "a build of the current source")
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "build" / "mamba2_scan_baseline.json")
    args = ap.parse_args(argv)
    smi = chip_smoke.phase_card()
    out_dir = ROOT / "build" / "mamba2_scan_baseline"
    out_dir.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(
            1 + len(args.baseline) + len(args.heads)) as pool:
        cur = pool.submit(_build.load, "mamba_scan")
        bases = {src.parent.name: pool.submit(build_baseline, src.resolve(),
                                              out_dir, src.parent.name)
                 for src in args.baseline}
        variants = {f"heads{n}": pool.submit(
            build_baseline, heads_variant(n, out_dir), out_dir, f"heads{n}")
                    for n in args.heads}
        records = {"current": {"name": "current",
                               "ptxas": _ptxas(cur.result().log)}}
        libs = {}
        for name, fut in bases.items():
            libs[name], ptxas = fut.result()
            records[name] = {"name": name, "ptxas": ptxas}
        heads = {name: fut.result()[0] for name, fut in variants.items()}
    for r in records.values():
        print("PTXAS " + json.dumps(r), flush=True)

    def caller(name):
        if name == "current":
            return ms.mamba2_scan
        return lambda *a: baseline_call(libs[name], *a)

    gen = torch.Generator(device="cuda").manual_seed(4321)
    bf16 = torch.bfloat16
    for B, T, H, P, N, offset, reset in chip_smoke.MAMBA2_CHUNKED_CASES:
        a = chip_smoke._mamba2_inputs(gen, B, T, H, P, N, bf16, offset,
                                      reset)
        hold("current", ms.mamba2_scan, a,
             (B, T, H, P, N, offset, reset), records)
    order = [*libs, "current", "current", *reversed(list(libs))]
    B, _, H, P, N = chip_smoke.ZAMBA2_SCAN
    for T in (chip_smoke.ZAMBA2_SCAN[1], 1):
        a = chip_smoke._mamba2_inputs(gen, B, T, H, P, N, bf16, offset=0)
        for name in records:
            hold(name, caller(name), a, (B, T, H, P, N, 0, False), records)
        calls = {n: (lambda f=caller(n): f(*a)) for n in records}
        ts = {n: [] for n in calls}
        for _ in range(3):
            for n in order:
                ts[n].append(chip_smoke.graph_ms(calls[n]))
        plan = ms.kernel_mamba2_plan(*a, a[5])
        flops, nbytes, ssd_flops, instr = chip_smoke._mamba2_cost(
            B, T, H, P, N, 2)
        t_bytes = nbytes / chip_smoke.PEAK_BYTES * 1e3
        bound = max(flops / chip_smoke.PEAK_TF32_FLOPS * 1e3, t_bytes)
        path_ms = (ssd_flops / chip_smoke.PEAK_BF16_FLOPS
                   if plan.path == "chunked"
                   else instr / chip_smoke.PEAK_F32_INSTR) * 1e3
        tag = f"B{B}_T{T}_H{H}_P{P}_N{N}_bf16"
        for n, t in ts.items():
            records[n][tag] = {
                "ms": statistics.median(t), "ms_all": t,
                "bound_ms": bound,
                "current_plan": ",".join(map(str, plan.as_ints())),
                "current_design_bound_ms": max(path_ms, t_bytes)}
        del a, calls
    # the backward at zamba2's training shape, where a library has it
    bwd = [n for n in records
           if n == "current" or hasattr(libs[n], "mamba2_scan_bwd")]
    bwd += list(heads)
    for name in heads:
        records[name] = {"name": name,
                         "heads_a_block": int(name[len("heads"):])}
    B, T, H, P, N = chip_smoke.ZAMBA2_TRAIN_SCAN
    a = chip_smoke._mamba2_bwd_inputs(gen, B, T, H, P, N, bf16, offset=0)

    def bwd_caller(name):
        if name == "current":
            return ms.mamba2_scan_bwd
        if name in heads:
            return lambda *x: baseline_bwd_call(
                heads[name], *x, heads=records[name]["heads_a_block"])
        return lambda *x: baseline_bwd_call(libs[name], *x)

    case = (B, T, H, P, N, 0, False)
    for name in bwd:
        try:
            err = chip_smoke._hold_scan_bwd(case, bwd_caller(name)(*a), a)
            ok = True
        except AssertionError as e:
            err, ok = str(e), False
        records[name].setdefault("bwd_cases", []).append(
            {"case": list(case), "max_abs_err": err, "ok": ok})
    calls = {n: (lambda f=bwd_caller(n): f(*a)) for n in bwd}
    ts = {n: [] for n in calls}
    order = [n for n in [*libs, *heads, "current", "current",
                         *reversed(list(heads)), *reversed(list(libs))]
             if n in calls]
    for _ in range(3):
        for n in order:
            ts[n].append(chip_smoke.graph_ms(calls[n], iters=5, replays=3))
    flops, nbytes, instr, cflops, cbytes = chip_smoke._mamba2_bwd_cost(
        B, T, H, P, N, 2)
    t_bytes = nbytes / chip_smoke.PEAK_BYTES * 1e3
    bound = max(flops / chip_smoke.PEAK_TF32_FLOPS * 1e3, t_bytes)
    # each form's own floor: the CUDA-core form's FP32 instructions, the
    # chunked form's bf16 products or bytes
    cudacore = max(instr / chip_smoke.PEAK_F32_INSTR * 1e3, t_bytes)
    chunked = max(cflops / chip_smoke.PEAK_BF16_FLOPS * 1e3,
                  cbytes / chip_smoke.PEAK_BYTES * 1e3)
    for n, t in ts.items():
        records[n][f"bwd_B{B}_T{T}_H{H}_P{P}_N{N}_bf16"] = {
            "ms": statistics.median(t), "ms_all": t, "bound_ms": bound,
            "cudacore_design_bound_ms": cudacore,
            "chunked_design_bound_ms": chunked}
    del a, calls
    for r in records.values():
        print("BASELINE " + json.dumps(r), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi,
                                    "libraries": list(records.values())},
                                   indent=1))
    bad = [(r["name"], c) for r in records.values()
           for c in r.get("cases", []) + r.get("bwd_cases", [])
           if not c["ok"]]
    if bad:
        raise SystemExit(f"off the plain version: {bad}")


if __name__ == "__main__":
    main()
