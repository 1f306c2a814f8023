"""The flash-attention backward kernel against an older source, on one card.

    python3 tools/flash_bwd_baseline.py --baseline OLD.cu [OLD2.cu ...]
        [--out F]

Builds ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` (through
``repro_torch.kernels._build``, as the port does) and each ``--baseline``,
an older source of ``fa_bwd`` (e.g. ``git show
<commit>:src/repro_torch/kernels/csrc/flash_attention_bwd.cu``, written
into the git-ignored ``build/``; a baseline is named by its directory; a
source whose ``fa_bwd`` takes one ``T``, causal only, is called through
that interface), one
``nvcc`` each, started together, and prints each library's ptxas lines
(registers, spills, serialized wgmma).  Each library is held against
``ref.flash_attention_bwd_ref`` under ``chip_smoke.BWD_TOL`` on
``chip_smoke.BWD_CASES`` (the current source) or at granite-3-2b's training
shape (all), and the current one must give bit-identical dQ, dK, dV over
two calls.  Then all are timed with CUDA events in
turns (baselines, current, current, baselines reversed; twice) beside
SDPA's backward (forward + backward minus forward, a yardstick only) at
granite-3-2b's training shape and at a D = 128 shape, and the device time
of each library's kernels is read from ``torch.profiler`` over 5 calls.
Prints one JSON line a library and writes the records to ``--out``.  Needs
a card and ``nvcc``.
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
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# (B, T, H, K, D): granite-3-2b's training shape, and one at D = 128
SHAPES = (chip_smoke.TRAIN_ATTN, (4, 2048, 16, 4, 128))


def _ptxas(log: str) -> list[str]:
    return [ln.strip() for ln in log.splitlines()
            if any(w in ln for w in ("spill", "registers", "wgmma",
                                     "entry function"))]


def build_baseline(src: pathlib.Path, out_dir: pathlib.Path):
    out = out_dir / f"libflash_bwd_{src.parent.name}.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{src}: nvcc failed\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(out))
    # fa_bwd(..., B, H, KV, Tq, Tk, D, causal, window, ...) since the
    # non-causal form; fa_bwd(..., B, H, KV, T, D, window, ...) before it
    lib.two_lengths = "int Tk" in src.read_text()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fa_bwd.argtypes = ([p] * 10 + [i] * (9 if lib.two_lengths else 7)
                           + [ctypes.c_float] * 2 + [p])
    lib.fa_bwd.restype = i
    return lib, _ptxas(proc.stdout + proc.stderr)


def baseline_call(lib, q, k, v, o, lse, do, window=0, softcap=0.0,
                  causal=True):
    """The baseline's ``fa_bwd`` with the wrapper's outputs and scratch."""
    B, T, H, D = q.shape
    K = k.shape[2]
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if lib.two_lengths:
        shape = (B, H, K, T, k.shape[1], D, int(causal), int(window))
    elif causal and k.shape[1] == T:
        shape = (B, H, K, T, D, int(window))
    else:
        raise ValueError("this baseline takes causal Tq == Tk only")
    err = lib.fa_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
                     dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                     fa._DTYPES[q.dtype], *shape, float(softcap),
                     float(D ** -0.5),
                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"baseline launch failed: cudaError {err}")
    return dq, dk, dv


def _inputs(gen, B, T, H, K, D, dt, Tk=None):
    Tk = T if Tk is None else Tk
    q, do = (chip_smoke._rand(gen, (B, T, H, D), dt) for _ in range(2))
    k, v = (chip_smoke._rand(gen, (B, Tk, K, D), dt) for _ in range(2))
    return q, k, v, do


def hold(name, fn, case, gen, records) -> None:
    """``fn`` against the plain version at ``case`` (a ``BWD_CASES``
    tuple); the worst error and whether every output is within
    ``BWD_TOL``."""
    B, Tq, Tk, H, K, D, dt, window, softcap, causal = case
    q, k, v, do = _inputs(gen, B, Tq, H, K, D, dt, Tk=Tk)
    kw = dict(window=window, softcap=softcap, causal=causal)
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    got = fn(q, k, v, o, lse, do, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    res = [chip_smoke._close(g, w, **chip_smoke.BWD_TOL[dt])
           for g, w in zip(got, want)]
    rec = records[name].setdefault("cases", [])
    rec.append({"case": [B, Tq, Tk, H, K, D, str(dt)[6:], window, softcap,
                         causal],
                "max_abs_err": max(e for e, _ in res),
                "ok": all(ok for _, ok in res)})


def kernel_ms(fn, calls: int = 5) -> dict[str, float]:
    """Device time a call of each kernel ``fn`` launches, by name."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for ev in prof.events():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            m = re.search(r"(\w+_kernel)", ev.name)
            name = m.group(1) if m else ev.name
            out[name] = out.get(name, 0.0) + ev.time_range.elapsed_us() \
                / 1e3 / calls
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=pathlib.Path, nargs="+", required=True,
                    help="older flash_attention_bwd.cu sources to time beside")
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "build" / "flash_bwd_baseline.json")
    args = ap.parse_args(argv)
    smi = chip_smoke.phase_card()
    out_dir = ROOT / "build" / "flash_bwd_baseline"
    out_dir.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(2 + len(args.baseline)) as pool:
        cur = pool.submit(_build.load, "flash_attention_bwd")
        fwd = pool.submit(_build.load, "flash_attention")
        bases = {src.parent.name: pool.submit(build_baseline, src.resolve(),
                                              out_dir)
                 for src in args.baseline}
        records = {"current": {"name": "current",
                               "ptxas": _ptxas(cur.result().log)}}
        libs = {}
        for name, fut in bases.items():
            libs[name], ptxas = fut.result()
            records[name] = {"name": name, "ptxas": ptxas}
        fwd.result()
    for r in records.values():
        print("PTXAS " + json.dumps(r), flush=True)

    def caller(name):
        if name == "current":
            return fa.flash_attention_bwd
        return lambda *a, **kw: baseline_call(libs[name], *a, **kw)

    gen = torch.Generator(device="cuda").manual_seed(4321)
    for case in chip_smoke.BWD_CASES:
        hold("current", fa.flash_attention_bwd, case, gen, records)
    B, T, H, K, D = chip_smoke.TRAIN_ATTN
    train = (B, T, T, H, K, D, torch.bfloat16, 0, 0.0, True)
    for name in records:
        hold(name, caller(name), train, gen, records)
    q, k, v, do = _inputs(gen, *chip_smoke.TRAIN_ATTN, torch.bfloat16)
    o, lse = fa.flash_attention_lse(q, k, v)
    a = fa.flash_attention_bwd(q, k, v, o, lse, do)
    b = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    records["current"]["bit_identical"] = all(
        torch.equal(x, y) for x, y in zip(a, b))
    del a, b, q, k, v, do, o, lse

    order = [*libs, "current", "current", *reversed(list(libs))]
    for B, T, H, K, D in SHAPES:
        q, k, v, do = _inputs(gen, B, T, H, K, D, torch.bfloat16)
        o, lse = fa.flash_attention_lse(q, k, v)
        qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        doh = do.transpose(1, 2).contiguous()

        def sdpa_fwd():
            return F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True)

        calls = {n: (lambda f=caller(n): f(q, k, v, o, lse, do))
                 for n in records}
        ts = {n: [] for n in calls}
        fb, fo = [], []
        for _ in range(2):
            for n in order:
                ts[n].append(chip_smoke.cuda_ms(calls[n]))
            fb.append(chip_smoke.cuda_ms(lambda: torch.autograd.grad(
                sdpa_fwd(), (qh, kh, vh), doh)))
            fo.append(chip_smoke.cuda_ms(sdpa_fwd))
        flops, nbytes = chip_smoke._bwd_cost(B, T, T, H, K, D, 2)
        bound = max(flops / chip_smoke.PEAK_BF16_FLOPS,
                    nbytes / chip_smoke.PEAK_BYTES) * 1e3
        tag = f"B{B}_T{T}_H{H}_K{K}_D{D}_bf16_causal"
        for n, t in ts.items():
            records[n][tag] = {
                "ms": statistics.median(t), "ms_range": [min(t), max(t)],
                "kernels_ms": kernel_ms(calls[n]),
                "bound_ms": bound, "design_bound_ms": 1.4 * bound,
                "sdpa_bwd_ms": statistics.median(fb)
                - statistics.median(fo)}
        del q, k, v, do, o, lse, qh, kh, vh, doh, calls
    for r in records.values():
        print("BASELINE " + json.dumps(r), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi,
                                    "libraries": list(records.values())},
                                   indent=1))
    bad = [c for r in records.values() for c in r.get("cases", [])
           if not c["ok"]]
    if bad or not records["current"]["bit_identical"]:
        raise SystemExit(f"off the plain version: {bad}; bit-identical: "
                         f"{records['current']['bit_identical']}")


if __name__ == "__main__":
    main()
