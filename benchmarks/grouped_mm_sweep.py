"""Variant sweep of the MoE layer's grouped product on one NVIDIA card,
against older sources.

    python3 benchmarks/grouped_mm_sweep.py [--baseline OLD.cu ...]
        [--variants NAME ...] [--check-only] [--out F]

Builds ``src/repro_torch/kernels/csrc/grouped_mm.cu`` once for each set of
values of its bf16 path's constants (``RING_N128`` and ``RING_N256`` the
ring's stages at a 128- and a 256-wide tile, ``WIDE`` when the 256-wide
tile is taken: 0 never, 1 where N % 256 == 0, 2 where N > 128), written
into a copy under ``build/sweep_gmm/``, and each ``--baseline``, an older
source of the same C interface (e.g. ``git show
<commit>:src/repro_torch/kernels/csrc/grouped_mm.cu``, written into the
git-ignored ``build/``; named by its directory), one ``nvcc`` each, all
started together, and prints each library's ptxas lines (registers,
spills, serialized wgmma).  Each variant is held against
``ref.grouped_mm_ref`` and ``ref.grouped_mm_wgrad_ref`` on
``chip_smoke.GMM_CASES`` (bf16, every row outside the kept prefixes NaN,
those rows exactly zero, two calls bit-identical) and every library at
``chip_smoke.GMM_TOL`` at the timed shapes.  Then all are timed in turns
(baselines, variants, variants, baselines; twice) as device time from a
CUDA graph of 20 launches at qwen2-moe's served prefill (4 x 1100 tokens,
R = 17,600: the gate/up product 2048 -> 1408 and the down product 1408 ->
2048), its decode step (4 tokens, 16 rows) and its trained shape (4 x 2048
tokens, R = 32,768: the same two, the dX form and the weight gradient),
bf16, with the routing of ``chip_smoke._gmm_served``, beside
``torch._grouped_mm`` with every row kept and the bound over the kept
rows.  Prints one line a library and shape and writes the records as
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

VARIANTS = {      # RING_N128, RING_N256, WIDE
    "r5_r3_w2": (5, 3, 2),       # as the source has them
    "r5_r3_w1": (5, 3, 1),
    "r4_r3_w2": (4, 3, 2),
    "r5_r2_w2": (5, 2, 2),
}
NAMES = ("RING_N128", "RING_N256", "WIDE")
OUT_DIR = ROOT / "build" / "sweep_gmm"


def _ptxas(log: str) -> list[str]:
    return [ln.strip() for ln in log.splitlines()
            if any(w in ln for w in ("spill", "registers", "wgmma",
                                     "Compiling entry"))]


def variant_source(name: str) -> pathlib.Path:
    """A copy of the source with its constants set to the variant's."""
    src = (_build.CSRC / "grouped_mm.cu").read_text()
    for const, value in zip(NAMES, VARIANTS[name]):
        pattern = rf"constexpr int {const} = \d+;"
        if re.search(pattern, src) is None:
            raise RuntimeError(f"constant {const} not in the source")
        src = re.sub(pattern, f"constexpr int {const} = {value};", src,
                     count=1)
    path = OUT_DIR / f"grouped_mm_{name}.cu"
    path.write_text(src)
    return path


def build(job: tuple[str, pathlib.Path]) -> tuple[str, pathlib.Path, str]:
    name, src = job
    out = OUT_DIR / f"libgrouped_mm_{name}.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: {proc.stdout}{proc.stderr}")
    return name, out, proc.stdout + proc.stderr


def load(path: pathlib.Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grouped_mm.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.grouped_mm_wgrad.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    return lib


DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def forward(lib, x, w, start, kept, C, transposed):
    R, K = x.shape
    N = w.shape[1] if transposed else w.shape[2]
    y = torch.empty((R, N), dtype=x.dtype, device=x.device)
    err = lib.grouped_mm(x.data_ptr(), w.data_ptr(), start.data_ptr(),
                         kept.data_ptr(), y.data_ptr(), DTYPE_CODE[x.dtype],
                         R, K, N, w.shape[0], C, int(transposed),
                         torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"grouped_mm: cudaError {err}")
    return y


def wgrad(lib, a, b, start, kept):
    (R, M), N, G = a.shape, b.shape[1], start.shape[0]
    dw = torch.empty((G, M, N), dtype=a.dtype, device=a.device)
    err = lib.grouped_mm_wgrad(a.data_ptr(), b.data_ptr(), start.data_ptr(),
                               kept.data_ptr(), dw.data_ptr(),
                               DTYPE_CODE[a.dtype], R, M, N, G,
                               torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"grouped_mm_wgrad: cudaError {err}")
    return dw


def check_cases(name: str, lib, gen) -> float:
    """The library on every ``GMM_CASES`` entry in bf16 with the rows
    outside the kept prefixes NaN (``chip_smoke.nan_outside``): within
    ``GMM_TOL`` of the plain versions, exact zeros outside, two calls
    bit-identical.  Returns the worst error."""
    bf = torch.bfloat16
    worst = 0.0
    for case, c in chip_smoke.GMM_CASES.items():
        R, start, kept, cap = chip_smoke.gmm_segments(case)
        start, kept = start.cuda(), kept.cuda()
        G, K, N = len(c["counts"]), c["K"], c["N"]
        x = chip_smoke.nan_outside(chip_smoke._rand(gen, (R, K), bf),
                                   start, kept)
        dy = chip_smoke.nan_outside(chip_smoke._rand(gen, (R, N), bf),
                                    start, kept)
        runs = []
        for transposed in (False, True):
            w = (torch.randn((G, N, K) if transposed else (G, K, N),
                             generator=gen, device="cuda") * K ** -0.5).to(bf)
            runs.append((f"{case}_T{int(transposed)}",
                         lambda w=w, t=transposed: forward(lib, x, w, start,
                                                           kept, cap, t),
                         lambda w=w, t=transposed: ref.grouped_mm_ref(
                             x, w, start, kept, t), True))
        runs.append((f"{case}_wgrad", lambda: wgrad(lib, x, dy, start, kept),
                     lambda: ref.grouped_mm_wgrad_ref(x, dy, start, kept),
                     False))
        for label, run, plain, rows in runs:
            got, again, want = run(), run(), plain()
            torch.cuda.synchronize()
            err, ok = chip_smoke._close(got, want, **chip_smoke.GMM_TOL[bf])
            if rows:
                ok = ok and chip_smoke.zero_outside(got, start, kept)
            if not ok or not torch.equal(got, again):
                raise AssertionError(f"{name} {label}: max abs {err}, "
                                     f"bit-identical "
                                     f"{torch.equal(got, again)}")
            worst = max(worst, err)
    return worst


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=pathlib.Path, nargs="*", default=[])
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--check-only", action="store_true",
                    help="build and hold the variants, time nothing")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = chip_smoke.phase_card()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = [(f"base_{b.resolve().parent.name}", b.resolve())
            for b in args.baseline]
    jobs += [(v, variant_source(v)) for v in args.variants]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(build, jobs))
    libs, ptxas = {}, {}
    for name, path, log in built:
        libs[name] = load(path)
        ptxas[name] = _ptxas(log)
        print(name, flush=True)
        for ln in ptxas[name]:
            print("   ", ln, flush=True)

    gen = torch.Generator(device="cuda").manual_seed(1)
    checks = {name: check_cases(name, libs[name], gen)
              for name in args.variants}
    for name, err in checks.items():
        print(f"{name}: GMM_CASES bf16 NaN-filled held, worst abs err "
              f"{err:.3e}", flush=True)
    if args.check_only:
        return

    bf = torch.bfloat16
    tol = chip_smoke.GMM_TOL[bf]
    order = list(libs)
    times: dict[tuple, list] = {}
    records = []
    for label, n_tok in (("decode", 4),
                         ("served", 4 * max(chip_smoke.PROMPT_LENS)),
                         ("trained", chip_smoke.TRAIN_BATCH
                          * chip_smoke.TRAIN_SEQ)):
        R, start, kept, C, counts = chip_smoke._gmm_served(gen, n_tok)
        R_kept, n_used = int(kept.sum()), int((kept > 0).sum())
        x = torch.randn((R, 2048), generator=gen, device="cuda").to(bf)
        dy = torch.randn((R, 1408), generator=gen, device="cuda").to(bf)
        wi = (torch.randn((60, 2048, 1408), generator=gen, device="cuda")
              * 2048 ** -0.5).to(bf)
        wo = (torch.randn((60, 1408, 2048), generator=gen, device="cuda")
              * 1408 ** -0.5).to(bf)
        # product: (run(lib), plain, library call, flops, bytes)
        jobs = {"gate": (lambda lib: forward(lib, x, wi, start, kept, C,
                                             False),
                         lambda: ref.grouped_mm_ref(x, wi, start, kept),
                         chip_smoke._library_grouped_mm(x, wi, counts),
                         *chip_smoke._gmm_cost(R_kept, 2048, 1408, n_used,
                                               R, 2))}
        if label != "decode":
            jobs["down"] = (lambda lib: forward(lib, dy, wo, start, kept, C,
                                                False),
                            lambda: ref.grouped_mm_ref(dy, wo, start, kept),
                            chip_smoke._library_grouped_mm(dy, wo, counts),
                            *chip_smoke._gmm_cost(R_kept, 1408, 2048, n_used,
                                                  R, 2))
        if label == "trained":
            jobs["dX"] = (lambda lib: forward(lib, dy, wi, start, kept, C,
                                              True),
                          lambda: ref.grouped_mm_ref(dy, wi, start, kept,
                                                     True),
                          chip_smoke._library_grouped_mm(dy, wi, counts,
                                                         True),
                          *chip_smoke._gmm_cost(R_kept, 1408, 2048, n_used,
                                                R, 2))
            flops, nbytes = chip_smoke._gmm_cost(R_kept, 2048, 1408, 0, 0, 2)
            nbytes += 2 * (R_kept * 1408 + 60 * 2048 * 1408)
            jobs["wgrad"] = (lambda lib: wgrad(lib, x, dy, start, kept),
                             lambda: ref.grouped_mm_wgrad_ref(x, dy, start,
                                                              kept),
                             chip_smoke._library_grouped_mm_wgrad(x, dy,
                                                                  counts),
                             flops, nbytes)
        for job, (run, plain, library, flops, nbytes) in jobs.items():
            want = plain().float()
            for name, lib in libs.items():
                err, ok = chip_smoke._close(run(lib), want, **tol)
                if not ok:
                    raise AssertionError(f"{name} {label} {job}: max abs "
                                         f"{err}")
            del want
            lib_ms = []
            for _ in range(2):
                for name in order + order[::-1]:
                    times.setdefault((label, job, name), []).append(
                        chip_smoke.graph_ms(lambda: run(libs[name])))
                if library is not None:
                    lib_ms.append(chip_smoke.graph_ms(library))
            bound = max(flops / chip_smoke.PEAK_BF16_FLOPS,
                        nbytes / chip_smoke.PEAK_BYTES) * 1e3
            for name in order:
                ts = times[(label, job, name)]
                rec = {"shape": label, "R": R, "kept": R_kept,
                       "product": job, "library": name,
                       "ms": statistics.median(ts), "ms_min": min(ts),
                       "ms_max": max(ts), "bound_ms": bound,
                       "torch_grouped_mm_ms": (statistics.median(lib_ms)
                                               if lib_ms else None)}
                records.append(rec)
                print(f"{label:8s} {job:6s} {name:24s} median "
                      f"{rec['ms']:.4f} [{min(ts):.4f}, {max(ts):.4f}] "
                      f"bound {bound:.4f} torch._grouped_mm "
                      f"{rec['torch_grouped_mm_ms']}", flush=True)
        del x, dy, wi, wo
        torch.cuda.empty_cache()
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(
            {"card": smi, "ptxas": ptxas, "checks": checks,
             "records": records}, indent=1))


if __name__ == "__main__":
    main()
