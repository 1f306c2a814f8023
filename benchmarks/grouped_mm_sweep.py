"""Variant sweep of the MoE layer's grouped product on one NVIDIA card.

    python3 benchmarks/grouped_mm_sweep.py [--out F]

Builds ``src/repro_torch/kernels/csrc/grouped_mm.cu`` once for each set of
values of its constants (``BK_BYTES`` the bf16 ring's k depth in bytes a
row, ``STAGES`` the ring's stages, ``WN`` the bf16 block's warps along N,
``WTN`` a warp's columns), written into a copy under
``build/sweep_gmm/``, one ``nvcc`` each, all started together.  Each library
is held against ``ref.grouped_mm_ref`` and ``ref.grouped_mm_wgrad_ref`` at
``chip_smoke.GMM_TOL``, then all are timed in turns (three rounds) as
device time from a CUDA graph of 20 launches at qwen2-moe's served prefill
(4 x 1100 tokens, R = 17,600: the gate/up product 2048 -> 1408 and the down
product 1408 -> 2048) and trained shapes (4 x 2048 tokens, R = 32,768: the
same two, the dX form and the weight gradient), bf16, with the routing of
``chip_smoke._gmm_served``.  Prints one line a variant and shape and writes
the records as JSON.  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402

VARIANTS = {      # BK_BYTES, STAGES, WN, WTN
    "bk128_st3_2x64": (128, 3, 2, 64),     # as the source has them
    "bk64_st3_2x64": (64, 3, 2, 64),
    "bk64_st4_2x64": (64, 4, 2, 64),
    "bk64_st3_4x32": (64, 3, 4, 32),
    "bk64_st4_4x32": (64, 4, 4, 32),
    "bk128_st2_4x32": (128, 2, 4, 32),
    "bk64_st3_4x64": (64, 3, 4, 64),
}
NAMES = ("BK_BYTES", "STAGES", "WN", "WTN")
OUT_DIR = ROOT / "build" / "sweep_gmm"


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


def build(name: str) -> tuple[str, pathlib.Path, str]:
    out = OUT_DIR / f"libgrouped_mm_{name}.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(variant_source(name))],
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


def forward(lib, x, w, start, kept, C, transposed):
    R, K = x.shape
    N = w.shape[1] if transposed else w.shape[2]
    y = torch.empty((R, N), dtype=x.dtype, device=x.device)
    err = lib.grouped_mm(x.data_ptr(), w.data_ptr(), start.data_ptr(),
                         kept.data_ptr(), y.data_ptr(), 1, R, K, N,
                         w.shape[0], C, int(transposed),
                         torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"grouped_mm: cudaError {err}")
    return y


def wgrad(lib, a, b, start, kept):
    (R, M), N, G = a.shape, b.shape[1], start.shape[0]
    dw = torch.empty((G, M, N), dtype=a.dtype, device=a.device)
    err = lib.grouped_mm_wgrad(a.data_ptr(), b.data_ptr(), start.data_ptr(),
                               kept.data_ptr(), dw.data_ptr(), 1, R, M, N, G,
                               torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"grouped_mm_wgrad: cudaError {err}")
    return dw


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = chip_smoke.phase_card()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(build, VARIANTS))
    libs = {}
    for name, path, log in built:
        libs[name] = load(path)
        regs = [ln.split(":")[-1].strip() for ln in log.splitlines()
                if "registers" in ln or "spill stores" in ln]
        print(name, "|", "; ".join(regs), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16
    tol = chip_smoke.GMM_TOL[bf]
    times: dict[tuple, list] = {}
    for label, n_tok in (("served", 4 * max(chip_smoke.PROMPT_LENS)),
                         ("trained", chip_smoke.TRAIN_BATCH
                          * chip_smoke.TRAIN_SEQ)):
        R, start, kept, C, _ = chip_smoke._gmm_served(gen, n_tok)
        x = torch.randn((R, 2048), generator=gen, device="cuda").to(bf)
        dy = torch.randn((R, 1408), generator=gen, device="cuda").to(bf)
        wi = (torch.randn((60, 2048, 1408), generator=gen, device="cuda")
              * 2048 ** -0.5).to(bf)
        wo = (torch.randn((60, 1408, 2048), generator=gen, device="cuda")
              * 1408 ** -0.5).to(bf)
        jobs = {"gate": (lambda lib: forward(lib, x, wi, start, kept, C,
                                             False),
                         lambda: ref.grouped_mm_ref(x, wi, start, kept)),
                "down": (lambda lib: forward(lib, dy, wo, start, kept, C,
                                             False),
                         lambda: ref.grouped_mm_ref(dy, wo, start, kept))}
        if label == "trained":
            jobs["dX"] = (lambda lib: forward(lib, dy, wi, start, kept, C,
                                              True),
                          lambda: ref.grouped_mm_ref(dy, wi, start, kept,
                                                     True))
            jobs["wgrad"] = (lambda lib: wgrad(lib, x, dy, start, kept),
                             lambda: ref.grouped_mm_wgrad_ref(x, dy, start,
                                                              kept))
        for job, (run, plain) in jobs.items():
            want = plain().float()
            for name, lib in libs.items():
                d = (run(lib).float() - want).abs()
                if not bool((d <= tol["atol"] + tol["rtol"]
                             * want.abs()).all()):
                    raise AssertionError(f"{name} {label} {job}: max abs "
                                         f"{d.max().item()}")
            del want
        for _ in range(3):
            for name, lib in libs.items():
                for job, (run, _) in jobs.items():
                    times.setdefault((label, job, name), []).append(
                        chip_smoke.graph_ms(lambda: run(lib)))
    records = []
    for (label, job, name), ts in sorted(times.items()):
        records.append({"shape": label, "product": job, "variant": name,
                        "ms": sorted(ts)[1], "ms_min": min(ts),
                        "ms_max": max(ts)})
        print(f"{label:8s} {job:6s} {name:16s} median {sorted(ts)[1]:.4f} "
              f"[{min(ts):.4f}, {max(ts):.4f}]", flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(
            {"card": smi, "records": records}, indent=1))


if __name__ == "__main__":
    main()
