"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

    python3 chip_smoke.py

Phases, each printing what it found; any failure raises and exits non-zero:

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: every CUDA kernel of the port, from the sources in this checkout
   (one ``nvcc`` per source, started together), with ``-Xptxas -v`` output;
3. kernels against their plain PyTorch versions on the card, with stated
   tolerances, timed with CUDA events beside the plain version, a PyTorch
   library call computing the same function where there is one (flash and
   LUT: kernel and library timed in turns, three times each, median and
   range printed), and the card's bound: flash attention (timed at glm4-9b's
   and at qwen2-moe-a2.7b's prefill shape, the latter one query head a kv
   head, G = 1), the flash backward (phase 7 below, run here), the
   selective scan's two entry points (``mamba_scan``, ``selective_scan``,
   the latter timed as device time from a CUDA graph of its launches) and
   the LUT matmul;
4. moe-layer: ``moe.moe_block`` at qwen2-moe-a2.7b's layer width (N = 4400
   tokens, 60 experts, top-4, shared expert) in bf16 against a plain
   float32 loop over the experts with the same capacity rule, at the served
   capacity factor 1.25 and at 1.0, where experts overflow; equal routing
   and kept assignments, timed beside the loop;
5. for each served model, glm4-9b (40 layers), falcon-mamba-7b (64 Mamba-1
   layers) then qwen2-moe-a2.7b (24 MoE layers), at full width in bf16 with
   random weights from a seeded generator on the card, the previous
   model's weights freed first:
   a. serving: 4 requests of several hundred to 1100 tokens through
      ``Engine.generate``; launch counts are zeroed just before and read
      just after, and every kernel of the model's path must have run (flash
      once per layer in prefill; the selective scan once per layer in
      prefill and in every decode step);
   b. decode against forward: the teacher-forced forward logits at the
      generated positions against the logits decode produced (for the
      Mamba model, whose state carries each step's bf16 rounding, the
      served run is held at its prefill step and every step is held on
      the same model in float32, teacher-forced).  For the MoE model the
      capacity rule makes the cached path (4 tokens a decode step, one
      slot an expert) and the forward different functions: it runs a
      second ``generate`` that must give identical tokens and
      bit-identical step logits, then holds the teacher-forced cached path
      against the forward with ``moe_block``'s capacity factor bound to
      E / k (no assignment dropped; a check only), counting the (token,
      layer) top-k sets the two paths route differently; held in a
      float32 build when bf16's rounding and routing flips push a step
      past the limits;
   c. profile: one prefill and one decode step under ``torch.profiler``,
      device time split into GEMMs (``aten::mm``), batched products
      (``aten::bmm``: the experts' grouped FFN, and decode attention),
      index ops (sort, top-k, gathers and scatters), flash and the rest;
6. the entry points no model calls: ``ops.quantize_weights`` +
   ``ops.lut_matmul`` on falcon-mamba's layer-0 ``in_proj`` and
   ``ops.mamba_scan`` on the decay and input it builds, counted the same way;
7. flash_backward: the backward kernel against ``flash_attention_bwd_ref``
   (float32 and bfloat16, D 64/128/256, ``BWD_CASES``: GQA up to G = 8,
   T below, at and one past a tile, windows, soft-cap, and qwen2-moe's
   training shape, G = 1 at D = 128), the forward with LSE against the
   forward without it and its LSE against the plain one; two calls at
   granite-3-2b's training shape must be bit-identical; timed there and at
   qwen2-moe's training shape beside SDPA's backward (SDPA forward +
   backward minus SDPA forward, in turns; a yardstick only, it runs nowhere
   on the path), with the five-product bound and the design's
   seven-product bound;
8. train: granite-3-2b at full width (40 layers, 2.53 B parameters, bf16,
   remat "dots", AdamW 32-bit) through ``repro_torch.launch.train.main``
   for 5 steps of batch 4 x 2048 tokens; counts zeroed just before and read
   just after (per step: 40 flash forward launches + 40 in the recompute,
   40 backward launches); loss finite, ms/step, tokens/s, peak memory; one
   more step under ``torch.profiler``;
9. train_grad_vs_plain: at full width and 2 layers (B=1, T=2048), every
   gradient leaf against the same model with the attention backward on
   ``flash_attention_bwd_ref`` (a check only: the plain version runs nowhere
   on the training path);
10. train-moe: qwen2-moe-a2.7b at full width and 4 of its 24 layers (its
    full-depth state does not fit one card), the same 5 steps through
    ``make_train_step`` and the ``Trainer``, counted the same way (per
    step: 4 + 4 flash forward launches, 4 backward launches);
11. train_grad_vs_plain for qwen2-moe-a2.7b at full width and 2 layers.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or without the rest of
the repository beside it, the script fails before printing either.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import tree  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import lut_matmul as lm  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import layers, moe  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.train import train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# special-function units (exp): 16 per clock per SM, 132 SMs, 1.98 GHz boost
# (NVIDIA's arithmetic-instruction throughput table, compute capability 9.0)
PEAK_SFU_OPS = 16 * 132 * 1.98e9

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # abs, against the plain
# version on the same inputs: f32 differs by summation order only; bf16 by
# one rounding of the output (1 ulp of |o| < 4 is <= 1.6e-2)

# the selective scan against its plain version (both f32 recurrences: fma
# contraction and the order of the 16-term sum over n differ); elementwise
# |got - want| <= atol + rtol * |want|, TestMambaScan's 1e-4
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
# the LUT matmul against dequantize + cuBLAS SGEMM (TF32 off): f32 sums of K
# products in two orders; TestLutMatmul's f32 tolerance, with weights at the
# models' init scale N(0, 1/K) so that y ~ N(0, 1) and the rounding of the
# partial sums (~sqrt(K) * 2^-24 ~ 4e-6 at K = 4096) stays far below 1e-4
LUT_TOL = dict(rtol=1e-5, atol=1e-4)
# 4-bit codebooks against the bf16 weights they quantize: uniform rounding
# error over a ~4.8-sigma group range in 15 steps is ~9% of the product's
# rms; relative L2 above this is a wrong product, not quantization
LUT_QUANT_REL_L2 = 0.15

ARCHS = ("glm4-9b", "falcon-mamba-7b", "qwen2-moe-a2.7b")
PROMPT_LENS = (347, 611, 893, 1100)        # none a multiple of 128
MAX_NEW = 16
MAX_LEN = 2048
# the flash backward kernel against its plain version, elementwise
# |got - want| <= atol + rtol |want|: float32 differs by summation order and
# exp2; bfloat16 rounds P and dS to bf16 before the tensor-core products and
# dQ, dK, dV once on output (the bf16 scheme is held at half this on the
# CPU, tests/test_torch_kernels.py)
BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
LSE_TOL = dict(rtol=1e-4, atol=1e-4)        # natural-log units
# the backward's cases (B, T, H, K, D, dtype, window, softcap) at each D and
# dtype: GQA with a ragged last tile, window + soft-cap, tiles skipped
# outside the window, G = 8, T < 64, T one past a tile, a window of one
# tile and one shorter than a tile
BWD_CASES = [(B, T, H, K, D, dt, window, softcap)
             for D in (64, 128, 256)
             for dt in (torch.float32, torch.bfloat16)
             for (B, T, H, K, window, softcap) in (
                 (2, 300, 4, 2, 0, 0.0), (1, 130, 4, 1, 100, 30.0),
                 (1, 1000, 4, 2, 64, 50.0), (1, 200, 8, 1, 0, 0.0),
                 (2, 37, 4, 2, 0, 0.0), (1, 129, 4, 2, 0, 0.0),
                 (1, 300, 4, 2, 64, 0.0), (1, 300, 4, 2, 20, 0.0))]
# qwen2-moe-a2.7b's training shape: one query head a kv head (G = 1)
BWD_CASES.append((4, 2048, 16, 16, 128, torch.bfloat16, 0, 0.0))
# the training shapes (B, T, H, K, D) of granite-3-2b and qwen2-moe-a2.7b
TRAIN_ATTN = (4, 2048, 32, 8, 64)
MOE_TRAIN_ATTN = (4, 2048, 16, 16, 128)
# qwen2-moe-a2.7b's serving prefill shape: B, T, H, K, D
MOE_PREFILL_ATTN = (4, 1100, 16, 16, 128)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 5, 4, 2048
# qwen2-moe-a2.7b is trained at full width and this cut depth: its 24
# layers' bf16 params and grads and f32 AdamW moments come to ~172 GB; 4
# layers (2.90 B parameters) hold ~35 GB of state
MOE_TRAIN_LAYERS = 4
# the card's bf16 moe_block against the plain float32 loop over experts:
# bf16 rounds the gate and up products, their product, each expert's
# output and the weighted sum once each (2^-9 relative a rounding, ~4e-3
# in relative L2 together); this is ~2.5x that
MOE_LAYER_REL_L2 = 1e-2
# every gradient leaf (2 layers, full width) against the plain backward:
# the kernel's dQ, dK, dV are ~2.6e-3 off the plain ones in relative L2
# (bf16 P and dS); this is ~8x that
GRAD_REL_L2 = 2e-2

# decode vs forward at full width in bf16: the two paths round differently
# (kernel vs blockwise attention, different GEMM shapes) through 40 layers;
# the same limits hold falcon-mamba-7b (64 layers)
DECODE_REL_L2 = 5e-2                        # per step, ||d|| / ||logits||
DECODE_MAX_ABS_FRAC = 0.1                   # max |d| / max |logits|


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


COUNTED = {"flash_attention": fa.flash_attention_gqa,
           "flash_attention_bwd": fa.flash_attention_bwd,
           "mamba_scan": ms.mamba_scan,
           "selective_scan": ms.selective_scan,
           "lut_matmul": lm.lut_matmul}


def zero_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def read_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in COUNTED.items()}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph,
    the graph replayed ``replays`` times between two events, so no host
    work (the Python wrapper) sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def in_turns(kernel, library, rounds: int = 3, iters: int = 20):
    """Kernel and library call timed in turns (kernel, library, kernel,
    ...), ``rounds`` times each; the median and range of each, in ms."""
    ks, ls = [], []
    for _ in range(rounds):
        ks.append(cuda_ms(kernel, iters))
        ls.append(cuda_ms(library, iters))
    return ((statistics.median(ks), min(ks), max(ks)),
            (statistics.median(ls), min(ls), max(ls)))


def _range(stat) -> str:
    return f"[{stat[1]:.4f},{stat[2]:.4f}]"


def attn_cost(B, Tq, Tk, H, K, D, itemsize, causal):
    """Matmul FLOPs (q.k and p.v over the unmasked pairs) and the bytes of
    q, k, v read once and o written once."""
    if causal:
        pairs = sum(min(t + 1, Tk) for t in range(Tq))
    else:
        pairs = Tq * Tk
    flops = 4 * D * pairs * B * H
    nbytes = itemsize * D * (2 * B * Tq * H + 2 * B * Tk * K)
    return flops, nbytes


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    name = torch.cuda.get_device_name(0)
    log("card", nvidia_smi=repr(smi.stdout.strip()), torch_name=repr(name),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi.stdout.strip()


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.load_all()
    for name, lib in libs.items():
        ptxas = [ln.strip() for ln in lib.log.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln
                 or "Performance Loss" in ln]
        log("build", kernel=name, seconds=f"{time.perf_counter() - t0:.1f}",
            lib=lib.path.name)
        for ln in ptxas:
            print(f"    {ln}", flush=True)


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def phase_flash(gen) -> dict:
    """Flash attention against its plain versions in ``kernels/ref.py``."""
    cases = []
    for T in (1000, 1100):                       # the serving prefill shape
        cases.append(dict(B=4, Tq=T, Tk=T, H=32, K=2, D=128,
                          dtype=torch.bfloat16, causal=True, window=0,
                          softcap=0.0))
    B, T, H, K, D = MOE_PREFILL_ATTN             # qwen2-moe's, G = 1
    cases.append(dict(B=B, Tq=T, Tk=T, H=H, K=K, D=D, dtype=torch.bfloat16,
                      causal=True, window=0, softcap=0.0))
    for D in (64, 128, 256):
        for dt in (torch.float32, torch.bfloat16):
            cases.append(dict(B=2, Tq=300, Tk=300, H=4, K=2, D=D, dtype=dt,
                              causal=True, window=100, softcap=30.0))
            cases.append(dict(B=2, Tq=200, Tk=333, H=4, K=1, D=D, dtype=dt,
                              causal=False, window=0, softcap=50.0))
            cases.append(dict(B=1, Tq=130, Tk=130, H=2, K=2, D=D, dtype=dt,
                              causal=True, window=0, softcap=0.0))
    for c in cases:
        q = _rand(gen, (c["B"], c["Tq"], c["H"], c["D"]), c["dtype"])
        k = _rand(gen, (c["B"], c["Tk"], c["K"], c["D"]), c["dtype"])
        v = _rand(gen, (c["B"], c["Tk"], c["K"], c["D"]), c["dtype"])
        kw = dict(causal=c["causal"], window=c["window"],
                  softcap=c["softcap"])
        got = fa.flash_attention_gqa(q, k, v, **kw)
        want = ref.flash_attention_gqa_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[c["dtype"]]
        case = {k_: (str(v_).replace("torch.", "") if k_ == "dtype" else v_)
                for k_, v_ in c.items()}
        log("kernel", name="flash_attention",
            case=repr(case).replace(" ", ""), max_abs_err=f"{err:.3e}",
            tol=tol)
        if not err <= tol:
            raise AssertionError(f"flash attention off by {err} > {tol}: {c}")
    # the (BH, T, D) entry point of the reference's layout
    q = _rand(gen, (6, 257, 64), torch.float32)
    got = fa.flash_attention(q, q * 0.5, q * 2, window=33)
    want = ref.flash_attention_ref(q, q * 0.5, q * 2, window=33)
    err = (got - want).abs().max().item()
    log("kernel", name="flash_attention", case="bh_layout",
        max_abs_err=f"{err:.3e}", tol=TOL[torch.float32])
    if not err <= TOL[torch.float32]:
        raise AssertionError(f"flash_attention (BH layout) off by {err}")

    # timing at the main paths' shapes: the serving prefills of glm4-9b
    # (the record) and qwen2-moe-a2.7b
    rec = _time_flash(gen, 4, max(PROMPT_LENS), 32, 2, 128)
    _time_flash(gen, *MOE_PREFILL_ATTN)
    return rec


def _time_flash(gen, B, T, H, K, D) -> dict:
    """The forward at one bf16 causal shape against its plain version,
    timed in turns with SDPA; logged, and returned as a kernels record."""
    q = _rand(gen, (B, T, H, D), torch.bfloat16)
    k = _rand(gen, (B, T, K, D), torch.bfloat16)
    v = _rand(gen, (B, T, K, D), torch.bfloat16)
    got = fa.flash_attention_gqa(q, k, v)
    want = ref.flash_attention_gqa_ref(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    plain_ms = cuda_ms(lambda: ref.flash_attention_gqa_ref(q, k, v), iters=5)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                             enable_gqa=True)
    lib_err = (lib_out.transpose(1, 2).float() - want.float()).abs().max()
    kern, lib = in_turns(
        lambda: fa.flash_attention_gqa(q, k, v),
        lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                               enable_gqa=True))
    ms, library_ms = kern[0], lib[0]
    flops, nbytes = attn_cost(B, T, T, H, K, D, 2, True)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    # the design multiplies P V twice (P as bf16 hi + lo): 1.5x the work
    design_ms = max(1.5 * t_ops, t_bytes)
    log("kernel-time", name="flash_attention",
        shape=f"B{B}_T{T}_H{H}_K{K}_D{D}_bf16_causal",
        ms=f"{ms:.4f}", ms_range=_range(kern), plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{library_ms:.4f}", library_range=_range(lib),
        library_err=f"{lib_err.item():.3e}",
        bound_ms=f"{bound_ms:.4f}", design_bound_ms=f"{design_ms:.4f}",
        gflop=f"{flops / 1e9:.2f}", mbytes=f"{nbytes / 1e6:.2f}",
        tflops=f"{flops / ms / 1e9:.2f}",
        f32_core_bound_ms=f"{flops / PEAK_F32_FLOPS * 1e3:.4f}",
        max_abs_err=f"{err:.3e}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:73",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def _close(got, want, rtol, atol) -> tuple[float, bool]:
    """Max |got - want| and whether every element is within
    ``atol + rtol * |want|``."""
    d = (got.float() - want.float()).abs()
    return d.max().item(), bool((d <= atol + rtol * want.float().abs()).all())


def _held(name, case, got, want, tol) -> float:
    err, ok = _close(got, want, **tol)
    log("kernel", name=name, case=repr(case).replace(" ", ""),
        max_abs_err=f"{err:.3e}", tol=repr(tol).replace(" ", ""))
    if not ok:
        raise AssertionError(f"{name} off its plain version by {err} "
                             f"(tol {tol}) at {case}")
    return err


def _scan_inputs(gen, B, T, D, N):
    decay = torch.rand((B, T, D, N), generator=gen, device="cuda") * 0.5 + 0.5
    u = torch.randn((B, T, D, N), generator=gen, device="cuda") * 0.1
    c = torch.randn((B, T, N), generator=gen, device="cuda")
    return decay, u, c


def phase_mamba_scan(gen) -> dict:
    """``mamba_scan``, the TPU kernel's contract, against
    ``ref.mamba_scan_ref``; timed at B=1, T=1024, D=8192, N=16."""
    for case in [(2, 100, 37, 5), (3, 192, 8, 16), (2, 77, 300, 12)]:
        args = _scan_inputs(gen, *case)
        _held("mamba_scan", case, ms.mamba_scan(*args),
              ref.mamba_scan_ref(*args), SCAN_TOL)
    B, T, D, N = 1, 1024, 8192, 16
    args = _scan_inputs(gen, B, T, D, N)
    err = _held("mamba_scan", (B, T, D, N), ms.mamba_scan(*args),
                ref.mamba_scan_ref(*args), SCAN_TOL)
    ms_ = cuda_ms(lambda: ms.mamba_scan(*args))
    plain_ms = cuda_ms(lambda: ref.mamba_scan_ref(*args), iters=2, warmup=1)
    nbytes = 4 * (2 * B * T * D * N + B * T * N + B * T * D)
    bound_ms = nbytes / PEAK_BYTES * 1e3
    log("kernel-time", name="mamba_scan", shape=f"B{B}_T{T}_D{D}_N{N}_f32",
        ms=f"{ms_:.4f}", plain_ms=f"{plain_ms:.4f}", library_ms="none",
        bound_ms=f"{bound_ms:.4f}", mbytes=f"{nbytes / 1e6:.2f}",
        gbytes_s=f"{nbytes / ms_ / 1e6:.1f}", max_abs_err=f"{err:.3e}")
    return {"name": "mamba_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
            "replaces": "src/repro/kernels/mamba_scan.py:43",
            "launches": None, "max_abs_err": err, "ms": ms_,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None}


def _selective_inputs(gen, B, T, D, N, dtype, offset=7):
    """dt from a softplus as in the model, x and b, c (slices of one
    projection, ``offset`` columns in, as the model passes them) in
    ``dtype``, A = -(1..N) as the model's init, h0 random."""
    dt = F.softplus(torch.randn((B, T, D), generator=gen, device="cuda") - 1)
    x = torch.randn((B, T, D), generator=gen, device="cuda").to(dtype)
    proj = torch.randn((B, T, offset + 2 * N), generator=gen,
                       device="cuda").to(dtype)
    A = -torch.arange(1, N + 1, dtype=torch.float32, device="cuda"
                      ).repeat(D, 1)
    h0 = torch.randn((B, D, N), generator=gen, device="cuda") * 0.5
    return (dt, x, proj[..., offset:offset + N], proj[..., offset + N:], A,
            h0)


def _selective_cost(B, T, D, N, itemsize):
    nbytes = (4 * B * T * D + itemsize * B * T * D + 2 * itemsize * B * T * N
              + 4 * D * N + 2 * 4 * B * D * N + 4 * B * T * D)
    return B * T * D * N, nbytes          # exp evaluations, bytes


def phase_selective_scan(gen) -> dict:
    """``selective_scan``, the fused Mamba-1 form the model calls, against
    ``ref.selective_scan_ref``; timed at the serving prefill shape (B=4,
    T=1100, d_inner 8192, n 16, bf16 x/b/c) and the decode step's (T=1):
    ``ms`` is device time (``graph_ms``), ``wrapper_ms`` the wrapper's calls
    between two events (at T=1 the host's work, not the kernel's)."""
    for case in [(2, 37, 48, 12, torch.float32), (2, 300, 96, 16,
                                                  torch.bfloat16),
                 (3, 1, 64, 16, torch.bfloat16), (1, 70, 40, 5,
                                                  torch.float32)]:
        args = _selective_inputs(gen, *case)
        y, h = ms.selective_scan(*args)
        wy, wh = ref.selective_scan_ref(*args)
        _held("selective_scan", case[:4] + (str(case[4])[6:], "y"), y, wy,
              SCAN_TOL)
        _held("selective_scan", case[:4] + (str(case[4])[6:], "h_last"), h,
              wh, SCAN_TOL)
    rec = None
    for T in (max(PROMPT_LENS), 1):
        B, D, N = 4, 8192, 16
        args = _selective_inputs(gen, B, T, D, N, torch.bfloat16, offset=256)
        y, h = ms.selective_scan(*args)
        wy, wh = ref.selective_scan_ref(*args)
        err = max(_held("selective_scan", (B, T, D, N, "bfloat16", "y"), y,
                        wy, SCAN_TOL),
                  _held("selective_scan", (B, T, D, N, "bfloat16", "h_last"),
                        h, wh, SCAN_TOL))
        ms_ = graph_ms(lambda: ms.selective_scan(*args))
        wrapper_ms = cuda_ms(lambda: ms.selective_scan(*args))
        plain_ms = cuda_ms(lambda: ref.selective_scan_ref(*args), iters=2,
                           warmup=1)
        exps, nbytes = _selective_cost(B, T, D, N, 2)
        t_ops = exps / PEAK_SFU_OPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        plan = ms.kernel_plan(*args, h)
        if plan != ms.selective_plan(args[0], args[1], args[4], args[5], h):
            raise AssertionError(f"the kernel's plan {plan} is not the "
                                 "wrapper's mirror of it")
        log("kernel-time", name="selective_scan",
            shape=f"B{B}_T{T}_D{D}_N{N}_bf16", ms=f"{ms_:.4f}",
            wrapper_ms=f"{wrapper_ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", library_ms="none",
            plan=",".join(map(str, plan.as_ints())),
            bound_ms=f"{max(t_ops, t_bytes):.4f}",
            sfu_bound_ms=f"{t_ops:.4f}", bytes_bound_ms=f"{t_bytes:.4f}",
            mexp=f"{exps / 1e6:.1f}", mbytes=f"{nbytes / 1e6:.2f}",
            max_abs_err=f"{err:.3e}")
        if rec is None:                   # the prefill shape is the record
            rec = {"name": "selective_scan", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
                   "replaces": "src/repro/kernels/mamba_scan.py:43",
                   "launches": None, "max_abs_err": err, "ms": ms_,
                   "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "library_ms": None}
    return rec


def _lut_inputs(gen, M, K, N, dtype):
    """x ~ N(0, 1) and weights at the models' init scale N(0, 1/K), so that
    y ~ N(0, 1); codes and codebooks from ``quantize_weights``."""
    x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
    codes, lut = lm.quantize_weights(w)
    return x, codes, lut


def phase_lut_matmul(gen) -> dict:
    """``lut_matmul`` against ``ref.lut_matmul_ref`` (dequantize, then
    SGEMM); timed at falcon-mamba's in_proj, M=1024, K=4096, N=16384, f32,
    beside cuBLAS SGEMM (TF32 off) on the dequantized weights."""
    for case in [(100, 192, 77, torch.float32), (3, 512, 300, torch.bfloat16),
                 (256, 4096, 2048, torch.bfloat16),
                 (130, 128, 260, torch.float32)]:
        args = _lut_inputs(gen, *case)
        _held("lut_matmul", case[:3] + (str(case[3])[6:],),
              lm.lut_matmul(*args), ref.lut_matmul_ref(*args), LUT_TOL)
    M, K, N = 1024, 4096, 16384
    x, codes, lut = _lut_inputs(gen, M, K, N, torch.float32)
    want = ref.lut_matmul_ref(x, codes, lut)
    err = _held("lut_matmul", (M, K, N, "float32"),
                lm.lut_matmul(x, codes, lut), want, LUT_TOL)
    del want
    plain_ms = cuda_ms(lambda: ref.lut_matmul_ref(x, codes, lut), iters=5)
    w = torch.take_along_dim(lut.transpose(1, 2), codes.reshape(
        K // lm.GROUP, lm.GROUP, N).long(), dim=1).reshape(K, N)
    kern, lib = in_turns(lambda: lm.lut_matmul(x, codes, lut),
                         lambda: torch.matmul(x, w), iters=10)
    ms_, library_ms = kern[0], lib[0]
    flops = 2 * M * K * N
    nbytes = 4 * M * K + K * N + 4 * (K // lm.GROUP) * N * 16 + 4 * M * N
    # the design runs three TF32 products (3xTF32) on the tensor cores
    t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    f32_core_ms = flops / PEAK_F32_FLOPS * 1e3
    log("kernel-time", name="lut_matmul", shape=f"M{M}_K{K}_N{N}_f32",
        ms=f"{ms_:.4f}", ms_range=_range(kern), plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{library_ms:.4f}", library_range=_range(lib),
        bound_ms=f"{max(t_ops, t_bytes):.4f}",
        f32_core_bound_ms=f"{f32_core_ms:.4f}",
        gflop=f"{flops / 1e9:.2f}", mbytes=f"{nbytes / 1e6:.2f}",
        tflops=f"{flops / ms_ / 1e9:.2f}",
        library_tflops=f"{flops / library_ms / 1e9:.2f}",
        max_abs_err=f"{err:.3e}")
    return {"name": "lut_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lut_matmul.cu",
            "replaces": "src/repro/kernels/lut_matmul.py:62",
            "launches": None, "max_abs_err": err, "ms": ms_,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def moe_loop_ref(p, x, cfg, capacity_factor: float = 1.25):
    """Plain float32 version of ``moe.moe_block``: top-k of the softmax of
    the float32 router logits, renormalised; then a loop over the experts,
    each taking the first C of its assignments in (token, rank) order (the
    reference's stable sort) through its FFN.  Returns the output, the
    expert ids (N, k) and which assignments were kept (N, k)."""
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_active
    N = B * T
    xf = x.reshape(N, d).float()
    probs = torch.softmax(xf @ p["router"], dim=-1)
    w, ex = torch.topk(probs, k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    C = max(1, int(capacity_factor * k * N / E))
    out = torch.zeros((N, d), dtype=torch.float32, device=x.device)
    keep = torch.zeros((N, k), dtype=torch.bool, device=x.device)
    for e in range(E):
        tok, rank = (ex == e).nonzero(as_tuple=True)     # token-major order
        tok, rank = tok[:C], rank[:C]
        keep[tok, rank] = True
        h = xf[tok]
        y = (layers._act(h @ p["wi_gate"][e].float(), cfg.act)
             * (h @ p["wi_up"][e].float())) @ p["wo"][e].float()
        out.index_add_(0, tok, y * w[tok, rank][:, None])
    if "shared" in p:
        shared = tree.map_leaves(lambda a: a.float(), p["shared"])
        out = out + layers.mlp_block(shared, xf, cfg.act)
    return out.view(B, T, d), ex, keep


def _moe_layer_cost(cfg, N, C, itemsize):
    """FLOPs of the router, the grouped FFN over all E x C slots and the
    shared MLP; bytes of x, the weights and the output, each once."""
    d, E, f, fs = cfg.d_model, cfg.n_experts, cfg.moe_d_ff, \
        cfg.shared_expert_d_ff
    flops = 2 * N * d * E + 6 * E * C * d * f + 6 * N * d * fs
    nbytes = (4 * d * E + itemsize * (3 * E * d * f + 3 * d * fs)
              + 2 * itemsize * N * d)
    return flops, nbytes


def phase_moe_layer(gen) -> None:
    """``moe.moe_block`` at qwen2-moe-a2.7b's layer width in bf16 (4 x 1100
    tokens of the serving prefill) against ``moe_loop_ref`` on the same
    inputs: equal expert ids and kept assignments, output within
    ``MOE_LAYER_REL_L2``; at the served capacity factor 1.25 (random
    routing fills no expert there) and at 1.0, where about half the experts
    overflow and drop; timed beside the loop at 1.25."""
    cfg = registry.get("qwen2-moe-a2.7b")
    B, T = 4, max(PROMPT_LENS)
    N, E, k = B * T, cfg.n_experts, cfg.n_experts_active
    p = moe.init_moe_params(gen, cfg.d_model, cfg, torch.bfloat16)
    x = _rand(gen, (B, T, cfg.d_model), torch.bfloat16)
    for cf in (1.25, 1.0):
        got = moe.moe_block(p, x, cfg, capacity_factor=cf)
        want, want_ex, want_keep = moe_loop_ref(p, x, cfg, cf)
        C = moe.capacity(cf, k, N, E)
        _, ex = moe.route(p, x.reshape(N, -1), k)
        order, keep, _ = moe.dispatch(ex, E, C)
        kept = torch.empty_like(keep).scatter_(0, order, keep).view(N, k)
        rel = ((got.float() - want).norm() / want.norm()).item()
        same_route = torch.equal(ex, want_ex) and torch.equal(kept, want_keep)
        timing = {}
        if cf == 1.25:
            ms_ = cuda_ms(lambda: moe.moe_block(p, x, cfg))
            plain_ms = cuda_ms(lambda: moe_loop_ref(p, x, cfg), iters=3,
                               warmup=1)
            flops, nbytes = _moe_layer_cost(cfg, N, C, 2)
            t_ops = flops / PEAK_BF16_FLOPS * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            timing = dict(
                ms=f"{ms_:.4f}", plain_ms=f"{plain_ms:.4f}",
                bound_ms=f"{max(t_ops, t_bytes):.4f}",
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop=f"{flops / 1e9:.2f}", mbytes=f"{nbytes / 1e6:.2f}",
                tflops=f"{flops / ms_ / 1e9:.2f}")
        log("moe-layer", shape=f"N{N}_E{E}_k{k}_C{C}_d{cfg.d_model}"
            f"_f{cfg.moe_d_ff}_shared{cfg.shared_expert_d_ff}_bf16",
            capacity_factor=cf, rel_l2=f"{rel:.3e}",
            tol_rel_l2=MOE_LAYER_REL_L2, same_routing=same_route,
            dropped=int((~want_keep).sum()), assignments=N * k, **timing)
        if not same_route:
            raise AssertionError("moe_block routes or keeps otherwise than "
                                 f"the plain loop at capacity factor {cf}")
        if not (bool(torch.isfinite(got.float()).all())
                and rel <= MOE_LAYER_REL_L2):
            raise AssertionError(f"moe_block off the plain loop by {rel} at "
                                 f"capacity factor {cf}")


def _prompts(gen, vocab):
    return [torch.randint(2, vocab, (n,), generator=gen, device="cuda")
            .tolist() for n in PROMPT_LENS]


def _expected_counts(cfg, decode_steps: int) -> dict[str, int]:
    """Launches of the model's serving path: flash once per layer in
    prefill (decode attention is plain PyTorch); the selective scan once per
    layer in prefill and in every decode step."""
    want = dict.fromkeys(COUNTED, 0)
    if cfg.family == "ssm":
        want["selective_scan"] = cfg.n_layers * (1 + decode_steps)
    else:
        want["flash_attention"] = cfg.n_layers
    return want


def phase_serve(arch, gen) -> tuple:
    cfg = registry.get(arch)
    model = model_lib.build(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log("serve-init", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, params_B=f"{n_params / 1e9:.3f}",
        weights_GB=f"{sum(p.nbytes for p in _leaves(params)) / 1e9:.2f}",
        seconds=f"{time.perf_counter() - t0:.1f}")
    engine = Engine(model, params, ServeConfig(max_batch=4, max_len=MAX_LEN,
                                               eos_token=-1))
    # eos -1: no slot stops early, so every slot decodes MAX_NEW steps
    engine.generate([[5, 6, 7]] * 4, max_new=2)          # warm-up
    prompts = _prompts(gen, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    outs = engine.generate(prompts, max_new=MAX_NEW)
    torch.cuda.synchronize()
    counts = read_counts()
    tm = engine.timing
    new = [o[len(p):] for o, p in zip(outs, prompts)]
    n_new = sum(len(g) for g in new)
    log("serve", arch=cfg.name, prompts=list(PROMPT_LENS), max_new=MAX_NEW,
        prefill_ms=f"{tm['prefill_s'] * 1e3:.2f}",
        decode_ms_per_step=f"{tm['decode_s'] * 1e3 / tm['decode_steps']:.2f}",
        decode_steps=tm["decode_steps"],
        decode_tok_s=f"{4 * tm['decode_steps'] / tm['decode_s']:.1f}",
        e2e_tok_s=f"{n_new / (tm['prefill_s'] + tm['decode_s']):.1f}",
        peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        launches=repr(counts).replace(" ", ""))
    if not all(len(g) == MAX_NEW for g in new):
        raise AssertionError(f"generated lengths {[len(g) for g in new]}")
    if not all(0 <= t < cfg.vocab_size for g in new for t in g):
        raise AssertionError("token outside the vocabulary")
    for lg in engine.step_logits:
        if not bool(torch.isfinite(lg.float()).all()):
            raise AssertionError("non-finite logits")
    want = _expected_counts(cfg, tm["decode_steps"])
    if counts != want:
        raise AssertionError(f"{cfg.name} launches {counts} != {want}")
    return model, params, engine, prompts, outs, counts


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _padded(prompts, outs):
    plen = max(len(p) for p in prompts)
    rows = [[0] * (plen - len(p)) + o for p, o in zip(prompts, outs)]
    return plen, torch.tensor(rows, device="cuda")


def _teacher_forced(model, params, prompts, outs) -> list:
    """The logits ``Engine.generate`` produces for these tokens: prefill of
    the left-padded prompts, then one decode step per generated token."""
    plen, toks = _padded(prompts, outs)
    with torch.no_grad():
        lg, cache = model.prefill(params, model.init_cache(len(prompts),
                                                           MAX_LEN),
                                  toks[:, :plen])
        steps = [lg[:, -1]]
        for j in range(MAX_NEW - 1):
            lg, cache = model.decode_step(params, cache,
                                          toks[:, plen + j:plen + j + 1])
            steps.append(lg[:, -1])
    return steps


def _against_forward(model, params, prompts, outs, step_logits):
    """Per-step relative L2 and max-abs fraction of the step logits against
    the teacher-forced forward at the same positions, and the greedy
    agreement."""
    plen, toks = _padded(prompts, outs)
    with torch.no_grad():
        full = model.forward(params, {"tokens": toks})
    rels, fracs, agree, n = [], [], 0, 0
    for j, lg in enumerate(step_logits[:MAX_NEW]):
        want = full[:, plen - 1 + j].float()
        d = lg.float() - want
        rels.append((d.norm() / want.norm()).item())
        fracs.append((d.abs().max() / want.abs().max()).item())
        agree += int((lg.argmax(-1) == want.argmax(-1)).sum())
        n += lg.shape[0]
    return rels, fracs, f"{agree}/{n}"


def _rounding_sensitivity(model, params, prompts) -> float:
    """Relative change of the last logits when the last position's input
    embedding is scaled by 1 + 2^-8 (at most one bf16 ulp): how far the
    model's own rounding noise reaches its output."""
    plen = max(len(p) for p in prompts)
    toks = torch.tensor([[0] * (plen - len(p)) + p for p in prompts],
                        device="cuda")
    cfg = model.cfg

    def last_logits(x):
        if cfg.family == "ssm":
            h = model._run_ssm(params, x)
        else:
            pos = torch.arange(plen, device="cuda")[None].expand(len(x), plen)
            h = model._run_decoder(params, x, pos)
        h = layers.rms_norm(h[:, -1:], params["final_norm"], cfg.norm_eps)
        return model._unembed(params, h).float()

    with torch.no_grad():
        x = model.embed_inputs(params, {"tokens": toks})
        xp = x.clone()
        xp[:, -1] = (xp[:, -1].float() * (1 + 2 ** -8)).to(x.dtype)
        a, b = last_logits(x), last_logits(xp)
    return ((b - a).norm() / a.norm()).item()


def _fmt(xs) -> str:
    return "[" + ",".join(f"{x:.2e}" for x in xs) + "]"


def phase_decode_vs_forward(model, params, engine, prompts, outs) -> None:
    """The served bf16 logits against the forward's.  A dense model is held
    at every step.  A Mamba model carries each decode step's bf16 rounding
    in its state, so only its prefill step (no carried state yet) is held
    here; ``phase_decode_vs_forward_f32`` holds every step of its cached
    path."""
    cfg = model.cfg
    rels, fracs, agree = _against_forward(model, params, prompts, outs,
                                          engine.step_logits)
    held = len(rels) if cfg.family != "ssm" else 1
    worst_rel, worst_frac = max(rels[:held]), max(fracs[:held])
    noise = _rounding_sensitivity(model, params, prompts)
    log("decode-vs-forward", arch=cfg.name, dtype=cfg.dtype, steps=MAX_NEW,
        held_steps=held, worst_rel_l2=f"{worst_rel:.3e}",
        tol_rel_l2=DECODE_REL_L2, worst_max_abs_frac=f"{worst_frac:.3e}",
        tol_max_abs_frac=DECODE_MAX_ABS_FRAC, greedy_agreement=agree,
        per_step_rel_l2=_fmt(rels),
        rounding_sensitivity=f"{noise:.3e}")
    if not (worst_rel <= DECODE_REL_L2 and worst_frac <= DECODE_MAX_ABS_FRAC):
        raise AssertionError("decode logits disagree with forward")


def phase_decode_vs_forward_f32(arch, prompts, outs) -> None:
    """The cached path's function at full width without bf16's noise: the
    same model in float32 (weights from the same seed), the served tokens
    teacher-forced through prefill and decode, against its forward, held
    at every step under the same limits (an MoE model by
    ``_moe_against_forward``)."""
    cfg = dataclasses.replace(registry.get(arch), dtype="float32")
    model = model_lib.build(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    if cfg.family == "moe":
        if not _moe_against_forward(model, params, prompts, outs, cfg.dtype):
            raise AssertionError("float32 decode logits disagree with "
                                 "forward")
        return
    steps = _teacher_forced(model, params, prompts, outs)
    rels, fracs, agree = _against_forward(model, params, prompts, outs,
                                          steps)
    log("decode-vs-forward", arch=cfg.name, dtype=cfg.dtype, steps=MAX_NEW,
        held_steps=len(rels), worst_rel_l2=f"{max(rels):.3e}",
        tol_rel_l2=DECODE_REL_L2, worst_max_abs_frac=f"{max(fracs):.3e}",
        tol_max_abs_frac=DECODE_MAX_ABS_FRAC, greedy_agreement=agree,
        per_step_rel_l2=_fmt(rels))
    if not (max(rels) <= DECODE_REL_L2 and max(fracs) <= DECODE_MAX_ABS_FRAC):
        raise AssertionError("float32 decode logits disagree with forward")


@contextlib.contextmanager
def _moe_capacity(capacity_factor: float, record: list | None = None):
    """``moe.moe_block`` with its capacity factor bound (a check only: the
    served path keeps the reference's 1.25); with ``record``, the expert ids
    each call routes to, (B, T, k), are appended to it."""
    block = moe.moe_block

    def bound(params, x, cfg, *, capacity_factor=capacity_factor):
        if record is not None:
            _, ex = moe.route(params, x.reshape(-1, x.shape[-1]),
                              cfg.n_experts_active)
            record.append(ex.view(*x.shape[:2], -1))
        return block(params, x, cfg, capacity_factor=capacity_factor)

    moe.moe_block = bound
    try:
        yield
    finally:
        moe.moe_block = block


def _routing_flips(cached, full, n_layers) -> tuple[int, int]:
    """(differing, compared) (token, layer) top-k sets: the cached path's
    records (prefill, then one decode step at a time, ``n_layers`` records
    each) against the forward's at the same positions."""
    flips = pairs = 0
    for layer in range(n_layers):
        steps = cached[layer::n_layers]
        got = torch.cat(steps, dim=1).sort(-1).values
        want = full[layer][:, :got.shape[1]].sort(-1).values
        flips += int((got != want).any(-1).sum())
        pairs += got.shape[0] * got.shape[1]
    return flips, pairs


def phase_determinism(engine, prompts, outs) -> None:
    """A second ``generate`` of the same prompts: identical tokens and
    bit-identical step logits."""
    first = [lg.clone() for lg in engine.step_logits]
    again = engine.generate(prompts, max_new=MAX_NEW)
    same_logits = len(first) == len(engine.step_logits) and all(
        torch.equal(a, b) for a, b in zip(first, engine.step_logits))
    log("determinism", arch=engine.model.cfg.name,
        same_tokens=again == outs, same_step_logits=same_logits,
        steps=len(first))
    if not (again == outs and same_logits):
        raise AssertionError("two generate calls differ")


def _moe_against_forward(model, params, prompts, outs, dtype) -> bool:
    """The cached path, teacher-forced, against the forward, both with no
    assignment dropped (capacity factor E / k, so C = N); logs the limits
    and the routing flips between the two paths; returns whether every
    step is within the limits."""
    cfg = model.cfg
    no_drop = cfg.n_experts / cfg.n_experts_active
    cached, full = [], []
    with _moe_capacity(no_drop, cached):
        steps = _teacher_forced(model, params, prompts, outs)
    with _moe_capacity(no_drop, full):
        rels, fracs, agree = _against_forward(model, params, prompts, outs,
                                              steps)
    flips, pairs = _routing_flips(cached, full, cfg.n_layers)
    with _moe_capacity(no_drop):
        noise = _rounding_sensitivity(model, params, prompts)
    ok = max(rels) <= DECODE_REL_L2 and max(fracs) <= DECODE_MAX_ABS_FRAC
    log("decode-vs-forward", arch=cfg.name, dtype=dtype, steps=MAX_NEW,
        capacity_factor=no_drop, held_steps=len(rels),
        worst_rel_l2=f"{max(rels):.3e}", tol_rel_l2=DECODE_REL_L2,
        worst_max_abs_frac=f"{max(fracs):.3e}",
        tol_max_abs_frac=DECODE_MAX_ABS_FRAC, within=ok,
        greedy_agreement=agree, routing_flips=f"{flips}/{pairs}",
        per_step_rel_l2=_fmt(rels), rounding_sensitivity=f"{noise:.3e}")
    return ok


# the ATen ops whose own device time the profiles split out: cuBLAS GEMMs,
# batched products (the experts' grouped FFN; in decode also the plain
# attention's two einsums) and the index ops of MoE dispatch (and of the
# embedding lookup)
_GEMM_OPS = {"aten::mm", "aten::addmm"}
_BMM_OPS = {"aten::bmm", "aten::baddbmm"}
_INDEX_OPS = {"aten::sort", "aten::topk", "aten::searchsorted",
              "aten::index", "aten::index_put_", "aten::_index_put_impl_",
              "aten::scatter_", "aten::scatter", "aten::gather",
              "aten::index_select", "aten::index_add_", "aten::scatter_add_",
              "aten::nonzero", "aten::embedding_dense_backward"}


def _self_device_ms(prof) -> dict[str, float]:
    """Each ATen op's own device time (its kernels, not its children's),
    ms, by op name."""
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if ev.key.startswith("aten::") and us:
            out[ev.key] = us / 1e3
    return out


def _op_split(prof) -> dict[str, str]:
    """Device time (ms) of the GEMMs, the batched products and the index
    ops, summed by kind from ``_self_device_ms``."""
    own = _self_device_ms(prof)
    return {name: f"{sum(own.get(op, 0.0) for op in ops_):.2f}"
            for name, ops_ in (("gemm_ms", _GEMM_OPS), ("bmm_ms", _BMM_OPS),
                               ("index_ms", _INDEX_OPS))}


def _top_ops(prof, n: int = 8) -> None:
    own = sorted(_self_device_ms(prof).items(), key=lambda kv: -kv[1])
    for key, ms_ in own[:n]:
        print(f"    {ms_:9.3f} ms  {key}", flush=True)


def phase_profile(model, params, prompts) -> None:
    """Where the time goes: one prefill and one decode step under
    torch.profiler; device busy share = kernel time / host wall time (the
    profiler's own overhead lengthens the wall time, so the share is a
    lower bound)."""
    from torch.profiler import ProfilerActivity, profile
    plen = max(len(p) for p in prompts)
    toks = torch.tensor([[0] * (plen - len(p)) + p for p in prompts],
                        device="cuda")
    for name in ("prefill", "decode"):
        cache = model.init_cache(len(prompts), MAX_LEN)
        if name == "decode":
            _, cache = model.prefill(params, cache, toks)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if name == "prefill":
                model.prefill(params, cache, toks)
            else:
                model.decode_step(params, cache, toks[:, -1:])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels: dict[str, list] = {}
        for ev in prof.events():
            if str(getattr(ev, "device_type", "")).endswith("CUDA"):
                rec = kernels.setdefault(ev.name, [0.0, 0])
                rec[0] += ev.time_range.elapsed_us()
                rec[1] += 1
        dev_us = sum(us for us, _ in kernels.values())
        flash_us = sum(us for n, (us, _) in kernels.items() if "fa_fwd" in n)
        log("profile", arch=model.cfg.name, step=name,
            wall_ms=f"{wall_us / 1e3:.2f}",
            device_ms=(f"{dev_us / 1e3:.2f}" if dev_us else "not_measured"),
            busy_share=(f"{dev_us / wall_us:.3f}" if dev_us else
                        "not_measured"),
            device_events=sum(n for _, n in kernels.values()),
            flash_ms=f"{flash_us / 1e3:.2f}", **_op_split(prof))
        for kname, (us, n) in sorted(kernels.items(),
                                     key=lambda kv: -kv[1][0])[:6]:
            print(f"    {us / 1e3:9.3f} ms  x{n:<5d} {kname[:90]}", flush=True)
        _top_ops(prof, 6)


def phase_entry_points(model, params, prompts, gen) -> dict[str, int]:
    """The entry points that no model path calls, driven as a user would:
    ``ops.quantize_weights`` + ``ops.lut_matmul`` on falcon-mamba's layer-0
    ``in_proj`` (the layer's normalized input over the first 256 tokens of
    each prompt)
    against the product with the bf16 weights; ``ops.mamba_scan`` on the
    decay and input that ``ops.selective_scan`` builds, against it.
    Counts are zeroed just before and read just after."""
    cfg = model.cfg
    n = min(256, *map(len, prompts))
    toks = torch.tensor([p[:n] for p in prompts], device="cuda")
    h = layers.rms_norm(params["embed"][toks], params["blocks"]["ln"][0],
                        cfg.norm_eps).reshape(-1, cfg.d_model).float()
    w = params["blocks"]["mixer"]["in_proj"][0]
    B, T, D, N = 1, 1024, cfg.d_inner, cfg.ssm_state
    dt, x, b, c, A, _ = _selective_inputs(gen, B, T, D, N, torch.float32)
    torch.cuda.synchronize()
    zero_counts()
    y4 = ops.lut_matmul(h, *ops.quantize_weights(w.float()))
    y_fused, _ = ops.selective_scan(dt, x, b, c, A,
                                    torch.zeros((B, D, N), device="cuda"))
    decay = torch.exp(dt[..., None] * A)
    u = (dt * x)[..., None] * b[:, :, None, :]
    y_tpu = ops.mamba_scan(decay, u, c.contiguous())
    torch.cuda.synchronize()
    counts = read_counts()
    want = h @ w.float()
    rel = ((y4 - want).norm() / want.norm()).item()
    log("entry-points", lut_shape=f"M{h.shape[0]}_K{w.shape[0]}_N{w.shape[1]}",
        lut_rel_l2_vs_bf16_weights=f"{rel:.4f}", tol=LUT_QUANT_REL_L2,
        launches=repr(counts).replace(" ", ""))
    if not (bool(torch.isfinite(y4).all()) and rel <= LUT_QUANT_REL_L2):
        raise AssertionError(f"4-bit in_proj off the bf16 product: {rel}")
    _held("mamba_scan_vs_selective_scan", (B, T, D, N), y_tpu, y_fused,
          SCAN_TOL)
    want_counts = {"flash_attention": 0, "flash_attention_bwd": 0,
                   "mamba_scan": 1, "selective_scan": 1, "lut_matmul": 1}
    if counts != want_counts:
        raise AssertionError(f"entry-point launches {counts} != "
                             f"{want_counts}")
    return counts


def _bwd_cost(B, T, H, K, D, itemsize):
    """The gradient's five T x T x D products over the causal pairs, and
    the bytes of q, k, v, o, dO and the LSE read once and dQ, dK, dV
    written once."""
    pairs = T * (T + 1) // 2
    flops = 5 * 2 * D * pairs * B * H
    nbytes = itemsize * D * (4 * B * T * H + 4 * B * T * K) + 4 * B * H * T
    return flops, nbytes


def phase_flash_backward(gen) -> dict:
    """The backward kernel and the forward's LSE against their plain
    versions; timed at granite-3-2b's and qwen2-moe-a2.7b's training
    shapes."""
    for (B, T, H, K, D, dt, window, softcap) in BWD_CASES:
        q, do = _rand(gen, (B, T, H, D), dt), _rand(gen, (B, T, H, D), dt)
        k, v = _rand(gen, (B, T, K, D), dt), _rand(gen, (B, T, K, D), dt)
        kw = dict(window=window, softcap=softcap)
        o, lse = fa.flash_attention_lse(q, k, v, **kw)
        o0 = fa.flash_attention_gqa(q, k, v, **kw)
        _, want_lse = ref.flash_attention_gqa_ref(q, k, v, return_lse=True,
                                                  **kw)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        case = (B, T, H, K, D, str(dt)[6:], window, softcap)
        if not torch.equal(o, o0):
            raise AssertionError(f"forward with LSE changed o at {case}")
        _held("flash_attention_lse", case, lse, want_lse, LSE_TOL)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            _held("flash_attention_bwd", case + (name,), g, w, BWD_TOL[dt])
    # timed at the training shapes of granite-3-2b (the record) and
    # qwen2-moe-a2.7b
    rec = _time_flash_bwd(gen, *TRAIN_ATTN)
    _time_flash_bwd(gen, *MOE_TRAIN_ATTN)
    return rec


def _time_flash_bwd(gen, B, T, H, K, D) -> dict:
    """The backward at one bf16 causal shape against its plain version;
    two calls must be bit-identical; timed beside SDPA's backward and the
    forward with and without the LSE; returned as a kernels record."""
    q, do = (_rand(gen, (B, T, H, D), torch.bfloat16) for _ in range(2))
    k, v = (_rand(gen, (B, T, K, D), torch.bfloat16) for _ in range(2))
    o, lse = fa.flash_attention_lse(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    err = max(_held("flash_attention_bwd", (B, T, H, K, D, "bfloat16", n),
                    g, w, BWD_TOL[torch.bfloat16])
              for n, g, w in zip(("dq", "dk", "dv"), got, want))
    again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log("flash_attention_bwd", check="two calls bit-identical",
        shape=f"B{B}_T{T}_H{H}_K{K}_D{D}_bf16", ok=same)
    if not same:
        raise AssertionError("two backward calls differ: the kernel must be "
                             "deterministic")
    del got, want, again
    plain_ms = cuda_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse,
                                                           do), iters=3)
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    doh = do.transpose(1, 2).contiguous()

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                              enable_gqa=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qh, kh, vh), doh)

    def kernel():
        fa.flash_attention_bwd(q, k, v, o, lse, do)

    ks, fbs, fs = [], [], []
    for _ in range(3):                      # in turns
        ks.append(cuda_ms(kernel))
        fbs.append(cuda_ms(sdpa_fwd_bwd))
        fs.append(cuda_ms(sdpa_fwd))
    ms_ = statistics.median(ks)
    library_ms = statistics.median(fbs) - statistics.median(fs)
    # the forward at the same shape, with the LSE (training) and without
    fwd_lse_ms, fwd_ms = in_turns(lambda: fa.flash_attention_lse(q, k, v),
                                  lambda: fa.flash_attention_gqa(q, k, v))
    flops, nbytes = _bwd_cost(B, T, H, K, D, 2)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    # the kernel forms S and dP twice (dK/dV and dQ kernels, no atomics):
    # seven T^2 D products where the bound counts five
    log("kernel-time", name="flash_attention_bwd",
        shape=f"B{B}_T{T}_H{H}_K{K}_D{D}_bf16_causal", ms=f"{ms_:.4f}",
        ms_range=f"[{min(ks):.4f},{max(ks):.4f}]", plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{library_ms:.4f}",
        sdpa_fwd_bwd_ms=f"{statistics.median(fbs):.4f}",
        sdpa_fwd_ms=f"{statistics.median(fs):.4f}",
        bound_ms=f"{max(t_ops, t_bytes):.4f}", ops_bound_ms=f"{t_ops:.4f}",
        design_bound_ms=f"{max(1.4 * t_ops, t_bytes):.4f}",
        bytes_bound_ms=f"{t_bytes:.4f}", gflop=f"{flops / 1e9:.2f}",
        mbytes=f"{nbytes / 1e6:.2f}", tflops=f"{flops / ms_ / 1e9:.2f}",
        max_abs_err=f"{err:.3e}")
    log("kernel-time", name="flash_attention_fwd_train_shape",
        shape=f"B{B}_T{T}_H{H}_K{K}_D{D}_bf16_causal",
        with_lse_ms=f"{fwd_lse_ms[0]:.4f}", with_lse_range=_range(fwd_lse_ms),
        without_lse_ms=f"{fwd_ms[0]:.4f}", without_lse_range=_range(fwd_ms))
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/layers.py:71",
            "launches": None, "max_abs_err": err, "ms": ms_,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def _kernel_share(prof, wall_us, label) -> None:
    """Busy share, the top kernels, and device time by kind (GEMMs, flash
    forward and backward, the rest: elementwise, copies, reductions) of one
    profiled region."""
    kernels: dict[str, list] = {}
    for ev in prof.events():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            rec = kernels.setdefault(ev.name, [0.0, 0])
            rec[0] += ev.time_range.elapsed_us()
            rec[1] += 1
    dev_us = sum(us for us, _ in kernels.values())
    fwd_us = sum(us for n, (us, _) in kernels.items() if "fa_fwd" in n)
    bwd_us = sum(us for n, (us, _) in kernels.items()
                 if "dkdv_" in n or "dq_bf16" in n or "dq_f32" in n
                 or "delta_kernel" in n)
    gemm_us = sum(us for n, (us, _) in kernels.items()
                  if any(w in n for w in ("nvjet", "gemm", "xmma", "cutlass")))
    log("profile", step=label, wall_ms=f"{wall_us / 1e3:.2f}",
        device_ms=(f"{dev_us / 1e3:.2f}" if dev_us else "not_measured"),
        busy_share=(f"{dev_us / wall_us:.3f}" if dev_us else "not_measured"),
        device_events=sum(n for _, n in kernels.values()),
        gemm_ms=f"{gemm_us / 1e3:.2f}",
        ops=repr(_op_split(prof)).replace(" ", ""),
        other_ms=f"{(dev_us - gemm_us - fwd_us - bwd_us) / 1e3:.2f}",
        flash_fwd_ms=f"{fwd_us / 1e3:.2f}", flash_bwd_ms=f"{bwd_us / 1e3:.2f}",
        flash_fwd_share=(f"{fwd_us / dev_us:.3f}" if dev_us else "-"),
        flash_bwd_share=(f"{bwd_us / dev_us:.3f}" if dev_us else "-"))
    for kname, (us, n) in sorted(kernels.items(),
                                 key=lambda kv: -kv[1][0])[:8]:
        print(f"    {us / 1e3:9.3f} ms  x{n:<5d} {kname[:90]}", flush=True)
    _top_ops(prof)


def phase_train() -> dict[str, int]:
    """granite-3-2b at full width through the port's launcher."""
    cfg = registry.get("granite-3-2b")
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    return _train(cfg, ckpt_dir, lambda: train_launch.main([
        "--arch", cfg.name, "--steps", str(TRAIN_STEPS),
        "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
        "--ckpt-dir", str(ckpt_dir), "--ckpt-every", str(10 * TRAIN_STEPS)]),
        "train")


def phase_train_moe() -> dict[str, int]:
    """qwen2-moe-a2.7b at full width and ``MOE_TRAIN_LAYERS`` layers through
    ``make_train_step`` and the ``Trainer``, with the launcher's settings
    (the launcher has no depth option, as the reference's has none)."""
    cfg = dataclasses.replace(registry.get("qwen2-moe-a2.7b"),
                              n_layers=MOE_TRAIN_LAYERS)
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"

    def run() -> dict:
        model = model_lib.build(cfg, "cuda")
        opt_cfg = adamw.AdamWConfig(lr=3e-4, total_steps=TRAIN_STEPS,
                                    warmup_steps=max(1, TRAIN_STEPS // 10))
        state = train_step.make_train_state(
            model, opt_cfg, torch.Generator(device="cuda").manual_seed(0))
        trainer = Trainer(train_step.make_train_step(model, opt_cfg), state,
                          DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=TRAIN_SEQ,
                                     global_batch=TRAIN_BATCH),
                          str(ckpt_dir),
                          TrainerConfig(total_steps=TRAIN_STEPS,
                                        checkpoint_every=10 * TRAIN_STEPS,
                                        log_every=1))
        return {**trainer.run(), "trainer": trainer}

    return _train(cfg, ckpt_dir, run, "train-moe")


def _train(cfg, ckpt_dir, run, label) -> dict[str, int]:
    """``run()`` (5 steps of 4 x 2048 tokens, returning the trainer's result
    and the trainer) with the counts zeroed just before and read just
    after; then one more step under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    out = run()
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    trainer = out["trainer"]
    n_params = sum(p.numel() for p in tree.leaves(trainer.state["params"]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for m in out["metrics"]:
        log("train-step", step=m["step"], loss=f"{m['loss']:.4f}",
            ms=f"{m['sec_per_step'] * 1e3:.1f}",
            tokens_s=f"{tokens / m['sec_per_step']:.0f}")
    steady = [m["sec_per_step"] for m in out["metrics"][1:]]
    log("train", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        params_B=f"{n_params / 1e9:.3f}", dtype=cfg.dtype,
        remat=cfg.remat_policy, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        steps=out["final_step"],
        ms_per_step_median_after_first=f"{statistics.median(steady) * 1e3:.1f}",
        tokens_s=f"{tokens / statistics.median(steady):.0f}",
        peak_mem_GB=f"{peak / 1e9:.2f}",
        launches=repr(counts).replace(" ", ""))
    losses = [m["loss"] for m in out["metrics"]]
    if len(losses) != TRAIN_STEPS or not all(
            x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"train losses {losses}")
    want = dict.fromkeys(COUNTED, 0)
    want["flash_attention"] = 2 * cfg.n_layers * TRAIN_STEPS   # + recompute
    want["flash_attention_bwd"] = cfg.n_layers * TRAIN_STEPS
    if counts != want:
        raise AssertionError(f"train launches {counts} != {want}")
    batch = trainer.corpus.batch_at(TRAIN_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.state, metrics = trainer.step_fn(trainer.state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _kernel_share(prof, wall_us, label)
    del out, trainer, prof
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return counts


@contextlib.contextmanager
def _plain_backward():
    """The differentiable flash op's backward on ``flash_attention_bwd_ref``
    (a check only)."""
    kernel = fa.flash_attention_bwd

    def plain(q, k, v, o, lse, do, *, causal=True, window=0, softcap=0.0):
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                           window=window, softcap=softcap)

    fa.flash_attention_bwd = plain
    try:
        yield
    finally:
        fa.flash_attention_bwd = kernel


def phase_train_grad_vs_plain(arch: str) -> None:
    """Every gradient leaf of ``arch`` at full width and 2 layers (B=1,
    T=2048) with the backward kernel against the same with the plain
    backward: worst per-leaf relative L2."""
    cfg = dataclasses.replace(registry.get(arch), n_layers=2)
    model = model_lib.build(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=TRAIN_SEQ, global_batch=1)
                            ).batch_at(0)
    tokens = {"tokens": torch.as_tensor(batch["tokens"], device="cuda")}
    before = fa.flash_attention_bwd.launches
    loss, grads = train_step._loss_and_grads(model, params, tokens, 1)
    if fa.flash_attention_bwd.launches - before != cfg.n_layers:
        raise AssertionError("the kernel run did not use the backward kernel")
    with _plain_backward():
        loss_p, plain = train_step._loss_and_grads(model, params, tokens, 1)
    if fa.flash_attention_bwd.launches - before != cfg.n_layers:
        raise AssertionError("the plain run launched the backward kernel")
    worst, where = 0.0, ""
    for (path, g), w in zip(tree.items(grads), tree.leaves(plain)):
        if not bool(torch.isfinite(g.float()).all()):
            raise AssertionError(f"non-finite gradient at {path}")
        rel = ((g.float() - w.float()).norm() / w.float().norm()).item()
        if rel > worst:
            worst, where = rel, path
    log("train-grad-vs-plain", arch=cfg.name, layers=cfg.n_layers, batch=1,
        seq=TRAIN_SEQ, loss=f"{loss.item():.4f}",
        plain_loss=f"{loss_p.item():.4f}", leaves=len(tree.leaves(grads)),
        worst_rel_l2=f"{worst:.3e}", worst_leaf=where, tol=GRAD_REL_L2)
    if not worst <= GRAD_REL_L2:
        raise AssertionError(f"gradient {where} off the plain backward by "
                             f"{worst} > {GRAD_REL_L2}")


def run_arch(arch, gen) -> tuple:
    """Serve, decode against forward and profile one model (and, for the
    Mamba model, drive the entry points no model calls); its weights are
    freed when this returns.  The last item says whether the cached path
    is still to be held in a float32 build."""
    model, params, engine, prompts, outs, counts = phase_serve(arch, gen)
    family = model.cfg.family
    if family == "moe":
        phase_determinism(engine, prompts, outs)
        need_f32 = not _moe_against_forward(model, params, prompts, outs,
                                            model.cfg.dtype)
    else:
        phase_decode_vs_forward(model, params, engine, prompts, outs)
        need_f32 = family == "ssm"
    phase_profile(model, params, prompts)
    entry = (phase_entry_points(model, params, prompts, gen)
             if family == "ssm" else None)
    return counts, entry, prompts, outs, need_f32


def main() -> None:
    t_start = time.perf_counter()
    smi = phase_card()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    records = [phase_flash(gen), phase_flash_backward(gen),
               phase_mamba_scan(gen), phase_selective_scan(gen),
               phase_lut_matmul(gen)]
    phase_moe_layer(gen)
    by_name = {r["name"]: r for r in records}
    for arch in ARCHS:
        counts, entry, prompts, outs, need_f32 = run_arch(arch, gen)
        gc.collect()
        torch.cuda.empty_cache()
        if need_f32:
            phase_decode_vs_forward_f32(arch, prompts, outs)
            gc.collect()
            torch.cuda.empty_cache()
        # the first served path of each kernel gives its record's count
        for name, n in counts.items():
            if n and by_name[name]["launches"] is None:
                by_name[name]["launches"] = n
        for name, n in (entry or {}).items():
            if n and by_name[name]["launches"] is None:
                by_name[name]["launches"] = n
    gc.collect()
    torch.cuda.empty_cache()
    train_counts = phase_train()
    by_name["flash_attention_bwd"]["launches"] = train_counts[
        "flash_attention_bwd"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_grad_vs_plain("granite-3-2b")
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_moe()
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_grad_vs_plain("qwen2-moe-a2.7b")
    missing = [r["name"] for r in records if not r["launches"]]
    if missing:
        raise AssertionError(f"kernels never launched on a path: {missing}")
    log("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
