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
   range printed), and the card's bound: flash attention (head_dim 64, 80,
   128 and 256; timed at glm4-9b's, qwen2-moe-a2.7b's, musicgen-medium's
   and zamba2-2.7b's prefill shapes, the last three one query head a kv
   head, G = 1, zamba2's at head_dim 80, and at the VLM's non-causal
   cross-attention over 1601 media tokens in prefill, Tq = 1100, and in a
   decode step, Tq = 1, from a CUDA graph), the flash backward (phase 7
   below, run here), the
   selective scan's three entry points (``mamba_scan``, ``selective_scan``
   and the Mamba-2 form ``mamba2_scan``, the last two timed as device time
   from a CUDA graph of their launches, ``mamba2_scan`` at zamba2-2.7b's
   prefill and decode shapes, its chunked (SSD) path also on
   ``MAMBA2_CHUNKED_CASES``, and held against ``selective_scan`` over the
   same function; also timed at zamba2's training length T = 2048), the
   Mamba-2 scan's backward ``mamba2_scan_bwd`` against
   ``ref.mamba2_scan_bwd_ref`` on ``MAMBA2_BWD_CASES`` (both forms: the
   chunked (SSD) one on the tensor cores for bf16 with N <= 64 and T > 8,
   the CUDA-core one for the rest; two calls bit-identical, timed from a
   CUDA graph at zamba2-2.7b's training shape beside its bound and its
   design's; no library call computes it), the Mamba-1 scan's backward
   ``selective_scan_bwd`` against ``ref.selective_scan_bwd_ref`` on
   ``SEL_BWD_CASES`` (f32 and bf16, N 4, 16 and 128, T 1 to 300 and around
   its chunk, ragged channel blocks, the decay underflowing, its operands
   loaded by the block's threads and through TMA; two calls bit-identical;
   timed from a CUDA graph at falcon-mamba-7b's training shape beside its
   bound and its design's SFU floor; no library call computes it; under grad
   ``selective_scan`` is the differentiable op and ``mamba_scan`` raises),
   ``selective_scan`` also timed at T = 2048, the LUT matmul, and the
   MoE layer's grouped products (``grouped_mm``, both weight layouts, and
   ``grouped_mm_wgrad``) against their plain versions on ``GMM_CASES``
   (segments of length 0 and 1, drops, widths 88, 200, 1408, 2048, 5120
   and 8192, every row dropped, a decode step, a k depth of 88, segments
   across the 64-row stage and 128-row tile edges; every row outside the
   kept prefixes NaN, those rows exactly zero in the output; float32 and
   bf16, two calls bit-identical), held to them again and timed from a
   CUDA graph at qwen2-moe's decode step (gate/up only), served and
   trained shapes beside the bound over the kept
   rows and ``torch._grouped_mm`` with every row kept (the dX form and,
   by its 2d x 2d form, the weight gradient too), whose output is held to
   the kernel's with every row kept;
4. moe-layer: ``moe.moe_block`` at qwen2-moe-a2.7b's layer width (N = 4400
   tokens, 60 experts, top-4, shared expert) in bf16 against a plain
   float32 loop over the experts with the same capacity rule, at the served
   capacity factor 1.25 and at 1.0, where experts overflow; equal routing
   and kept assignments, timed beside the loop and beside its bound over
   the kept assignments (and over every padded E x C slot, as before);
5. for each served model, glm4-9b (40 layers), falcon-mamba-7b (64 Mamba-1
   layers), zamba2-2.7b (54 Mamba-2 layers and 9 applications of its 2
   shared attention blocks), qwen2-moe-a2.7b (24 MoE layers),
   musicgen-medium (48 layers after 64 conditioning frames) then
   llama-3.2-vision-11b (40 layers and
   8 gated cross blocks over 1601 media tokens, every gate set to
   ``VLM_GATE``), at full width and depth in bf16 with random weights from
   a seeded generator on the card, the previous model's weights freed
   first:
   a. serving: 4 requests of several hundred to 1100 tokens (the VLM and
      audio models with random N(0, 1) media) through ``Engine.generate``;
      launch counts are zeroed just before and read just after, and every
      kernel of the model's path must have run (flash once per layer in
      prefill, once per application of zamba2's shared blocks in prefill,
      and once per VLM cross block in prefill and in every decode step;
      the scan, ``selective_scan`` or ``mamba2_scan``, once per Mamba layer
      in prefill and in every decode step; ``grouped_mm`` three times per
      MoE layer in prefill and in every decode step); two calls at the same shapes
      come first, so the served run reads a steady prefill, and their
      prefills are printed beside it (``_first_prefills``);
   b. decode against forward: the teacher-forced forward logits at the
      generated positions against the logits decode produced (for the
      Mamba and hybrid models, whose state carries each step's bf16
      rounding, the served run is held at its prefill step and every step
      is held on the same model in float32, teacher-forced).  For the MoE model the
      capacity rule makes the cached path (4 tokens a decode step, one
      slot an expert) and the forward different functions: it runs a
      second ``generate`` that must give identical tokens and
      bit-identical step logits, then holds the teacher-forced cached path
      against the forward with ``moe_block``'s capacity factor bound to
      E / k (no assignment dropped; a check only), counting the (token,
      layer) top-k sets the two paths route differently; held in a
      float32 build when bf16's rounding and routing flips push a step
      past the limits.  The VLM also runs the second ``generate``; the VLM
      and audio models are held at every step in bf16, with the served
      media;
   c. profile: one prefill and one decode step under ``torch.profiler``,
      device time split into GEMMs (``aten::mm``), batched products
      (``aten::bmm``: decode attention), the experts' grouped products
      (``gmm_ms``), index ops (sort, top-k, gathers and scatters), flash,
      the scans and the rest;
      for the VLM also its cross blocks' device time (CUDA events);
6. the entry points no model calls: ``ops.quantize_weights`` +
   ``ops.lut_matmul`` on falcon-mamba's layer-0 ``in_proj`` and
   ``ops.mamba_scan`` on the decay and input it builds, counted the same way;
7. flash_backward: the backward kernel against ``flash_attention_bwd_ref``
   (float32 and bfloat16, D 64/80/128/256, ``BWD_CASES``: causal GQA up to
   G = 8, T below, at and one past a tile, windows, soft-cap, and
   qwen2-moe's training shape, G = 1 at D = 128; non-causal Tq < Tk and
   Tq > Tk, ragged on both sides, 37 queries over 1601 keys, and the VLM's
   cross-attention training shape, Tq = 2048 over Tk = 1601), the forward
   with LSE against the forward without it and its LSE against the plain
   one (timed at the training shapes beside its bound); two calls at each
   timed shape must be bit-identical; timed at
   granite-3-2b's, qwen2-moe's, zamba2-2.7b's (D = 80) and the VLM
   cross-attention's training shapes beside SDPA's backward (SDPA
   forward + backward minus SDPA forward, in turns; a yardstick only, it
   runs nowhere on the path), with
   the five-product bound and the design's seven-product bound;
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
    step: 4 + 4 flash forward launches, 4 backward launches; 36
    ``grouped_mm``, a layer's three products forward, recomputed and in
    their dX form, and 12 ``grouped_mm_wgrad``);
11. train_grad_vs_plain for qwen2-moe-a2.7b at full width and 2 layers,
    the grouped products' backward (the dX form and the weight gradient)
    also on their plain versions in the plain run;
12. train-audio: musicgen-medium at full width and depth (48 layers,
    1.82 B parameters), the same 5 steps of 4 x 2048 tokens after 64
    random conditioning frames each (sequence 2112), counted the same way
    (per step 48 + 48 flash forward launches, 48 backward launches);
13. train_grad_vs_plain for musicgen-medium at full width and 2 layers,
    with random media;
14. train-vlm: llama-3.2-vision-11b at full width and 10 of its 40 layers
    (two groups of 5 self layers and a cross block; its full-depth state
    does not fit one card), gates at ``VLM_GATE``, random media, the same
    5 steps (per step (10 + 2) x 2 flash forward launches and 10 + 2
    backward launches, the cross blocks' non-causal);
15. train_grad_vs_plain for the VLM at full width and 5 layers (one group:
    5 self layers and a cross block), gates and ``media_proj`` among the
    leaves;
16. train-hybrid: zamba2-2.7b at full width and depth (54 Mamba-2 layers,
    2.527 B parameters) through ``repro_torch.launch.train.main``, the
    same 5 steps, counted the same way (per step 9 + 9 flash forward and
    9 backward launches, 54 + 54 ``mamba2_scan`` and 54
    ``mamba2_scan_bwd`` launches);
17. train_grad_vs_plain for zamba2 at full width and 6 layers (one group:
    6 Mamba-2 layers and a shared block), both backward kernels swapped
    for their plain versions;
18. train-ssm: falcon-mamba-7b at full width and depth (64 Mamba-1 layers,
    7.273 B parameters) through ``make_train_step`` and the ``Trainer``
    with 8-bit AdamW moments and remat "full" (with 32-bit moments its
    state does not fit one card), the same 5 steps, counted the same way
    (per step 64 + 64 ``selective_scan`` and 64 ``selective_scan_bwd``
    launches);
19. train_grad_vs_plain for falcon-mamba-7b at full width and 2 layers,
    the scan backward swapped for its plain version;
20. pluto: the pLUTo LUT ALU (``core/pluto_alu.py``) and the paper's Fig-8
    applications (``core/executor.py``) on the card at the paper's sizes:
    MM 200 x 200 x 200, PMM n = 300, NTT n = 512 (q = 7681) and BFS over
    the complete 1000-node graph and a random sparse one, each bit for bit
    against its NumPy oracle and timed (wall clock to a synchronize, the
    card's name and power limit beside it); ``pluto_add``, ``pluto_mul``
    and ``pluto_sub`` on 2^20 random uint32 pairs and the width sweep
    4-32 likewise;
20b. pim-sim: the Shared-PIM simulator's core (``repro_torch.core``
   engine and scheduler) on the card: the five Fig-8 applications at the
   paper's sizes (``PIM_FIG8``: MM n = 200, PMM n = 300, NTT n = 512,
   BFS and DFS over 1000 nodes; 16 PEs) under both interconnects,
   scheduled by the vector engine with its state on the card, each held
   bit for bit (makespan, busy and stall times, counts, rows, energies
   and a SHA-256 of the finish times) against the host's scalar engine
   and ``core/reference.py``, then ``scheduler.schedule`` timed on the
   card and with ``device="cpu"`` in turns (``PIM_TIMING_ROUNDS`` each;
   median and range, the card's name and power limit beside them); MM
   n = 64 on 256 PEs (``PIM_WIDE``), whose wide frontiers take the
   engine's batched path, held the same way; every row of
   ``benchmarks/paper_tables.py`` but its wall-clock ones
   (``pim_paper_rows``: Table II, Fig 6, Fig 7, Fig 8 from the card's
   schedules, the energy constants, Table III, Fig 9) printed beside its
   paper value, each equal to the host's and the ``PIM_PAPER_ROWS`` with
   a paper value within that module's tolerance;
20c. pim-device: the device-scale simulator (``repro_torch.device``,
   ``passes``, ``frontend``) on the card: every ``device`` and ``synth``
   case of ``tests/golden_schedules.json`` (104 schedules, the grid kept
   here as ``GOLDEN_APP_KW``, ``GOLDEN_GEOMETRIES`` and ``GOLDEN_SYNTH``)
   scheduled by ``device.scheduler.schedule(..., device="cuda")`` and held
   exactly to the golden record (makespan, busy and stall times, counts,
   rows, energies, rows by route, bus busy times and a SHA-256 of the
   finish times); the HBM-scale device (``PIM_HBM``: 16 channels x 16
   banks, 4 groups a channel, 16 PEs a bank, 4,096 PEs) running the five
   Fig-8 applications at the paper's sizes, ``round_robin``, strong
   scaling, under both interconnects through ``BatchRunner(device=
   "cuda").run``, each held bit for bit to the same runner on the host
   (BFS, DFS and PMM n = 32 also to the host's scalar engine), its
   makespan beside the reference's (``PIM_HBM_REF``), timed on the card
   and the host in turns (``PIM_TIMING_ROUNDS`` for ``PIM_HBM_REPEAT``,
   once for MM, PMM and NTT) with the engine's batch counts;
   qwen2-moe-a2.7b prefill at full depth on that device with and without
   the passes pipeline (``DEFAULT_OPT``: 291 rewrites, the optimised
   Shared-PIM makespan below the unoptimised one), card against host;
20d. pim-runtime: the simulator's observability, placement search and
   serving runtime (``repro_torch.obs``, ``search``, ``runtime``) on the
   card, every figure held to the reference's benchmark scripts' (constants
   recorded from ``benchmarks/obs.py``, ``placement.py``, ``serving.py``
   and ``continuous.py`` run with the JAX package on a host CPU): the two
   recorder cells (``PIM_RT_OBS``, ``RefreshSpec()``) under both
   interconnects on the card and on the host, in turns, their tasks,
   makespans and trace events the reference's, recorded equal to plain
   on each side and the trace JSON's SHA-256 the same on both; the two
   placement cells (``PIM_RT_SEARCH``, the default ``SearchConfig``)
   searched on the card with one worker and with ``PIM_RT_WORKERS``
   spawned ones (the pool's start time printed) and on the host, digests,
   makespans, evals and prunes the reference's, then the moe cell again
   from the persistent cache the card's run wrote (zero engine evals); the
   serving cells (the five-app tenant mix, 200 jobs, fifo, loads 0.3 and
   0.9) and the continuous-batching cells (the chat and agent fleet,
   loads 0.25-4.0), each on the card then the host, the card's results
   equal to the host's and every p50/p99/jobs/s, tok/s and p99 the
   reference's, with the engine's batch counts; the session-vs-offline
   and continuous-off-vs-whole-job guards on the card;
21. overlap: the distributed layer in an NCCL process group of one rank
    (a ``FileStore`` under ``build/``): ``ag_matmul``, ``matmul_rs`` and
    ``overlapped_ffn`` against the unsharded products (1e-5, 1e-4),
    ``psum_compressed`` (the codes on the link byte for byte against
    ``quantize``, the mean against the dequantized gradient), the
    pipeline with one stage against the sequential oracle, and one
    compressed train step on a 'pod' mesh of one at a reduced width
    against the same step averaged uncompressed.  A group of one posts no
    ``isend``/``irecv``: the ring's hand-off is held over gloo on several
    ranks by ``tests/test_torch_distributed.py``, not here.  Then the
    gradients of every input through ``ag_matmul``, ``matmul_rs``,
    ``overlapped_ffn`` and the one-stage pipeline against autograd of the
    plain products (1e-4);
22. mesh-train: granite-3-2b (4 layers) and qwen2-moe-a2.7b (2 layers,
    its MoE layers through ``moe_block``'s mesh path) at full width under
    a one-card ``DeviceMesh`` ('data' x 'model' = 1 x 1, an NCCL group of
    one), DTensor parameters and batch, ``overlap="shared_bus"``,
    ``constrain_activations`` and ``constrain_internals``: two steps each
    (loss, every gradient leaf, AdamW) against the same steps with plain
    parameters and no mesh (each plain step from the mesh run's
    parameters), with the ms of each step; the flash forward
    and backward launch counts of each mesh step asserted (the kernels run
    on the local shards through the ops' DTensor sharding rules), and
    qwen2-moe's grouped products (9 ``grouped_mm`` and 3
    ``grouped_mm_wgrad`` a MoE layer, on its rank's sorted rows);
23. planner: the dry-run planner (``launch/dryrun.py``) held against the
    card on granite-3-2b at full width and ``PLANNER_LAYERS`` layers, one
    train step of 4 x 2048 on a 1 x 1 mesh: its ``MemTracker`` peak within
    ``PLANNER_MEM_RTOL`` of ``torch.cuda.max_memory_allocated`` of the
    same step run for real, its FLOPs equal to ``FlopCounterMode`` over
    the plain step;
24. dryrun: ``python -m repro_torch.launch.dryrun`` in subprocesses,
    all started together, on ``DRYRUN_CELLS`` (granite-3-2b train_4k on the 256- and 512-rank
    meshes; glm4-9b decode_32k, qwen2-moe-a2.7b train_4k and
    llama4-maverick-400b-a17b decode_32k on the 256-rank one; a fake
    process group and fake CUDA tensors), every cell ``ok``, each cell's per-device
    planner counts printed (counts for cards this machine does not have,
    not timings).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or without the rest of
the repository beside it, the script fails before printing either.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import gc
import hashlib
import json
import os
import pathlib
import shutil
import statistics
import struct
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import tree  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import executor  # noqa: E402
from repro_torch.core import pluto_alu as alu  # noqa: E402
from repro_torch.core import area as pim_area  # noqa: E402
from repro_torch.core import copy_models as pim_copy  # noqa: E402
from repro_torch.core import engine as pim_engine  # noqa: E402
from repro_torch.core import engine_vec as pim_engine_vec  # noqa: E402
from repro_torch.core import ir as pim_ir  # noqa: E402
from repro_torch.core import nonpim as pim_nonpim  # noqa: E402
from repro_torch.core import pluto as pim_pluto  # noqa: E402
from repro_torch.core import reference as pim_ref  # noqa: E402
from repro_torch.core import scheduler as pim_sched  # noqa: E402
from repro_torch.core import taskgraph as pim_tg  # noqa: E402
from repro_torch.core.energy import DEFAULT_TABLE as PIM_ENERGY_TABLE  # noqa: E402
from repro_torch.core.energy import move_energy as pim_move_energy  # noqa: E402
from repro_torch.core.pluto import Interconnect  # noqa: E402
from repro_torch.core.overlap import collective_matmul as cm  # noqa: E402
from repro_torch.core.overlap import compression  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch import passes as pim_passes  # noqa: E402
from repro_torch.device import batch as dev_batch  # noqa: E402
from repro_torch.device import partition as dev_part  # noqa: E402
from repro_torch.device import scheduler as dev_sched  # noqa: E402
from repro_torch.device.geometry import DeviceGeometry  # noqa: E402
from repro_torch.device.resources import DeviceModel  # noqa: E402
from repro_torch import obs as pim_obs  # noqa: E402
from repro_torch import runtime as pim_runtime  # noqa: E402
from repro_torch import search as pim_search  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import grouped_mm as gm  # noqa: E402
from repro_torch.kernels import lut_matmul as lm  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import layers, moe  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.sharding import partition  # noqa: E402
from repro_torch.sharding.context import use_mesh  # noqa: E402
from repro_torch.train import pipeline as pipe  # noqa: E402
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
# |got - want| <= atol + rtol * |want|, TestMambaScan's 1e-4; the Mamba-2
# scan likewise
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
# FP32 instructions a second on the CUDA cores: 128 lanes an SM, 132 SMs,
# 1.98 GHz boost (an FFMA is one instruction; PEAK_F32_FLOPS counts it as 2)
PEAK_F32_INSTR = 128 * 132 * 1.98e9
# the LUT matmul against dequantize + cuBLAS SGEMM (TF32 off): f32 sums of K
# products in two orders; TestLutMatmul's f32 tolerance, with weights at the
# models' init scale N(0, 1/K) so that y ~ N(0, 1) and the rounding of the
# partial sums (~sqrt(K) * 2^-24 ~ 4e-6 at K = 4096) stays far below 1e-4
LUT_TOL = dict(rtol=1e-5, atol=1e-4)
# 4-bit codebooks against the bf16 weights they quantize: uniform rounding
# error over a ~4.8-sigma group range in 15 steps is ~9% of the product's
# rms; relative L2 above this is a wrong product, not quantization
LUT_QUANT_REL_L2 = 0.15

ARCHS = ("glm4-9b", "falcon-mamba-7b", "zamba2-2.7b", "qwen2-moe-a2.7b",
         "musicgen-medium", "llama-3.2-vision-11b")
# zamba2-2.7b's training shapes: its Mamba-2 scan (B, T, H, P, N) and
# its shared attention (B, T, H, K, D; 32 heads of 80, G = 1)
ZAMBA2_TRAIN_SCAN = (4, 2048, 80, 64, 64)
ZAMBA2_TRAIN_ATTN = (4, 2048, 32, 32, 80)
# every VLM cross gate is set to this after init: the reference initialises
# them to 0, where a cross block adds tanh(0) a = 0 and a wrong cross path
# would show nothing
VLM_GATE = 0.5
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
# the backward's cases (B, Tq, Tk, H, K, D, dtype, window, softcap, causal)
# at each D and dtype: causal (Tq == Tk) GQA with a ragged last tile,
# window + soft-cap, tiles skipped outside the window, G = 8, T < 64, T one
# past a tile, a window of one tile and one shorter than a tile; then
# non-causal (cross-attention) with Tq < Tk and Tq > Tk, ragged on both
# sides, and 37 queries over 1601 keys (the VLM's media tokens) with a
# soft-cap
BWD_CASES = [(B, T, T, H, K, D, dt, window, softcap, True)
             for D in (64, 80, 128, 256)
             for dt in (torch.float32, torch.bfloat16)
             for (B, T, H, K, window, softcap) in (
                 (2, 300, 4, 2, 0, 0.0), (1, 130, 4, 1, 100, 30.0),
                 (1, 1000, 4, 2, 64, 50.0), (1, 200, 8, 1, 0, 0.0),
                 (2, 37, 4, 2, 0, 0.0), (1, 129, 4, 2, 0, 0.0),
                 (1, 300, 4, 2, 64, 0.0), (1, 300, 4, 2, 20, 0.0))]
# qwen2-moe-a2.7b's training shape: one query head a kv head (G = 1)
BWD_CASES.append((4, 2048, 2048, 16, 16, 128, torch.bfloat16, 0, 0.0, True))
BWD_CASES += [(B, Tq, Tk, H, K, D, dt, 0, softcap, False)
              for D in (64, 80, 128, 256)
              for dt in (torch.float32, torch.bfloat16)
              for (B, Tq, Tk, H, K, softcap) in (
                  (2, 300, 333, 4, 2, 0.0), (1, 333, 130, 4, 1, 0.0),
                  (1, 37, 1601, 4, 2, 30.0))]
# llama-3.2-vision-11b's cross-attention in training: 2048 text positions
# over 1601 media tokens, non-causal (B, Tq, Tk, H, K, D)
VLM_CROSS_TRAIN_ATTN = (4, 2048, 1601, 32, 8, 128)
BWD_CASES.append(VLM_CROSS_TRAIN_ATTN[:6] + (torch.bfloat16, 0, 0.0, False))
# zamba2-2.7b's shared attention in training: D = 80 on the 128-wide tile
BWD_CASES.append((4, 2048, 2048, 32, 32, 80, torch.bfloat16, 0, 0.0, True))
# the training shapes (B, T, H, K, D) of granite-3-2b and qwen2-moe-a2.7b
TRAIN_ATTN = (4, 2048, 32, 8, 64)
MOE_TRAIN_ATTN = (4, 2048, 16, 16, 128)
# qwen2-moe-a2.7b's serving prefill shape: B, T, H, K, D
MOE_PREFILL_ATTN = (4, 1100, 16, 16, 128)
# musicgen-medium's prefill (1100 prompt tokens after 64 conditioning
# frames; 24 heads of 64 over 24 kv heads, G = 1): B, T, H, K, D
MUSICGEN_PREFILL_ATTN = (4, 1164, 24, 24, 64)
# zamba2-2.7b's shared attention in prefill (1100 prompt tokens, 32 heads
# of 80 over 32 kv heads, G = 1; the bf16 kernel runs D = 80 on its
# 128-wide tile): B, T, H, K, D
ZAMBA2_PREFILL_ATTN = (4, 1100, 32, 32, 80)
# zamba2-2.7b's Mamba-2 scan in prefill: B, T, H (80 heads), P, N
ZAMBA2_SCAN = (4, 1100, 80, 64, 64)
# llama-3.2-vision-11b's cross-attention in serving, B, Tq, Tk, H, K, D:
# prefill (the 1100-token prompt) and a decode step, over 1601 media tokens
VLM_CROSS_PREFILL_ATTN = (4, 1100, 1601, 32, 8, 128)
VLM_CROSS_DECODE_ATTN = (4, 1, 1601, 32, 8, 128)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 5, 4, 2048
# qwen2-moe-a2.7b is trained at full width and this cut depth: its 24
# layers' bf16 params and grads and f32 AdamW moments come to ~172 GB; 4
# layers (2.90 B parameters) hold ~35 GB of state
MOE_TRAIN_LAYERS = 4
# llama-3.2-vision-11b likewise: 40 layers (10.13 B parameters) hold ~122
# GB of state; 10 layers (two groups, so the cross stack holds two blocks;
# 3.33 B parameters) ~40 GB.  musicgen-medium (1.82 B) trains whole.
VLM_TRAIN_LAYERS = 10
# the gradient check's depths: every gradient leaf at full width; the VLM
# needs one whole group (5 self layers and a cross block)
GRAD_LAYERS = {"granite-3-2b": 2, "qwen2-moe-a2.7b": 2, "musicgen-medium": 2,
               "llama-3.2-vision-11b": 5, "zamba2-2.7b": 6,
               "falcon-mamba-7b": 2}
# the card's bf16 moe_block against the plain float32 loop over experts:
# bf16 rounds the gate and up products, their product, each expert's
# output and the weighted sum once each (2^-9 relative a rounding, ~4e-3
# in relative L2 together); this is ~2.5x that
MOE_LAYER_REL_L2 = 1e-2
# the Mamba-2 scan's backward against its plain version.  Its sums are
# longer than the forward's (y sums N = 64 terms under SCAN_TOL): ddt and
# da sum P N (4096 at zamba2's widths) terms a (b, t, h), db and dc H P
# (5120), dA B T (8192).  Two orders of a sum of n terms of scale s differ
# by up to ~n eps s, and the output's largest element is ~sqrt(n) s
# (terms of random sign), so an element may differ by ~sqrt(n) eps of the
# output's largest element even where cancellation left it near zero,
# which SCAN_TOL's atol alone does not allow for: the limit is SCAN_TOL
# plus sqrt(n) 2^-24 of the largest element, n the case's longest sum.
# dx, db and dc, which the kernel rounds to the operands' dtype once, are
# held against the plain version's float32 values: in bf16 that rounding
# is at most half an ulp, 2^-8 of the value (8 significant bits), so their
# rtol is 2^-8 there.
SCAN_BWD_ROUND_RTOL = {torch.float32: SCAN_TOL["rtol"], torch.bfloat16: 2 ** -8}
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
           "mamba2_scan": ms.mamba2_scan,
           "selective_scan_bwd": ms.selective_scan_bwd,
           "mamba2_scan_bwd": ms.mamba2_scan_bwd,
           "lut_matmul": lm.lut_matmul,
           "grouped_mm": gm.grouped_mm,
           "grouped_mm_wgrad": gm.grouped_mm_wgrad}


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
    for (B, T, H, K, D) in (MOE_PREFILL_ATTN,         # qwen2-moe's, G = 1
                            MUSICGEN_PREFILL_ATTN):  # musicgen's, G = 1
        cases.append(dict(B=B, Tq=T, Tk=T, H=H, K=K, D=D,
                          dtype=torch.bfloat16, causal=True, window=0,
                          softcap=0.0))
    # the VLM's cross-attention: prefill and a decode step over 1601 keys
    for (B, Tq, Tk, H, K, D) in (VLM_CROSS_PREFILL_ATTN,
                                 VLM_CROSS_DECODE_ATTN):
        cases.append(dict(B=B, Tq=Tq, Tk=Tk, H=H, K=K, D=D,
                          dtype=torch.bfloat16, causal=False, window=0,
                          softcap=0.0))
    # zamba2's head_dim 80: T below, at and one past a 128-row tile, and
    # the prefill's G = 1 with 32 heads
    for dt in (torch.float32, torch.bfloat16):
        for T in (100, 128, 129):
            cases.append(dict(B=2, Tq=T, Tk=T, H=4, K=2, D=80, dtype=dt,
                              causal=True, window=0, softcap=0.0))
    cases.append(dict(B=4, Tq=1100, Tk=1100, H=32, K=32, D=80,
                      dtype=torch.bfloat16, causal=True, window=0,
                      softcap=0.0))
    for D in (64, 80, 128, 256):
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
    # (the record), qwen2-moe-a2.7b and musicgen-medium, and the VLM's
    # cross-attention in prefill and in a decode step (a launch shorter
    # than its wrapper: device time from a CUDA graph of launches)
    rec = _time_flash(gen, 4, max(PROMPT_LENS), 32, 2, 128)
    _time_flash(gen, *MOE_PREFILL_ATTN)
    _time_flash(gen, *MUSICGEN_PREFILL_ATTN)
    _time_flash(gen, *ZAMBA2_PREFILL_ATTN)
    for shape, graph in ((VLM_CROSS_PREFILL_ATTN, False),
                         (VLM_CROSS_DECODE_ATTN, True)):
        B, Tq, Tk, H, K, D = shape
        _time_flash(gen, B, Tq, H, K, D, Tk=Tk, causal=False, graph=graph)
    return rec


def _time_flash(gen, B, T, H, K, D, Tk=None, causal=True,
                graph=False) -> dict:
    """The forward at one bf16 shape (T queries over ``Tk``, default T,
    keys) against its plain version, timed in turns with SDPA (with
    ``graph``, each as device time from a CUDA graph of launches); logged,
    and returned as a kernels record."""
    Tk = T if Tk is None else Tk
    q = _rand(gen, (B, T, H, D), torch.bfloat16)
    k = _rand(gen, (B, Tk, K, D), torch.bfloat16)
    v = _rand(gen, (B, Tk, K, D), torch.bfloat16)
    got = fa.flash_attention_gqa(q, k, v, causal=causal)
    want = ref.flash_attention_gqa_ref(q, k, v, causal=causal)
    err = (got.float() - want.float()).abs().max().item()
    plain_ms = cuda_ms(lambda: ref.flash_attention_gqa_ref(q, k, v,
                                                           causal=causal),
                       iters=5)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def kernel():
        return fa.flash_attention_gqa(q, k, v, causal=causal)

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                              enable_gqa=True)

    lib_err = (library().transpose(1, 2).float() - want.float()).abs().max()
    if graph:
        before = fa.flash_attention_gqa.launches
        kern = [graph_ms(kernel) for _ in range(3)]
        lib = [graph_ms(library) for _ in range(3)]
        fa.flash_attention_gqa.launches = before   # captures, not launches
        kern, lib = ((statistics.median(x), min(x), max(x))
                     for x in (kern, lib))
    else:
        kern, lib = in_turns(kernel, library)
    ms, library_ms = kern[0], lib[0]
    flops, nbytes = attn_cost(B, T, Tk, H, K, D, 2, causal)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    # the design multiplies P V twice (P as bf16 hi + lo): 1.5x the work;
    # D = 80 runs on the 128-wide tile: 128 / 80 = 1.6x the products
    tile_d = 128 if D == 80 else D
    design_ms = max(1.5 * tile_d / D * t_ops, t_bytes)
    shape = (f"B{B}_T{T}_H{H}_K{K}_D{D}_bf16_causal" if causal else
             f"B{B}_Tq{T}_Tk{Tk}_H{H}_K{K}_D{D}_bf16_noncausal")
    log("kernel-time", name="flash_attention", shape=shape,
        timing="cuda_graph_device_time" if graph else "events_in_turns",
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
    T=1100, d_inner 8192, n 16, bf16 x/b/c), the decode step's (T=1) and
    falcon-mamba-7b's training length (T=2048):
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
    for T in (max(PROMPT_LENS), 1, TRAIN_SEQ):
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


def _mamba2_inputs(gen, B, T, H, P, N, dtype, offset=7, reset=False):
    """dt from a softplus as in the model (B, T, H), x (B, T, H, P) and b,
    c (slices of one projection, ``offset`` columns in, as the model passes
    them) in ``dtype``, A = -exp(N(0, 1)) < 0 a head, h0 random.
    ``reset``: at step 3 of every 64-step chunk dt A = -1000 and x = 0, so
    the state is wiped without an input of that size and the chunked
    form's segment sums reach -1e3 (the SSD "segsum" trap: a difference of
    two running sums would then lose ~1e3 * 2^-24 of an exponent, the
    size of the tolerance)."""
    dt = F.softplus(torch.randn((B, T, H), generator=gen, device="cuda") - 1)
    x = torch.randn((B, T, H, P), generator=gen, device="cuda").to(dtype)
    proj = torch.randn((B, T, offset + 2 * N), generator=gen,
                       device="cuda").to(dtype)
    A = -torch.exp(torch.randn((H,), generator=gen, device="cuda"))
    h0 = torch.randn((B, H, P, N), generator=gen, device="cuda") * 0.5
    if reset:
        dt[:, 3::SSD_CHUNK] = 1000.0 / -A
        x[:, 3::SSD_CHUNK] = 0
    return (dt, x, proj[..., offset:offset + N], proj[..., offset + N:], A,
            h0)


# chunk length of the chunked (SSD) form of the Mamba-2 scan
SSD_CHUNK = 64
# the chunked path's own cases (B, T, H, P, N, b/c offset, reset), bf16:
# a ragged last chunk (130), T a multiple of 64 (128, 640), a ragged P and
# N (40, 16), two row blocks of P (100), N = 5, b and c through TMA
# (offset 0) and by the threads (offset 7, not 16-byte aligned), y stored
# from registers (P = 33: no TMA stride), and the segment-sum trap
# (``_mamba2_inputs``' reset) over several chunks
MAMBA2_CHUNKED_CASES = [
    (2, 130, 3, 64, 64, 0, False), (2, 128, 3, 64, 64, 7, False),
    (1, 640, 2, 64, 64, 0, False), (2, 200, 2, 40, 16, 7, False),
    (1, 300, 2, 100, 64, 0, False), (2, 77, 3, 64, 5, 7, False),
    (2, 100, 2, 33, 64, 0, False), (2, 300, 3, 64, 64, 7, True),
    (2, 1100, 2, 64, 64, 0, True)]


def _mamba2_cost(B, T, H, P, N, itemsize):
    """The function's least work and bytes, and each path's own work.

    With a scalar decay a head the scan is a chunked product on the tensor
    cores (SSD, chunk Q): a chunk's C Bᵀ (Q x Q x N, shared by the heads),
    each head's masked (C Bᵀ) X (Q x Q x P), its chunk state Bᵀ X and the
    carried state's output C h (Q x N x P each), ~2·B·T·(Q·N + H·P·(Q +
    2N)) flops at the TF32 rate (the state is f32).  The chunked path
    issues, for each 64-row block of P and each 64-step chunk (the last
    padded), four m64n64 products of depth 64 (N padded to 64): C Bᵀ once
    and the other three in three bf16 terms each, 10 · 2 · 64³ flops at the
    bf16 rate.  The CUDA-core paths (decode) spend three FP32 instructions a
    state-step (FMUL for u, FFMA for h, FFMA for y).  Bytes: dt, x, b, c,
    A, h0 read once and y, h_last written once."""
    Q = min(SSD_CHUNK, T)
    flops = 2 * B * T * (Q * N + H * P * (Q + 2 * N))
    nbytes = (4 * B * T * H + itemsize * B * T * H * P + 2 * itemsize * B * T
              * N + 4 * H + 2 * 4 * B * H * P * N + 4 * B * T * H * P)
    tiles = B * H * -(-P // SSD_CHUNK) * -(-T // SSD_CHUNK)
    ssd_flops = tiles * 10 * 2 * SSD_CHUNK ** 3
    return flops, nbytes, ssd_flops, 3 * B * T * H * P * N


def mamba2_plan_want(B, T, H) -> ms.Mamba2Plan:
    """The plan at zamba2's widths (P = N = 64, bf16 x/b/c, b and c at
    offset 0): the chunked path, one 64-row block a head, x, b, c in and y
    out through TMA, for a prefill; the direct path (16 lanes a row group,
    32 rows a block, 2 blocks a head) for a decode step."""
    if T > 8:
        return ms.Mamba2Plan("chunked", 0, 64, False, (True,) * 4,
                             (1, H, B))
    return ms.Mamba2Plan("direct", 16, 32, True, (False,) * 4, (2, H, B))


def phase_mamba2_scan(gen) -> dict:
    """``mamba2_scan``, the Mamba-2 form zamba2's ``mamba2_block`` calls,
    against ``ref.mamba2_scan_ref`` (f32 and bf16 x/b/c; N 16, 64, 128;
    T 1, 7, 65, 1100; A < 0, h0 nonzero; then ``MAMBA2_CHUNKED_CASES`` on
    the chunked path), and against ``selective_scan`` over the same
    function with dt and x spread over (head, row) channels and A over the
    rows (a check only: the model never calls it so); timed at zamba2's
    serving prefill (B=4, T=1100, H=80, P=64, N=64, bf16 x/b/c: the chunked
    path), a decode step (T=1: the direct path) and its training length
    (T=2048, the chunked path) as device time from a CUDA graph."""
    for dtype in (torch.float32, torch.bfloat16):
        for N in (16, 64, 128):
            for T in (1, 7, 65, 1100):
                args = _mamba2_inputs(gen, 2, T, 3, 64, N, dtype)
                y, h = ms.mamba2_scan(*args)
                wy, wh = ref.mamba2_scan_ref(*args)
                case = (2, T, 3, 64, N, str(dtype)[6:])
                _held("mamba2_scan", case + ("y",), y, wy, SCAN_TOL)
                _held("mamba2_scan", case + ("h_last",), h, wh, SCAN_TOL)
    for B, T, H, P, N, offset, reset in MAMBA2_CHUNKED_CASES:
        args = _mamba2_inputs(gen, B, T, H, P, N, torch.bfloat16, offset,
                              reset)
        y, h = ms.mamba2_scan(*args)
        wy, wh = ref.mamba2_scan_ref(*args)
        plan = ms.kernel_mamba2_plan(*args, h)
        case = (B, T, H, P, N, offset, "reset" if reset else "softplus",
                ",".join(map(str, plan.as_ints())))
        if plan.path != "chunked":
            raise AssertionError(f"{case}: the plan is {plan}, not chunked")
        _held("mamba2_scan", case + ("y",), y, wy, SCAN_TOL)
        _held("mamba2_scan", case + ("h_last",), h, wh, SCAN_TOL)
    dt, x, b, c, A, h0 = _mamba2_inputs(gen, 2, 70, 3, 64, 16,
                                        torch.bfloat16)
    B, T, H, P = x.shape
    y, h = ms.mamba2_scan(dt, x, b, c, A, h0)
    y1, h1 = ms.selective_scan(
        dt[..., None].expand(B, T, H, P).reshape(B, T, H * P),
        x.reshape(B, T, H * P), b, c,
        A[:, None, None].expand(H, P, 16).reshape(H * P, 16).contiguous(),
        h0.reshape(B, H * P, 16))
    _held("mamba2_scan_vs_selective_scan", (B, T, H, P, 16, "y"),
          y.reshape(B, T, H * P), y1, SCAN_TOL)
    _held("mamba2_scan_vs_selective_scan", (B, T, H, P, 16, "h_last"),
          h.reshape(B, H * P, 16), h1, SCAN_TOL)
    rec = None
    for T in (ZAMBA2_SCAN[1], 1, ZAMBA2_TRAIN_SCAN[1]):
        B, _, H, P, N = ZAMBA2_SCAN
        args = _mamba2_inputs(gen, B, T, H, P, N, torch.bfloat16, offset=0)
        y, h = ms.mamba2_scan(*args)
        wy, wh = ref.mamba2_scan_ref(*args)
        case = (B, T, H, P, N, "bfloat16")
        err = max(_held("mamba2_scan", case + ("y",), y, wy, SCAN_TOL),
                  _held("mamba2_scan", case + ("h_last",), h, wh, SCAN_TOL))
        plan = ms.kernel_mamba2_plan(*args, h)
        want = mamba2_plan_want(B, T, H)
        if plan != want:
            raise AssertionError(f"the kernel's plan {plan} is not {want}")
        ms_ = graph_ms(lambda: ms.mamba2_scan(*args))
        wrapper_ms = cuda_ms(lambda: ms.mamba2_scan(*args))
        plain_ms = cuda_ms(lambda: ref.mamba2_scan_ref(*args), iters=2,
                           warmup=1)
        flops, nbytes, ssd_flops, instr = _mamba2_cost(B, T, H, P, N, 2)
        t_ops = flops / PEAK_TF32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        # the path's own floor: the chunked path's bf16 products on the
        # tensor cores, or the CUDA-core paths' FP32 instructions
        path_ms = (ssd_flops / PEAK_BF16_FLOPS if plan.path == "chunked"
                   else instr / PEAK_F32_INSTR) * 1e3
        log("kernel-time", name="mamba2_scan",
            shape=f"B{B}_T{T}_H{H}_P{P}_N{N}_bf16", path=plan.path,
            timing="cuda_graph_device_time", ms=f"{ms_:.4f}",
            wrapper_ms=f"{wrapper_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms="none", plan=",".join(map(str, plan.as_ints())),
            bound_ms=f"{max(t_ops, t_bytes):.4f}",
            ops_bound_ms=f"{t_ops:.4f}", bytes_bound_ms=f"{t_bytes:.4f}",
            design_bound_ms=f"{max(path_ms, t_bytes):.4f}",
            design_ops_ms=f"{path_ms:.4f}", gflop=f"{flops / 1e9:.3f}",
            design_gflop=f"{ssd_flops / 1e9:.3f}",
            ginstr=f"{instr / 1e9:.3f}", mbytes=f"{nbytes / 1e6:.2f}",
            max_abs_err=f"{err:.3e}")
        if rec is None:                   # the prefill shape is the record
            rec = {"name": "mamba2_scan", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
                   "replaces": "src/repro/kernels/mamba_scan.py:43",
                   "launches": None, "max_abs_err": err, "ms": ms_,
                   "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "library_ms": None}
    return rec


# the scan backward's cases (B, T, H, P, N, dtype, b/c offset, reset): T
# of one step, one below, at and one past a 64-step chunk, and 2048 (32
# chunks, zamba2's training length); P 64 and 33 (a ragged row block);
# N 16, 64 and 128 (4, 16 and 32 lanes a row group); float32 and bf16;
# b and c at an odd column of one projection, and at 0; the segment-sum
# reset (dt A = -1000, the decay underflowing to 0) over several chunks;
# h0 and dh_last nonzero throughout.  bf16 with N <= 64 and T > 8 takes
# the chunked form; its own cases at the end: 30 heads (a group of
# ``ms.BWD_HEADS`` = 20 and a short one) with T = 200, two row blocks
# (P = 100) over the reset, and a ragged P and N (40, 5) over the reset,
# at offsets 7 and 0
MAMBA2_BWD_CASES = (
    [(2, T, 3, 64, N, dt, 7, False)
     for dt in (torch.float32, torch.bfloat16) for N in (16, 64, 128)
     for T in (1, 63, 64, 65)]
    + [(1, 2048, 2, P, N, dt, 7, False)
       for dt in (torch.float32, torch.bfloat16) for (P, N) in
       ((64, 16), (33, 64), (64, 128))]
    + [(2, 65, 3, 33, N, torch.bfloat16, 7, False) for N in (16, 64, 128)]
    + [(2, 130, 3, 64, 64, torch.bfloat16, 0, False),
       (2, 300, 3, 64, 64, torch.bfloat16, 7, True),
       (1, 2048, 2, 33, 16, torch.float32, 7, True)]
    + [(2, 200, 30, 64, 64, torch.bfloat16, 7, False),
       (1, 300, 2, 100, 64, torch.bfloat16, 0, True),
       (2, 77, 3, 40, 5, torch.bfloat16, 7, True)])


def _mamba2_bwd_inputs(gen, B, T, H, P, N, dtype, offset=7, reset=False):
    """``_mamba2_inputs`` and the output gradients dy (B, T, H, P) and
    dh_last (B, H, P, N), float32 N(0, 1)."""
    args = _mamba2_inputs(gen, B, T, H, P, N, dtype, offset, reset)
    dy = torch.randn((B, T, H, P), generator=gen, device="cuda")
    dh = torch.randn((B, H, P, N), generator=gen, device="cuda")
    return (*args, dy, dh)


def _hold_bwd(name, case, got, want, dtype, n) -> float:
    """A scan backward kernel's (ddt, dx, db, dc, dA, dh0) against its
    plain version's on float32 copies of x, b, c under
    ``SCAN_BWD_ROUND_RTOL``'s limits (n the case's longest sum; dx, db, dc
    in the operands' ``dtype``); the largest difference."""
    worst = 0.0
    for out, g, w in zip(("ddt", "dx", "db", "dc", "dA", "dh0"), got, want):
        if g.dtype != (dtype if out in ("dx", "db", "dc")
                       else torch.float32) or g.shape != w.shape:
            raise AssertionError(f"{name} {out}: {g.dtype} "
                                 f"{tuple(g.shape)} at {case}")
        d = (g.float() - w).abs()
        lim = (SCAN_TOL["atol"] + SCAN_BWD_ROUND_RTOL[g.dtype] * w.abs()
               + n ** 0.5 * 2.0 ** -24 * w.abs().max())
        err, ratio = d.max().item(), (d / lim).max().item()
        log("kernel", name=name, case=repr(case + (out,)).replace(" ", ""),
            max_abs_err=f"{err:.3e}", worst_of_limit=f"{ratio:.3f}")
        if not ratio <= 1.0:
            raise AssertionError(f"{name} {out} off its plain version by "
                                 f"{err} ({ratio:.2f} of its limit) at "
                                 f"{case}")
        worst = max(worst, err)
    return worst


def _hold_scan_bwd(case, got, args) -> float:
    """The Mamba-2 backward under ``_hold_bwd`` (n: P N for ddt, H P for db
    and dc, B T for dA)."""
    dt, x, b, c, A, h0, dy, dh = args
    want = ref.mamba2_scan_bwd_ref(dt, x.float(), b.float(), c.float(), A,
                                   h0, dy, dh)
    B, T, H, P = x.shape
    return _hold_bwd("mamba2_scan_bwd", case, got, want, x.dtype,
                     max(P * b.shape[2], H * P, B * T))


def _mamba2_bwd_cost(B, T, H, P, N, itemsize):
    """The backward's least work and bytes, and each form's own work.

    Least work: the chunked (SSD) form's backward, each of the forward's
    products (``_mamba2_cost``) differentiated once for each operand: twice
    the forward's flops, at the TF32 rate (the state is f32).  Bytes: dt,
    x, b, c, A, h0, dy and dh_last read once; ddt, dx, db, dc, dA and dh0
    written once.  The CUDA-core form's work: each state-step on the CUDA
    cores, three forward steps (two FP32 instructions each, one a recompute
    level) and the reverse step (seven: g += dy c, g b, x g, dy h, g h, the
    decay and the bookkeeping), 13 FP32 instructions.  The chunked form's
    work: its bf16 products, 112 m64n64k16 steps a (chunk, head, 64-row
    block) tile and 12 a chunk of each of its two state walks; its bytes:
    the function's, the walks' second reads of x and dy, and its scratch
    (h_in and dh_out written and read, the partial sums of db and dc per
    head group of ``ms.BWD_HEADS`` and of da and ddt per head, each written
    and read).  Returns (flops, bytes, CUDA-core instructions, chunked
    flops, chunked bytes)."""
    flops = 2 * _mamba2_cost(B, T, H, P, N, itemsize)[0]
    # each of dt, x, b, c, A once in and its gradient once out; h0, dh_last
    # in and dh0 out; dy in
    nbytes = (2 * (4 * B * T * H + itemsize * B * T * H * P
                   + 2 * itemsize * B * T * N + 4 * H)
              + 3 * 4 * B * H * P * N + 4 * B * T * H * P)
    K, RB = -(-T // SSD_CHUNK), -(-P // SSD_CHUNK)
    tiles = B * K * H * RB
    chunked_flops = tiles * (112 + 2 * 12) * 2 * 64 * 64 * 16
    groups = -(-H // ms.BWD_HEADS)
    chunked_bytes = (nbytes + (itemsize + 4) * B * T * H * P
                     + 4 * (4 * B * K * H * P * N
                            + 2 * 2 * B * T * groups * RB * N
                            + 2 * 2 * B * T * H * RB))
    return flops, nbytes, 13 * B * T * H * P * N, chunked_flops, chunked_bytes


def phase_mamba2_scan_bwd(gen) -> dict:
    """The Mamba-2 scan's backward kernel against
    ``ref.mamba2_scan_bwd_ref`` on ``MAMBA2_BWD_CASES``; its plan against
    the wrapper's mirror; two calls bit-identical; timed from a CUDA graph
    at zamba2-2.7b's training shape (B=4, T=2048, H=80, P=N=64, bf16 x, b,
    c) beside its plain version.  No PyTorch call computes this function
    (library "none")."""
    for case in MAMBA2_BWD_CASES:
        B, T, H, P, N, dtype, offset, reset = case
        args = _mamba2_bwd_inputs(gen, B, T, H, P, N, dtype, offset, reset)
        plan = ms.kernel_mamba2_bwd_plan(B, T, H, P, N, dtype)
        want = ("chunked" if dtype == torch.bfloat16 and N <= 64 and T > 8
                else "cudacore")
        if plan.path != want:
            raise AssertionError(f"{case}: the backward's plan is {plan}, "
                                 f"not {want}")
        tag = (B, T, H, P, N, str(dtype)[6:], offset,
               "reset" if reset else "softplus", plan.path)
        _hold_scan_bwd(tag, ms.mamba2_scan_bwd(*args), args)
    for shape in (ZAMBA2_TRAIN_SCAN, (2, 65, 3, 33, 16), (1, 1, 2, 64, 128),
                  (1, 300, 2, 100, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            plan = ms.kernel_mamba2_bwd_plan(*shape, dtype)
            if plan != ms.mamba2_bwd_plan(*shape, dtype):
                raise AssertionError(f"the backward's plan {plan} at {shape}"
                                     f", {dtype} is not the wrapper's "
                                     "mirror of it")
    B, T, H, P, N = ZAMBA2_TRAIN_SCAN
    args = _mamba2_bwd_inputs(gen, B, T, H, P, N, torch.bfloat16, offset=0)
    got = ms.mamba2_scan_bwd(*args)
    case = (B, T, H, P, N, "bfloat16", 0, "softplus")
    err = _hold_scan_bwd(case, got, args)
    again = ms.mamba2_scan_bwd(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log("mamba2_scan_bwd", check="two calls bit-identical", shape=case,
        ok=same)
    if not same:
        raise AssertionError("two scan backward calls differ: the kernel "
                             "must be deterministic")
    del got, again
    ms_ = graph_ms(lambda: ms.mamba2_scan_bwd(*args), iters=5, replays=3)
    plain_ms = cuda_ms(lambda: ref.mamba2_scan_bwd_ref(*args), iters=1,
                       warmup=0)
    flops, nbytes, instr, cflops, cbytes = _mamba2_bwd_cost(B, T, H, P, N, 2)
    t_ops = flops / PEAK_TF32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    plan = ms.mamba2_bwd_plan(B, T, H, P, N, torch.bfloat16)
    if plan.path != "chunked":
        raise AssertionError(f"zamba2's training shape takes {plan.path}")
    # the chunked form's own floor: its bf16 products or its bytes
    design_ops = cflops / PEAK_BF16_FLOPS * 1e3
    design_bytes = cbytes / PEAK_BYTES * 1e3
    log("kernel-time", name="mamba2_scan_bwd",
        shape=f"B{B}_T{T}_H{H}_P{P}_N{N}_bf16", path=plan.path,
        timing="cuda_graph_device_time", ms=f"{ms_:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms="none",
        plan=",".join(map(str, plan.as_ints())),
        bound_ms=f"{max(t_ops, t_bytes):.4f}", ops_bound_ms=f"{t_ops:.4f}",
        bytes_bound_ms=f"{t_bytes:.4f}",
        design_bound_ms=f"{max(design_ops, design_bytes):.4f}",
        design_ops_ms=f"{design_ops:.4f}",
        design_bytes_ms=f"{design_bytes:.4f}",
        gflop=f"{flops / 1e9:.3f}", design_gflop=f"{cflops / 1e9:.3f}",
        mbytes=f"{nbytes / 1e6:.2f}", design_mbytes=f"{cbytes / 1e6:.2f}",
        cudacore_ginstr=f"{instr / 1e9:.3f}",
        scratch_MB=f"{plan.scratch * 4 / 1e6:.1f}", max_abs_err=f"{err:.3e}")
    return {"name": "mamba2_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
            "replaces": "src/repro/models/ssm.py:58",
            "launches": None, "max_abs_err": err, "ms": ms_,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


# falcon-mamba-7b's selective scan in training (B, T, D = d_inner, N)
FALCON_TRAIN_SCAN = (4, 2048, 8192, 16)
# the Mamba-1 scan's backward against its plain version: f32 and bf16, N of
# one (P = 1), two (the model's 16) and sixteen lanes a channel, T of one
# step, at and around the kernel's chunks (16 steps at N = 16, 8 at N = 4
# and 128: T = Q - 1, Q, Q + 1, 2 Q + 1, one chunk, a ragged one, a ragged
# sub-chunk), below, at and past 64 and 300; D = 203 leaves every channel
# block ragged and b and c are slices of one projection at an odd column,
# so that the block's threads load every operand; h0 and dh_last nonzero.
# Then the underflow: at step 3 of every 64, dt A <= -1000 (the decay is 0)
# and x = 0.  Then the TMA route for every operand: D a multiple of 8 and
# b and c at a 16-byte aligned column, as falcon's are (N = 4 over a
# ring's 8 states).  A case: (B, T, D, N, dtype, reset, column of b in the
# projection).
SEL_BWD_CASES = (
    [(2, T, 203, N, dt, False, 7) for dt in (torch.float32, torch.bfloat16)
     for N in (4, 16, 128)
     for T in (1, 7, 8, 9, 15, 16, 17, 33, 63, 64, 65, 300)]
    + [(2, 300, 203, 16, torch.bfloat16, True, 7),
       (2, 130, 203, 4, torch.float32, True, 7),
       (1, 130, 40, 128, torch.bfloat16, True, 7)]
    + [(2, T, 256, 16, dt, False, 256) for dt in (torch.float32,
                                                   torch.bfloat16)
       for T in (1, 17, 300)]
    + [(2, 130, 256, 16, torch.bfloat16, True, 256),
       (1, 77, 512, 128, torch.bfloat16, False, 256),
       (2, 65, 256, 4, torch.float32, False, 256)])


def _sel_bwd_inputs(gen, B, T, D, N, dtype, reset=False, offset=7):
    """``_selective_inputs`` (b and c slices of one projection ``offset``
    columns in, A = -(1..N), h0 random) and the output gradients dy
    (B, T, D) and dh_last (B, D, N), float32 N(0, 1).  ``reset``: at step 3
    of every 64, dt = 1000 (dt A <= -1000: the decay underflows to 0) and
    x = 0 (so the input there is 0, not of that size)."""
    dt, x, b, c, A, h0 = _selective_inputs(gen, B, T, D, N, dtype, offset)
    if reset:
        dt[:, 3::64] = 1000.0
        x[:, 3::64] = 0
    dy = torch.randn((B, T, D), generator=gen, device="cuda")
    dh = torch.randn((B, D, N), generator=gen, device="cuda")
    return dt, x, b, c, A, h0, dy, dh


def _hold_sel_bwd(case, got, args) -> float:
    """The Mamba-1 backward under ``_hold_bwd`` (n: N for ddt and dx, D for
    db and dc, B T for dA)."""
    dt, x, b, c, A, h0, dy, dh = args
    want = ref.selective_scan_bwd_ref(dt, x.float(), b.float(), c.float(),
                                      A, h0, dy, dh)
    B, T, D = dt.shape
    return _hold_bwd("selective_scan_bwd", case, got, want, x.dtype,
                     max(b.shape[2], D, B * T))


def _sel_bwd_cost(B, T, D, N, itemsize):
    """The backward's exponentials (one a state-step) and bytes: dt, x, b,
    c, A, h0, dy and dh_last read once; ddt, dx, db, dc, dA and dh0
    written once."""
    nbytes = (2 * (4 * B * T * D + itemsize * B * T * D
                   + 2 * itemsize * B * T * N + 4 * D * N)
              + 3 * 4 * B * D * N + 4 * B * T * D)
    return B * T * D * N, nbytes


def _sel_bwd_levels(T, Q):
    """How many times the kernel evaluates each exponential, on average
    over the T steps, with chunks of Q steps: level 1 over every chunk but
    the last, level 2 over every sub-chunk of a chunk but its last, level
    3 over all."""
    SC = ms.SEL_BWD_SUB
    n = -(-T // Q)
    steps = (n - 1) * Q
    for k in range(n):
        subs = min(Q // SC, -(-(T - k * Q) // SC))
        steps += (subs - 1) * SC + min(subs * SC, T - k * Q)
    return steps / T


def phase_selective_scan_bwd(gen) -> dict:
    """The Mamba-1 scan's backward kernel against
    ``ref.selective_scan_bwd_ref`` on ``SEL_BWD_CASES``, each case's plan
    against the wrapper's mirror (and the TMA route asserted where the
    case is meant to take it for every operand, or for none); two calls
    bit-identical; timed from a CUDA graph at falcon-mamba-7b's training
    shape (B=4, T=2048, D=8192, N=16, bf16 x, b, c, every operand through
    TMA) beside its plain version, its bound and its design's own floor
    (its exponential levels, one exponential a state-step each, on the
    special-function units).  No PyTorch call computes this function
    (library "none").  Also: under grad on the card ``selective_scan`` is
    the differentiable op (one forward and one backward launch), and
    ``mamba_scan``, which has no backward, raises."""
    routes = {}
    for case in SEL_BWD_CASES:
        B, T, D, N, dtype, reset, offset = case
        args = _sel_bwd_inputs(gen, B, T, D, N, dtype, reset, offset)
        dt, x, b, c, A, h0, dy, dh = args
        plan = ms.kernel_selective_scan_bwd_plan(dt, x, b, c, dy)
        if plan != ms.selective_scan_bwd_plan(B, T, D, N, dtype,
                                              (dt, x, b, c, dy)):
            raise AssertionError(f"the backward's plan {plan} at {case} is "
                                 "not the wrapper's mirror of it")
        xb = 2 if dtype == torch.bfloat16 else 4
        want = (D % 4 == 0, D * xb % 16 == 0, D % 4 == 0, offset == 256,
                offset == 256 and (offset + N) * xb % 16 == 0)
        if plan.tma != want:
            raise AssertionError(f"the backward at {case} loads "
                                 f"{plan.tma} through TMA, not {want}")
        routes[plan.tma] = routes.get(plan.tma, 0) + 1
        tag = (B, T, D, N, str(dtype)[6:], "reset" if reset else "softplus",
               offset)
        _hold_sel_bwd(tag, ms.selective_scan_bwd(*args), args)
    log("selective_scan_bwd", check="routes",
        cases=",".join(f"{''.join('T' if f else '-' for f in k)}:{v}"
                       for k, v in routes.items()))
    args = _sel_bwd_inputs(gen, 1, 20, 16, 16, torch.bfloat16)
    ins = [t.clone().requires_grad_() for t in args[:6]]
    before = (ms.selective_scan.launches, ms.selective_scan_bwd.launches)
    y, h = ms.selective_scan(*ins)
    got = torch.autograd.grad((y * args[6]).sum() + (h * args[7]).sum(), ins)
    if (ms.selective_scan.launches - before[0],
            ms.selective_scan_bwd.launches - before[1]) != (1, 1):
        raise AssertionError("selective_scan under grad did not run one "
                             "forward and one backward launch")
    _hold_sel_bwd((1, 20, 16, 16, "bfloat16", "op"), got, args)
    decay, u, c = _scan_inputs(gen, 1, 20, 16, 16)
    try:
        ms.mamba_scan(decay.requires_grad_(), u, c)
    except NotImplementedError:
        pass
    else:
        raise AssertionError("mamba_scan ran under grad on a card without "
                             "a backward")
    B, T, D, N = FALCON_TRAIN_SCAN
    args = _sel_bwd_inputs(gen, B, T, D, N, torch.bfloat16, offset=256)
    dt, x, b, c, A, h0, dy, dh = args
    plan = ms.kernel_selective_scan_bwd_plan(dt, x, b, c, dy)
    if plan != ms.selective_scan_bwd_plan(B, T, D, N, torch.bfloat16,
                                          (dt, x, b, c, dy)):
        raise AssertionError(f"the backward's plan {plan} at falcon's shape "
                             "is not the wrapper's mirror of it")
    got = ms.selective_scan_bwd(*args)
    case = (B, T, D, N, "bfloat16", "softplus", 256)
    err = _hold_sel_bwd(case, got, args)
    again = ms.selective_scan_bwd(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log("selective_scan_bwd", check="two calls bit-identical", shape=case,
        ok=same)
    if not same:
        raise AssertionError("two selective scan backward calls differ: the "
                             "kernel must be deterministic")
    del got, again
    ms_ = graph_ms(lambda: ms.selective_scan_bwd(*args), iters=5, replays=3)
    plain_ms = cuda_ms(lambda: ref.selective_scan_bwd_ref(*args), iters=1,
                       warmup=0)
    exps, nbytes = _sel_bwd_cost(B, T, D, N, 2)
    t_ops = exps / PEAK_SFU_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    levels = _sel_bwd_levels(T, plan.chunk)
    log("kernel-time", name="selective_scan_bwd",
        shape=f"B{B}_T{T}_D{D}_N{N}_bf16", timing="cuda_graph_device_time",
        ms=f"{ms_:.4f}", plain_ms=f"{plain_ms:.4f}", library_ms="none",
        plan=",".join(map(str, plan.as_ints())),
        tma=",".join(n for n, f in zip(ms.SEL_BWD_OPERANDS, plan.tma) if f)
        or "none",
        bound_ms=f"{max(t_ops, t_bytes):.4f}", sfu_bound_ms=f"{t_ops:.4f}",
        bytes_bound_ms=f"{t_bytes:.4f}", exp_levels=f"{levels:.4f}",
        design_sfu_ms=f"{levels * t_ops:.4f}", mexp=f"{exps / 1e6:.1f}",
        mbytes=f"{nbytes / 1e6:.2f}",
        scratch_MB=f"{plan.scratch * 4 / 1e6:.1f}", max_abs_err=f"{err:.3e}")
    return {"name": "selective_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
            "replaces": "src/repro/models/ssm.py:58",
            "launches": None, "max_abs_err": err, "ms": ms_,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


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


# grouped-mm cases: widths K x N (the transposed form reads W (G, N, K));
# rows before the first segment and after the last (under EP, the other
# experts' rows); each segment's length and its kept prefix.  Segments of
# length 0 and 1, kept prefixes shorter than their segments, rows and
# widths that are not tile multiples (qwen2-moe's TP shard of 88 columns,
# its 1408-wide ffn, llama4's 5120 x 8192 experts under EP), every row
# dropped, a decode step's 16 rows over 60 experts, qwen2-moe's TP down
# product (a k depth of 88, shorter than two 64-deep stages), and segments
# that start at rows no multiple of 8 with lengths and kept prefixes on
# either side of the 64-row stage and the 128-row tile
GMM_CASES = {
    "short_and_empty": dict(K=2048, N=1408, lead=0, tail=0,
                            counts=(0, 1, 3, 0, 200, 129),
                            kept=(0, 1, 3, 0, 200, 129)),
    "drops": dict(K=1408, N=2048, lead=0, tail=0,
                  counts=(300, 17, 129, 64, 1), kept=(128, 17, 0, 33, 1)),
    "tp_shard": dict(K=2048, N=88, lead=0, tail=0,
                     counts=tuple(e * 37 % 71 for e in range(60)),
                     kept=tuple(min(e * 37 % 71, 40) for e in range(60))),
    "ep": dict(K=5120, N=8192, lead=301, tail=77,
               counts=(40, 0, 77, 1, 129, 3, 0, 255),
               kept=(40, 0, 50, 1, 128, 3, 0, 200)),
    "all_dropped": dict(K=1408, N=2048, lead=5, tail=3,
                        counts=(10, 20, 5, 30), kept=(0, 0, 0, 0)),
    "decode": dict(K=2048, N=1408, lead=0, tail=0,
                   counts=tuple(2 if e % 15 == 0 else 1 if e % 7 == 3 else 0
                                for e in range(60)),
                   kept=tuple(min(1, int(e % 15 == 0 or e % 7 == 3))
                              for e in range(60))),
    "tp_down": dict(K=88, N=2048, lead=0, tail=0,
                    counts=tuple(e * 37 % 71 for e in range(60)),
                    kept=tuple(min(e * 37 % 71, 40) for e in range(60))),
    "stage_edges": dict(K=1408, N=200, lead=5, tail=11,
                        counts=(63, 64, 65, 127, 128, 129, 257),
                        kept=(63, 50, 65, 100, 128, 129, 200)),
}
# against the plain version on the same inputs: float32 differs by the
# order of its sums, bf16 by one rounding of the output
GMM_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def gmm_segments(case: str) -> tuple[int, torch.Tensor, torch.Tensor, int]:
    """(R, start, kept, capacity) of a ``GMM_CASES`` entry: int64 on the
    CPU; the capacity the largest kept prefix (at least 1)."""
    c = GMM_CASES[case]
    counts = torch.tensor(c["counts"], dtype=torch.int64)
    start = c["lead"] + torch.cumsum(counts, 0) - counts
    R = c["lead"] + int(counts.sum()) + c["tail"]
    return R, start, torch.tensor(c["kept"], dtype=torch.int64), max(
        1, max(c["kept"]))


def _kept_mask(R, start, kept) -> torch.Tensor:
    """(R,) bool: the rows some segment's kept prefix holds."""
    mask = torch.zeros(R, dtype=torch.bool, device=start.device)
    for s, n in zip(start.tolist(), kept.tolist()):
        mask[s:s + n] = True
    return mask


def nan_outside(t, start, kept):
    """``t`` with every row outside the segments' kept prefixes NaN: rows
    the kernels must neither read into a sum nor let into an output."""
    return t.masked_fill(~_kept_mask(t.shape[0], start, kept)[:, None],
                         float("nan"))


def zero_outside(y, start, kept) -> bool:
    """Whether every row of ``y`` outside the kept prefixes is exactly 0."""
    return bool((y[~_kept_mask(y.shape[0], start, kept)] == 0).all())


def _gmm_cost(R_kept, K, N, n_used, R, itemsize):
    """FLOPs of the kept rows' products and the bytes the function must
    move: the kept rows of x, the weights of the experts that keep a row,
    the whole output (its zeros too)."""
    flops = 2 * R_kept * K * N
    nbytes = itemsize * (R_kept * K + n_used * K * N + R * N)
    return flops, nbytes


def _gmm_served(gen, N_tok, cf=1.25):
    """qwen2-moe's segments for ``N_tok`` tokens: top-4 of 60 experts from
    random router probabilities, sorted and cut at its capacity by the
    layer's own ``moe.dispatch``; (R, start, kept, C, counts)."""
    E, k = 60, 4
    probs = torch.rand((N_tok, E), generator=gen, device="cuda")
    experts = probs.topk(k, dim=-1).indices
    C = moe.capacity(cf, k, N_tok, E)
    _, _, (start, kept) = moe.dispatch(experts, E, C)
    counts = torch.bincount(experts.reshape(-1), minlength=E)
    return N_tok * k, start, kept, C, counts


def _library_grouped_mm(x, w, counts, transposed=False):
    """``torch._grouped_mm`` over the same segments with every row kept,
    where this torch has it (else None): the weight handed over
    column-major, as its CUTLASS path wants (a (G, N, K) weight read
    transposed already is)."""
    if not hasattr(torch, "_grouped_mm"):
        return None
    offs = torch.cumsum(counts, 0).to(torch.int32)
    wt = (w.transpose(1, 2) if transposed
          else w.transpose(1, 2).contiguous().transpose(1, 2))
    return lambda: torch._grouped_mm(x, wt, offs=offs)


def _library_grouped_mm_wgrad(a, b, counts):
    """``torch._grouped_mm``'s 2d x 2d form, its groups along the shared
    dim: ``a[seg].T @ b[seg]`` for every segment, every row kept (None
    where this torch lacks it)."""
    if not hasattr(torch, "_grouped_mm"):
        return None
    offs = torch.cumsum(counts, 0).to(torch.int32)
    return lambda: torch._grouped_mm(a.t(), b, offs=offs)


def _gmm_timed(name, shape, fn, plain, lib, full, flops, nbytes, tol):
    """Time a grouped product at a full shape from a CUDA graph beside its
    plain version and the library call; hold its output to the plain
    version's and the library's (every row kept) to ``full``, the kernel's
    with every row kept, at ``tol``.  Returns (ms, plain_ms, bound_ms,
    bound_by, library_ms, max_abs_err)."""
    got = fn()
    want = plain()
    err = _held(name, shape, got, want, tol)
    del got, want
    ms_ = graph_ms(fn)
    plain_ms = cuda_ms(plain, iters=3, warmup=1)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    library_ms = lib_err = None
    if lib is not None:
        kernel_all = full()
        lib_err = _held(f"{name}_vs_torch._grouped_mm", shape, lib(),
                        kernel_all, tol)
        del kernel_all
        library_ms = graph_ms(lib)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    log("kernel-time", name=name, shape=shape, ms=f"{ms_:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{max(t_ops, t_bytes):.4f}",
        bound_by=bound_by, gflop=f"{flops / 1e9:.2f}",
        mbytes=f"{nbytes / 1e6:.2f}", tflops=f"{flops / ms_ / 1e9:.2f}",
        max_abs_err=f"{err:.3e}",
        library_ms=("none" if library_ms is None else f"{library_ms:.4f}"),
        library_max_abs_diff=("none" if lib_err is None
                              else f"{lib_err:.3e}"))
    return ms_, plain_ms, max(t_ops, t_bytes), bound_by, library_ms, err


def phase_grouped_mm(gen) -> list[dict]:
    """``grouped_mm`` (both weight layouts) and ``grouped_mm_wgrad`` against
    ``ref.grouped_mm_ref`` / ``ref.grouped_mm_wgrad_ref`` on ``GMM_CASES``
    in float32 and bf16 (``GMM_TOL``), with every row outside the kept
    prefixes of x and dy NaN and those rows of the output exactly zero, two
    calls bit-identical; then held to the plain versions and timed from a
    CUDA graph at qwen2-moe's decode step (4 tokens, 16 rows: the gate/up
    product, bound by the used experts' weights), served
    prefill (4 x 1100 tokens, R = 17,600: the gate/up product 2048 -> 1408
    and the down product 1408 -> 2048) and trained shapes (4 x 2048 tokens,
    R = 32,768: the forward, the dX form and the weight gradient), beside
    the bound over the kept rows, the plain version and
    ``torch._grouped_mm`` with every row kept, itself held to the kernel
    with every row kept (none where this torch lacks it)."""
    worst = {"grouped_mm": 0.0, "grouped_mm_wgrad": 0.0}
    for case, c in GMM_CASES.items():
        R, start, kept, cap = gmm_segments(case)
        start, kept = start.cuda(), kept.cuda()
        G = len(c["counts"])
        for dtype in (torch.float32, torch.bfloat16):
            K, N = c["K"], c["N"]
            # the rows outside the kept prefixes are NaN: the kernels must
            # give exact zeros there and keep them out of every sum
            x = nan_outside(_rand(gen, (R, K), dtype), start, kept)
            dy = nan_outside(_rand(gen, (R, N), dtype), start, kept)
            for transposed in (False, True):
                shape = (G, N, K) if transposed else (G, K, N)
                w = (torch.randn(shape, generator=gen, device="cuda")
                     * K ** -0.5).to(dtype)
                got = gm.grouped_mm(x, w, start, kept, cap,
                                    transposed=transposed)
                again = gm.grouped_mm(x, w, start, kept, cap,
                                      transposed=transposed)
                want = ref.grouped_mm_ref(x, w, start, kept, transposed)
                name = f"{case}_{str(dtype)[6:]}" + ("_T" if transposed
                                                     else "")
                err = _held("grouped_mm", name, got, want, GMM_TOL[dtype])
                worst["grouped_mm"] = max(worst["grouped_mm"], err)
                if not zero_outside(got, start, kept):
                    raise AssertionError(f"grouped_mm {name}: a row outside "
                                         "the kept prefixes is not zero")
                if not torch.equal(got, again):
                    raise AssertionError(f"grouped_mm {name}: two calls "
                                         "differ")
                del w, got, again, want
            got = gm.grouped_mm_wgrad(x, dy, start, kept, cap)
            again = gm.grouped_mm_wgrad(x, dy, start, kept, cap)
            want = ref.grouped_mm_wgrad_ref(x, dy, start, kept)
            err = _held("grouped_mm_wgrad", f"{case}_{str(dtype)[6:]}", got,
                        want, GMM_TOL[dtype])
            worst["grouped_mm_wgrad"] = max(worst["grouped_mm_wgrad"], err)
            if not torch.equal(got, again):
                raise AssertionError(f"grouped_mm_wgrad {case}: two calls "
                                     "differ")
            del x, dy, got, again, want
    torch.cuda.empty_cache()

    bf = torch.bfloat16
    tol = GMM_TOL[bf]
    records = {}
    for label, N_tok in (("decode", 4), ("served", 4 * max(PROMPT_LENS)),
                         ("trained", TRAIN_BATCH * TRAIN_SEQ)):
        R, start, kept, C, counts = _gmm_served(gen, N_tok)
        R_kept = int(kept.sum())
        n_used = int((kept > 0).sum())
        x = _rand(gen, (R, 2048), bf)
        for K, N, transposed in ((2048, 1408, False), (1408, 2048, False),
                                 (1408, 2048, True)):
            if label != "trained" and transposed:
                continue                     # serving runs no backward
            if label == "decode" and K != 2048:
                continue                     # one product: the weights' bytes
            xk = x[:, :K].contiguous()
            w = (torch.randn((60, N, K) if transposed else (60, K, N),
                             generator=gen, device="cuda") * K ** -0.5
                 ).to(bf)
            shape = (f"{label}_R{R}_kept{R_kept}_K{K}_N{N}_G60_C{C}"
                     f"{'_T' if transposed else ''}_bf16")
            timed = _gmm_timed(
                "grouped_mm", shape,
                lambda: gm.grouped_mm(xk, w, start, kept, C,
                                      transposed=transposed),
                lambda: ref.grouped_mm_ref(xk, w, start, kept, transposed),
                _library_grouped_mm(xk, w, counts, transposed),
                lambda: gm.grouped_mm(xk, w, start, counts, R,
                                      transposed=transposed),
                *_gmm_cost(R_kept, K, N, n_used, R, 2), tol)
            worst["grouped_mm"] = max(worst["grouped_mm"], timed[5])
            if label == "served" and not transposed and K == 2048:
                records["grouped_mm"] = timed
            del w
        if label == "trained":
            dy = _rand(gen, (R, 1408), bf)
            flops, nbytes = _gmm_cost(R_kept, 2048, 1408, 0, 0, 2)
            nbytes += 2 * (R_kept * 1408 + 60 * 2048 * 1408)
            timed = _gmm_timed(
                "grouped_mm_wgrad",
                f"{label}_R{R}_kept{R_kept}_M2048_N1408_G60_C{C}_bf16",
                lambda: gm.grouped_mm_wgrad(x, dy, start, kept, C),
                lambda: ref.grouped_mm_wgrad_ref(x, dy, start, kept),
                _library_grouped_mm_wgrad(x, dy, counts),
                lambda: gm.grouped_mm_wgrad(x, dy, start, counts, R),
                flops, nbytes, tol)
            worst["grouped_mm_wgrad"] = max(worst["grouped_mm_wgrad"],
                                            timed[5])
            records["grouped_mm_wgrad"] = timed
            del dy
        del x
    torch.cuda.empty_cache()
    out = []
    for name in ("grouped_mm", "grouped_mm_wgrad"):
        ms_, plain_ms, bound_ms, bound_by, library_ms, _ = records[name]
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/grouped_mm.cu",
                    "replaces": "src/repro/models/moe.py:74",
                    "launches": None, "max_abs_err": worst[name],
                    "ms": ms_, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": library_ms})
    return out


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


def _moe_layer_cost(cfg, N, rows, itemsize):
    """FLOPs of the router, the grouped FFN over ``rows`` assignments (the
    kept ones: what the layer must compute; or every E x C slot of the
    reference's buffer) and the shared MLP; bytes of x, the weights and the
    output, each once."""
    d, E, f, fs = cfg.d_model, cfg.n_experts, cfg.moe_d_ff, \
        cfg.shared_expert_d_ff
    flops = 2 * N * d * E + 6 * rows * d * f + 6 * N * d * fs
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
            flops, nbytes = _moe_layer_cost(cfg, N, int(want_keep.sum()),
                                            2)
            t_ops = flops / PEAK_BF16_FLOPS * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            p_flops, p_bytes = _moe_layer_cost(cfg, N, E * C, 2)
            padded = max(p_flops / PEAK_BF16_FLOPS, p_bytes / PEAK_BYTES)
            timing = dict(
                ms=f"{ms_:.4f}", plain_ms=f"{plain_ms:.4f}",
                bound_ms=f"{max(t_ops, t_bytes):.4f}",
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                padded_slots_bound_ms=f"{padded * 1e3:.4f}",
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
    prefill (decode self-attention is plain PyTorch), and for the VLM once
    per cross block in prefill and in every decode step (over the cached
    media K/V); the scan (``selective_scan`` for Mamba-1, ``mamba2_scan``
    for Mamba-2) once per Mamba layer in prefill and in every decode step;
    the hybrid's flash once per application of a shared block in
    prefill; the MoE family's three grouped products per MoE layer in
    prefill and in every decode step."""
    want = dict.fromkeys(COUNTED, 0)
    want["grouped_mm"] = 3 * _moe_layers(cfg) * (1 + decode_steps)
    if cfg.family in ("ssm", "hybrid"):
        scan = "selective_scan" if cfg.mamba_version == 1 else "mamba2_scan"
        want[scan] = cfg.n_layers * (1 + decode_steps)
        if cfg.family == "hybrid":
            want["flash_attention"] = cfg.n_layers // cfg.attn_every
    else:
        want["flash_attention"] = cfg.n_layers
    if cfg.family == "vlm":
        n_cross = cfg.n_layers // cfg.cross_attn_every
        want["flash_attention"] += n_cross * (1 + decode_steps)
    return want


def _init_params(model, seed=0):
    """Random weights from a seeded generator on the card; the VLM's cross
    gates set to ``VLM_GATE``."""
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    if "cross_blocks" in params:
        params["cross_blocks"]["gate"].fill_(VLM_GATE)
    return params


def _random_media(cfg, gen, batch=4):
    """N(0, 1) float32 stub-frontend output for the VLM and audio families
    (None for the others)."""
    if not cfg.n_media_tokens:
        return None
    return torch.randn((batch, cfg.n_media_tokens, cfg.media_embed_dim),
                       generator=gen, device="cuda")


def _first_prefills(engine, prompts, media) -> dict[str, str]:
    """Two calls at the served shapes before the served run, so that it
    reads the steady prefill: the first after the short warm-up (new
    allocator segments and each kernel's first launch at these shapes),
    then one after ``empty_cache`` (the segments again, every kernel
    already loaded).  For each: its prefill's host-clock time, and over
    the whole call (prefill and 2 decode steps) the host-clock time, the
    process's CPU time (well below the host clock: the process waited off
    the CPU), the time in Python's garbage collector and the device
    allocations (``cudaMalloc`` calls)."""
    gc_s = [0.0, 0.0]

    def gc_timer(phase, info):
        if phase == "start":
            gc_s[1] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_s[1]

    out = {}
    gc.callbacks.append(gc_timer)
    try:
        for name in ("first", "regrow"):
            if name == "regrow":
                torch.cuda.empty_cache()
            torch.cuda.synchronize()
            n0 = torch.cuda.memory_stats().get("num_device_alloc", 0)
            gc_s[0] = 0.0
            t0, c0 = time.perf_counter(), time.process_time()
            engine.generate(prompts, max_new=2, media=media)
            torch.cuda.synchronize()
            wall, cpu = time.perf_counter() - t0, time.process_time() - c0
            n1 = torch.cuda.memory_stats().get("num_device_alloc", 0)
            out[f"{name}_prefill_ms"] = (
                f"{engine.timing['prefill_s'] * 1e3:.2f}")
            out[f"{name}_call_ms"] = f"{wall * 1e3:.2f}"
            out[f"{name}_call_cpu_ms"] = f"{cpu * 1e3:.2f}"
            out[f"{name}_call_gc_ms"] = f"{gc_s[0] * 1e3:.2f}"
            out[f"{name}_device_allocs"] = str(n1 - n0)
    finally:
        gc.callbacks.remove(gc_timer)
    return out


def phase_serve(arch, gen) -> tuple:
    cfg = registry.get(arch)
    model = model_lib.build(cfg, "cuda")
    t0 = time.perf_counter()
    params = _init_params(model)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log("serve-init", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, params_B=f"{n_params / 1e9:.3f}",
        weights_GB=f"{sum(p.nbytes for p in _leaves(params)) / 1e9:.2f}",
        seconds=f"{time.perf_counter() - t0:.1f}")
    engine = Engine(model, params, ServeConfig(max_batch=4, max_len=MAX_LEN,
                                               eos_token=-1))
    engine.keep_step_logits = True    # read by the checks below
    # eos -1: no slot stops early, so every slot decodes MAX_NEW steps
    engine.generate([[5, 6, 7]] * 4, max_new=2)          # warm-up
    prompts = _prompts(gen, cfg.vocab_size)
    media = _random_media(cfg, gen)
    first = _first_prefills(engine, prompts, media)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    outs = engine.generate(prompts, max_new=MAX_NEW, media=media)
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
        launches=repr(counts).replace(" ", ""), **first)
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
    return model, params, engine, prompts, outs, counts, media


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


def _teacher_forced(model, params, prompts, outs, media=None) -> list:
    """The logits ``Engine.generate`` produces for these tokens: prefill of
    the left-padded prompts (and the media), then one decode step per
    generated token."""
    plen, toks = _padded(prompts, outs)
    with torch.no_grad():
        lg, cache = model.prefill(params, model.init_cache(len(prompts),
                                                           MAX_LEN),
                                  toks[:, :plen], media)
        steps = [lg[:, -1]]
        for j in range(MAX_NEW - 1):
            lg, cache = model.decode_step(params, cache,
                                          toks[:, plen + j:plen + j + 1])
            steps.append(lg[:, -1])
    return steps


def _against_forward(model, params, prompts, outs, step_logits,
                     media=None):
    """Per-step relative L2 and max-abs fraction of the step logits against
    the teacher-forced forward at the same positions (audio's forward
    strips its conditioning frames, so the positions are the tokens'), and
    the greedy agreement."""
    plen, toks = _padded(prompts, outs)
    batch = {"tokens": toks}
    if media is not None:
        batch["media"] = media
    with torch.no_grad():
        full = model.forward(params, batch)
    rels, fracs, agree, n = [], [], 0, 0
    for j, lg in enumerate(step_logits[:MAX_NEW]):
        want = full[:, plen - 1 + j].float()
        d = lg.float() - want
        rels.append((d.norm() / want.norm()).item())
        fracs.append((d.abs().max() / want.abs().max()).item())
        agree += int((lg.argmax(-1) == want.argmax(-1)).sum())
        n += lg.shape[0]
    return rels, fracs, f"{agree}/{n}"


def _rounding_sensitivity(model, params, prompts, media=None) -> float:
    """Relative change of the last logits when the last position's input
    embedding is scaled by 1 + 2^-8 (at most one bf16 ulp): how far the
    model's own rounding noise reaches its output."""
    plen = max(len(p) for p in prompts)
    toks = torch.tensor([[0] * (plen - len(p)) + p for p in prompts],
                        device="cuda")
    cfg = model.cfg
    batch = {"tokens": toks}
    if media is not None:
        batch["media"] = media

    def last_logits(x):
        T = x.shape[1]                       # audio: the frames and tokens
        pos = torch.arange(T, device="cuda")[None].expand(len(x), T)
        if cfg.family == "ssm":
            h = model._run_ssm(params, x)
        elif cfg.family == "hybrid":
            h = model._run_hybrid(params, x, pos)
        else:
            mtok = (model._media_tokens(params, media, x.dtype)
                    if cfg.family == "vlm" else None)
            h = model._run_decoder(params, x, pos, mtok=mtok)
        h = layers.rms_norm(h[:, -1:], params["final_norm"], cfg.norm_eps)
        return model._unembed(params, h).float()

    with torch.no_grad():
        x = model.embed_inputs(params, batch)
        xp = x.clone()
        xp[:, -1] = (xp[:, -1].float() * (1 + 2 ** -8)).to(x.dtype)
        a, b = last_logits(x), last_logits(xp)
    return ((b - a).norm() / a.norm()).item()


def _fmt(xs) -> str:
    return "[" + ",".join(f"{x:.2e}" for x in xs) + "]"


def phase_decode_vs_forward(model, params, engine, prompts, outs,
                            media=None) -> None:
    """The served bf16 logits against the forward's (with the served
    media).  A dense, VLM or audio model is held at every step.  A Mamba
    or hybrid model carries each decode step's bf16 rounding in its state,
    so only its prefill step (no carried state yet) is held here; that
    step runs the forward's kernels on the forward's values and reads 0,
    so it holds only that prefill's last position is the forward's.
    ``phase_decode_vs_forward_f32`` holds every step of its cached path."""
    cfg = model.cfg
    rels, fracs, agree = _against_forward(model, params, prompts, outs,
                                          engine.step_logits, media)
    held = len(rels) if cfg.family not in ("ssm", "hybrid") else 1
    worst_rel, worst_frac = max(rels[:held]), max(fracs[:held])
    noise = _rounding_sensitivity(model, params, prompts, media)
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


def phase_determinism(engine, prompts, outs, media=None) -> None:
    """A second ``generate`` of the same prompts (and media): identical
    tokens and bit-identical step logits."""
    first = [lg.clone() for lg in engine.step_logits]
    again = engine.generate(prompts, max_new=MAX_NEW, media=media)
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
# batched products (decode's plain attention's two einsums) and the index
# ops of MoE dispatch (and of the embedding lookup)
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


@contextlib.contextmanager
def _timed_cross_blocks(spans: list):
    """``Model._cross_layer`` with a pair of CUDA events around each call,
    appended to ``spans``: the device time of the VLM's cross blocks (norm,
    q and o projections, the cross flash launch, the gate), read after a
    synchronize."""
    cross = model_lib.Model._cross_layer

    def timed(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = cross(self, *args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    model_lib.Model._cross_layer = timed
    try:
        yield
    finally:
        model_lib.Model._cross_layer = cross


def phase_profile(model, params, prompts, media=None) -> None:
    """Where the time goes: one prefill and one decode step under
    torch.profiler; device busy share = kernel time / host wall time (the
    profiler's own overhead lengthens the wall time, so the share is a
    lower bound).  For the VLM also the cross blocks' device time
    (``_timed_cross_blocks``; its flash launches are within ``flash_ms``
    too)."""
    from torch.profiler import ProfilerActivity, profile
    plen = max(len(p) for p in prompts)
    toks = torch.tensor([[0] * (plen - len(p)) + p for p in prompts],
                        device="cuda")
    for name in ("prefill", "decode"):
        cache = model.init_cache(len(prompts), MAX_LEN)
        if name == "decode":
            _, cache = model.prefill(params, cache, toks, media)
        torch.cuda.synchronize()
        spans: list = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                _timed_cross_blocks(spans):
            t0 = time.perf_counter()
            if name == "prefill":
                model.prefill(params, cache, toks, media)
            else:
                model.decode_step(params, cache, toks[:, -1:], media)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        cross_ms = sum(a.elapsed_time(b) for a, b in spans)
        cross = ({"cross_block_ms": f"{cross_ms:.2f}",
                  "cross_blocks": len(spans)} if spans else {})
        kernels: dict[str, list] = {}
        for ev in prof.events():
            if str(getattr(ev, "device_type", "")).endswith("CUDA"):
                rec = kernels.setdefault(ev.name, [0.0, 0])
                rec[0] += ev.time_range.elapsed_us()
                rec[1] += 1
        dev_us = sum(us for us, _ in kernels.values())
        flash_us = sum(us for n, (us, _) in kernels.items() if "fa_fwd" in n)
        scan_us = sum(us for n, (us, _) in kernels.items()
                      if "selective_" in n or "mamba2_" in n)
        gmm_us = sum(us for n, (us, _) in kernels.items()
                     if "grouped_mm" in n)
        log("profile", arch=model.cfg.name, step=name,
            wall_ms=f"{wall_us / 1e3:.2f}",
            device_ms=(f"{dev_us / 1e3:.2f}" if dev_us else "not_measured"),
            busy_share=(f"{dev_us / wall_us:.3f}" if dev_us else
                        "not_measured"),
            device_events=sum(n for _, n in kernels.values()),
            flash_ms=f"{flash_us / 1e3:.2f}", scan_ms=f"{scan_us / 1e3:.2f}",
            gmm_ms=f"{gmm_us / 1e3:.2f}", **_op_split(prof), **cross)
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
    want_counts = {**dict.fromkeys(COUNTED, 0), "mamba_scan": 1,
                   "selective_scan": 1, "lut_matmul": 1}
    if counts != want_counts:
        raise AssertionError(f"entry-point launches {counts} != "
                             f"{want_counts}")
    return counts


def _bwd_cost(B, Tq, Tk, H, K, D, itemsize, causal=True):
    """The gradient's five Tq x Tk x D products over the pairs a query
    sees (the causal ones, or all), and the bytes of q, k, v, o, dO and
    the LSE read once and dQ, dK, dV written once."""
    pairs = Tq * (Tq + 1) // 2 if causal else Tq * Tk
    flops = 5 * 2 * D * pairs * B * H
    nbytes = (itemsize * D * (4 * B * Tq * H + 4 * B * Tk * K)
              + 4 * B * H * Tq)
    return flops, nbytes


def phase_flash_backward(gen) -> dict:
    """The backward kernel and the forward's LSE against their plain
    versions; timed at granite-3-2b's, qwen2-moe-a2.7b's, zamba2-2.7b's
    and the VLM's cross-attention training shapes."""
    for (B, Tq, Tk, H, K, D, dt, window, softcap, causal) in BWD_CASES:
        q, do = _rand(gen, (B, Tq, H, D), dt), _rand(gen, (B, Tq, H, D), dt)
        k, v = _rand(gen, (B, Tk, K, D), dt), _rand(gen, (B, Tk, K, D), dt)
        kw = dict(window=window, softcap=softcap, causal=causal)
        o, lse = fa.flash_attention_lse(q, k, v, **kw)
        o0 = fa.flash_attention_gqa(q, k, v, **kw)
        _, want_lse = ref.flash_attention_gqa_ref(q, k, v, return_lse=True,
                                                  **kw)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        case = (B, Tq, Tk, H, K, D, str(dt)[6:], window, softcap, causal)
        if not torch.equal(o, o0):
            raise AssertionError(f"forward with LSE changed o at {case}")
        _held("flash_attention_lse", case, lse, want_lse, LSE_TOL)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            _held("flash_attention_bwd", case + (name,), g, w, BWD_TOL[dt])
    # timed at the training shapes of granite-3-2b (the record),
    # qwen2-moe-a2.7b, zamba2-2.7b (D = 80) and the VLM's cross-attention
    rec = _time_flash_bwd(gen, *TRAIN_ATTN)
    _time_flash_bwd(gen, *MOE_TRAIN_ATTN)
    _time_flash_bwd(gen, *ZAMBA2_TRAIN_ATTN)
    B, Tq, Tk, H, K, D = VLM_CROSS_TRAIN_ATTN
    _time_flash_bwd(gen, B, Tq, H, K, D, Tk=Tk, causal=False)
    return rec


def _time_flash_bwd(gen, B, T, H, K, D, Tk=None, causal=True) -> dict:
    """The backward at one bf16 shape (T queries over ``Tk``, default T,
    keys) against its plain version; two calls must be bit-identical; timed
    beside SDPA's backward and the forward with and without the LSE;
    returned as a kernels record."""
    Tk = T if Tk is None else Tk
    kw = dict(causal=causal)
    q, do = (_rand(gen, (B, T, H, D), torch.bfloat16) for _ in range(2))
    k, v = (_rand(gen, (B, Tk, K, D), torch.bfloat16) for _ in range(2))
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    shape = (f"B{B}_T{T}_H{H}_K{K}_D{D}_bf16_causal" if causal else
             f"B{B}_Tq{T}_Tk{Tk}_H{H}_K{K}_D{D}_bf16_noncausal")
    err = max(_held("flash_attention_bwd", (shape, n), g, w,
                    BWD_TOL[torch.bfloat16])
              for n, g, w in zip(("dq", "dk", "dv"), got, want))
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log("flash_attention_bwd", check="two calls bit-identical",
        shape=shape, ok=same)
    if not same:
        raise AssertionError("two backward calls differ: the kernel must be "
                             "deterministic")
    del got, want, again
    plain_ms = cuda_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse,
                                                           do, **kw), iters=3)
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    doh = do.transpose(1, 2).contiguous()

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                              enable_gqa=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qh, kh, vh), doh)

    def kernel():
        fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)

    ks, fbs, fs = [], [], []
    for _ in range(3):                      # in turns
        ks.append(cuda_ms(kernel))
        fbs.append(cuda_ms(sdpa_fwd_bwd))
        fs.append(cuda_ms(sdpa_fwd))
    ms_ = statistics.median(ks)
    library_ms = statistics.median(fbs) - statistics.median(fs)
    # the forward at the same shape, with the LSE (training) and without
    fwd_lse_ms, fwd_ms = in_turns(
        lambda: fa.flash_attention_lse(q, k, v, **kw),
        lambda: fa.flash_attention_gqa(q, k, v, **kw))
    flops, nbytes = _bwd_cost(B, T, Tk, H, K, D, 2, causal)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    # the kernel forms S and dP twice (dK/dV and dQ kernels, no atomics):
    # seven T^2 D products where the bound counts five
    log("kernel-time", name="flash_attention_bwd", shape=shape,
        ms=f"{ms_:.4f}",
        ms_range=f"[{min(ks):.4f},{max(ks):.4f}]", plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{library_ms:.4f}",
        sdpa_fwd_bwd_ms=f"{statistics.median(fbs):.4f}",
        sdpa_fwd_ms=f"{statistics.median(fs):.4f}",
        bound_ms=f"{max(t_ops, t_bytes):.4f}", ops_bound_ms=f"{t_ops:.4f}",
        design_bound_ms=f"{max(1.4 * t_ops, t_bytes):.4f}",
        bytes_bound_ms=f"{t_bytes:.4f}", gflop=f"{flops / 1e9:.2f}",
        mbytes=f"{nbytes / 1e6:.2f}", tflops=f"{flops / ms_ / 1e9:.2f}",
        max_abs_err=f"{err:.3e}")
    # the forward's bound: q.k and p.v over the unmasked pairs, q, k, v
    # read and o written once, and the LSE written (with it)
    fflops, fbytes = attn_cost(B, T, Tk, H, K, D, 2, causal)
    f_ops = fflops / PEAK_BF16_FLOPS * 1e3
    f_bytes = (fbytes + 4 * B * H * T) / PEAK_BYTES * 1e3
    log("kernel-time", name="flash_attention_fwd_train_shape", shape=shape,
        with_lse_ms=f"{fwd_lse_ms[0]:.4f}", with_lse_range=_range(fwd_lse_ms),
        without_lse_ms=f"{fwd_ms[0]:.4f}", without_lse_range=_range(fwd_ms),
        with_lse_bound_ms=f"{max(f_ops, f_bytes):.4f}",
        bound_by="operations" if f_ops >= f_bytes else "bytes",
        ops_bound_ms=f"{f_ops:.4f}", bytes_bound_ms=f"{f_bytes:.4f}")
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/layers.py:71",
            "launches": None, "max_abs_err": err, "ms": ms_,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def _kernel_share(prof, wall_us, label) -> None:
    """Busy share, the top kernels, and device time by kind (GEMMs, the
    MoE experts' grouped products, flash forward and backward, the scans'
    forward and backward, the rest: elementwise, copies, reductions) of
    one profiled region."""
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
                  if "grouped_mm" not in n
                  and any(w in n for w in ("nvjet", "gemm", "xmma", "cutlass")))
    scan_bwd_us = sum(us for n, (us, _) in kernels.items()
                      if "mamba2_bwd" in n or "selective_bwd" in n)
    scan_fwd_us = sum(us for n, (us, _) in kernels.items()
                      if ("mamba2_" in n or "selective_" in n)
                      and "mamba2_bwd" not in n and "selective_bwd" not in n)
    scan_us = scan_fwd_us + scan_bwd_us
    # the MoE experts' grouped products, out of "other" before the GEMMs
    gmm_us = sum(us for n, (us, _) in kernels.items() if "grouped_mm" in n)
    other_us = dev_us - gemm_us - gmm_us - fwd_us - bwd_us - scan_us
    log("profile", step=label, wall_ms=f"{wall_us / 1e3:.2f}",
        device_ms=(f"{dev_us / 1e3:.2f}" if dev_us else "not_measured"),
        busy_share=(f"{dev_us / wall_us:.3f}" if dev_us else "not_measured"),
        device_events=sum(n for _, n in kernels.values()),
        gemm_ms=f"{gemm_us / 1e3:.2f}", gmm_ms=f"{gmm_us / 1e3:.2f}",
        ops=repr(_op_split(prof)).replace(" ", ""),
        other_ms=f"{other_us / 1e3:.2f}",
        scan_fwd_ms=f"{scan_fwd_us / 1e3:.2f}",
        scan_bwd_ms=f"{scan_bwd_us / 1e3:.2f}",
        flash_fwd_ms=f"{fwd_us / 1e3:.2f}", flash_bwd_ms=f"{bwd_us / 1e3:.2f}",
        flash_fwd_share=(f"{fwd_us / dev_us:.3f}" if dev_us else "-"),
        flash_bwd_share=(f"{bwd_us / dev_us:.3f}" if dev_us else "-"))
    for kname, (us, n) in sorted(kernels.items(),
                                 key=lambda kv: -kv[1][0])[:8]:
        print(f"    {us / 1e3:9.3f} ms  x{n:<5d} {kname[:90]}", flush=True)
    _top_ops(prof)


def phase_train(arch: str = "granite-3-2b", label: str = "train"
                ) -> dict[str, int]:
    """``arch`` at full width and depth through the port's launcher."""
    cfg = registry.get(arch)
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    return _train(cfg, ckpt_dir, lambda: train_launch.main([
        "--arch", cfg.name, "--steps", str(TRAIN_STEPS),
        "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
        "--ckpt-dir", str(ckpt_dir), "--ckpt-every", str(10 * TRAIN_STEPS)]),
        label)


def _data_cfg(cfg, batch: int) -> DataConfig:
    """The corpus at ``TRAIN_SEQ`` tokens a row, with the family's media."""
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=batch, n_media_tokens=cfg.n_media_tokens,
                      media_embed_dim=cfg.media_embed_dim)


def phase_train_with_trainer(arch: str, n_layers: int | None,
                             label: str, state_bits: int = 32,
                             remat: str | None = None) -> dict[str, int]:
    """``arch`` at full width (and ``n_layers`` layers, where its full-depth
    state does not fit one card) through ``make_train_step`` and the
    ``Trainer``, with the launcher's settings (the launcher has no depth
    option, as the reference's has none) but for AdamW's ``state_bits``
    and the remat policy, where given; the VLM's cross gates set to
    ``VLM_GATE``, so that its cross blocks' gradients are not zero."""
    cfg = registry.get(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat_policy=remat)
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"

    def run() -> dict:
        model = model_lib.build(cfg, "cuda")
        opt_cfg = adamw.AdamWConfig(lr=3e-4, total_steps=TRAIN_STEPS,
                                    warmup_steps=max(1, TRAIN_STEPS // 10),
                                    state_bits=state_bits)
        state = train_step.make_train_state(
            model, opt_cfg, torch.Generator(device="cuda").manual_seed(0))
        if "cross_blocks" in state["params"]:
            state["params"]["cross_blocks"]["gate"].fill_(VLM_GATE)
        trainer = Trainer(train_step.make_train_step(model, opt_cfg), state,
                          _data_cfg(cfg, TRAIN_BATCH), str(ckpt_dir),
                          TrainerConfig(total_steps=TRAIN_STEPS,
                                        checkpoint_every=10 * TRAIN_STEPS,
                                        log_every=1))
        return {**trainer.run(), "trainer": trainer}

    return _train(cfg, ckpt_dir, run, label)


def _attention_layers(cfg) -> int:
    """Flash attention launches of one forward: one a layer, one a VLM
    cross block, one an application of a hybrid's shared block, none in an
    SSM model."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    n = cfg.n_layers
    if cfg.family == "vlm":
        n += cfg.n_layers // cfg.cross_attn_every
    return n


def _moe_layers(cfg) -> int:
    """MoE layers of one forward, each three grouped products."""
    return cfg.n_layers // cfg.moe_every if cfg.family == "moe" else 0


def _scan_layers(cfg) -> dict[str, int]:
    """Scan launches of one forward, by kernel: one a Mamba layer, of the
    Mamba-1 form (``selective_scan``) or of the Mamba-2 form."""
    if cfg.family not in ("ssm", "hybrid"):
        return {}
    return {"selective_scan" if cfg.mamba_version == 1 else "mamba2_scan":
            cfg.n_layers}


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
    tokens = TRAIN_BATCH * TRAIN_SEQ         # text tokens (media not counted)
    for m in out["metrics"]:
        log("train-step", step=m["step"], loss=f"{m['loss']:.4f}",
            ms=f"{m['sec_per_step'] * 1e3:.1f}",
            tokens_s=f"{tokens / m['sec_per_step']:.0f}")
    steady = [m["sec_per_step"] for m in out["metrics"][1:]]
    log("train", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        params_B=f"{n_params / 1e9:.3f}", dtype=cfg.dtype,
        remat=cfg.remat_policy,
        adamw_bits=(8 if isinstance(trainer.state["opt"]["m"]["embed"], dict)
                    else 32),
        batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        media_tokens=cfg.n_media_tokens,
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
    attn = _attention_layers(cfg)
    want["flash_attention"] = 2 * attn * TRAIN_STEPS     # + recompute
    want["flash_attention_bwd"] = attn * TRAIN_STEPS
    for scan, n in _scan_layers(cfg).items():
        want[scan] = 2 * n * TRAIN_STEPS                 # + recompute
        want[scan + "_bwd"] = n * TRAIN_STEPS
    # forward, recompute and dX, then dW, of each of the three products
    want["grouped_mm"] = 3 * 3 * _moe_layers(cfg) * TRAIN_STEPS
    want["grouped_mm_wgrad"] = 3 * _moe_layers(cfg) * TRAIN_STEPS
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
    """The differentiable ops' backwards on their plain versions, the flash
    op's on ``flash_attention_bwd_ref`` and the scan ops' on
    ``selective_scan_bwd_ref`` and ``mamba2_scan_bwd_ref``, and the
    grouped products' on ``grouped_mm_ref`` (their dX form, the op with
    the weight read transposed, which the model's forward never uses)
    and ``grouped_mm_wgrad_ref`` (a check only).  The forwards stay on
    the kernels: a bf16 rounding there moves the next layer's routing,
    and the router's gradient with it (PERF.md §6)."""
    flash, scan = fa.flash_attention_bwd, ms.mamba2_scan_bwd
    sel = ms.selective_scan_bwd
    gmm, wgrad = gm._forward, gm._wgrad

    def plain(q, k, v, o, lse, do, *, causal=True, window=0, softcap=0.0):
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                           window=window, softcap=softcap)

    fa.flash_attention_bwd = plain
    ms.mamba2_scan_bwd = ref.mamba2_scan_bwd_ref
    ms.selective_scan_bwd = ref.selective_scan_bwd_ref
    gm._forward = (lambda x, w, start, kept, capacity, transposed:
                   ref.grouped_mm_ref(x, w, start, kept, True) if transposed
                   else gmm(x, w, start, kept, capacity, False))
    gm._wgrad = ref.grouped_mm_wgrad_ref
    try:
        yield
    finally:
        fa.flash_attention_bwd = flash
        ms.mamba2_scan_bwd = scan
        ms.selective_scan_bwd = sel
        gm._forward, gm._wgrad = gmm, wgrad


def phase_train_grad_vs_plain(arch: str) -> None:
    """Every gradient leaf of ``arch`` at full width and ``GRAD_LAYERS``
    layers (B=1, T=2048, the family's random media, the VLM's gates at
    ``VLM_GATE``) with the backward kernels against the same with the
    plain backwards (``_plain_backward``, which neither kernel may launch
    in): worst per-leaf relative L2."""
    cfg = dataclasses.replace(registry.get(arch), n_layers=GRAD_LAYERS[arch])
    model = model_lib.build(cfg, "cuda")
    params = _init_params(model)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             SyntheticCorpus(_data_cfg(cfg, 1)).batch_at(0).items()}
    want = {"flash_attention_bwd": _attention_layers(cfg),
            "selective_scan_bwd": 0, "mamba2_scan_bwd": 0,
            "grouped_mm_wgrad": 3 * _moe_layers(cfg)}
    for scan, n in _scan_layers(cfg).items():
        want[scan + "_bwd"] = n

    def bwd_launches():
        return {name: COUNTED[name].launches for name in want}

    before = bwd_launches()
    g0 = gm.grouped_mm.launches
    loss, grads = train_step._loss_and_grads(model, params, batch, 1)
    after = bwd_launches()
    g1 = gm.grouped_mm.launches
    if {k: after[k] - before[k] for k in want} != want:
        raise AssertionError(f"the kernel run launched {after} - {before} "
                             f"backward kernels, not {want}")
    with _plain_backward():
        loss_p, plain = train_step._loss_and_grads(model, params, batch, 1)
    if bwd_launches() != after:
        raise AssertionError("the plain run launched a backward kernel")
    # grouped products: forward, recompute and dX in the kernel run, the
    # first two only in the plain one
    n_gmm = 3 * _moe_layers(cfg)
    if (g1 - g0, gm.grouped_mm.launches - g1) != (3 * n_gmm, 2 * n_gmm):
        raise AssertionError(f"grouped_mm launched {g1 - g0} and "
                             f"{gm.grouped_mm.launches - g1} times, not "
                             f"{3 * n_gmm} and {2 * n_gmm}")
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


# ---- the pLUTo ALU and the Fig-8 applications ------------------------------

# the paper's sizes: the defaults of the reference's task graphs (MM n=200,
# PMM n=300, NTT n=512, BFS over 1000 nodes, fully connected in the paper's
# graph); the NTT's modulus (7681 = 15 * 512 + 1)
PLUTO_MM, PLUTO_PMM, PLUTO_NTT, PLUTO_BFS = 200, 300, 512, 1000
PLUTO_Q = 7681
PLUTO_LANES = 1 << 20
U32 = 0xFFFFFFFF


def _lanes_on_card(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64)).cuda()


def _timed_host(fn):
    """(result, ms): wall clock of ``fn`` to a synchronize (the ALU's
    work is thousands of small launches from the host)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _bit_equal(name: str, got, want: np.ndarray) -> None:
    got = got if isinstance(got, np.ndarray) else got.cpu().numpy()
    if got.dtype != np.uint32 or not np.array_equal(got,
                                                    want.astype(np.uint32)):
        bad = int(np.count_nonzero(got.astype(np.uint64)
                                   != want.astype(np.uint64)))
        raise AssertionError(f"pluto {name}: {bad} of {want.size} lanes "
                             "differ from the oracle")


def _aten_ops(fn) -> int:
    """The ATen operations ``fn`` dispatches (each a kernel launch on the
    card, or a view)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def phase_pluto(smi: str) -> None:
    rng = np.random.default_rng(25)
    x = rng.integers(0, 2**32, PLUTO_LANES, dtype=np.uint64)
    y = rng.integers(0, 2**32, PLUTO_LANES, dtype=np.uint64)
    tx, ty = _lanes_on_card(x), _lanes_on_card(y)
    for name, fn, want in (("add", alu.pluto_add, (x + y) & U32),
                           ("mul", alu.pluto_mul, (x * y) & U32),
                           ("sub", alu.pluto_sub, (x - y) & U32)):
        got, ms_ = _timed_host(lambda: fn(tx, ty))
        _bit_equal(name, got, want)
        log("pluto", op=name, lanes=PLUTO_LANES, bits=32, ms=f"{ms_:.2f}",
            bit_equal=True, card=repr(smi))
    for bits in (4, 8, 16, 24, 32):
        m = (1 << bits) - 1
        xb, yb = x & m, y & m
        for name, fn, want in (("add", alu.pluto_add, (xb + yb) & m),
                               ("mul", alu.pluto_mul, (xb * yb) & m)):
            _bit_equal(f"{name}{bits}", fn(_lanes_on_card(xb),
                                           _lanes_on_card(yb), bits=bits),
                       want)
    log("pluto", width_sweep="4,8,16,24,32", ops="add,mul", bit_equal=True)

    n = PLUTO_MM
    a = rng.integers(0, 2**32, (n, n), dtype=np.uint64)
    b = rng.integers(0, 2**32, (n, n), dtype=np.uint64)
    got, ms_ = _timed_host(lambda: executor.matmul(_lanes_on_card(a),
                                                   _lanes_on_card(b)))
    # uint64 wraps mod 2^64, so its low 32 bits are exact mod 2^32
    _bit_equal("MM", got, (a @ b) & U32)
    # one step of the k loop (a column x row product, its accumulation):
    # the ops of the whole run are n times these
    ta, tb = _lanes_on_card(a), _lanes_on_card(b)
    acc = torch.zeros((n, n), dtype=torch.int64, device="cuda")
    ops_k = _aten_ops(lambda: alu._add(acc, alu._mul(
        ta[:, 0][:, None], tb[0, :][None, :], 32), 32))
    log("pluto", app="MM", n=n, ms=f"{ms_:.1f}", bit_equal=True,
        aten_ops=n * ops_k, us_per_op=f"{ms_ * 1e3 / (n * ops_k):.2f}",
        card=repr(smi))

    n = PLUTO_PMM
    a = rng.integers(0, 2**32, n, dtype=np.uint64)
    b = rng.integers(0, 2**32, n, dtype=np.uint64)
    got, ms_ = _timed_host(lambda: executor.pmm(_lanes_on_card(a),
                                                _lanes_on_card(b)))
    want = np.zeros(2 * n - 1, dtype=np.uint64)
    for i in range(n):
        want[i:i + n] = (want[i:i + n] + a[i] * b) & U32
    _bit_equal("PMM", got, want)
    log("pluto", app="PMM", n=n, ms=f"{ms_:.1f}", bit_equal=True,
        card=repr(smi))

    n, q = PLUTO_NTT, PLUTO_Q
    root = next(c for c in range(2, q)
                if pow(c, n, q) == 1 and pow(c, n // 2, q) != 1)
    xs = rng.integers(0, q, n, dtype=np.uint32)
    got, ms_ = _timed_host(lambda: executor.ntt(xs, q=q, root=root,
                                                device="cuda"))
    _bit_equal("NTT", got, executor.ntt_oracle(xs, q=q, root=root))
    log("pluto", app="NTT", n=n, q=q, root=root, ms=f"{ms_:.1f}",
        bit_equal=True, card=repr(smi))

    n = PLUTO_BFS
    sparse = rng.random((n, n)) < 0.004
    sparse |= sparse.T
    np.fill_diagonal(sparse, False)
    for graph, adj in (("complete", ~np.eye(n, dtype=bool)),
                       ("random-sparse", sparse)):
        adj = adj.astype(np.uint8)
        got, ms_ = _timed_host(lambda: executor.bfs(adj, device="cuda"))
        want = executor.bfs_oracle(adj)
        _bit_equal(f"BFS {graph}", got, want)
        reached = want != U32
        log("pluto", app="BFS", graph=graph, nodes=n,
            edges=int(adj.sum()) // 2, levels=int(want[reached].max()),
            reached=int(reached.sum()), ms=f"{ms_:.1f}", bit_equal=True,
            card=repr(smi))


# ---- the Shared-PIM simulator's core: the paper's tables on the card -------

# the Fig-8 applications at the paper's sizes (taskgraph's defaults), each
# with the improvement the paper reports; 16 subarray PEs, one bank
PIM_N_PES = 16
PIM_FIG8 = (("mm", dict(n=200), 0.40), ("pmm", dict(n=300), 0.44),
            ("ntt", dict(n=512), 0.31), ("bfs", dict(n_nodes=1000), 0.29),
            ("dfs", dict(n_nodes=1000), 0.29))
# a wide bank whose frontiers run the batched (tensor) path of the vector
# engine on the card, not just its small-batch path
PIM_WIDE = ("mm", dict(n=64, n_pes=256))
# how many rows benchmarks/paper_tables.py checks against a paper value,
# and how many it computes besides its wall-clock rows
PIM_PAPER_ROWS, PIM_ROWS = 42, 93
PIM_TIMING_ROUNDS = 3


def pim_row(name: str, value: float, paper: float | None, tol: float):
    """One row as ``benchmarks/paper_tables.py`` makes it: (name, value,
    paper value or None, within tolerance)."""
    ok = paper is None or abs(value - paper) <= tol
    return (name, value, paper, ok)


def pim_paper_rows(device="cuda", fig8=None) -> list:
    """Every row of ``benchmarks/paper_tables.py`` but its wall-clock ones,
    computed from the port, with that module's paper values and
    tolerances: Table II, Fig 6, Fig 7, Fig 8 (the schedules on
    ``device``, or ``fig8[(app, mode)]`` where given), the energy
    constants, Table III and Fig 9."""
    rows = []
    t2 = pim_copy.table2()
    paper = {"memcpy (via mem. channel)": (1366.25, 6.2),
             "RC-InterSA": (1363.75, 4.33),
             "LISA": (260.5, 0.17),
             "Shared-PIM": (52.75, 0.14)}
    for mech, (lat, en) in t2.items():
        plat, pen = paper[mech]
        rows.append(pim_row(f"table2.{mech}.latency_ns", lat, plat, 0.01))
        rows.append(pim_row(f"table2.{mech}.energy_uJ", en, pen, 0.01))
    rows.append(pim_row("fig6.sharedpim_vs_lisa_speedup",
                        pim_copy.lisa_copy(distance=1).latency_ns
                        / pim_copy.sharedpim_copy().latency_ns, 4.94, 0.1))
    rows.append(pim_row("fig6.sharedpim_vs_rc_speedup",
                        pim_copy.rc_intersa_copy().latency_ns
                        / pim_copy.sharedpim_copy().latency_ns, 25.85, 0.2))
    paper_pct = {("add", 32): 0.18, ("mul", 32): 0.31,
                 ("add", 128): 0.40, ("mul", 128): 0.40}
    for (op, bits), v in pim_pluto.fig7_table().items():
        rows.append(pim_row(f"fig7.{op}{bits}.lisa_ns", v["lisa_ns"], None, 0))
        rows.append(pim_row(f"fig7.{op}{bits}.sharedpim_ns",
                            v["shared_pim_ns"], None, 0))
        rows.append(pim_row(f"fig7.{op}{bits}.improvement",
                            v["improvement"], paper_pct.get((op, bits)),
                            0.01))
    savings = []
    for app, kw, target in PIM_FIG8:
        res = {}
        for m in Interconnect:
            res[m] = (fig8[(app, m)] if fig8 is not None else
                      pim_sched.schedule(pim_tg.build(app, m, **kw), m,
                                         device=device))
        lisa, sp = res[Interconnect.LISA], res[Interconnect.SHARED_PIM]
        imp = 1.0 - sp.makespan_ns / lisa.makespan_ns
        esave = 1.0 - sp.transfer_energy_j / lisa.transfer_energy_j
        savings.append(esave)
        rows.append(pim_row(f"fig8.{app}.lisa_us", lisa.makespan_ns / 1e3,
                            None, 0))
        rows.append(pim_row(f"fig8.{app}.sharedpim_us",
                            sp.makespan_ns / 1e3, None, 0))
        rows.append(pim_row(f"fig8.{app}.improvement", imp, target, 0.04))
        rows.append(pim_row(f"fig8.{app}.transfer_energy_saving", esave,
                            None, 0))
    rows.append(pim_row("fig8.avg_transfer_energy_saving",
                        sum(savings) / len(savings), 0.18, 0.02))
    t = PIM_ENERGY_TABLE
    rows += [
        pim_row("energy.lisa_row_uJ", t.lisa_row_j * 1e6, 0.17, 0.001),
        pim_row("energy.sharedpim_row_uJ", t.sp_row_j * 1e6, 0.14, 0.001),
        pim_row("energy.per_move_advantage", t.lisa_row_j / t.sp_row_j,
                1.2, 0.02),
        pim_row("energy.channel_row_uJ", t.channel_row_j * 1e6, 6.2, 0.001),
        pim_row("energy.group_row_uJ", t.group_row_j * 1e6, 4.33 / 2, 0.001),
        pim_row("energy.pe_op_uJ", t.op_j * 1e6, 0.17, 0.001),
        pim_row("energy.refresh_window_uJ", t.refresh_window_j * 1e6,
                0.17, 0.001),
        pim_row("energy.move_lisa_d1_uJ",
                pim_move_energy(Interconnect.LISA, 0, [1], 1) * 1e6,
                pim_copy.lisa_copy(distance=1).energy_j * 1e6, 0.0),
        pim_row("energy.move_sp_uJ",
                pim_move_energy(Interconnect.SHARED_PIM, 0, [1], 1) * 1e6,
                pim_copy.sharedpim_copy().energy_j * 1e6, 0.0),
        pim_row("energy.move_sp_bcast4_uJ",
                pim_move_energy(Interconnect.SHARED_PIM, 0, [1, 2, 3, 4],
                                1) * 1e6,
                pim_copy.sharedpim_broadcast(dests=(1, 2, 3, 4)).energy_j
                * 1e6, 0.0),
        pim_row("table3.base_dram_mm2", pim_area.total(0), 70.24, 0.01),
        pim_row("table3.pluto_bsa_mm2", pim_area.total(1), 82.00, 0.02),
        pim_row("table3.pluto_sharedpim_mm2", pim_area.total(2), 87.87,
                0.01),
        pim_row("table3.overhead_pct", pim_area.sharedpim_overhead_pct(),
                7.16, 0.02),
    ]
    for app, r in pim_nonpim.fig9_table().items():
        rows.append(pim_row(f"fig9.{app}.lisa_ipc", r["lisa"], None, 0))
        rows.append(pim_row(f"fig9.{app}.sharedpim_ipc", r["shared_pim"],
                            None, 0))
        rows.append(pim_row(f"fig9.{app}.no_regression",
                            float(r["shared_pim"] >= r["lisa"] >= 1.0),
                            1.0, 0))
    return rows


def pim_record(r) -> dict:
    """What ``tests/capture_goldens.py`` pins of a schedule: the floats,
    the counts, the energies and a SHA-256 of the finish times packed as
    (uid int64, finish float64) in uid order."""
    blob = b"".join(struct.pack("<qd", uid, r.finish_times[uid])
                    for uid in sorted(r.finish_times))
    return {"makespan_ns": r.makespan_ns, "op_busy_ns": r.op_busy_ns,
            "move_busy_ns": r.move_busy_ns, "stall_ns": r.stall_ns,
            "n_ops": r.n_ops, "n_moves": r.n_moves,
            "n_rows_moved": r.n_rows_moved,
            "transfer_energy_j": r.transfer_energy_j,
            "compute_energy_j": r.compute_energy_j,
            "finish_sha256": hashlib.sha256(blob).hexdigest()}


def _pim_result(st, mode):
    """An engine's ``EngineStats`` as the scheduler's ``ScheduleResult``."""
    return pim_sched.ScheduleResult(
        mode, st.makespan_ns, st.op_busy_ns, st.move_busy_ns, st.stall_ns,
        st.n_ops, st.n_moves, st.n_rows_moved, st.finish_times)


def _pim_wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _pim_schedule(app, kw, mode, smi, timed: bool):
    """One schedule on the card, held bit for bit against the host's scalar
    engine and ``core/reference.py``; then (``timed``) the entry point
    ``scheduler.schedule`` timed on the card and on the host in turns, its
    results held to the same record."""
    n_pes = kw.get("n_pes", PIM_N_PES)
    g = pim_tg.build_ir(app, mode, **kw)
    sess = pim_engine.EngineSession(pim_engine.BankModel(mode, n_pes),
                                    device="cuda")
    sess.admit(g)
    sess.advance()
    where = {t.device.type for t in (sess.free, sess._v_ready.a,
                                      sess._v_finish.a, sess._v_M.a)}
    if where != {"cuda"}:
        raise AssertionError(f"pim-sim {app}: session state on {where}")
    got = _pim_result(sess.stats(), mode)
    rec = pim_record(got)
    want = {"scalar": pim_record(_pim_result(pim_engine.run(
                g, pim_engine.BankModel(mode, n_pes), engine="scalar",
                device="cpu"), mode)),
            "reference": pim_record(pim_ref.schedule(
                pim_tg.build(app, mode, **kw), mode, n_pes))}
    line = dict(app=app, mode=mode.value, n_pes=n_pes, tasks=g.n,
                makespan_ns=repr(got.makespan_ns),
                bit_equal="scalar,reference")
    if timed:
        card, host = [], []
        for rnd in range(PIM_TIMING_ROUNDS):
            out = {}
            for dev, walls in (("cuda", card), ("cpu", host)):
                walls.append(_pim_wall(lambda: out.__setitem__(
                    dev, pim_sched.schedule(g, mode, n_pes, device=dev))))
            for dev, r in out.items():
                want[f"schedule(device={dev!r}), round {rnd}"] = \
                    pim_record(r)
        med_c, med_h = statistics.median(card), statistics.median(host)
        line.update(card_ms=f"{med_c:.1f}",
                    card_range=f"[{min(card):.1f},{max(card):.1f}]",
                    host_ms=f"{med_h:.1f}",
                    host_range=f"[{min(host):.1f},{max(host):.1f}]",
                    card_over_host=f"{med_c / med_h:.2f}", card=repr(smi))
    for oracle, w in want.items():
        bad = [k for k in rec if rec[k] != w[k]]
        if bad:
            raise AssertionError(f"pim-sim {app}/{mode.value}: the card's "
                                 f"schedule differs from {oracle} in {bad}")
    log("pim-sim", **line)
    return got


def phase_pim_sim(smi: str) -> None:
    t0 = time.perf_counter()
    fig8 = {}
    for app, kw, _ in PIM_FIG8:
        for mode in Interconnect:
            fig8[(app, mode)] = _pim_schedule(app, kw, mode, smi, True)
    for mode in Interconnect:
        _pim_schedule(*PIM_WIDE, mode, smi, False)
    card = pim_paper_rows("cuda", fig8)
    host = pim_paper_rows("cpu")
    if len(card) != PIM_ROWS or sum(r[2] is not None for r in card) \
            != PIM_PAPER_ROWS:
        raise AssertionError(f"pim-sim: {len(card)} rows, "
                             f"{sum(r[2] is not None for r in card)} with a "
                             f"paper value; want {PIM_ROWS}, "
                             f"{PIM_PAPER_ROWS}")
    for (name, value, paper, ok), h in zip(card, host):
        if (name, value) != h[:2]:
            raise AssertionError(f"pim-sim row {name}: card {value!r}, "
                                 f"host {h[1]!r}")
        log("pim-sim", row=name, value=repr(value),
            paper="-" if paper is None else paper, ok=ok)
    off = [r[0] for r in card if not r[3]]
    if off:
        raise AssertionError(f"pim-sim: rows out of the paper's tolerance: "
                             f"{off}")
    log("pim-sim", rows=len(card), paper_rows=PIM_PAPER_ROWS,
        within_tolerance=True, card_equals_host=True,
        seconds=f"{time.perf_counter() - t0:.1f}")


# ---- the device-scale simulator: goldens, the HBM device, the passes -------

# tests/capture_goldens.py's golden grid and handcrafted graphs, kept here
# because this script imports nothing of the reference package (a CPU test
# holds the copies equal to the originals)
GOLDEN_APP_KW = {"mm": dict(n=30), "pmm": dict(n=30), "ntt": dict(n=64),
                 "bfs": dict(n_nodes=60), "dfs": dict(n_nodes=60)}
GOLDEN_GEOMETRIES = {
    "1ch_1bank": dict(channels=1, banks_per_channel=1),
    "1ch_4banks": dict(channels=1, banks_per_channel=4),
    "2ch_4banks_2groups": dict(channels=2, banks_per_channel=4,
                               bank_groups_per_channel=2),
}
GOLDEN_SYNTH = {
    "bcast_mixed": [
        pim_sched.Task(0, "move", src=0, dst=(1, 17, 18, 33), rows=2),
        pim_sched.Task(1, "op", deps=(0,), pe=17, duration=300.0),
        pim_sched.Task(2, "move", deps=(1,), src=17, dst=70, rows=3),
        pim_sched.Task(3, "op", pe=2, duration=100.0),
    ],
    "fanout5": [
        pim_sched.Task(0, "op", pe=0, duration=50.0),
        pim_sched.Task(1, "move", deps=(0,), src=0, dst=(1, 2, 3, 4, 5),
                       rows=2),
        pim_sched.Task(2, "op", deps=(1,), pe=5, duration=75.0),
    ],
}
# the HBM-scale device: 16 channels x 16 banks, 4 bank groups a channel,
# 16 PEs a bank (4,096 PEs, 12,624 resource tokens)
PIM_HBM = dict(channels=16, banks_per_channel=16, bank_groups_per_channel=4,
               pes_per_bank=16)
# the reference package's makespans (ns, to two decimals) of the Fig-8
# applications at the paper's sizes on that device, round_robin, strong
# scaling (its NumPy simulator on a host CPU)
PIM_HBM_REF = {
    ("mm", "lisa"): 49245370.86, ("mm", "shared_pim"): 33921611.30,
    ("pmm", "lisa"): 166931354.62, ("pmm", "shared_pim"): 92723984.80,
    ("ntt", "lisa"): 15422754.86, ("ntt", "shared_pim"): 3185970.80,
    ("bfs", "lisa"): 30738233.57, ("bfs", "shared_pim"): 13818954.31,
    ("dfs", "lisa"): 30738233.57, ("dfs", "shared_pim"): 13818954.31}
# the apps timed PIM_TIMING_ROUNDS times on the HBM device; MM, PMM and
# NTT (120,000, 270,000 and 184,320 tasks, 97% of the grid's time) are
# timed once, so the phase stays under three minutes
PIM_HBM_REPEAT = ("bfs", "dfs")
# the held-against-the-scalar-engine cases besides BFS and DFS: the HBM
# test's PMM n = 32
PIM_HBM_SMALL = ("pmm", dict(n=32))
# qwen2-moe-a2.7b prefill at full depth (24 layers) on the HBM device,
# locality_first: tasks without and with the passes, the rewrites, and the
# reference's makespans (ns) without and with them
PIM_MOE = ("qwen2-moe-a2.7b", dict(phase="prefill"))
PIM_MOE_TASKS, PIM_MOE_REWRITES = (10620, 10329), 291
PIM_MOE_REF = {("lisa", False): 45307276.62, ("lisa", True): 43206300.54,
               ("shared_pim", False): 10569127.37,
               ("shared_pim", True): 10313996.92}


def pim_device_record(r) -> dict:
    """What ``tests/capture_goldens.py`` pins of a device schedule:
    ``pim_record``'s fields, the cross moves, the rows by route and the
    bus busy times."""
    rec = pim_record(r)
    rec.update(n_cross_moves=r.n_cross_moves,
               rows_by_route=dict(r.rows_by_route),
               bus_busy_ns=dict(r.bus_busy_ns))
    return rec


def _pim_scalar_device(g, mode, geom) -> dict:
    """The record of ``g``'s schedule by the host's scalar engine, wrapped
    as ``device.scheduler.schedule`` wraps the vector engine's."""
    g = pim_ir.materialize(g, mode)
    st = pim_engine.run(g, DeviceModel(mode, geom), engine="scalar",
                        device="cpu")
    e_row = (pim_pluto.E_MOVE_LISA if mode is Interconnect.LISA
             else pim_pluto.E_MOVE_BUS)
    return pim_device_record(dev_sched.DeviceScheduleResult(
        mode, geom, st.makespan_ns, st.op_busy_ns, st.move_busy_ns,
        st.stall_ns, st.n_ops, st.n_moves, st.n_rows_moved, st.finish_times,
        st.energy_j + sum(st.rows_by_route.values()) * e_row,
        st.n_cross_moves, st.rows_by_route, st.bus_busy_ns))


def _pim_held(what: str, got: dict, want: dict, oracle: str) -> None:
    bad = [k for k in got if got[k] != want[k]]
    if bad:
        raise AssertionError(f"pim-device {what}: the card's schedule "
                             f"differs from {oracle} in {bad}")


def _pim_device_goldens() -> None:
    """Every device and synth golden, scheduled with the state on the
    card, held exactly to its record."""
    t0 = time.perf_counter()
    golden = json.loads((ROOT / "tests" / "golden_schedules.json")
                        .read_text())
    n = 0
    for gname, gkw in GOLDEN_GEOMETRIES.items():
        geom = DeviceGeometry(**gkw)
        for app, kw in GOLDEN_APP_KW.items():
            for scaling in ("strong", "weak"):
                policies = (("locality_first", "round_robin",
                             "bandwidth_balanced")
                            if scaling == "strong" and geom.n_banks > 1
                            else ("locality_first",))
                for policy in policies:
                    for mode in Interconnect:
                        g = dev_part.build_partitioned_ir(
                            app, mode, geom, policy=policy, scaling=scaling,
                            **kw)
                        key = f"{app}/{mode.value}/{gname}/{scaling}/{policy}"
                        _pim_held(key, pim_device_record(dev_sched.schedule(
                            g, mode, geom, device="cuda")),
                            golden["device"][key], "the golden")
                        n += 1
    big = DeviceGeometry(**GOLDEN_GEOMETRIES["2ch_4banks_2groups"])
    for name, tasks in GOLDEN_SYNTH.items():
        for mode in Interconnect:
            key = f"{name}/{mode.value}"
            _pim_held(key, pim_device_record(dev_sched.schedule(
                tasks, mode, big, device="cuda")), golden["synth"][key],
                "the golden")
            n += 1
    if n != len(golden["device"]) + len(golden["synth"]) or n != 104:
        raise AssertionError(f"pim-device: {n} goldens run, the file has "
                             f"{len(golden['device'])} + "
                             f"{len(golden['synth'])}")
    log("pim-device", goldens=n, bit_equal=True,
        seconds=f"{time.perf_counter() - t0:.1f}")


def _pim_run_timed(runner, cfg):
    """One config through ``runner.run``: (result, wall ms, batches, wide
    batches), the counts from the engine's dispatch counters."""
    pim_engine_vec.advance.batches = pim_engine_vec.advance.wide_batches = 0
    out = []
    ms_ = _pim_wall(lambda: out.extend(runner.run([cfg])))
    return (out[0], ms_, pim_engine_vec.advance.batches,
            pim_engine_vec.advance.wide_batches)


def _pim_hbm_grid(smi: str) -> None:
    """The five Fig-8 apps at the paper's sizes on the HBM device, card
    against host in turns, and the small cases against the scalar
    engine."""
    geom = DeviceGeometry(**PIM_HBM)
    card = dev_batch.BatchRunner(device="cuda")
    host = dev_batch.BatchRunner(device="cpu")
    cfgs = [dev_batch.SweepConfig.make(app, mode, geom, policy="round_robin",
                                       **kw)
            for app, kw, _ in PIM_FIG8 for mode in Interconnect]
    walls = {cfg: ([], []) for cfg in cfgs}
    want, got, batches = {}, {}, {}
    for rnd in range(PIM_TIMING_ROUNDS):
        for cfg in cfgs:
            if rnd and cfg.app not in PIM_HBM_REPEAT:
                continue
            what = f"{cfg.app}/{cfg.mode.value} round {rnd}"
            rc, ms_c, nb, nw = _pim_run_timed(card, cfg)
            rh, ms_h, _, _ = _pim_run_timed(host, cfg)
            walls[cfg][0].append(ms_c)
            walls[cfg][1].append(ms_h)
            rec = pim_device_record(rc)
            if not rnd:
                want[cfg], got[cfg] = pim_device_record(rh), rec
                batches[cfg] = (nb, nw, rc.n_ops + rc.n_moves)
            _pim_held(what, rec, want[cfg], "the host's BatchRunner")
            _pim_held(what + " (host)", pim_device_record(rh), want[cfg],
                      "the host's first round")
    small = [dev_batch.SweepConfig.make(
        PIM_HBM_SMALL[0], mode, geom, policy="round_robin",
        **PIM_HBM_SMALL[1]) for mode in Interconnect]
    for cfg in small:
        got[cfg] = pim_device_record(card.run([cfg])[0])
        want[cfg] = pim_device_record(host.run([cfg])[0])
    for cfg in [c for c in cfgs if c.app in ("bfs", "dfs")] + small:
        label = f"{cfg.app} {cfg.kwargs}/{cfg.mode.value}"
        g = dev_part.partitioned_struct(cfg.app, geom, policy=cfg.policy,
                                        **cfg.kwargs)
        oracle = _pim_scalar_device(g, cfg.mode, geom)
        _pim_held(label, got[cfg], oracle, "the host's scalar engine")
        _pim_held(label + " (host)", want[cfg], oracle,
                  "the host's scalar engine")
        log("pim-device", hbm=cfg.app, kw=json.dumps(cfg.kwargs),
            mode=cfg.mode.value, tasks=g.n,
            makespan_ns=repr(got[cfg]["makespan_ns"]),
            bit_equal="host BatchRunner,host scalar engine")
    tot_c = tot_h = 0.0
    for cfg in cfgs:
        card_w, host_w = walls[cfg]
        tot_c += card_w[0]
        tot_h += host_w[0]
        mk = want[cfg]["makespan_ns"]
        ref_mk = PIM_HBM_REF[(cfg.app, cfg.mode.value)]
        if round(mk, 2) != ref_mk:
            raise AssertionError(f"pim-device {cfg.app}/{cfg.mode.value}: "
                                 f"makespan {mk!r}, the reference's "
                                 f"{ref_mk!r}")
        nb, nw, n_tasks = batches[cfg]
        med_c, med_h = statistics.median(card_w), statistics.median(host_w)
        log("pim-device", hbm=cfg.app, mode=cfg.mode.value,
            pes=geom.total_pes, tasks=n_tasks, makespan_ns=repr(mk),
            reference_ns=ref_mk, bit_equal="host BatchRunner",
            batches=nb, wide_batches=nw, rounds=len(card_w),
            card_ms=f"{med_c:.1f}",
            card_range=f"[{min(card_w):.1f},{max(card_w):.1f}]",
            host_ms=f"{med_h:.1f}",
            host_range=f"[{min(host_w):.1f},{max(host_w):.1f}]",
            card_over_host=f"{med_c / med_h:.2f}", card=repr(smi))
    log("pim-device", hbm_grid="first round", card_ms=f"{tot_c:.1f}",
        host_ms=f"{tot_h:.1f}", card_over_host=f"{tot_c / tot_h:.2f}",
        card=repr(smi))


def _pim_moe_passes(smi: str) -> None:
    """qwen2-moe-a2.7b prefill at full depth on the HBM device, with and
    without the passes pipeline, card against host."""
    geom = DeviceGeometry(**PIM_HBM)
    app, kw = PIM_MOE
    opt = pim_passes.DEFAULT_OPT
    card = dev_batch.BatchRunner(device="cuda")
    host = dev_batch.BatchRunner(device="cpu")
    rewrites = dev_part.optimization_log(app, geom, opt=opt, **kw)
    if rewrites.summary()["total"] != PIM_MOE_REWRITES:
        raise AssertionError(f"pim-device {app}: {rewrites.summary()} "
                             f"rewrites, want {PIM_MOE_REWRITES}")
    pipe = pim_passes.optimization_pipeline(
        opt, pes_per_bank=geom.pes_per_bank, total_pes=geom.total_pes)
    log("pim-device", moe=app, rewrites=json.dumps(rewrites.summary()),
        pipeline="|".join(pipe.describe()), fingerprint=pipe.fingerprint())
    span = {}
    for mode in Interconnect:
        for on in (False, True):
            cfg = dev_batch.SweepConfig.make(app, mode, geom,
                                             opt=opt if on else (), **kw)
            rc, ms_c, nb, nw = _pim_run_timed(card, cfg)
            rh, ms_h, _, _ = _pim_run_timed(host, cfg)
            what = f"{app}/{mode.value} passes={on}"
            _pim_held(what, pim_device_record(rc), pim_device_record(rh),
                      "the host's BatchRunner")
            n_tasks = rc.n_ops + rc.n_moves
            ref_mk = PIM_MOE_REF[(mode.value, on)]
            if n_tasks != PIM_MOE_TASKS[on] or \
                    round(rc.makespan_ns, 2) != ref_mk:
                raise AssertionError(f"pim-device {what}: {n_tasks} tasks, "
                                     f"makespan {rc.makespan_ns!r}; want "
                                     f"{PIM_MOE_TASKS[on]}, {ref_mk}")
            span[(mode, on)] = rc.makespan_ns
            log("pim-device", moe=app, mode=mode.value, passes=on,
                tasks=n_tasks, makespan_ns=repr(rc.makespan_ns),
                reference_ns=ref_mk, bit_equal="host BatchRunner",
                batches=nb, wide_batches=nw, card_ms=f"{ms_c:.1f}",
                host_ms=f"{ms_h:.1f}", card=repr(smi))
    sp = Interconnect.SHARED_PIM
    if not span[(sp, True)] < span[(sp, False)]:
        raise AssertionError(f"pim-device {app}: the passes did not shorten "
                             f"the Shared-PIM makespan ({span[(sp, True)]!r}"
                             f" >= {span[(sp, False)]!r})")
    li = Interconnect.LISA
    log("pim-device", moe=app,
        sharedpim_gain=f"{1 - span[(sp, True)] / span[(sp, False)]:.4f}",
        lisa_gain=f"{1 - span[(li, True)] / span[(li, False)]:.4f}")


def phase_pim_device(smi: str) -> None:
    t0 = time.perf_counter()
    _pim_device_goldens()
    _pim_hbm_grid(smi)
    _pim_moe_passes(smi)
    log("pim-device", goldens=True, hbm_grid=True, moe_passes=True,
        seconds=f"{time.perf_counter() - t0:.1f}")


# ---- the simulator's observability, placement search and serving runtime --

# the recorder cells (benchmarks/obs.py's): name -> (app, geometry, app
# kwargs), each recorded under both interconnects with RefreshSpec()
PIM_RT_OBS = {
    "matmul": ("mm", dict(channels=1, banks_per_channel=4), dict(n=48)),
    "moe": ("qwen2-moe-a2.7b",
            dict(channels=1, banks_per_channel=4, pes_per_bank=8),
            dict(phase="prefill", n_layers=3, seq_tiles=4)),
}
# the reference package's (tasks, makespan ns, trace events) of each
# recorded cell (its NumPy simulator on a host CPU)
PIM_RT_OBS_REF = {
    ("matmul", "lisa"): (6048, 7483295.039999968, 9864),
    ("matmul", "shared_pim"): (6048, 2047224.6600000004, 7276),
    ("moe", "lisa"): (1338, 6499732.799999976, 4680),
    ("moe", "shared_pim"): (1338, 2099461.9800000037, 2765),
}
# the placement-search cells (benchmarks/placement.py's), Shared-PIM, the
# default SearchConfig; the reference's (best greedy ns, its policy,
# searched ns, digest, engine evals, surrogate prunes)
PIM_RT_SEARCH = {
    "matmul": ("gemma3-1b", dict(channels=1, banks_per_channel=4),
               dict(phase="prefill", n_layers=4, seq_tiles=4)),
    "moe": ("qwen2-moe-a2.7b",
            dict(channels=1, banks_per_channel=4, pes_per_bank=8),
            dict(phase="prefill", n_layers=3, seq_tiles=4)),
}
PIM_RT_SEARCH_REF = {
    "matmul": (1074230.040000002, "locality_first", 895976.5000000014,
               "a4461064231e0617", 186, 9),
    "moe": (1419344.0500000033, "locality_first", 1399745.0100000033,
            "388c0039555b9eb5", 116, 62),
}
PIM_RT_WORKERS = 4
# the serving cells (benchmarks/serving.py's full size): 1 channel of 8
# banks in 4 groups, 16 PEs a bank, the five-app tenant mix with rates
# calibrated to the LISA-serviced device, RefreshSpec(), fifo, seed 0,
# 40 jobs a tenant
PIM_RT_TENANTS = (("mm", "mm", 2, 0, dict(n=60)),
                  ("pmm", "pmm", 2, 0, dict(n=60)),
                  ("ntt", "ntt", 1, 0, dict(n=128)),
                  ("bfs", "bfs", 1, 2, dict(n_nodes=200)),
                  ("dfs", "dfs", 1, 1, dict(n_nodes=150)))
PIM_RT_SERVE_GEOM = dict(channels=1, banks_per_channel=8,
                         bank_groups_per_channel=4)
PIM_RT_SERVE_LOADS = (0.3, 0.9)
PIM_RT_SLO_REF = 32477884.55999991        # 4 x the slowest LISA service
# the reference's (p50 ns, p99 ns, jobs/s) of each (load, mode)
PIM_RT_SERVE_REF = {
    (0.3, "lisa"): (12770116.745378923, 251100725.59113464,
                    133.05917962885798),
    (0.3, "shared_pim"): (2357429.3262094855, 16650909.591134649,
                          133.74394008083615),
    (0.9, "lisa"): (146538101.93183982, 848733081.1137115,
                    234.4907230015862),
    (0.9, "shared_pim"): (21103929.38375545, 255114724.86371154,
                          399.97465716174855),
}
# the continuous-batching cells (benchmarks/continuous.py's full size): 1
# channel of 16 banks in 4 groups, 2 PEs a bank; chat on gemma3-1b and an
# agent on granite-3-2b (4 layers each), 8 sessions a spec, chunks of 128
# tokens, 256 tokens a bank, the p99 TPOT SLO 6 x the slowest LISA decode
# step
PIM_RT_SESSIONS = (
    dict(name="chat", app="gemma3-1b", n_layers=4, prompt_tokens=512,
         decode_tokens=16, turns=2, think_ns=5e5, rate_sps=1500.0),
    dict(name="agent", app="granite-3-2b", n_layers=4, prompt_tokens=256,
         decode_tokens=12, turns=1, think_ns=0.0, rate_sps=1500.0))
PIM_RT_CONT_GEOM = dict(channels=1, banks_per_channel=16,
                        bank_groups_per_channel=4, pes_per_bank=2)
PIM_RT_CONT_LOADS = (0.25, 0.5, 1.0, 2.0, 4.0)
PIM_RT_TPOT_SLO_REF = 7353362.880000008
# the reference's (decode tok/s, TPOT p99 ns, TTFT p99 ns, makespan ns,
# preemptions, migrations) of each (load, mode)
PIM_RT_CONT_REF = {
    (0.25, "lisa"): (2091.7149566872336, 5027429.521600878,
                     91802589.56029405, 168282967.46392354, 4, 3),
    (0.25, "shared_pim"): (3248.3138297629807, 2916918.8068997916,
                           52787516.25797825, 108363913.84809157, 1, 4),
    (0.5, "lisa"): (2280.0971839810554, 4174189.652600797,
                    90712831.95999335, 154379384.56000686, 0, 1),
    (0.5, "shared_pim"): (3543.984544748878, 2782839.4489996317,
                          58523881.77955143, 99323232.24195728, 1, 2),
    (1.0, "lisa"): (2280.097183981057, 4174189.652600797,
                    93864434.85589723, 154379384.56000674, 0, 1),
    (1.0, "shared_pim"): (3904.741500670256, 2099009.6100004613,
                          53548615.902099535, 90146812.52000384, 1, 2),
    (2.0, "lisa"): (2280.0971839810586, 4174189.652600797,
                    95440236.30384916, 154379384.56000662, 0, 1),
    (2.0, "shared_pim"): (3904.741500670255, 2099009.6100004613,
                          55124417.3500514, 90146812.52000386, 1, 2),
    (4.0, "lisa"): (2280.0971839810595, 4174189.652600797,
                    96228137.02782515, 154379384.56000656, 0, 1),
    (4.0, "shared_pim"): (3904.741500670255, 2099009.6100004613,
                          55912318.07402736, 90146812.52000387, 1, 2),
}

def _pim_rt_recorded(app, geom, kw, mode, device):
    """(plain stats, wall ms, recorder, recorded stats, wall ms, trace
    SHA-256) of one recorder cell on ``device``."""
    cfg = dev_batch.SweepConfig.make(app, mode, geom, **kw)
    g = pim_ir.materialize(dev_part.partitioned_struct(app, geom, **kw), mode)
    plain = pim_engine.EngineSession(DeviceModel(mode, geom),
                                     refresh=pim_engine.RefreshSpec(),
                                     device=device)
    plain_ms = _pim_wall(lambda: (plain.admit(g), plain.advance()))
    out = []
    rec_ms = _pim_wall(lambda: out.append(pim_obs.record_sweep(
        cfg, refresh=pim_engine.RefreshSpec(), device=device)))
    rec = out[0]
    blob = json.dumps(rec.chrome_trace(), sort_keys=True,
                      separators=(",", ":")).encode()
    return (plain.stats(), plain_ms, rec, rec._session.stats(), rec_ms,
            hashlib.sha256(blob).hexdigest())


def _pim_rt_obs(smi: str) -> None:
    """The recorder cells on the card and on the host, in turns."""
    for name, (app, gkw, kw) in PIM_RT_OBS.items():
        geom = DeviceGeometry(**gkw)
        for mode in Interconnect:
            card = _pim_rt_recorded(app, geom, kw, mode, "cuda")
            host = _pim_rt_recorded(app, geom, kw, mode, "cpu")
            n_tasks = card[2]._session.job(0).n_tasks
            got = (n_tasks, card[3].makespan_ns, card[2].n_events)
            want = PIM_RT_OBS_REF[(name, mode.value)]
            if got != want:
                raise AssertionError(f"pim-runtime obs {name}/{mode.value}:"
                                     f" {got}, the reference's {want}")
            for side, (plain, _, _, recorded, _, _) in (("card", card),
                                                        ("host", host)):
                if recorded != plain:
                    raise AssertionError(f"pim-runtime obs {name}/"
                                         f"{mode.value}: recorded differs "
                                         f"from plain on the {side}")
            if card[3] != host[3] or card[5] != host[5]:
                raise AssertionError(f"pim-runtime obs {name}/{mode.value}:"
                                     " the card's schedule or trace differs "
                                     "from the host's")
            log("pim-runtime", obs=name, mode=mode.value, tasks=n_tasks,
                makespan_ns=repr(got[1]), trace_events=got[2],
                trace_sha256=card[5][:16], bit_equal="host,plain",
                card_plain_ms=f"{card[1]:.1f}",
                card_recorded_ms=f"{card[4]:.1f}",
                host_plain_ms=f"{host[1]:.1f}",
                host_recorded_ms=f"{host[4]:.1f}",
                card_over_host=f"{card[4] / host[4]:.2f}", card=repr(smi))


def _pim_rt_search_one(name, device, cache=None):
    """One placement cell searched by one worker on ``device``: (result,
    wall ms)."""
    app, gkw, kw = PIM_RT_SEARCH[name]
    geom = DeviceGeometry(**gkw)
    struct = pim_tg.structural(app, n_pes=geom.total_pes, **kw)
    t0 = time.perf_counter()
    oracle = pim_search.PlacementOracle(
        struct, Interconnect.SHARED_PIM, geom, cache=cache,
        n_workers=1, device=device)
    res = pim_search.search_pe_map(struct, Interconnect.SHARED_PIM, geom,
                                   config=pim_search.SearchConfig(seed=0),
                                   oracle=oracle)
    return res, (time.perf_counter() - t0) * 1e3


# the pool-backed search runs in a fresh interpreter started with ``-c``:
# spawned workers re-run their parent's main module, and this script's
# imports (every model, kernel and launcher) would be paid by each worker
_PIM_RT_POOL_SEARCH = """
import json, sys, time
import torch
from repro_torch import search
from repro_torch.core import taskgraph
from repro_torch.core.pluto import Interconnect
from repro_torch.device.geometry import DeviceGeometry
app, gkw, kw, n_workers = json.loads(sys.argv[1])
geom = DeviceGeometry(**gkw)
struct = taskgraph.structural(app, n_pes=geom.total_pes, **kw)
torch.cuda.synchronize()
t0 = time.perf_counter()
oracle = search.PlacementOracle(struct, Interconnect.SHARED_PIM, geom,
                                n_workers=n_workers, device="cuda")
try:
    res = search.search_pe_map(struct, Interconnect.SHARED_PIM, geom,
                               config=search.SearchConfig(seed=0),
                               oracle=oracle)
finally:
    oracle.close()
torch.cuda.synchronize()
print(json.dumps({"ms": (time.perf_counter() - t0) * 1e3,
                  "pool_start_s": oracle.pool_start_s,
                  "greedy_ns": res.incumbent_makespan_ns,
                  "policy": res.incumbent_policy,
                  "searched_ns": res.makespan_ns, "digest": res.digest,
                  "stats": res.stats, "pe_map": res.pe_map.tolist()}))
"""


def _pim_rt_search_pool(name: str) -> dict:
    """One placement cell searched on the card by ``PIM_RT_WORKERS``
    spawned workers, in a fresh interpreter (see above)."""
    app, gkw, kw = PIM_RT_SEARCH[name]
    proc = subprocess.run(
        [sys.executable, "-c", _PIM_RT_POOL_SEARCH,
         json.dumps([app, gkw, kw, PIM_RT_WORKERS])],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        print(proc.stderr[-8000:], flush=True)
        raise AssertionError(f"pim-runtime search {name} with "
                             f"{PIM_RT_WORKERS} workers exited "
                             f"{proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _pim_rt_search(smi: str) -> None:
    """The two placement cells searched on the card with one worker and
    with ``PIM_RT_WORKERS`` spawned ones, and on the host, in turns; then
    the moe cell again against the persistent cache the first card run
    wrote: zero engine evals."""
    cache_path = ROOT / "build" / "pim_runtime" / "oracle_cache.jsonl"
    shutil.rmtree(cache_path.parent, ignore_errors=True)
    for name in PIM_RT_SEARCH:
        want = PIM_RT_SEARCH_REF[name]
        cache = pim_search.OracleCache(cache_path) if name == "moe" else None
        runs = {}
        runs["card"] = _pim_rt_search_one(name, "cuda", cache)
        runs["host"] = _pim_rt_search_one(name, "cpu")
        pool = _pim_rt_search_pool(name)
        sides = [(side, (r.incumbent_makespan_ns, r.incumbent_policy,
                         r.makespan_ns, r.digest, r.stats["engine_evals"],
                         r.stats["surrogate_prunes"]), r.pe_map.tolist())
                 for side, (r, _) in runs.items()]
        sides.append(("card_pool", (pool["greedy_ns"], pool["policy"],
                                    pool["searched_ns"], pool["digest"],
                                    pool["stats"]["engine_evals"],
                                    pool["stats"]["surrogate_prunes"]),
                      pool["pe_map"]))
        for side, got, pe_map in sides:
            if got != want:
                raise AssertionError(f"pim-runtime search {name} ({side}): "
                                     f"{got}, the reference's {want}")
            if pe_map != sides[0][2]:
                raise AssertionError(f"pim-runtime search {name}: the "
                                     f"{side} map differs from the card's")
        res = runs["card"][0]
        log("pim-runtime", search=name, greedy_ns=repr(want[0]),
            policy=want[1], searched_ns=repr(res.makespan_ns),
            digest=res.digest, evals=res.stats["engine_evals"],
            prunes=res.stats["surrogate_prunes"],
            candidates=res.n_candidates, bit_equal="host,4 workers",
            card_ms=f"{runs['card'][1]:.1f}",
            host_ms=f"{runs['host'][1]:.1f}",
            card_pool_ms=f"{pool['ms']:.1f}",
            pool_workers=pool["stats"]["n_workers"],
            pool_start_s=f"{pool['pool_start_s']:.2f}",
            card_over_host=f"{runs['card'][1] / runs['host'][1]:.2f}",
            card=repr(smi))
        if name == "moe":
            pim_search.clear_caches()
            warm, ms_ = _pim_rt_search_one(
                name, "cuda", pim_search.OracleCache(cache_path))
            if (warm.stats["engine_evals"] != 0
                    or warm.stats["cache_hits"] != want[4]
                    or warm.digest != want[3]
                    or warm.makespan_ns != want[2]):
                raise AssertionError(f"pim-runtime search {name} warm: "
                                     f"{warm.stats}, digest {warm.digest}")
            log("pim-runtime", search=name, warm_cache=True, evals=0,
                cache_hits=warm.stats["cache_hits"], digest=warm.digest,
                card_ms=f"{ms_:.1f}", card=repr(smi))


def _pim_rt_tenants(device):
    """The serving tenants, their rates calibrated on ``device`` exactly as
    ``benchmarks/serving.py`` does, and the p99 SLO."""
    geom = DeviceGeometry(**PIM_RT_SERVE_GEOM)
    tenants, s_max = [], 0.0
    for name, app, banks, prio, kw in PIM_RT_TENANTS:
        lease = tuple(range(banks))
        struct = pim_tg.structural(app, n_pes=banks * geom.pes_per_bank,
                                   **kw)
        s = dev_sched.schedule(dev_part.place_on_banks(struct, geom, lease),
                               Interconnect.LISA, geom,
                               device=device).makespan_ns
        s_max = max(s_max, s)
        tenants.append(pim_runtime.TenantSpec.make(
            name, app, rate_jps=geom.n_banks / (len(PIM_RT_TENANTS) * s
                                                * banks) * 1e9,
            priority=prio, banks=banks, **kw))
    return geom, tenants, 4.0 * s_max


def _pim_rt_cont_specs():
    geom = DeviceGeometry(**PIM_RT_CONT_GEOM)
    specs = [pim_runtime.SessionSpec.make(**s) for s in PIM_RT_SESSIONS]
    return geom, specs


def _pim_rt_tpot_slo(device) -> float:
    """6 x the slowest LISA decode step at full-prompt KV, as
    ``benchmarks/continuous.py`` calibrates it."""
    from repro_torch.frontend.lower import decode_step
    geom, specs = _pim_rt_cont_specs()
    steps = []
    for spec in specs:
        kv = spec.prompt_tokens + spec.decode_tokens
        nb = min(geom.n_banks, max(1, -(-kv // 256)))
        g = decode_step(spec.app, n_pes=nb * geom.pes_per_bank, kv_len=kv,
                        **spec.kwargs)
        steps.append(dev_sched.schedule(
            dev_part.place_on_banks(g, geom, tuple(range(nb))),
            Interconnect.LISA, geom, device=device).makespan_ns)
    return 6.0 * max(steps)


def _pim_rt_cell(kind: str, load: float, mode: Interconnect, device: str,
                 slo: float, tenants: list):
    """One serving or continuous cell on ``device``: (results, summary,
    wall ms, engine batches, wide batches)."""
    if kind == "serving":
        geom = DeviceGeometry(**PIM_RT_SERVE_GEOM)
        trace = pim_runtime.open_loop_trace(tenants, jobs_per_tenant=40,
                                            seed=0, load=load)
        rt = pim_runtime.ServingRuntime(mode, geom, admission="fifo",
                                        refresh=pim_engine.RefreshSpec(),
                                        device=device)
        run = lambda: rt.run(trace)  # noqa: E731
    else:
        geom, specs = _pim_rt_cont_specs()
        trace = pim_runtime.session_trace(specs, sessions_per_spec=8, seed=0,
                                          load=load)
        rt = pim_runtime.ContinuousRuntime(mode, geom, chunk_tokens=128,
                                           tokens_per_bank=256,
                                           tpot_slo_ns=slo, device=device)
        run = lambda: rt.run_sessions(trace)  # noqa: E731
    pim_engine_vec.advance.batches = pim_engine_vec.advance.wide_batches = 0
    out = []
    ms_ = _pim_wall(lambda: out.extend(run()))
    return (out, pim_runtime.summarize(out), ms_,
            pim_engine_vec.advance.batches,
            pim_engine_vec.advance.wide_batches)


def _pim_rt_serving_row(s):
    return (s["latency_ns"]["p50"], s["latency_ns"]["p99"],
            s["throughput_jps"])


def _pim_rt_cont_row(res, s):
    return (s["decode_tps"], s["tpot_ns"].get("p99"),
            s["ttft_ns"].get("p99"), s["makespan_ns"],
            sum(r.n_preemptions for r in res),
            sum(r.n_migrations for r in res))


def _pim_rt_guards() -> None:
    """The runtimes' bit-for-bit guards on the card: a single-job session
    equals the offline schedule (``benchmarks/serving.py``'s mm n = 24 and
    ntt n = 64 on the serving device), and the continuous runtime with
    continuous batching off equals the whole-job runtime
    (``benchmarks/continuous.py``'s mm n = 60 and bfs 66 nodes, 12 jobs a
    tenant, on the continuous device)."""
    geom = DeviceGeometry(**PIM_RT_SERVE_GEOM)
    fields = ("makespan_ns", "op_busy_ns", "move_busy_ns", "stall_ns",
              "n_ops", "n_moves", "n_rows_moved", "finish_times")
    for app, kw in (("mm", dict(n=24)), ("ntt", dict(n=64))):
        for mode in Interconnect:
            g = pim_ir.materialize(dev_part.partitioned_struct(app, geom,
                                                               **kw), mode)
            offline = dev_sched.schedule(g, mode, geom, device="cuda")
            sess = pim_engine.EngineSession(DeviceModel(mode, geom),
                                            device="cuda")
            sess.admit(g)
            sess.advance()
            st = sess.stats()
            bad = [f for f in fields if getattr(st, f) != getattr(offline, f)]
            if bad:
                raise AssertionError(f"pim-runtime {app}/{mode.value}: the "
                                     f"session differs from the offline "
                                     f"schedule in {bad}")
    geom, _ = _pim_rt_cont_specs()
    tenants = [pim_runtime.TenantSpec.make("mm", "mm", n=60, banks=2,
                                           rate_jps=2000.0),
               pim_runtime.TenantSpec.make("bfs", "bfs", n_nodes=66, banks=2,
                                           priority=1, rate_jps=2000.0)]
    trace = pim_runtime.open_loop_trace(tenants, jobs_per_tenant=12, seed=0)
    for mode in Interconnect:
        base = pim_runtime.ServingRuntime(mode, geom, device="cuda").run(trace)
        cont = pim_runtime.ContinuousRuntime(mode, geom, continuous=False,
                                             device="cuda").run(trace)
        if cont != base:
            raise AssertionError(f"pim-runtime {mode.value}: continuous="
                                 "False differs from the whole-job runtime")
    log("pim-runtime", guards="session==offline,batch==whole-job",
        bit_equal=True)


def _pim_rt_runtimes(smi: str) -> None:
    """The serving and continuous cells, each on the card then on the host;
    every figure held to the reference's and the card's results to the
    host's, bit for bit."""
    _, tenants, slo = _pim_rt_tenants("cuda")
    tpot_slo = _pim_rt_tpot_slo("cuda")
    if (slo, tpot_slo) != (PIM_RT_SLO_REF, PIM_RT_TPOT_SLO_REF):
        raise AssertionError(f"pim-runtime SLOs {slo!r}, {tpot_slo!r}; the "
                             f"reference's {PIM_RT_SLO_REF!r}, "
                             f"{PIM_RT_TPOT_SLO_REF!r}")
    cells = [("serving", load, mode, slo)
             for load in PIM_RT_SERVE_LOADS for mode in Interconnect]
    cells += [("continuous", load, mode, tpot_slo)
              for load in PIM_RT_CONT_LOADS for mode in Interconnect]
    tot = {"serving": [0.0, 0.0], "continuous": [0.0, 0.0]}
    for kind, load, mode, s in cells:
        c = _pim_rt_cell(kind, load, mode, "cuda", s, tenants)
        h = _pim_rt_cell(kind, load, mode, "cpu", s, tenants)
        mv = mode.value
        if c[0] != h[0] or c[1] != h[1]:
            raise AssertionError(f"pim-runtime {kind} load {load} {mv}: the "
                                 "card's results differ from the host's")
        if kind == "serving":
            got = _pim_rt_serving_row(c[1])
            want = PIM_RT_SERVE_REF[(load, mv)]
            extra = dict(p50_ns=repr(got[0]), p99_ns=repr(got[1]),
                         jobs_per_s=repr(got[2]), jobs=len(c[0]))
        else:
            got = _pim_rt_cont_row(c[0], c[1])
            want = PIM_RT_CONT_REF[(load, mv)]
            extra = dict(decode_tps=repr(got[0]), tpot_p99_ns=repr(got[1]),
                         ttft_p99_ns=repr(got[2]), makespan_ns=repr(got[3]),
                         preemptions=got[4], migrations=got[5],
                         sessions=len(c[0]))
        if got != want:
            raise AssertionError(f"pim-runtime {kind} load {load} {mv}: "
                                 f"{got}, the reference's {want}")
        tot[kind][0] += c[2]
        tot[kind][1] += h[2]
        log("pim-runtime", cell=kind, load=load, mode=mv, **extra,
            bit_equal="host,reference", batches=c[3], wide_batches=c[4],
            card_ms=f"{c[2]:.1f}", host_ms=f"{h[2]:.1f}",
            card_over_host=f"{c[2] / h[2]:.2f}", card=repr(smi))
    for kind, (c_ms, h_ms) in tot.items():
        log("pim-runtime", cells=kind, card_ms=f"{c_ms:.1f}",
            host_ms=f"{h_ms:.1f}", card_over_host=f"{c_ms / h_ms:.2f}",
            card=repr(smi))


def phase_pim_runtime(smi: str) -> None:
    t0 = time.perf_counter()
    _pim_rt_obs(smi)
    t1 = time.perf_counter()
    _pim_rt_search(smi)
    t2 = time.perf_counter()
    _pim_rt_runtimes(smi)
    t3 = time.perf_counter()
    _pim_rt_guards()
    log("pim-runtime", obs=True, search=True, serving=True, continuous=True,
        obs_s=f"{t1 - t0:.1f}", search_s=f"{t2 - t1:.1f}",
        runtimes_s=f"{t3 - t2:.1f}", guards_s=f"{time.perf_counter() - t3:.1f}",
        seconds=f"{time.perf_counter() - t0:.1f}")


# ---- the distributed layer in a group of one -------------------------------

# under a one-card mesh at full width: granite-3-2b at 4 of its 40
# layers, qwen2-moe-a2.7b (its MoE layers through moe_block's mesh path)
# at 2 of its 24
MESH_TRAIN = (("granite-3-2b", 4), ("qwen2-moe-a2.7b", 2))
# bf16 on a mesh of one against no mesh: the same kernels, the loss summed
# in another order (``model._sharded_xent``)
MESH_LOSS_RTOL = 1e-3
# AdamW on DTensor parameters against the plain AdamW of the same gradients
# from the same state, on a mesh of one: the same arithmetic on the same
# local tensors
MESH_ADAMW_REL_L2 = 1e-6
# the planner against the card: granite-3-2b at full width, 2 layers
PLANNER_LAYERS = 2
PLANNER_MEM_RTOL = 0.10
DRYRUN_CELLS = (("--arch", "granite-3-2b", "--shape", "train_4k",
                 "--mesh", "both"),
                ("--arch", "glm4-9b", "--shape", "decode_32k",
                 "--mesh", "single"),
                ("--arch", "qwen2-moe-a2.7b", "--shape", "train_4k",
                 "--mesh", "single"),
                ("--arch", "llama4-maverick-400b-a17b", "--shape",
                 "decode_32k", "--mesh", "single"))
DRYRUN_TIMEOUT_S = 300
OVERLAP_SHAPE = (2, 64, 32, 48)      # B, T, D, F: check_overlap.py's
OVERLAP_TOL = {"ag": 1e-5, "rs": 1e-4}


def _held_close(name: str, got, want, tol: float) -> None:
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        err = (got - want).abs().max().item()
        raise AssertionError(f"overlap {name}: max |err| {err} > {tol}")
    log("overlap", check=name, max_abs_err=f"{(got - want).abs().max():.3e}",
        tol=tol)


def _pod_step_check(mesh) -> None:
    """One compressed step of reduced granite-3-2b (head_dim 64, the flash
    kernel's) on the 'pod' mesh against the same step with the gradients
    averaged uncompressed: loss equal, every parameter within
    lr * |residual| / eps of it (Adam's first step is 1/eps-Lipschitz in
    the gradient; ``tests/test_torch_distributed.py`` derives the bound)."""
    cfg = dataclasses.replace(registry.get("granite-3-2b").reduced(),
                              head_dim=64, dtype="float32")
    model = model_lib.build(cfg, "cuda")
    opt = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, grad_clip=0.0, eps=1e-3)
    settings = train_step.TrainSettings(compress_pod_grads=True)
    tokens = torch.randint(0, cfg.vocab_size, (4, 128),
                           generator=torch.Generator().manual_seed(5))
    batch = {"tokens": tokens}
    state = train_step.make_train_state(
        model, opt, torch.Generator(device="cuda").manual_seed(0), settings)
    state, metrics = train_step.make_train_step(model, opt, settings, mesh)(
        state, batch)
    plain = train_step.make_train_state(
        model, opt, torch.Generator(device="cuda").manual_seed(0))
    plain, pm = train_step.make_train_step(model, opt)(plain, batch)
    if metrics["loss"].item() != pm["loss"].item():
        raise AssertionError(f"pod step loss {metrics['loss'].item()} != "
                             f"{pm['loss'].item()}")
    worst = 0.0
    for (path, p), q, e in zip(tree.items(state["params"]),
                               tree.leaves(plain["params"]),
                               tree.leaves(state["grad_err"])):
        lim = opt.lr * e.abs().float() / opt.eps + 1e-6
        over = ((p - q).abs() - lim).max().item()
        worst = max(worst, (p - q).abs().max().item())
        if over > 0:
            raise AssertionError(f"pod step {path}: beyond the int8 bound "
                                 f"by {over}")
    log("overlap", check="pod-compressed-step",
        loss=f"{pm['loss'].item():.6f}", max_param_diff=f"{worst:.3e}",
        leaves=len(tree.leaves(plain["params"])))


def _grads(fn, inputs, cot):
    ins = [t.detach().clone().requires_grad_() for t in inputs]
    return torch.autograd.grad((fn(*ins) * cot).sum(), ins)


def _overlap_grads(gen, mesh, pmesh, stage) -> None:
    """The gradients of every input (x and the weights, the stage's
    parameters and the microbatches) through ``ag_matmul``, ``matmul_rs``,
    ``overlapped_ffn`` and the one-stage pipeline against autograd of the
    plain products."""
    B, T, D, Fd = OVERLAP_SHAPE
    x, wg, wu = (_rand(gen, s, torch.float32) for s in
                 ((B, T, D), (D, Fd), (D, Fd)))
    wo, h = _rand(gen, (Fd, D), torch.float32), \
        _rand(gen, (B, T, Fd), torch.float32)
    cot_f, cot_d = _rand(gen, (B, T, Fd), torch.float32), \
        _rand(gen, (B, T, D), torch.float32)
    w, bias = _rand(gen, (16, 16), torch.float32) * 0.3, \
        _rand(gen, (16,), torch.float32) * 0.1
    xs, cot_p = _rand(gen, (6, 2, 16), torch.float32), \
        _rand(gen, (6, 2, 16), torch.float32)
    cases = (
        ("ag_matmul", lambda x, w: cm.ag_matmul(x, w, mesh),
         lambda x, w: x @ w, (x, wg), cot_f),
        ("matmul_rs", lambda h, w: cm.matmul_rs(h, w, mesh),
         lambda h, w: h @ w, (h, wo), cot_d),
        ("overlapped_ffn",
         lambda x, a, b, c: cm.overlapped_ffn(x, a, b, c, mesh, F.silu),
         lambda x, a, b, c: (F.silu(x @ a) * (x @ b)) @ c,
         (x, wg, wu, wo), cot_d),
        ("pipeline-1-stage",
         lambda v, w, b: pipe.pipeline(stage, {"w": w, "b": b}, v, pmesh),
         lambda v, w, b: stage({"w": w, "b": b}, v), (xs, w, bias), cot_p))
    for name, ring, plain, inputs, cot in cases:
        for i, (g, want) in enumerate(zip(_grads(ring, inputs, cot),
                                          _grads(plain, inputs, cot))):
            _held_close(f"{name}-grad{i}", g, want, OVERLAP_TOL["rs"])


def phase_overlap() -> None:
    from torch.distributed.device_mesh import init_device_mesh

    store = ROOT / "build" / "overlap_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        gen = torch.Generator(device="cuda").manual_seed(25)
        B, T, D, Fd = OVERLAP_SHAPE
        x, w1 = _rand(gen, (B, T, D), torch.float32), \
            _rand(gen, (D, Fd), torch.float32)
        w2, h = _rand(gen, (Fd, D), torch.float32), \
            _rand(gen, (B, T, Fd), torch.float32)
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("model",))
        _held_close("ag_matmul", cm.ag_matmul(x, w1, mesh), x @ w1,
                    OVERLAP_TOL["ag"])
        _held_close("matmul_rs", cm.matmul_rs(h, w2, mesh), h @ w2,
                    OVERLAP_TOL["rs"])
        a = x @ w1
        _held_close("overlapped_ffn",
                    cm.overlapped_ffn(x, w1, w1, w2, mesh, F.silu),
                    (F.silu(a) * a) @ w2, OVERLAP_TOL["rs"])

        g = _rand(gen, (8, 128), torch.float32)
        gathered = []
        real = dist.all_gather

        def recording(tensors, tensor, group=None, async_op=False):
            res = real(tensors, tensor, group=group, async_op=async_op)
            gathered.append(torch.stack(tensors).clone())
            return res

        dist.all_gather = recording
        try:
            mean, _ = compression.psum_compressed(
                g, torch.zeros_like(g), mesh.get_group("model"))
        finally:
            dist.all_gather = real
        codes, scale = compression.quantize(g)
        if not (torch.equal(gathered[0][0], codes)
                and torch.equal(gathered[1][0], scale)):
            raise AssertionError("psum_compressed: the codes on the link "
                                 "differ from quantize's")
        _held_close("psum_compressed", mean, compression.dequantize(
            codes, scale, tuple(g.shape), torch.float32), OVERLAP_TOL["ag"])

        pmesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pipe",))
        w = _rand(gen, (16, 16), torch.float32) * 0.3
        bias = _rand(gen, (16,), torch.float32) * 0.1
        xs = _rand(gen, (6, 2, 16), torch.float32)

        def stage(p, v):
            return torch.tanh(v @ p["w"] + p["b"])

        _held_close("pipeline-1-stage",
                    pipe.pipeline(stage, {"w": w, "b": bias}, xs, pmesh),
                    stage({"w": w, "b": bias}, xs), OVERLAP_TOL["ag"])
        _overlap_grads(gen, mesh, pmesh, stage)
        _pod_step_check(init_device_mesh("cuda", (1,),
                                         mesh_dim_names=("pod",)))
        print("[overlap] note: a group of one posts no isend/irecv, so the "
              "ring's hand-off is not exercised on the card; the multi-rank "
              "parity (8 ranks for the rings, 4 for the pipeline, 2 for the "
              "pod step) is in tests/test_torch_distributed.py over gloo",
              flush=True)
    finally:
        dist.destroy_process_group()


def _one_rank_group(name: str) -> None:
    store = ROOT / "build" / name
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def phase_mesh_train() -> None:
    """Each of ``MESH_TRAIN`` (granite-3-2b and qwen2-moe-a2.7b) at full
    width and its number of layers under a one-card ``DeviceMesh`` ('data'
    x 'model' = 1 x 1, an NCCL group of one rank), its parameters and batch
    DTensors, with ``overlap="shared_bus"``, ``constrain_activations`` and
    ``constrain_internals`` on: two train steps (loss and gradients, then
    the AdamW update) held to the same steps with plain parameters and no
    mesh, the two runs apart (``_mesh_train``).  The flash forward and
    backward launch counts of each mesh step are asserted: the kernels ran
    on the DTensors' local shards through the ops' sharding rules
    (qwen2-moe's MoE layers through ``moe_block``'s mesh path, its grouped
    products on each rank's sorted rows)."""
    from torch.distributed.device_mesh import init_device_mesh

    _one_rank_group("mesh_train_store")
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        for arch, n_layers in MESH_TRAIN:
            _mesh_train(mesh, arch, n_layers)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def _routing_changes(a: list, b: list, E: int) -> tuple[int, int]:
    """Two runs' ``moe.record_routing`` logs of the same tokens: (tokens
    whose set of k experts differs, (token, expert) assignments made in
    both whose kept-or-dropped differs), summed over the layers."""
    topk = kept = 0
    for (ea, ka), (eb, kb) in zip(a, b):
        def mats(ex, keep):
            z = torch.zeros((ex.shape[0], E), dtype=torch.bool,
                            device=ex.device)
            return (z.scatter(1, ex, True),
                    z.scatter(1, ex, keep.view(ex.shape)))

        (ca, ma), (cb, mb) = mats(ea, ka), mats(eb, kb)
        topk += int((ca != cb).any(1).sum())
        kept += int(((ma != mb) & ca & cb).sum())
    return topk, kept


def _worst_grad(dg, pg) -> tuple[float, str, float]:
    """(worst relative L2 of a gradient leaf, its path, the router's
    worst) of the mesh run's gradients ``dg`` against the plain ones."""
    worst, where, router = 0.0, "", 0.0
    for (path, g), w in zip(tree.items(dg), tree.leaves(pg)):
        g = g.full_tensor()
        if not bool(torch.isfinite(g.float()).all()):
            raise AssertionError(f"non-finite gradient at {path}")
        rel = _rel_l2(g, w)
        if rel > worst:
            worst, where = rel, path
        if path.endswith("/router"):
            router = max(router, rel)
    return worst, where, router


def _mesh_train(mesh, arch: str, n_layers: int) -> None:
    """Two train steps of ``arch`` under ``mesh`` and without it.  The
    runs go apart: each takes AdamW from its own gradients.  For an MoE
    config the optimizer is also held on its own: at step 1 the two runs'
    routings (top-k choices, capacity drops) are counted apart, the plain
    run then takes the mesh run's parameters and moments and its step
    again (the gradients held on that one), and the plain AdamW applied to
    the mesh run's gathered gradients must equal the mesh update leaf for
    leaf within ``MESH_ADAMW_REL_L2``."""
    cfg = dataclasses.replace(
        registry.get(arch), n_layers=n_layers, overlap="shared_bus",
        constrain_activations=True, constrain_internals=True)
    is_moe = cfg.family == "moe"
    n_moe = cfg.n_layers // cfg.moe_every if is_moe else 0
    model = model_lib.build(cfg, "cuda")
    opt = adamw.AdamWConfig()
    params = _init_params(model)
    dparams = partition.distribute(
        params, partition.param_shardings(params, mesh), mesh)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             SyntheticCorpus(_data_cfg(cfg, TRAIN_BATCH)).batch_at(
                 0).items()}
    dbatch = partition.distribute(
        batch, partition.batch_shardings(batch, mesh, TRAIN_BATCH), mesh)
    states = {"mesh": [dparams, adamw.init_state(opt, dparams)],
              "plain": [params, adamw.init_state(opt, params)]}
    n_attn = _attention_layers(cfg)

    def grads_of(name):
        p = states[name][0]
        ctx = use_mesh(mesh) if name == "mesh" else contextlib.nullcontext()
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        with ctx, moe.record_routing() as routing:
            loss, grads = train_step._loss_and_grads(
                model, p, dbatch if name == "mesh" else batch, 1)
        torch.cuda.synchronize()
        # a remat recompute logs the layers again: the forward's come first
        return (loss, grads, read_counts(), (time.perf_counter() - t0) * 1e3,
                routing[:n_moe])

    def update(name, grads):
        p, o = states[name]
        ctx = use_mesh(mesh) if name == "mesh" else contextlib.nullcontext()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx:
            _, states[name][1], _ = adamw.apply_updates(opt, p, grads, o)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for step in range(2):
        out = {name: grads_of(name) for name in states}
        extra = {}
        if is_moe:
            extra["drops"] = sum(int((~k).sum()) for _, k in out["mesh"][4])
        if is_moe and step:
            # the evidence: the plain run went on from its own step 0
            topk, kept = _routing_changes(out["mesh"][4], out["plain"][4],
                                          cfg.n_experts)
            worst, where, router = _worst_grad(out["mesh"][1],
                                               out["plain"][1])
            extra.update(apart_topk_changed=topk, apart_kept_changed=kept,
                         apart_worst_grad_rel_l2=f"{worst:.3e}",
                         apart_worst_leaf=where,
                         apart_router_grad_rel_l2=f"{router:.3e}")
            del out["plain"]
            with torch.no_grad():
                for key in ("p", "m", "v"):
                    src = states["mesh"][0] if key == "p" else \
                        states["mesh"][1][key]
                    dst = states["plain"][0] if key == "p" else \
                        states["plain"][1][key]
                    for d, w in zip(tree.leaves(src), tree.leaves(dst)):
                        w.copy_(d.full_tensor())
            out["plain"] = grads_of("plain")
        (dl, dg, dc, dms, dr), (pl, pg, pc, pms, pr) = \
            out["mesh"], out["plain"]
        if not (dc["flash_attention_bwd"] == n_attn
                and dc["flash_attention"] == pc["flash_attention"] > 0
                and dc["grouped_mm"] == 3 * 3 * n_moe
                and dc["grouped_mm_wgrad"] == 3 * n_moe
                and dc == pc):
            raise AssertionError(f"{arch} mesh step {step} launched {dc}, "
                                 f"the plain one {pc}")
        if is_moe:
            topk, kept = _routing_changes(dr, pr, cfg.n_experts)
            extra.update(topk_changed=topk, kept_changed=kept)
        dl = dl.full_tensor()
        worst, where, _ = _worst_grad(dg, pg)
        loss_rel = abs(dl.item() - pl.item()) / abs(pl.item())
        if is_moe and step:
            # the plain AdamW on the mesh run's gradients, from the same
            # parameters and moments as the mesh update
            gathered = tree.unflatten(pg, [g.full_tensor()
                                           for g in tree.leaves(dg)])
            del out, pg
            pms += update("plain", gathered)
            dms += update("mesh", dg)
            adamw_worst, adamw_where = 0.0, ""
            for (path, d), w in zip(tree.items(states["mesh"][0]),
                                    tree.leaves(states["plain"][0])):
                rel = _rel_l2(d.full_tensor(), w)
                if rel > adamw_worst:
                    adamw_worst, adamw_where = rel, path
            extra.update(adamw_worst_rel_l2=f"{adamw_worst:.3e}",
                         adamw_worst_leaf=adamw_where or "-")
            if adamw_worst > MESH_ADAMW_REL_L2:
                raise AssertionError(
                    f"{arch} mesh step {step}: the AdamW update on DTensors "
                    f"is off the plain one of the same gradients by "
                    f"{adamw_worst} at {adamw_where} (limit "
                    f"{MESH_ADAMW_REL_L2})")
        else:
            dms += update("mesh", dg)
            pms += update("plain", pg)
        log("mesh-train", step=step, arch=cfg.name, layers=cfg.n_layers,
            mesh="1x1 (data, model)", loss=f"{dl.item():.6f}",
            plain_loss=f"{pl.item():.6f}", loss_rel=f"{loss_rel:.3e}",
            worst_grad_rel_l2=f"{worst:.3e}", worst_leaf=where,
            flash_fwd=dc["flash_attention"],
            flash_bwd=dc["flash_attention_bwd"], mesh_ms=f"{dms:.1f}",
            plain_ms=f"{pms:.1f}", **extra)
        if not (loss_rel <= MESH_LOSS_RTOL and worst <= GRAD_REL_L2):
            raise AssertionError(
                f"{arch} mesh step {step}: loss off by {loss_rel} (limit "
                f"{MESH_LOSS_RTOL}), gradient {where} by {worst} (limit "
                f"{GRAD_REL_L2})")


def phase_planner(smi: str) -> None:
    """The dry-run planner held against the card once: granite-3-2b at
    full width and ``PLANNER_LAYERS`` layers, one train step of
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens on a 1 x 1 mesh (a ``fake``
    group of one rank).  The planner's peak (``MemTracker``, fake tensors)
    against ``torch.cuda.max_memory_allocated`` of the same step run for
    real on the same mesh, within ``PLANNER_MEM_RTOL``; its FLOPs equal to
    ``FlopCounterMode`` over the plain step (no mesh, real tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode

    cfg = dataclasses.replace(registry.get("granite-3-2b"),
                              n_layers=PLANNER_LAYERS)
    shape = ShapeConfig("smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    dryrun.fake_world(1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        t0 = time.perf_counter()
        with FakeTensorMode():
            fn, args = dryrun.build_cell(cfg, shape, mesh, "cuda")
            planned = dryrun.measure(fn, args, mesh)
        plan_s = time.perf_counter() - t0
        del fn, args
        gc.collect()
        torch.cuda.empty_cache()
        model = model_lib.Model(cfg, torch.device("cuda"))
        opt = adamw.AdamWConfig()
        step = train_step.make_train_step(model, opt)
        tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                               generator=torch.Generator(device="cuda")
                               .manual_seed(1), device="cuda",
                               dtype=torch.int32)

        def new_state():
            return train_step.make_train_state(
                model, opt, torch.Generator(device="cuda").manual_seed(0))

        counter = FlopCounterMode(display=False)
        with counter:
            step(new_state(), {"tokens": tokens})
        flops = counter.get_total_flops()
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        state = new_state()
        dstate = partition.distribute(
            state, partition.param_shardings(state, mesh), mesh)
        del state
        dbatch = partition.distribute(
            {"tokens": tokens}, partition.batch_shardings(
                {"tokens": tokens}, mesh, TRAIN_BATCH), mesh)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with use_mesh(mesh):
            step(dstate, dbatch)
        torch.cuda.synchronize()
        # above what was held before: the distributed state and batch (the
        # planner's arguments) and the step's own
        real_peak = torch.cuda.max_memory_allocated() - base
        del dstate, dbatch
    finally:
        dist.destroy_process_group()
    peak = planned["mem"]["peak_hbm_bytes"]
    rel = abs(peak - real_peak) / real_peak
    log("planner", arch=cfg.name, layers=cfg.n_layers,
        step=f"{TRAIN_BATCH}x{TRAIN_SEQ}", mesh="1x1 (fake group)",
        planner_peak_GiB=f"{peak / 2**30:.3f}",
        card_peak_GiB=f"{real_peak / 2**30:.3f}", peak_rel=f"{rel:.3e}",
        planner_flops=f"{planned['flops']:.6e}",
        flop_counter=f"{flops:.6e}", plan_s=f"{plan_s:.1f}", card=smi)
    if not rel <= PLANNER_MEM_RTOL:
        raise AssertionError(f"planner peak {peak} vs the card's {real_peak}"
                             f": {rel} > {PLANNER_MEM_RTOL}")
    if planned["flops"] != flops:
        raise AssertionError(f"planner FLOPs {planned['flops']} != "
                             f"FlopCounterMode's {flops}")


def phase_dryrun() -> None:
    """``python -m repro_torch.launch.dryrun`` in subprocesses (a fake
    process group of 256 or 512 ranks each, fake CUDA tensors) on
    ``DRYRUN_CELLS``, all started together, each with a report of its own
    and within ``DRYRUN_TIMEOUT_S``; every cell must come out ``ok``.
    Prints each cell's per-device planner counts: counts for a mesh of
    cards this machine does not have, not timings."""
    out_dir = ROOT / "build" / "dryrun_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    procs = []
    try:
        for i, argv in enumerate(DRYRUN_CELLS):
            with open(out_dir / f"cell{i}.log", "w") as sink:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
                     "--report", str(out_dir / f"cell{i}.json")], cwd=ROOT,
                    env=env, stdout=sink, stderr=subprocess.STDOUT))
        for i, (argv, proc) in enumerate(zip(DRYRUN_CELLS, procs)):
            rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                                       - (time.perf_counter() - t0)))
            log("dryrun", args=" ".join(argv), rc=rc,
                seconds=f"{time.perf_counter() - t0:.1f}")
            if rc != 0:
                print((out_dir / f"cell{i}.log").read_text()[-8000:],
                      flush=True)
                raise AssertionError(f"dryrun {argv} exited {rc}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cells = {}
    for i in range(len(DRYRUN_CELLS)):
        cells.update(json.loads((out_dir / f"cell{i}.json").read_text()))
    for key, cell in sorted(cells.items()):
        if cell["status"] != "ok":
            raise AssertionError(f"dryrun cell {key}: {cell}")
        pd, cost = cell["per_device"], cell["per_device_cost"]
        log("dryrun", cell=key, planner_counts="per device",
            devices=cell["devices"],
            peak_GiB=f"{pd['peak_hbm_bytes'] / 2**30:.3f}",
            argument_GiB=f"{pd['argument_bytes'] / 2**30:.3f}",
            flops=f"{cost['flops']:.4e}",
            bytes_accessed=f"{cost['bytes_accessed']:.4e}",
            collective_bytes=f"{cost['collective_bytes']:.4e}",
            collectives={k: v["count"] for k, v in
                         cell["raw_cost"]["collectives"].items()},
            run_s=cell["compile_s"])


def run_arch(arch, gen) -> tuple:
    """Serve, decode against forward and profile one model (and, for the
    Mamba-1 model, drive the entry points no model calls); its weights are
    freed when this returns.  ``need_f32`` says whether the cached path is
    still to be held in a float32 build: always for the Mamba and hybrid
    models; for the MoE model when bf16 misses the limits."""
    model, params, engine, prompts, outs, counts, media = phase_serve(arch,
                                                                      gen)
    family = model.cfg.family
    if family in ("moe", "vlm"):
        phase_determinism(engine, prompts, outs, media)
    if family == "moe":
        need_f32 = not _moe_against_forward(model, params, prompts, outs,
                                            model.cfg.dtype)
    else:
        phase_decode_vs_forward(model, params, engine, prompts, outs, media)
        need_f32 = family in ("ssm", "hybrid")
    phase_profile(model, params, prompts, media)
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
               phase_selective_scan_bwd(gen), phase_mamba2_scan(gen),
               phase_mamba2_scan_bwd(gen), phase_lut_matmul(gen),
               *phase_grouped_mm(gen)]
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
    for arch, n_layers, label in (
            ("qwen2-moe-a2.7b", MOE_TRAIN_LAYERS, "train-moe"),
            ("musicgen-medium", None, "train-audio"),
            ("llama-3.2-vision-11b", VLM_TRAIN_LAYERS, "train-vlm")):
        train_counts = phase_train_with_trainer(arch, n_layers, label)
        if train_counts["grouped_mm_wgrad"]:
            by_name["grouped_mm_wgrad"]["launches"] = train_counts[
                "grouped_mm_wgrad"]
        gc.collect()
        torch.cuda.empty_cache()
        phase_train_grad_vs_plain(arch)
        gc.collect()
        torch.cuda.empty_cache()
    train_counts = phase_train("zamba2-2.7b", "train-hybrid")
    by_name["mamba2_scan_bwd"]["launches"] = train_counts["mamba2_scan_bwd"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_grad_vs_plain("zamba2-2.7b")
    gc.collect()
    torch.cuda.empty_cache()
    train_counts = phase_train_with_trainer(
        "falcon-mamba-7b", None, "train-ssm", state_bits=8, remat="full")
    by_name["selective_scan_bwd"]["launches"] = train_counts[
        "selective_scan_bwd"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_grad_vs_plain("falcon-mamba-7b")
    gc.collect()
    torch.cuda.empty_cache()
    phase_pluto(smi)
    phase_pim_sim(smi)
    phase_pim_device(smi)
    phase_pim_runtime(smi)
    phase_overlap()
    phase_mesh_train()
    gc.collect()
    torch.cuda.empty_cache()
    phase_planner(smi)
    gc.collect()
    torch.cuda.empty_cache()
    phase_dryrun()
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
