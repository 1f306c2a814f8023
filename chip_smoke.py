"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

    python3 chip_smoke.py

Phases, each printing what it found; any failure raises and exits non-zero:

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: every CUDA kernel of the port, from the sources in this checkout
   (one ``nvcc`` per source, started together), with ``-Xptxas -v`` output;
3. kernels against their plain PyTorch versions on the card, with stated
   tolerances, timed with CUDA events beside the plain version, a PyTorch
   library call computing the same function, and the card's bound;
4. serving: glm4-9b at full width (40 layers, bf16, random weights from a
   seeded generator on the card) answers 4 requests of several hundred to
   1100 tokens through ``Engine.generate``; launch counts are zeroed just
   before and read just after, and every kernel of the path must have run;
5. decode against forward: the teacher-forced forward logits at the
   generated positions against the logits decode produced.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or without the rest of
the repository beside it, the script fails before printing either.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # abs, against the plain
# version on the same inputs: f32 differs by summation order only; bf16 by
# one rounding of the output (1 ulp of |o| < 4 is <= 1.6e-2)

ARCH = "glm4-9b"
PROMPT_LENS = (347, 611, 893, 1100)        # none a multiple of 128
MAX_NEW = 16
MAX_LEN = 2048
# decode vs forward at full width in bf16: the two paths round differently
# (kernel vs blockwise attention, different GEMM shapes) through 40 layers
DECODE_REL_L2 = 5e-2                        # per step, ||d|| / ||logits||
DECODE_MAX_ABS_FRAC = 0.1                   # max |d| / max |logits|


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


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
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
        log("build", kernel=name, seconds=f"{time.perf_counter() - t0:.1f}",
            lib=lib.path.name)
        for ln in ptxas:
            print(f"    {ln}", flush=True)


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def phase_kernels(gen) -> dict:
    """Flash attention against its plain versions in ``kernels/ref.py``."""
    cases = []
    for T in (1000, 1100):                       # the serving prefill shape
        cases.append(dict(B=4, Tq=T, Tk=T, H=32, K=2, D=128,
                          dtype=torch.bfloat16, causal=True, window=0,
                          softcap=0.0))
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
        log("kernel", case={k_: (str(v_).replace("torch.", "") if
                                 k_ == "dtype" else v_)
                            for k_, v_ in c.items()}.__repr__()
            .replace(" ", ""), max_abs_err=f"{err:.3e}", tol=tol)
        if not err <= tol:
            raise AssertionError(f"flash attention off by {err} > {tol}: {c}")
    # the (BH, T, D) entry point of the reference's layout
    q = _rand(gen, (6, 257, 64), torch.float32)
    got = fa.flash_attention(q, q * 0.5, q * 2, window=33)
    want = ref.flash_attention_ref(q, q * 0.5, q * 2, window=33)
    err = (got - want).abs().max().item()
    log("kernel", case="bh_layout", max_abs_err=f"{err:.3e}",
        tol=TOL[torch.float32])
    if not err <= TOL[torch.float32]:
        raise AssertionError(f"flash_attention (BH layout) off by {err}")

    # timing at the main path's shape: the serving prefill
    B, T, H, K, D = 4, max(PROMPT_LENS), 32, 2, 128
    q = _rand(gen, (B, T, H, D), torch.bfloat16)
    k = _rand(gen, (B, T, K, D), torch.bfloat16)
    v = _rand(gen, (B, T, K, D), torch.bfloat16)
    got = fa.flash_attention_gqa(q, k, v)
    want = ref.flash_attention_gqa_ref(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    ms = cuda_ms(lambda: fa.flash_attention_gqa(q, k, v))
    plain_ms = cuda_ms(lambda: ref.flash_attention_gqa_ref(q, k, v), iters=5)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                             enable_gqa=True)
    lib_err = (lib_out.transpose(1, 2).float() - want.float()).abs().max()
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=True))
    flops, nbytes = attn_cost(B, T, T, H, K, D, 2, True)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    log("kernel-time", shape=f"B{B}_T{T}_H{H}_K{K}_D{D}_bf16_causal",
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{library_ms:.4f}", library_err=f"{lib_err.item():.3e}",
        bound_ms=f"{bound_ms:.4f}", gflop=f"{flops / 1e9:.2f}",
        mbytes=f"{nbytes / 1e6:.2f}",
        tflops=f"{flops / ms / 1e9:.2f}",
        f32_core_bound_ms=f"{flops / PEAK_F32_FLOPS * 1e3:.4f}",
        max_abs_err=f"{err:.3e}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:71",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def _prompts(gen, vocab):
    return [torch.randint(2, vocab, (n,), generator=gen, device="cuda")
            .tolist() for n in PROMPT_LENS]


def phase_serve(gen) -> tuple:
    cfg = registry.get(ARCH)
    model = model_lib.build(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log("serve-init", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, params_B=f"{n_params / 1e9:.3f}",
        seconds=f"{time.perf_counter() - t0:.1f}")
    engine = Engine(model, params, ServeConfig(max_batch=4, max_len=MAX_LEN,
                                               eos_token=-1))
    # eos -1: no slot stops early, so every slot decodes MAX_NEW steps
    engine.generate([[5, 6, 7]] * 4, max_new=2)          # warm-up
    prompts = _prompts(gen, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_gqa.launches = 0
    outs = engine.generate(prompts, max_new=MAX_NEW)
    torch.cuda.synchronize()
    launches = fa.flash_attention_gqa.launches
    tm = engine.timing
    new = [o[len(p):] for o, p in zip(outs, prompts)]
    n_new = sum(len(g) for g in new)
    log("serve", prompts=list(PROMPT_LENS), max_new=MAX_NEW,
        prefill_ms=f"{tm['prefill_s'] * 1e3:.2f}",
        decode_ms_per_step=f"{tm['decode_s'] * 1e3 / tm['decode_steps']:.2f}",
        decode_steps=tm["decode_steps"],
        decode_tok_s=f"{4 * tm['decode_steps'] / tm['decode_s']:.1f}",
        e2e_tok_s=f"{n_new / (tm['prefill_s'] + tm['decode_s']):.1f}",
        peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        flash_launches=launches)
    if not all(len(g) == MAX_NEW for g in new):
        raise AssertionError(f"generated lengths {[len(g) for g in new]}")
    if not all(0 <= t < cfg.vocab_size for g in new for t in g):
        raise AssertionError("token outside the vocabulary")
    for lg in engine.step_logits:
        if not bool(torch.isfinite(lg.float()).all()):
            raise AssertionError("non-finite logits")
    if launches != cfg.n_layers * 1:           # one prefill call
        raise AssertionError(f"flash launches {launches} != {cfg.n_layers}")
    return model, params, engine, prompts, outs, launches


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def phase_decode_vs_forward(model, params, engine, prompts, outs) -> None:
    plen = max(len(p) for p in prompts)
    rows = [[0] * (plen - len(p)) + o for p, o in zip(prompts, outs)]
    toks = torch.tensor(rows, device="cuda")
    with torch.no_grad():
        full = model.forward(params, {"tokens": toks})
    worst_rel, worst_frac, agree, n = 0.0, 0.0, 0, 0
    for j, lg in enumerate(engine.step_logits[:MAX_NEW]):
        want = full[:, plen - 1 + j].float()
        d = lg.float() - want
        rel = (d.norm() / want.norm()).item()
        frac = (d.abs().max() / want.abs().max()).item()
        worst_rel, worst_frac = max(worst_rel, rel), max(worst_frac, frac)
        agree += int((lg.argmax(-1) == want.argmax(-1)).sum())
        n += lg.shape[0]
    log("decode-vs-forward", steps=MAX_NEW, worst_rel_l2=f"{worst_rel:.3e}",
        tol_rel_l2=DECODE_REL_L2, worst_max_abs_frac=f"{worst_frac:.3e}",
        tol_max_abs_frac=DECODE_MAX_ABS_FRAC,
        greedy_agreement=f"{agree}/{n}")
    if not (worst_rel <= DECODE_REL_L2 and worst_frac <= DECODE_MAX_ABS_FRAC):
        raise AssertionError("decode logits disagree with forward")


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
        log("profile", step=name, wall_ms=f"{wall_us / 1e3:.2f}",
            device_ms=(f"{dev_us / 1e3:.2f}" if dev_us else "not_measured"),
            busy_share=(f"{dev_us / wall_us:.3f}" if dev_us else
                        "not_measured"),
            device_events=sum(n for _, n in kernels.values()))
        for kname, (us, n) in sorted(kernels.items(),
                                     key=lambda kv: -kv[1][0])[:6]:
            print(f"    {us / 1e3:9.3f} ms  x{n:<5d} {kname[:90]}", flush=True)


def main() -> None:
    smi = phase_card()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    record = phase_kernels(gen)
    model, params, engine, prompts, outs, launches = phase_serve(gen)
    record["launches"] = launches
    phase_decode_vs_forward(model, params, engine, prompts, outs)
    phase_profile(model, params, prompts)
    print(json.dumps({"kernels": [record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
