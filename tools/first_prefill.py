"""What a served model's first prefill at the served shapes pays, on one card.

    python3 tools/first_prefill.py [--arch zamba2-2.7b] [--out F]

Builds the model at full width with random weights (``chip_smoke``'s
init), runs the engine's short warm-up (4 prompts of 3 tokens, as
``chip_smoke.phase_serve`` does), then profiles three prefills of the
served prompts (``chip_smoke.PROMPT_LENS``, left-padded) under
``torch.profiler``: the first at these shapes, a second, and a third
after ``torch.cuda.empty_cache``.  For each it prints the host-clock time,
the device time of its kernels and the ``cudaMalloc`` calls, and then the
host-side entries (ATen ops and CUDA runtime or driver calls) whose own
host time in the first prefill exceeds the second's by the most.  Writes
the readings as JSON to ``--out``.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402


def _prefill(model, params, toks) -> dict:
    """One prefill into a fresh cache under the profiler: host-clock ms,
    kernels' device ms, device allocations and each host entry's own
    time (ms) and count."""
    cache = model.init_cache(len(toks), chip_smoke.MAX_LEN)
    torch.cuda.synchronize()
    n0 = torch.cuda.memory_stats().get("num_device_alloc", 0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(params, cache, toks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n1 = torch.cuda.memory_stats().get("num_device_alloc", 0)
    host: dict[str, list] = {}
    dev_us = 0.0
    for ev in prof.events():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            dev_us += ev.time_range.elapsed_us()
            continue
        rec = host.setdefault(ev.name, [0.0, 0])
        rec[0] += ev.self_cpu_time_total / 1e3
        rec[1] += 1
    return {"wall_ms": wall * 1e3, "device_ms": dev_us / 1e3,
            "device_allocs": n1 - n0, "host": host}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(chip_smoke.phase_card(), flush=True)
    cfg = registry.get(args.arch)
    model = model_lib.build(cfg, "cuda")
    params = chip_smoke._init_params(model)
    engine = Engine(model, params, ServeConfig(
        max_batch=4, max_len=chip_smoke.MAX_LEN, eos_token=-1))
    engine.generate([[5, 6, 7]] * 4, max_new=2)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    prompts = chip_smoke._prompts(gen, cfg.vocab_size)
    plen = max(map(len, prompts))
    toks = torch.tensor([[0] * (plen - len(p)) + p for p in prompts],
                        device="cuda")
    runs = {}
    for name in ("first", "second", "after_empty_cache"):
        if name == "after_empty_cache":
            torch.cuda.empty_cache()
        runs[name] = _prefill(model, params, toks)
        r = runs[name]
        print(f"[first-prefill] arch={cfg.name} run={name} "
              f"wall_ms={r['wall_ms']:.2f} device_ms={r['device_ms']:.2f} "
              f"device_allocs={r['device_allocs']}", flush=True)
    first, second = runs["first"]["host"], runs["second"]["host"]
    grew = sorted(((ms - second.get(n, [0.0, 0])[0], n, ms, cnt)
                   for n, (ms, cnt) in first.items()), reverse=True)[:15]
    print("host entries whose own time grew most in the first prefill "
          "(ms first, ms second, count first):", flush=True)
    for extra, n, ms, cnt in grew:
        print(f"  +{extra:9.2f}  {ms:9.2f}  {second.get(n, [0.0])[0]:9.2f}"
              f"  x{cnt:<6d} {n[:90]}", flush=True)
    out = {"arch": cfg.name, "prompts": list(chip_smoke.PROMPT_LENS),
           "runs": {k: {kk: v for kk, v in r.items() if kk != "host"}
                    for k, r in runs.items()},
           "grew": [{"name": n, "extra_ms": e, "first_ms": m, "count": c}
                    for e, n, m, c in grew]}
    print(json.dumps(out), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
