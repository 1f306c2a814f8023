"""Serving launcher: batched generation with the KV-cache engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given; without a card the
default raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve
from repro_torch.models import model as model_lib
from repro_torch.serve.engine import Engine, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b", choices=list(registry.ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-len", type=int, default=128)
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = registry.get(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = model_lib.build(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    engine = Engine(model, params,
                    ServeConfig(max_batch=args.batch, max_len=args.max_len,
                                temperature=args.temperature))
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(2, cfg.vocab_size,
                                          size=rng.integers(4, 12))))
               for _ in range(args.batch)]
    outs = engine.generate(prompts, max_new=args.max_new)
    for i, o in enumerate(outs):
        print(f"req{i}: prompt={o[:len(prompts[i])]} -> "
              f"generated={o[len(prompts[i]):]}")
    return outs


if __name__ == "__main__":
    main()
