"""Training launcher (PyTorch port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --steps 50 --batch 8 --seq 128 --smoke --device cpu

Same flags as the reference, plus ``--device`` (default ``cuda``, which
raises without a card).  ``--smoke`` swaps in the reduced config.  One card,
no mesh: the state lives whole on the device.  Weights are random from a
seeded generator on the device.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
    """Train, print the logged steps; returns the trainer's result with the
    ``trainer`` itself (its ``state`` is the trained state)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b",
                    choices=list(registry.ARCHS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    cfg = registry.get(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = model_lib.build(cfg, device)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(1, args.steps // 10))
    settings = ts.TrainSettings(microbatches=args.microbatches)

    gen = torch.Generator(device=device).manual_seed(0)
    state = ts.make_train_state(model, opt_cfg, gen, settings)
    step = ts.make_train_step(model, opt_cfg, settings)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch,
                          n_media_tokens=cfg.n_media_tokens,
                          media_embed_dim=cfg.media_embed_dim)
    trainer = Trainer(step, state, data_cfg, args.ckpt_dir,
                      TrainerConfig(total_steps=args.steps,
                                    checkpoint_every=args.ckpt_every,
                                    log_every=max(1, args.steps // 10)))
    result = trainer.run()
    for m in result["metrics"]:
        print(f"step {m['step']:6d}  loss {m['loss']:.4f}  "
              f"{m['sec_per_step']*1e3:.0f} ms/step")
    print(f"finished at step {result['final_step']}; "
          f"straggler breaches: {result['straggler_breaches']}")
    return {**result, "trainer": trainer}


if __name__ == "__main__":
    main()
