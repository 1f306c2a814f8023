"""Fault-tolerant training loop (PyTorch port of ``repro/train/trainer.py``).

Production behaviours implemented (and covered by tests):

* **checkpoint/restart**: periodic async atomic checkpoints; on construction
  the trainer auto-resumes from the newest valid checkpoint, and the data
  pipeline replays deterministically from the restored step.
* **straggler mitigation**: a wall-clock SLO per step (rolling median x
  ``straggler_factor``); breaching steps are counted and surfaced so an
  orchestrator can evict the slow host.  (On real fleets the same watchdog
  triggers the pre-emption path; here it is fully testable logic.)
* **failure retry**: transient step failures (injectable for tests) retry up
  to ``max_retries`` from the last good state — the port's step computes
  the loss and every gradient before it writes anything, so a failure in
  the forward or backward leaves the state as it was.  The optimizer
  update that follows is in place (``train_step.make_train_step``): a
  failure after it began writing raises ``adamw.PartialUpdateError``,
  which is never retried, since the state then mixes two steps (the
  reference's functional update has no such case); restart from the last
  checkpoint.

One card holds the whole state: there is no elastic re-sharding.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import (DataConfig, PrefetchIterator,
                                       SyntheticCorpus)
from repro_torch.optim.adamw import PartialUpdateError


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    max_retries: int = 2


class StragglerWatchdog:
    def __init__(self, factor: float):
        self.factor = factor
        self.history: list[float] = []
        self.breaches = 0

    def observe(self, dt: float) -> bool:
        slow = False
        if len(self.history) >= 5:
            slo = statistics.median(self.history) * self.factor
            slow = dt > slo
            if slow:
                self.breaches += 1
        self.history.append(dt)
        if len(self.history) > 50:
            self.history.pop(0)
        return slow


class Trainer:
    def __init__(self, step_fn: Callable, state, data_cfg: DataConfig,
                 ckpt_dir: str, cfg: TrainerConfig = TrainerConfig(),
                 fail_hook: Callable[[int], None] | None = None):
        self.step_fn = step_fn
        self.cfg = cfg
        self.ckpt = Checkpointer(ckpt_dir)
        self.watchdog = StragglerWatchdog(cfg.straggler_factor)
        self.fail_hook = fail_hook          # test hook: raise to simulate
        self.metrics_log: list[dict] = []

        latest = self.ckpt.latest_step()
        if latest is not None:
            state, _ = self.ckpt.restore(state, latest)
            self.start_step = latest
        else:
            self.start_step = 0
        self.state = state
        self.corpus = SyntheticCorpus(data_cfg)

    def run(self) -> dict:
        it = PrefetchIterator(self.corpus, start_step=self.start_step)
        try:
            for step, batch in it:
                if step >= self.cfg.total_steps:
                    break
                t0 = time.perf_counter()
                # retry THIS step from the last good state until the retry
                # budget is exhausted (transient node failures)
                for attempt in range(self.cfg.max_retries + 1):
                    try:
                        if self.fail_hook is not None:
                            self.fail_hook(step)
                        new_state, metrics = self.step_fn(self.state, batch)
                        loss = float(metrics["loss"])   # waits for the step
                        break
                    except PartialUpdateError:
                        raise       # the state mixes two steps: no retry
                    except Exception:
                        if attempt == self.cfg.max_retries:
                            raise
                self.state = new_state
                dt = time.perf_counter() - t0
                self.watchdog.observe(dt)
                if (step + 1) % self.cfg.log_every == 0:
                    self.metrics_log.append(
                        {"step": step + 1,
                         "loss": loss,
                         "sec_per_step": dt})
                if (step + 1) % self.cfg.checkpoint_every == 0:
                    self.ckpt.save_async(self.state, step + 1)
        finally:
            it.close()
            self.ckpt.wait()
        return {"final_step": min(self.cfg.total_steps, step + 1),
                "straggler_breaches": self.watchdog.breaches,
                "metrics": self.metrics_log}
