"""A run's check against a timed path broken underneath: the harness's look
for a chip is skipped (the run drives the CPU at the reduced sizes) and
the rest of a run goes through; a sound run is correct, and each fault
the cell can have makes ``correct`` come out false.  Both configurations'
references are kept under test, also where ``BENCHMARK.json`` has no cell
of one yet."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import tiny_cell
from yardstick import drivers

SEED = 2**33 + 7
CPU = torch.device("cpu")


def run(cell, seconds=0.5):
    return drivers.run_cell(cell, SEED, seconds, False, CPU,
                            time.perf_counter())


@pytest.mark.parametrize("config", ["granite-3-2b", "zamba2-2.7b"])
@pytest.mark.parametrize("traffic", ["train-4x2048", "score-longdoc"])
def test_a_sound_run_is_correct(config, traffic):
    out = run(tiny_cell(config, traffic))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["values"]["setup_s"] > 0


@pytest.mark.parametrize("config", ["granite-3-2b", "zamba2-2.7b"])
def test_a_step_that_returns_its_state_unchanged(config, monkeypatch):
    from repro_torch.optim import adamw

    def unchanged(cfg, params, grads, state):
        return params, state, {"grad_norm": torch.zeros(()),
                               "lr": torch.zeros(())}

    monkeypatch.setattr(adamw, "apply_updates", unchanged)
    out = run(tiny_cell(config, "train-4x2048"))
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("config", ["granite-3-2b", "zamba2-2.7b"])
def test_the_smallest_leaves_never_updated(config, monkeypatch):
    import controls
    from repro_torch.optim import adamw
    from yardstick import weights

    cell = tiny_cell(config, "train-4x2048")
    frozen = controls.small_leaves(cell.model)
    assert frozen
    real = adamw.apply_updates

    def frozen_small(cfg, params, grads, state):
        old = {p: weights.get(params, p).clone() for p in frozen}
        params, state, metrics = real(cfg, params, grads, state)
        for p, t in old.items():
            weights.get(params, p).copy_(t)
        return params, state, metrics

    monkeypatch.setattr(adamw, "apply_updates", frozen_small)
    out = run(cell)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("config", ["granite-3-2b", "zamba2-2.7b"])
def test_half_the_batch_left_out(config, monkeypatch):
    from repro_torch.models import model as model_lib

    real = model_lib.Model.train_loss

    def half(self, params, batch):
        rows = batch["tokens"].shape[0] // 2
        return real(self, params, {"tokens": batch["tokens"][:rows]})

    monkeypatch.setattr(model_lib.Model, "train_loss", half)
    out = run(tiny_cell(config, "train-4x2048"))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("config", ["granite-3-2b", "zamba2-2.7b"])
def test_a_served_token_altered_where_it_is_produced(config, monkeypatch):
    from repro_torch.serve import engine

    real = engine.Engine._sample

    def altered(self, logits, gen):
        return (real(self, logits, gen) + 1) % logits.shape[-1]

    monkeypatch.setattr(engine.Engine, "_sample", altered)
    out = run(tiny_cell(config, "score-longdoc"))
    assert not out["correct"]
    assert out["failed"] == 0
    assert out["checks"]["logit_gap"]["value"] > 0.05


@pytest.mark.parametrize("config", ["granite-3-2b", "zamba2-2.7b"])
def test_half_of_a_batch_left_unanswered(config, monkeypatch):
    from repro_torch.serve import engine

    real = engine.Engine.generate

    def half(self, prompts, max_new=32, media=None):
        out = real(self, prompts, max_new, media)
        return [o if i % 2 else list(p) for i, (o, p) in
                enumerate(zip(out, prompts))]

    monkeypatch.setattr(engine.Engine, "generate", half)
    out = run(tiny_cell(config, "score-longdoc"))
    assert not out["correct"]
    assert out["failed"] == out["attempted"] // 2
