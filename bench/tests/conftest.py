"""The benchmark's tests: ``python -m pytest -q bench/tests`` from the root
of a checkout (the card's tests: add ``-m cuda`` on a machine with one).

``tiny_cell`` builds a cell of a configuration's reduced sizes (the
port's ``ModelConfig.reduced()``) and a traffic mix shrunk to match, for
runs on the CPU; the cells of ``BENCHMARK.json`` are full size.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

TINY_TRAFFIC = {
    "train": dict(batch=2, seq_len=32),
    "score": dict(batch=4, max_len=64, median_len=16, min_len=4,
                  max_prompt=63, cycle_batches=2, check_rows=4),
}
# what the tiny cells' sound runs stay under, with room, and the faults
# pass: readings on the CPU, bf16 program against the float32 reference
TINY_LIMITS = {"train": {"loss1_gap": 1e-3, "grad_gap": 0.05,
                         "grad_err": 0.15, "change_gap": 0.05},
               "score": {"logit_gap": 0.05, "logit_err": 0.05}}


def tiny_cell(config: str, traffic: str):
    from repro_torch.configs.base import ModelConfig
    from yardstick import cell as cell_lib

    conf = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    conf["model"] = dataclasses.asdict(ModelConfig(**conf["model"]).reduced())
    spec = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    spec.update(TINY_TRAFFIC[spec["kind"]])
    ref = cell_lib.load_module(BENCH / "configs" / conf["reference"],
                               f"tiny_{conf['reference'][:-3]}")
    return cell_lib.Cell(f"{config}.{traffic}", 1, conf, spec,
                         dict(TINY_LIMITS[spec["kind"]]), ref, [], [], BENCH)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
