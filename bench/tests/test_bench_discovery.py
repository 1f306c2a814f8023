"""The harness finds each piece by name, from files of its own, and a new
configuration, mix, cell or per-layer metric is added as files and
entries alone; ``BENCHMARK.json`` keeps the benchmark's contract."""

from __future__ import annotations

import hashlib
import json
import re
import shutil

import pytest

from conftest import BENCH, ROOT
from yardstick import cell as cell_lib
from yardstick import drivers

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
END_TO_END = {"setup_s", "train_tokens_per_s", "prefill_tokens_per_s",
              "ttft_p95_ms", "peak_mem_gb"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_is_found_by_name(name):
    from repro_torch.configs import registry
    from repro_torch.configs.base import ModelConfig

    cell = cell_lib.load(name, ROOT / "BENCHMARK.json")
    # the configuration as it is run is the port's own
    assert ModelConfig(**cell.model) == registry.get(cell.config["name"])
    assert callable(cell.reference.logits)
    kind = cell.traffic["kind"]
    want = {"train": {"loss1_gap", "grad_gap", "grad_err",
                      "change_gap"},
            "score": {"logit_gap", "logit_err"}}[kind]
    assert set(cell.limits) == want
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and names <= END_TO_END
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)


def test_readers_stay_silent_without_a_trace():
    rec = drivers.Record("train", {}, {}, 1.0, [], [], [])
    for m in SPEC["per_layer"]:
        if m["source"] == "device_trace":
            reader = cell_lib.load_module(BENCH / "metrics" /
                                          f"{m['name']}.py", "r")
            assert reader.read(rec) is None, m["name"]


def _hashes(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_config_mix_cell_and_metric_are_files_and_entries(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _hashes(bench)
    conf = json.loads((bench / "configs" / "granite-3-2b.json").read_text())
    conf["name"] = "granite-3-2b-copy"
    (bench / "configs" / "granite-3-2b-copy.json").write_text(
        json.dumps(conf))
    mix = json.loads((bench / "traffic" / "train-4x2048.json").read_text())
    mix.update(batch=2, seq_len=1024)
    (bench / "traffic" / "train-2x1024.json").write_text(json.dumps(mix))
    cell = "granite-3-2b-copy.train-2x1024"
    (bench / "limits" / f"{cell}.json").write_text(json.dumps(
        {"loss1_gap": 1, "grad_gap": 1, "grad_err": 1,
         "change_gap": 1}))
    (bench / "metrics" / "steps.train.py").write_text(
        "def read(rec):\n    return float(len(rec.step_s))\n")
    spec["configs"].append({"name": "granite-3-2b-copy"})
    spec["workloads"].append({"name": cell, "config": "granite-3-2b-copy",
                              "traffic": "train-2x1024", "chips": 1})
    spec["per_layer"].append({"name": "steps.train", "unit": "steps",
                              "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    found = cell_lib.load(cell, tmp_path / "BENCHMARK.json", bench)
    assert found.traffic["seq_len"] == 1024
    assert [m["name"] for m in found.per_layer] == ["steps.train"]
    rec = drivers.Record("train", found.model, found.traffic, 1.0,
                         [0.5, 0.6], [], [])
    assert found.reader("steps.train").read(rec) == 2.0
    after = _hashes(bench)
    assert all(after[p] == h for p, h in before.items())


def test_benchmark_file_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"][1] == "bench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    rs = SPEC["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    configs = {c["name"]: c for c in SPEC["configs"]}
    used = set()
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench/")
        assert NAME.match(c["name"]) and 1 <= len(c["why"]) <= 200
    names = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\t" not in w["why"]
        used.add(w["config"])
        names.add(w["name"])
    assert used == set(configs)
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(SPEC["workloads"]) // 4)
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["name"] in END_TO_END
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", names)) <= names
    layers = {}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        # each cell that reads it reports what it moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get(
            "workloads", names))
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in names:
        reported = [m for m in SPEC["end_to_end"]
                    if cell in m.get("workloads", names)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])
    assert len(json.dumps(SPEC)) <= 64 * 1024
