"""No module under bench/ imports JAX or the JAX package, and the plain
references import nothing of the program: top-level module names (the
part before the first dot) compared whole, from each file's syntax tree,
imports inside functions included."""

from __future__ import annotations

import ast

import pytest

from conftest import BENCH

NEVER = {"jax", "jaxlib", "flax", "repro"}
PROGRAM = {"repro_torch"}


def imported_tops(path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_top_level_names_are_compared_whole(tmp_path):
    src = tmp_path / "mod.py"
    src.write_text("import repro_torch.models\nfrom jax.numpy import x\n"
                   "def f():\n    import repro.kernels\n"
                   "    importlib.import_module('flax.linen')\n")
    tops = imported_tops(src)
    assert tops == {"repro_torch", "jax", "repro", "flax"}
    assert tops & NEVER == {"jax", "repro", "flax"}


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not imported_tops(path) & NEVER


def _reference_modules():
    refs = sorted((BENCH / "configs").glob("ref_*.py"))
    return refs + [BENCH / "yardstick" / "plain.py"]


@pytest.mark.parametrize("path", _reference_modules(),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert not tops & (PROGRAM | NEVER)
    # and what it imports of the benchmark is the plain pieces alone
    assert tops <= {"__future__", "math", "torch", "yardstick"}


def test_every_config_names_a_reference_that_exists():
    import json

    for conf in (BENCH / "configs").glob("*.json"):
        ref = json.loads(conf.read_text())["reference"]
        assert (BENCH / "configs" / ref) in _reference_modules()
