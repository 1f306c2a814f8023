"""Port's serving engine and launcher against ``repro.serve.engine``.

Greedy generation must equal the JAX engine token for token on converted
parameters (float32, so that bf16 near-ties cannot flip an argmax).
Temperature sampling cannot reproduce ``jax.random``; it is held by
determinism under a seed and by in-vocab output.
"""

import ast
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model as jmodel
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig

from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.serve.engine import Engine, ServeConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _engines(arch, **kw):
    """Both engines on one float32 parameter tree; a VLM's cross gates are
    set to nonzero values first (at init they are 0 and a cross block adds
    nothing)."""
    jcfg = dataclasses.replace(jreg.get(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(treg.get(arch).reduced(), dtype="float32")
    jm = jmodel.build(jcfg)
    np_tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                           jm.init(jax.random.key(0)))
    if "cross_blocks" in np_tree:
        np_tree["cross_blocks"]["gate"] = np.linspace(
            0.5, -0.5, tcfg.n_layers // tcfg.cross_attn_every,
            dtype=np.float32)
    jp = jax.tree.map(jax.numpy.asarray, np_tree)
    tm = tmodel.build(tcfg, "cpu")
    tp = convert.params_from_numpy(np_tree, tcfg, "cpu")
    return (tcfg, JEngine(jm, jp, JServeConfig(max_batch=4, max_len=96, **kw)),
            Engine(tm, tp, ServeConfig(max_batch=4, max_len=96, **kw)))


def _prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(2, cfg.vocab_size, size=n)))
            for n in (3, 7, 5, 9)]


def _media(cfg, seed=0):
    """Random media for the VLM and audio archs (the same array to both
    engines), None for the others."""
    if not cfg.n_media_tokens:
        return None
    rng = np.random.default_rng(seed + 50)
    return rng.normal(size=(4, cfg.n_media_tokens, cfg.media_embed_dim)
                      ).astype(np.float32)


@pytest.mark.parametrize("arch", ["granite-3-2b", "glm4-9b",
                                  "falcon-mamba-7b", "qwen2-moe-a2.7b",
                                  "llama-3.2-vision-11b", "musicgen-medium"])
def test_greedy_matches_jax_engine(arch):
    cfg, jeng, teng = _engines(arch)
    prompts = _prompts(cfg)
    media = _media(cfg)
    want = jeng.generate(prompts, max_new=8, media=media)
    teng.keep_step_logits = True
    got = teng.generate(prompts, max_new=8, media=media)
    assert got == want
    # as in the reference, the step after the last kept token still decodes
    assert teng.timing["decode_steps"] == 8
    assert len(teng.step_logits) == 9


def test_step_logits_kept_only_when_asked():
    """The engine keeps no step logits unless ``keep_step_logits`` is set
    (the reference keeps none); set, it keeps one (B, V) row a step, the
    logits the step sampled from."""
    cfg, _, teng = _engines("granite-3-2b")
    prompts = _prompts(cfg, seed=3)
    got = teng.generate(prompts, max_new=4)
    assert teng.step_logits == []
    teng.keep_step_logits = True
    assert teng.generate(prompts, max_new=4) == got
    assert len(teng.step_logits) == 5
    assert all(lg.shape == (4, cfg.vocab_size) for lg in teng.step_logits)
    new = got[0][len(prompts[0]):]                  # greedy: the argmaxes
    assert [int(lg[0].argmax()) for lg in teng.step_logits[:len(new)]] == new


def test_stops_at_max_len():
    cfg, jeng, teng = _engines("granite-3-2b")
    jeng.cfg = JServeConfig(max_batch=4, max_len=12)
    teng.cfg = ServeConfig(max_batch=4, max_len=12)
    prompts = _prompts(cfg, seed=1)
    got = teng.generate(prompts, max_new=8)
    assert got == jeng.generate(prompts, max_new=8)
    assert len(got[3]) == 9 + 3          # pos reaches max_len - 1 = 11


def test_eos_stops_slot():
    cfg, _, eng = _engines("granite-3-2b")
    prompts = _prompts(cfg, seed=2)
    outs = eng.generate(prompts, max_new=6)
    first = outs[1][len(prompts[1])]
    eng.cfg = ServeConfig(max_batch=4, max_len=96, eos_token=first)
    outs2 = eng.generate(prompts, max_new=6)
    assert outs2[1] == prompts[1] + [first]       # that slot stopped
    for i in (0, 2, 3):                           # the others did not
        stop = [j for j, t in enumerate(outs[i][len(prompts[i]):])
                if t == first]
        n = stop[0] + 1 if stop else 6
        assert outs2[i] == outs[i][:len(prompts[i]) + n]


def test_temperature_deterministic_under_seed():
    cfg, _, eng = _engines("granite-3-2b", temperature=0.8, seed=3)
    prompts = _prompts(cfg, seed=4)
    a = eng.generate(prompts, max_new=6)
    b = eng.generate(prompts, max_new=6)
    assert a == b
    assert all(0 <= t < cfg.vocab_size for o in a for t in o)
    eng.cfg = dataclasses.replace(eng.cfg, seed=4)
    assert eng.generate(prompts, max_new=6) != a


def test_launcher_smoke_on_cpu():
    outs = tlaunch.main(["--smoke", "--device", "cpu", "--max-new", "4"])
    assert len(outs) == 4
    assert all(0 <= t < 256 for o in outs for t in o)


def test_launcher_smoke_on_cpu_serves_falcon_mamba():
    outs = tlaunch.main(["--arch", "falcon-mamba-7b", "--smoke", "--device",
                         "cpu", "--max-new", "4"])
    assert len(outs) == 4
    assert all(0 <= t < 256 for o in outs for t in o)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-medium"])
def test_engine_default_media_is_zeros(arch):
    """Without media the engine gives both the reference's float32 zeros."""
    cfg, jeng, teng = _engines(arch)
    prompts = _prompts(cfg, seed=5)
    zeros = np.zeros((4, cfg.n_media_tokens, cfg.media_embed_dim),
                     np.float32)
    got = teng.generate(prompts, max_new=4)
    assert got == teng.generate(prompts, max_new=4, media=zeros)
    assert got == jeng.generate(prompts, max_new=4)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b",
                                  "llama4-maverick-400b-a17b"])
def test_launcher_smoke_on_cpu_serves_moe(arch):
    outs = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--max-new", "4"])
    assert len(outs) == 4
    assert all(0 <= t < 256 for o in outs for t in o)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-medium"])
def test_launcher_smoke_on_cpu_serves_multimodal(arch):
    outs = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--max-new", "4"])
    assert len(outs) == 4
    assert all(0 <= t < 256 for o in outs for t in o)


def test_launcher_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tlaunch.main(["--smoke"])


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    port = ROOT / "src" / "repro_torch"
    for mod in ("core/overlap/compression", "optim/adamw", "data/pipeline",
                "train/train_step", "train/trainer",
                "checkpoint/checkpointer", "launch/train", "tree",
                "core/pluto_alu", "core/executor", "core/overlap/sharedbus",
                "core/overlap/collective_matmul", "sharding/partition",
                "sharding/context", "train/pipeline", "launch/mesh",
                "launch/specs", "launch/dryrun", "core/timing",
                "core/copy_models", "core/pluto", "core/energy", "core/area",
                "core/nonpim", "core/ir", "core/taskgraph", "core/engine",
                "core/engine_vec", "core/scheduler", "core/reference",
                "device/__init__", "device/geometry", "device/interconnect",
                "device/resources", "device/scheduler", "device/partition",
                "device/reference", "device/batch", "passes/__init__",
                "passes/pipeline", "passes/rewrite", "passes/optimize",
                "passes/placement", "passes/search", "frontend/__init__",
                "frontend/lower"):
        assert port / f"{mod}.py" in files, mod
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)
