"""Multi-pod dry-run planner: every (arch x shape x mesh) cell on a fake
256- or 512-rank ``DeviceMesh`` (PyTorch port of
``repro/launch/dryrun.py``).

For each cell this builds the step's inputs as fake tensors
(``launch/specs.py``), distributes them over the production mesh
(``sharding/partition.py``: every leaf a DTensor built from its rank's
local shard), and runs the step eagerly on them: ``train_step`` for train
shapes, ``prefill`` and ``decode_step`` for the others, under
``sharding.context.use_mesh``.  Nothing is allocated and no byte moves: the
process group is ``fake`` (``torch.testing._internal.distributed.fake_pg``)
and every tensor is a fake tensor, so the run takes seconds to minutes of
host time whatever the cell's size.  It records, per device (rank 0's
shard of everything), into ``reports/dryrun_torch.json`` (incremental:
existing cells are skipped unless --force):

* ``per_device``: ``argument_bytes`` (the inputs' local shards: the state
  and batch, or the parameters, cache and tokens), ``output_bytes`` (the
  outputs' local tensors), ``alias_bytes`` (the outputs that are inputs
  updated in place: the train state, the cache), ``peak_hbm_bytes``
  (``MemTracker``'s peak of live local tensors, arguments included) and
  ``temp_bytes`` = peak - argument - output + alias, so that the
  reference's relation peak = argument + output + temp - alias holds.
* ``raw_cost.flops``: the FLOPs of the local ops, by ``FlopCounterMode``'s
  formulas (matmul-class ops; the flash kernels' ops count their two and
  five products; elementwise work and the scans count nothing).  A
  ``FlopCounterMode`` around DTensor ops would count each op at its global
  shape; ``Planner`` lets DTensor turn each op into its local ops first
  and counts those.
* ``raw_cost.bytes_accessed``: for every local op that is not a view, the
  bytes of its tensor inputs and outputs (eager and unfused: each op reads
  its inputs and writes its outputs once).
* ``collectives``: count and output-shape bytes for each of the reference's
  five names; ring and pipeline hand-offs (``send``) count as
  ``collective-permute``.

XLA's ``cost_analysis`` counts a scanned layer body once, so the reference
compiles probes of one and two layer groups and extrapolates; the eager
run sees every layer, so the port needs no probes and ``per_device_cost``
equals ``raw_cost``.  The figures are counts for a mesh of cards, not
timings.  Every tensor is a fake CUDA tensor unless ``--device cpu``; a
host without CUDA can index no fake CUDA tensor, so there the run needs
``--device cpu`` (the kernels' ops are counted the same way on both).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi|both] [--device cuda|cpu]
        [--force] [--report PATH] [--set a=b,c=d] [--tag T]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.sharding import partition
from repro_torch.sharding.context import use_mesh
from repro_torch.train import train_step as ts

REPORT = pathlib.Path(__file__).resolve().parents[3] / "reports" / \
    "dryrun_torch.json"

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# local ops -> the reference's collective names: DTensor's functional
# collectives, and the ring and pipeline hand-offs' sends
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "send": "collective-permute",
}


def layer_group(cfg) -> int:
    """Scan-group granularity: the unit by which n_layers can be reduced."""
    return max(cfg.local_global_every, cfg.cross_attn_every, cfg.attn_every,
               cfg.moe_every, 1)


# config overrides applied by --set (the §Perf variant mechanism)
CONFIG_OVERRIDES: dict = {}


def _apply_overrides(cfg):
    if not CONFIG_OVERRIDES:
        return cfg
    coerced = {}
    for k, v in CONFIG_OVERRIDES.items():
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            coerced[k] = v in ("1", "true", "True", True)
        elif isinstance(cur, int):
            coerced[k] = int(v)
        elif isinstance(cur, float):
            coerced[k] = float(v)
        else:
            coerced[k] = v
    return dataclasses.replace(cfg, **coerced)


# ---- counting -------------------------------------------------------------

def _in_sharding_propagation() -> bool:
    """Whether the current op runs inside DTensor's sharding propagation,
    which computes an op's global output shape on fake tensors of the
    global shapes; those ops are not work any rank does."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x) -> list:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


class Planner(TorchDispatchMode):
    """Counts the local ops a rank runs: FLOPs (``FlopCounterMode``'s
    formulas), bytes accessed and collectives.  An op on DTensors returns
    ``NotImplemented`` here, so DTensor turns it into local ops (and
    collectives) first, which come back through this mode and are
    counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: dict[str, dict] = {}
        self.last_op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        self.last_op = str(func)
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        name = _COLLECTIVE_OPS.get(packet.__name__)
        if name is not None and func.namespace in ("_c10d_functional",
                                                   "c10d"):
            outs = _tensors(out if func.namespace == "_c10d_functional"
                            else args[0])
            d = self.collectives.setdefault(name, {"count": 0, "bytes": 0})
            d["count"] += 1
            d["bytes"] += sum(_nbytes(t) for t in outs)
        elif not func.is_view and not packet.__name__.startswith("empty"):
            self.bytes_accessed += sum(
                _nbytes(t) for t in _tensors((args, kwargs, out)))
        return out


def _peak_tracker():
    """``MemTracker`` that ignores the ops of DTensor's sharding
    propagation (global-shape fake tensors no rank holds)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class _Tracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            from torch.distributed.tensor import DTensor

            if not any(issubclass(t, DTensor) for t in types) and \
                    _in_sharding_propagation():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return _Tracker()


def _local_storages(x) -> dict:
    """{storage key: bytes} of the local tensors of every tensor in ``x``."""
    from torch.distributed.tensor import DTensor

    out = {}
    for t in _tensors(x):
        if isinstance(t, DTensor):
            t = t.to_local()
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def measure(fn, args: tuple, mesh) -> dict:
    """Run ``fn(*args)`` (fake, distributed inputs) under ``use_mesh`` and
    count what rank 0 runs and holds."""
    tracker = _peak_tracker()
    tracker.track_external(*_tensors(args))
    planner = Planner()
    with use_mesh(mesh):
        with tracker:
            with planner:
                try:
                    out = fn(*args)
                except Exception as e:
                    e.add_note(f"last op: {planner.last_op}")
                    raise
    peak = max((snap.get("Total", 0) for snap in
                tracker.get_tracker_snapshot("peak").values()), default=0)
    arg = _local_storages(args)
    outs = _local_storages(out)
    arg_b, out_b = sum(arg.values()), sum(outs.values())
    alias_b = sum(n for k, n in outs.items() if k in arg)
    coll = {k: planner.collectives[k] for k in COLLECTIVES
            if k in planner.collectives}
    return {
        "flops": float(planner.flops),
        "bytes_accessed": float(planner.bytes_accessed),
        "collectives": coll,
        "collective_bytes": float(sum(d["bytes"] for d in coll.values())),
        "mem": {"argument_bytes": arg_b, "output_bytes": out_b,
                "temp_bytes": max(0, peak - arg_b - out_b + alias_b),
                "alias_bytes": alias_b, "peak_hbm_bytes": peak},
    }


# ---- cells ------------------------------------------------------------------

def build_cell(cfg, shape, mesh, device: str = "cuda") -> tuple:
    """(fn, args) for the cell (``shape`` a name in ``SHAPES`` or a
    ``ShapeConfig``): the step and its fake inputs, distributed over
    ``mesh``.  Call under the ``FakeTensorMode`` the inputs live in."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    model = model_lib.Model(cfg, torch.device(device))
    gen = torch.Generator(device=device).manual_seed(0)

    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig(
            state_bits=8 if cfg.name.startswith("llama4") else 32)
        settings = ts.TrainSettings()
        state = ts.make_train_state(model, opt_cfg, gen, settings)
        if opt_cfg.state_bits == 8:
            del state["opt"]
        state = partition.distribute(
            state, partition.param_shardings(state, mesh), mesh)
        if opt_cfg.state_bits == 8:
            # 8-bit moments hold the blocks of each rank's shard of their
            # parameter (``optim/adamw.py``), not the partition rules'
            # layout of the whole leaf's blocks
            state["opt"] = adamw.init_state(opt_cfg, state["params"])
        batch = specs.train_batch_specs(cfg, shape, device)
        batch = partition.distribute(
            batch, partition.batch_shardings(batch, mesh,
                                             shape.global_batch), mesh)
        return ts.make_train_step(model, opt_cfg, settings), (state, batch)

    params = model.init(gen)
    params = partition.distribute(
        params, partition.param_shardings(params, mesh), mesh)
    if shape.kind == "prefill":
        cache, inputs = specs.prefill_input_specs(cfg, model, shape)
    else:
        cache, inputs = specs.decode_input_specs(cfg, model, shape)
    cache = partition.distribute(
        cache, partition.cache_shardings(cache, mesh, shape.global_batch),
        mesh)
    inputs = {k: v for k, v in inputs.items() if v is not None}
    inputs = partition.distribute(
        inputs, partition.batch_shardings(inputs, mesh, shape.global_batch),
        mesh)
    step = model.prefill if shape.kind == "prefill" else model.decode_step

    def fn(params, cache, tokens, media):
        return step(params, cache, tokens, media)

    return fn, (params, cache, inputs["tokens"], inputs.get("media"))


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             device: str = "cuda", mesh=None) -> dict:
    """One cell on the production mesh of ``mesh_kind`` (or on ``mesh``),
    in the fake process group the caller started (``fake_world``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = _apply_overrides(registry.get(arch))
    ok, reason = shape_applicable(cfg, SHAPES[shape_name])
    if not ok:
        return {"status": "skipped", "reason": reason}
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    device=device)
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=False):
        fn, args = build_cell(cfg, shape_name, mesh, device)
        full = measure(fn, args, mesh)
    cost = {k: full[k] for k in ("flops", "bytes_accessed",
                                 "collective_bytes")}
    return {
        "status": "ok",
        "mesh": mesh_kind,
        "devices": int(mesh.size()),
        "n_layers": cfg.n_layers,
        "per_device": full["mem"],
        "raw_cost": {**cost, "collectives": full["collectives"]},
        # the eager run counts every layer: no probes to extrapolate
        "per_device_cost": cost,
        "compile_s": round(time.time() - t0, 1),
    }


def fake_world(size: int) -> None:
    """Make the default process group a ``fake`` one of ``size`` ranks,
    this process rank 0 (a group of another size is torn down first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == size and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


MESH_DEVICES = {"single": 256, "multi": 512}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--report", default=str(REPORT))
    ap.add_argument("--set", default="", help="cfg overrides a=b,c=d")
    ap.add_argument("--tag", default="", help="report-key suffix for variants")
    args = ap.parse_args()
    if args.set:
        CONFIG_OVERRIDES.update(
            dict(kv.split("=", 1) for kv in args.set.split(",")))

    report_path = pathlib.Path(args.report)
    report_path.parent.mkdir(parents=True, exist_ok=True)
    report = json.loads(report_path.read_text()) if report_path.exists() \
        else {}

    archs = [args.arch] if args.arch else list(registry.ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]

    failures = 0
    try:
        for mesh_kind in meshes:
            for arch in archs:
                for shape_name in shapes:
                    key = f"{arch}|{shape_name}|{mesh_kind}"
                    if args.tag:
                        key += f"|{args.tag}"
                    if key in report and report[key].get("status") in (
                            "ok", "skipped") and not args.force:
                        continue
                    print(f"=== {key}", flush=True)
                    try:
                        fake_world(MESH_DEVICES[mesh_kind])
                        result = run_cell(arch, shape_name, mesh_kind,
                                          args.device)
                    except Exception as e:
                        notes = "; ".join(getattr(e, "__notes__", []))
                        result = {"status": "error",
                                  "error": f"{type(e).__name__}: {e}",
                                  "op": notes.removeprefix("last op: "),
                                  "trace": traceback.format_exc()[-2000:]}
                        failures += 1
                        print(f"    ERROR {e} ({notes})", flush=True)
                    else:
                        if result["status"] == "ok":
                            pd = result["per_device"]
                            c = result["per_device_cost"]
                            print(f"    ok in {result['compile_s']}s  "
                                  f"peak/dev="
                                  f"{pd['peak_hbm_bytes'] / 2**30:.2f}GiB"
                                  f"  flops/dev={c['flops']:.3e}  "
                                  f"coll/dev={c['collective_bytes']:.3e}B",
                                  flush=True)
                        else:
                            print(f"    {result['status']}: "
                                  f"{result.get('reason', '')}", flush=True)
                    report[key] = result
                    report_path.write_text(json.dumps(report, indent=1,
                                                      sort_keys=True))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
