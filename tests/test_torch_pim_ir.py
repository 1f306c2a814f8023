"""The port's task-graph IR and Fig-8 app builders (``repro_torch.core.ir``,
``repro_torch.core.taskgraph``) against the reference package: the
structural and materialized graphs of the five apps hold the same arrays,
value for value and dtype for dtype; successors, levels, validation, the
``Task`` round trips and ``convert.taskgraph_from_numpy`` agree.  The
reference package is imported only inside the tests.
"""

import dataclasses
import importlib
import random

import numpy as np
import pytest
import torch

from capture_goldens import APP_KW
from repro_torch import convert
from repro_torch.core import ir, pluto, taskgraph
from repro_torch.core.ir import GraphBuilder, from_tasks, materialize, to_tasks
from repro_torch.core.pluto import Interconnect
from repro_torch.core.scheduler import Task


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run thousands of tiny tensor ops: one intra-op thread is
    faster than a pool, and leaves the cores to the tests beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref(name):
    return importlib.import_module(f"repro.core.{name}")


def _rmode(mode):
    return _ref("pluto").Interconnect(mode.value)


def _same_graph(got, want):
    """Every array field equal in value and dtype, and the tags."""
    for f in ir.ARRAY_FIELDS:
        a, b = getattr(got, f).numpy(), getattr(want, f)
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f
    assert got.tags == want.tags


def _rtasks(tasks):
    """The same tasks as the reference's ``Task`` objects."""
    T = _ref("scheduler").Task
    return [T(**dataclasses.asdict(t)) for t in tasks]


def seeded_tasks(rng, n, n_pes=16, bcast=True, arbitrary_uids=False):
    """A random DAG: ops and moves (some broadcasts) over ``n_pes`` PEs."""
    uids = rng.sample(range(10 * n + 10), n) if arbitrary_uids \
        else list(range(n))
    tasks = []
    for i in range(n):
        deps = tuple(uids[d] for d in range(max(0, i - 4), i)
                     if rng.random() < 0.5)
        if rng.random() < 0.5:
            tasks.append(Task(uids[i], "op", deps=deps,
                              pe=rng.randrange(n_pes),
                              duration=rng.uniform(1.0, 1e4), tag=f"t{i}"))
        else:
            src = rng.randrange(n_pes)
            others = [d for d in range(n_pes) if d != src]
            dst = tuple(rng.sample(others, rng.randint(2, 5))) \
                if bcast and rng.random() < 0.3 else rng.choice(others)
            tasks.append(Task(uids[i], "move", deps=deps, src=src, dst=dst,
                              rows=rng.randint(1, 8)))
    return tasks


@pytest.mark.parametrize("app", sorted(APP_KW))
def test_structural_graphs(app):
    got = taskgraph.structural(app, **APP_KW[app])
    want = _ref("taskgraph").structural(app, **APP_KW[app])
    _same_graph(got, want)
    assert got.n == want.n


@pytest.mark.parametrize("app", sorted(APP_KW))
@pytest.mark.parametrize("mode", list(Interconnect), ids=lambda m: m.value)
def test_materialized_graphs(app, mode):
    got = taskgraph.build_ir(app, mode, **APP_KW[app])
    want = _ref("taskgraph").build_ir(app, _rmode(mode), **APP_KW[app])
    _same_graph(got, want)
    # the legacy Task lists and the preserved legacy builders agree too
    assert [dataclasses.asdict(t) for t in taskgraph.build(
        app, mode, **APP_KW[app])] == [dataclasses.asdict(t) for t in
                                       _ref("taskgraph").build(
                                           app, _rmode(mode), **APP_KW[app])]


@pytest.mark.parametrize("app,kw", [("mm", dict(n=200)), ("pmm", dict(n=300)),
                                    ("ntt", dict(n=512)),
                                    ("bfs", dict(n_nodes=1000)),
                                    ("ntt", dict(n=64, n_pes=32, groups=40)),
                                    ("bfs", dict(n_nodes=50, n_pes=16,
                                                 n_stripes=4))])
def test_paper_size_structure(app, kw):
    got = taskgraph.structural(app, **kw)
    want = _ref("taskgraph").structural(app, **kw)
    _same_graph(got, want)
    for a, b in zip(got.successors(), want.successors()):
        assert np.array_equal(a.numpy(), b)
    assert np.array_equal(got.levels().numpy(), want.levels())


@pytest.mark.parametrize("seed", range(6))
def test_random_graph_derived_structure(seed):
    rng = random.Random(seed)
    tasks = seeded_tasks(rng, rng.randint(1, 60), arbitrary_uids=seed % 2)
    got = from_tasks(tasks)
    want = _ref("ir").from_tasks(_rtasks(tasks))
    _same_graph(got, want)
    for a, b in zip(got.successors(), want.successors()):
        assert a.dtype == torch.int64 and np.array_equal(a.numpy(), b)
    assert np.array_equal(got.levels().numpy(), want.levels())
    got.validate()
    assert [dataclasses.asdict(t) for t in to_tasks(got)] == \
        [dataclasses.asdict(t) for t in _ref("ir").to_tasks(want)]
    assert to_tasks(got) == tasks


def test_taskgraph_from_numpy():
    rng = random.Random(11)
    want = _ref("ir").from_tasks(_rtasks(seeded_tasks(rng, 40)))
    fields = {f: getattr(want, f) for f in ir.ARRAY_FIELDS}
    got = convert.taskgraph_from_numpy({**fields, "tags": want.tags})
    _same_graph(got, want)
    assert ir.graph_fingerprint(got) == importlib.import_module(
        "repro.obs.trace").graph_fingerprint(want)
    with pytest.raises(KeyError, match="dep_pos"):
        convert.taskgraph_from_numpy({k: v for k, v in fields.items()
                                      if k != "dep_pos"})
    with pytest.raises(TypeError, match="kinds"):
        convert.taskgraph_from_numpy(
            {**fields, "kinds": fields["kinds"].astype(np.int64)})


def diamond_tasks():
    return [
        Task(0, "op", pe=0, duration=10.0),
        Task(1, "move", deps=(0,), src=0, dst=2, rows=4),
        Task(2, "move", deps=(0,), src=0, dst=(3, 4), rows=2),
        Task(3, "op", deps=(1, 2), pe=2, duration=5.0, tag="join"),
    ]


def test_round_trips_and_derived():
    tasks = diamond_tasks()
    g = from_tasks(tasks)
    assert to_tasks(g) == tasks
    assert g.levels().tolist() == [0, 1, 1, 2]
    indptr, flat = g.successors()
    assert flat[indptr[0]:indptr[1]].tolist() == [1, 2]
    assert flat[indptr[3]:indptr[4]].tolist() == []
    assert g.deps_of(3).tolist() == [1, 2]
    assert g.dsts_of(2).tolist() == [3, 4]
    back = to_tasks(from_tasks([Task(0, "move", src=0, dst=1),
                                Task(1, "move", src=0, dst=(1,))]))
    assert back[0].dst == 1 and back[1].dst == (1,)
    e = from_tasks([])
    e.validate()
    assert e.n == 0 and e.levels().tolist() == []


def _same_error(build, check=lambda g: g.validate()):
    """The port and the reference raise the same ValueError message."""
    with pytest.raises(ValueError) as got:
        check(build(ir, Task))
    with pytest.raises(ValueError) as want:
        check(build(_ref("ir"), _ref("scheduler").Task))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["cycle", "dangling", "duplicate", "kind",
                                  "self", "no_pe", "no_src", "no_dst",
                                  "long_cycle"])
def test_validation_messages(case):
    def build(m, T):
        if case == "cycle":
            return m.from_tasks([T(10, "op", deps=(11,), pe=0, duration=1.0),
                                 T(11, "op", deps=(10,), pe=0, duration=1.0),
                                 T(12, "op", pe=0, duration=1.0)])
        if case == "long_cycle":
            return m.from_tasks([T(i, "op", deps=((i + 1) % 30,), pe=0)
                                 for i in range(30)])
        if case == "dangling":
            return m.from_tasks([T(0, "op", pe=0, duration=1.0),
                                 T(1, "op", deps=(99,), pe=0, duration=1.0)])
        if case == "duplicate":
            return m.from_tasks([T(3, "op", pe=0), T(3, "op", pe=1)])
        if case == "kind":
            return m.from_tasks([T(0, "teleport", pe=0)])
        if case == "self":
            return m.from_tasks([T(0, "op", deps=(0,), pe=0)])
        if case == "no_pe":
            return m.from_tasks([T(7, "op", duration=5.0)])
        if case == "no_src":
            return m.from_tasks([T(3, "move", dst=1, rows=2)])
        b = m.GraphBuilder()
        b.move(0, ())
        return b.build()
    _same_error(build)


def test_materialize():
    b = GraphBuilder()
    u = b.op(0, op_class="mul")
    b.op(1, (u,), op_class="add")
    g = b.build()
    for mode in Interconnect:
        m = materialize(g, mode)
        assert m.duration.dtype == torch.float64
        assert m.duration[0].item() == pluto.op32_latency_ns("mul", mode)
        assert m.duration[1].item() == pluto.op32_latency_ns("add", mode)
        assert m.dep_pos is g.dep_pos and m._derived is g._derived
    assert (g.duration == 0).all()
    g2 = from_tasks([Task(0, "op", pe=0, duration=123.0)])
    assert materialize(g2, Interconnect.LISA) is g2


def test_structural_cache_and_registry():
    assert taskgraph.structural("mm", n=10, n_pes=16) is \
        taskgraph.structural("mm", n=10, n_pes=16)
    a = taskgraph.build_ir("mm", Interconnect.LISA, n=10)
    b = taskgraph.build_ir("mm", Interconnect.SHARED_PIM, n=10)
    assert a.dep_pos is b.dep_pos
    assert not torch.equal(a.duration, b.duration)
    assert set(taskgraph.known_apps()) >= {"mm", "pmm", "ntt", "bfs", "dfs"}
    with pytest.raises(ValueError, match="unknown app"):
        taskgraph.structural("nope")
    with pytest.raises(TypeError, match="unknown kwargs"):
        taskgraph.structural("mm", bogus=1)
    with pytest.raises(ValueError, match="builtin"):
        taskgraph.register_app("mm", taskgraph._matmul_struct, ())
    with pytest.raises(ValueError, match="cache_clear"):
        taskgraph.register_app("x-app", lambda: None, ())
    with pytest.raises(ValueError, match="unknown optimization pass"):
        taskgraph.build_ir("mm", Interconnect.LISA, opt=("dedup",), n=10)


def test_frozen_graph_flags_writes():
    # a graph of its own: the write lands before the error is raised
    g = from_tasks(diamond_tasks())
    with pytest.raises(RuntimeError, match="[Ii]nference"):
        g.duration.add_(1.0)
    with pytest.raises(RuntimeError, match="[Ii]nference"):
        g.successors()[1][0] = 3
