"""The pass pipeline: staged, inspectable rewrites over the TaskGraph IR
(PyTorch port of ``repro/passes/pipeline.py``: plain Python, the same
descriptors and digests).

The frontend and the app builders emit *logical* graphs — virtual PEs,
symbolic op classes, every hand-off spelled out.  Everything physical
(which bank a virtual PE lands on, which moves are redundant once placement
is known) is decided here, by a pipeline of pure
``TaskGraph -> TaskGraph`` passes run in four stages::

    validate  -> place        -> optimize            -> legalize
    (reject     (virtual PE      (delete/coalesce/      (re-validate;
     malformed    -> physical     fuse moves using       bounds-check
     graphs)      PE maps)        placement knowledge)   endpoints)

Every pass appends :class:`Rewrite` records to the run's
:class:`RewriteLog`, so a schedule can always answer *which compiler
decision produced this graph*.  A pipeline with no optimization passes is
the **off** configuration: it reproduces the pre-pipeline placement path
bit-for-bit (the golden schedules pin this), which is what lets the
optimizing configuration be compared honestly against it.

:func:`Pipeline.fingerprint` digests the stage descriptors; batch-runner
and partitioner caches key per-stage artifacts on it so two sweeps that
share a pipeline share its work.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence

from repro_torch.core.ir import TaskGraph

#: stage order every pipeline must respect
STAGES = ("validate", "place", "optimize", "legalize")
_STAGE_RANK = {s: i for i, s in enumerate(STAGES)}


@dataclasses.dataclass(frozen=True)
class Rewrite:
    """One recorded graph rewrite (log entry, not an instruction)."""

    pass_name: str
    action: str                  # "eliminate" | "coalesce" | "fuse"
    uid: int                     # uid of the task removed by the rewrite
    into: int | None = None      # uid of the surviving task, if any
    detail: str = ""

    def __str__(self) -> str:
        tail = f" -> kept uid {self.into}" if self.into is not None else ""
        note = f" ({self.detail})" if self.detail else ""
        return f"[{self.pass_name}] {self.action} uid {self.uid}{tail}{note}"


class RewriteLog:
    """Ordered record of every rewrite a pipeline run applied."""

    def __init__(self) -> None:
        self.entries: list[Rewrite] = []

    def add(self, entry: Rewrite) -> None:
        self.entries.append(entry)

    def count(self, action: str | None = None) -> int:
        if action is None:
            return len(self.entries)
        return sum(e.action == action for e in self.entries)

    def summary(self) -> dict[str, int]:
        """Rewrite counts per action (stable keys for benchmark artifacts)."""
        out = {"eliminated": self.count("eliminate"),
               "coalesced": self.count("coalesce"),
               "fused": self.count("fuse")}
        out["total"] = len(self.entries)
        return out

    def __len__(self) -> int:
        return len(self.entries)

    def __str__(self) -> str:
        if not self.entries:
            return "(no rewrites)"
        return "\n".join(str(e) for e in self.entries)


class Pass:
    """One pure ``TaskGraph -> TaskGraph`` stage of a pipeline.

    Subclasses set ``name`` and ``stage`` and implement :meth:`run`.  A pass
    must never mutate its input (IR arrays are frozen, so an attempt raises)
    and must return the input graph *unchanged* when it has nothing to do —
    that is what makes pass application idempotent and lets the pipeline
    cache per-stage artifacts.
    """

    name: str = "pass"
    stage: str = "optimize"

    def run(self, g: TaskGraph, log: RewriteLog) -> TaskGraph:
        raise NotImplementedError

    def describe(self) -> str:
        """Stable descriptor (name + parameters) used for fingerprints."""
        return self.name

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.describe()}>"


class Pipeline:
    """An ordered, stage-checked sequence of passes."""

    def __init__(self, passes: Sequence[Pass]):
        self.passes = tuple(passes)
        last = -1
        for p in self.passes:
            rank = _STAGE_RANK.get(p.stage)
            if rank is None:
                raise ValueError(
                    f"pass {p.describe()!r} has unknown stage {p.stage!r}; "
                    f"stages are {STAGES}")
            if rank < last:
                raise ValueError(
                    f"pass {p.describe()!r} ({p.stage}) is out of stage "
                    f"order; pipelines run {' -> '.join(STAGES)}")
            last = rank

    def run(self, g: TaskGraph) -> tuple[TaskGraph, RewriteLog]:
        """Run every pass in order; returns (graph, rewrite log)."""
        log = RewriteLog()
        for p in self.passes:
            g = p.run(g, log)
        return g, log

    def describe(self) -> tuple[str, ...]:
        return tuple(p.describe() for p in self.passes)

    def fingerprint(self) -> str:
        """Short stable digest of the stage descriptors (cache key part)."""
        blob = "|".join(self.describe()).encode()
        return hashlib.sha256(blob).hexdigest()[:12]

    def __repr__(self) -> str:
        return f"<Pipeline {' -> '.join(self.describe()) or '(empty)'}>"
