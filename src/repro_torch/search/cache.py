"""Persistent on-disk oracle cache (append-only JSONL, corruption tolerant;
PyTorch port of ``repro/search/cache.py``).

One :class:`OracleCache` file stores every engine-oracle verdict a search
has ever computed, keyed by ``(graph fingerprint, geometry, interconnect,
placement digest)`` — the composite key the
:class:`~repro_torch.search.oracle.PlacementOracle` builds from
:func:`repro_torch.obs.trace.graph_fingerprint` plus the candidate map's SHA-256
digest.  Repeated searches, CI smoke runs, and the autotuner warm-start
from it instead of recomputing: a fully warm search re-run issues **zero**
full engine evaluations (``benchmarks/placement.py`` guards this).

Design constraints, in order:

* **never crash on a bad file** — the cache lives across runs and machines,
  so a truncated final line (killed process), a garbage line (concurrent
  writer, disk corruption), or a wrong-schema line must each degrade to a
  cache miss, not an exception.  Every line is parsed independently;
  unparseable or mis-shaped lines are counted and skipped.
* **append-only writes** — a put is one ``json.dumps`` line appended to the
  file, so a crash can only ever truncate the newest entry (which the
  reader then skips).  Re-puts of a key append a new line; the last parseable
  occurrence wins on load.
* **values are plain JSON** — floats for oracle makespans, objects for
  autotuner choices; the cache does not interpret them.
"""

from __future__ import annotations

import json
import weakref
from pathlib import Path

#: every live cache, so :func:`clear_loaded` (via
#: ``repro_torch.device.batch.clear_caches``) can drop in-memory state without
#: holding references that would keep test-temporary caches alive
_CACHES: "weakref.WeakSet[OracleCache]" = weakref.WeakSet()


class OracleCache:
    """Append-only JSONL key/value store (see module docstring)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._mem: dict[str, object] = {}
        self._loaded = False
        self.n_bad_lines = 0
        _CACHES.add(self)

    # --- load -------------------------------------------------------------------

    def _load(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        self._mem = {}
        self.n_bad_lines = 0
        try:
            text = self.path.read_text()
        except (OSError, UnicodeDecodeError):
            return                        # missing/unreadable file == empty
        for line in text.splitlines():
            if not line.strip():
                continue
            try:
                entry = json.loads(line)
                key, value = entry["k"], entry["v"]
                if not isinstance(key, str):
                    raise TypeError(key)
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                # truncated tail, garbage, or wrong schema: a miss, never
                # an error — the oracle recomputes and re-appends
                self.n_bad_lines += 1
                continue
            self._mem[key] = value        # later lines win

    # --- access -----------------------------------------------------------------

    def get(self, key: str):
        """The stored value, or ``None`` when absent (or unparseable)."""
        self._load()
        return self._mem.get(key)

    def put(self, key: str, value) -> None:
        """Store ``value`` (append one JSONL line; last write wins)."""
        self._load()
        if key in self._mem and self._mem[key] == value:
            return                        # idempotent re-put: no disk churn
        self._mem[key] = value
        line = json.dumps({"k": key, "v": value}, separators=(",", ":"))
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "a+") as f:
            # a truncated final line (crashed writer) must not swallow this
            # append: start on a fresh line unless the file ends with one
            f.seek(0, 2)
            if f.tell():
                f.seek(f.tell() - 1)
                if f.read(1) != "\n":
                    f.write("\n")
            f.write(line + "\n")

    def __contains__(self, key: str) -> bool:
        self._load()
        return key in self._mem

    def __len__(self) -> int:
        self._load()
        return len(self._mem)

    # --- teardown ---------------------------------------------------------------

    def forget(self) -> None:
        """Drop in-memory state only; the next access re-reads the file."""
        self._mem = {}
        self._loaded = False

    def clear(self) -> None:
        """Forget everything *and* delete the backing file."""
        self.forget()
        try:
            self.path.unlink()
        except OSError:
            pass


def clear_loaded() -> None:
    """Drop every live cache's in-memory state (files stay on disk).

    Part of the :func:`repro_torch.device.batch.clear_caches` teardown: after
    this, a cold-start benchmark measures real file reads again instead of
    hitting process-lifetime dictionaries.
    """
    for c in list(_CACHES):
        c.forget()
