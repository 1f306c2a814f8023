"""Fault-tolerant checkpointing: atomic, async (PyTorch port of
``repro/checkpoint/checkpointer.py``).

Layout:  <dir>/step_<k>/{manifest.json, arr_<i>.npy...}, the reference's:

* leaves are numbered in ``jax.tree.flatten`` order, which sorts dict keys
  (``repro_torch.tree``), so a checkpoint written by either package
  restores in the other;
* bfloat16 leaves are written as float32 (an exact upcast), as the
  reference does; ``restore`` casts back to the target's dtype;
* **atomic**: writes land in ``step_<k>.tmp`` and are renamed only after the
  manifest is fsync'd;
* **async**: ``save_async`` copies every leaf to host memory before it
  returns (a copy of its own, also for a leaf already on the host), so the
  in-place optimizer update of the next step cannot reach the snapshot;
  a background thread writes it.

One card holds the whole state, so there is no re-sharding on restore.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch import tree


def _host(leaf: torch.Tensor) -> np.ndarray:
    """A host copy of ``leaf`` that no later in-place update reaches: the
    numpy view of a tensor already on the host shares its memory, so it is
    copied."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy()      # .float() is a new tensor
    if t.device.type == "cpu":
        return t.numpy().copy()
    return t.cpu().numpy()


class Checkpointer:
    def __init__(self, directory: str | os.PathLike):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ---------------- save ----------------

    def save(self, state, step: int) -> pathlib.Path:
        host = [_host(x) for x in tree.leaves(state)]
        return self._write(host, tree.structure(state), step)

    def save_async(self, state, step: int) -> None:
        self.wait()
        host = [_host(x) for x in tree.leaves(state)]     # snapshot now
        self._thread = threading.Thread(
            target=self._write, args=(host, tree.structure(state), step),
            daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, host_leaves, structure: str, step: int) -> pathlib.Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        for i, arr in enumerate(host_leaves):
            np.save(tmp / f"arr_{i}.npy", arr)
        manifest = {"step": step, "n_leaves": len(host_leaves),
                    "treedef": structure}
        mf = tmp / "manifest.json"
        with open(mf, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        return final

    # ---------------- restore ----------------

    def latest_step(self) -> int | None:
        steps = [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                 if p.is_dir() and not p.name.endswith(".tmp")]
        return max(steps) if steps else None

    def restore(self, target: Any, step: int | None = None) -> tuple[Any, int]:
        """Restore into the structure of ``target``, a tree of tensors whose
        shapes, dtypes and devices the restored leaves take."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / f"step_{step:08d}"
        with open(path / "manifest.json") as f:
            manifest = json.load(f)
        refs = tree.leaves(target)
        if manifest["n_leaves"] != len(refs):
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, target has "
                f"{len(refs)} — incompatible structures")
        out = []
        for i, ref in enumerate(refs):
            arr = np.load(path / f"arr_{i}.npy")
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: shape {arr.shape} != "
                                 f"{tuple(ref.shape)}")
            out.append(torch.from_numpy(arr).to(device=ref.device,
                                                 dtype=ref.dtype))
        return tree.unflatten(target, out), step
