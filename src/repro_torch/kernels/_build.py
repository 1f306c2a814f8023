"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for Hopper into a shared
library with a plain C interface and loaded with ``ctypes`` (seconds to
build, where ``torch.utils.cpp_extension.load`` on a source that includes
PyTorch's headers takes minutes).  The library goes to ``build/kernels/`` at
the root of the checkout, named by a hash of its source, the shared headers
``csrc/*.cuh`` it may include and the flags, so that an edited source or
header is rebuilt; it is built at first use, never at import.
``-Xptxas -v`` in ``NVCC_FLAGS`` prints each kernel's registers, shared
memory and spills; the output is kept in ``Library.log``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(CSRC))


@dataclasses.dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: pathlib.Path
    log: str                     # nvcc's -Xptxas -v output of the build


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's compiler")
    return found


def digest(name: str, csrc: pathlib.Path = CSRC) -> str:
    """Hash of ``<name>.cu``, every ``*.cuh`` beside it and the flags."""
    h = hashlib.sha256()
    for path in [csrc / f"{name}.cu", *sorted(csrc.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load(name: str) -> Library:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it."""
    src = CSRC / f"{name}.cu"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{name}-{digest(name)}.so"
    log_path = out.with_suffix(".log")
    if not out.exists():
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}"
                               f"{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    log = log_path.read_text() if log_path.exists() else ""
    return Library(ctypes.CDLL(str(out)), out, log)


def load_all() -> dict[str, Library]:
    """Build every ``csrc/*.cu`` at once (one ``nvcc`` each, all started
    together) and load them."""
    from concurrent.futures import ThreadPoolExecutor
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(load, names)))
