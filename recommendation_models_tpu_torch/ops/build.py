"""Build and load the port's CUDA sources (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, and loaded with ``ctypes``. The
library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and concurrent
processes never load a half-written file (the build writes to a temporary
name and renames it into place). Libraries go to ``build/kernels/`` at the
root of the checkout. ``build`` takes several sources and starts their
``nvcc`` runs together, in one ``kernels.build`` span, and counts the
sources it compiled in ``kernels.built`` (``utils.profiling``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

from recommendation_models_tpu_torch.utils.profiling import count, span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit "
                       "to build the port's kernels")


def library_path(name: str) -> Path:
    h = hashlib.blake2b(digest_size=8)
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    h.update(repr(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()}.so"


def build(*names: str) -> None:
    """Compile each ``csrc/<name>.cu`` whose library is not built yet, one
    ``nvcc`` per source, all started together; raises if any fails."""
    todo = [(n, library_path(n)) for n in names]
    todo = [(n, out) for n, out in todo if not out.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with span("kernels.build"):
        runs = []
        for name, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            runs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, out, tmp, proc in runs:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu "
                              f"(exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
                count("kernels.built")
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib


__all__ = ["build", "load", "library_path", "nvcc"]
