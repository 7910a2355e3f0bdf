"""ctypes binding for the port's native ratings parser (lazy build via g++).

``ratings_parser.cpp`` beside this file is compiled with the host's
``g++ -O3 -march=native`` on first use into ``build/native/`` at the root of
the checkout, never into the package directory, and rebuilt when the source
is newer than the library. The build writes a temporary file and renames it
into place, so concurrent processes never load a half-written library. If
the build or the load fails, or ``RMTPU_NO_NATIVE`` is set, ``parse_ratings``
returns None, the loader in ``movielens.py`` falls back to its NumPy parser,
and one ``logger.warning`` names the reason. C ABI + ctypes only: the same
interface (``parse_ratings``, ``free_buffer``) as the JAX package's parser.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import weakref
from pathlib import Path
from typing import Optional

import numpy as np

from recommendation_models_tpu_torch.utils.logging import logger

SRC = Path(__file__).resolve().parent / "ratings_parser.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
LIB = BUILD_DIR / "_ratings_parser.so"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    """Compile ``SRC`` into ``LIB``; None on success, else the error."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_name(f"{LIB.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, LIB)
        return None
    except subprocess.CalledProcessError as exc:
        return f"g++ exit {exc.returncode}: {exc.stderr.strip()[-2000:]}"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"{type(exc).__name__}: {exc}"


def _load() -> Optional[ctypes.CDLL]:
    """The loaded parser library, built if needed; None (after one warning
    per process) when it cannot be had."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("RMTPU_NO_NATIVE"):
        reason = "RMTPU_NO_NATIVE is set"
    else:
        reason = None
        if not LIB.exists() or (
                SRC.exists() and SRC.stat().st_mtime > LIB.stat().st_mtime):
            reason = _build()
        if reason is None:
            try:
                lib = ctypes.CDLL(str(LIB))
                lib.parse_ratings.restype = ctypes.c_long
                lib.parse_ratings.argtypes = [
                    ctypes.c_char_p, ctypes.c_int,
                    ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
                ]
                lib.free_buffer.restype = None
                lib.free_buffer.argtypes = [ctypes.POINTER(ctypes.c_double)]
                _lib = lib
            except OSError as exc:
                reason = f"loading {LIB} failed: {exc}"
    if _lib is None:
        logger.warning("native ratings parser unavailable (%s); using the "
                       "NumPy parser", reason)
    return _lib


def available() -> bool:
    """Whether the native parser is built and loaded (building it if
    needed)."""
    return _load() is not None


def parse_ratings(path: str, delim: Optional[str], skip_header: bool
                  ) -> Optional[np.ndarray]:
    """Parse with the native scanner: an (n, 3) float64 array [user, item,
    rating]; None if the parser is unavailable or cannot read the file.

    The native scanner is delimiter-agnostic (extracts the first three
    numeric fields per line), so ``delim`` is accepted for API symmetry with
    the NumPy fallback but unused.
    """
    del delim
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_double)()
    n = lib.parse_ratings(os.fsencode(path), int(skip_header),
                          ctypes.byref(out))
    if n < 0:
        logger.warning("native ratings parser could not read %s; using the "
                       "NumPy parser", path)
        return None
    # Zero-copy: wrap the C buffer directly (a copy of ML-25M's 600 MB is
    # seconds of page faults). np.frombuffer holds a reference to `buf`;
    # the finalizer frees the C allocation when the LAST view dies.
    buf = (ctypes.c_double * (n * 3)).from_address(
        ctypes.addressof(out.contents))
    weakref.finalize(buf, lib.free_buffer, out)
    return np.frombuffer(buf, dtype=np.float64).reshape(n, 3)


__all__ = ["available", "parse_ratings", "LIB"]
