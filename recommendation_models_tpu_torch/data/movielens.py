"""MovieLens dataset parsers (SURVEY.md N12; BASELINE.json configs 1-3).

Handles the three on-disk formats:

- ML-100K  ``u.data``            tab-separated  ``user\\titem\\trating\\tts``
- ML-1M    ``ratings.dat``       ``user::item::rating::ts``
- ML-25M   ``ratings.csv``       CSV with header ``userId,movieId,rating,timestamp``

IDs are remapped to dense 0-based ranges (MovieLens ids are 1-based and, for
25M, sparse in movieId space). A packed ``.npz`` cache is written next to the
source file so big files parse once (SURVEY.md §7 hard part 6).

The text decode goes through the native parser (``data/native``) when it
builds; otherwise through NumPy, after one warning that names the reason.
Each load logs one INFO record on the ``recommendation_models_tpu_torch``
logger whose ``ingest`` attribute holds the route (``native``, ``numpy`` or
``cache``), the row count and the seconds of the parse, the remap and the
cache write.

The cache file name is the JAX package's (``<path>[.<fmt>].rmtpu.npz``), so
the two loaders share a cache for the same file.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np

from recommendation_models_tpu_torch.data import native
from recommendation_models_tpu_torch.utils.logging import logger


def _dense_remap(ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    uniq, inv = np.unique(ids, return_inverse=True)
    return inv.astype(np.int32), uniq


def _parse_numpy(path: str, delim: Optional[str], skip_header: bool
                 ) -> np.ndarray:
    """The NumPy fallback: an (n, 3) float64 array [user, item, rating]."""
    # '::' needs a two-step split since loadtxt wants 1-char delimiters.
    if delim == "::":
        with open(path, "rb") as f:
            raw = f.read().replace(b"::", b"\t")
        from io import BytesIO
        return np.loadtxt(BytesIO(raw), delimiter="\t", usecols=(0, 1, 2),
                          ndmin=2)
    return np.loadtxt(path, delimiter=delim, usecols=(0, 1, 2),
                      skiprows=1 if skip_header else 0, ndmin=2)


def load_ratings_file(
    path: str,
    fmt: Optional[str] = None,
    cache: bool = True,
) -> Dict[str, np.ndarray]:
    """Load a MovieLens ratings file of any vintage.

    Returns dict with ``users`` (int32, dense), ``items`` (int32, dense),
    ``ratings`` (float32), ``n_users``, ``n_items``, plus the original-id
    vocabularies ``user_vocab`` / ``item_vocab``.

    Robustness: with the NATIVE parser, malformed/short/binary lines are
    skipped and CRLF / missing trailing newlines handled; the NumPy fallback
    (no C toolchain) is strict and raises on malformed lines. Ids flow
    through float64/uint64 — exact to 2^53, silently ROUNDED (not wrapped)
    beyond (MovieLens ids are <10^6).

    The cache key is (path, fmt): an explicit ``fmt`` different from the
    cached parse re-parses. A corrupt/truncated cache (crash mid-write)
    falls through to a re-parse instead of poisoning every later load.
    """
    cache_path = path + (f".{fmt}" if fmt else "") + ".rmtpu.npz"
    # A cache with a missing source is valid (archives are often deleted
    # after ingest); only a NEWER source invalidates it.
    if cache and os.path.exists(cache_path) and (
            not os.path.exists(path)
            or os.path.getmtime(cache_path) >= os.path.getmtime(path)):
        t0 = time.perf_counter()
        try:
            with np.load(cache_path) as z:
                out = {k: z[k] for k in z.files} | {
                    "n_users": int(z["user_vocab"].shape[0]),
                    "n_items": int(z["item_vocab"].shape[0]),
                }
        except Exception:
            # truncated/corrupt cache (e.g. killed mid-write): re-parse
            # and rewrite rather than raising BadZipFile forever
            pass
        else:
            _log_ingest(path, "cache", out["ratings"].shape[0],
                        read_s=time.perf_counter() - t0)
            return out

    if fmt is None:
        base = os.path.basename(path)
        if base.endswith(".csv"):
            fmt = "csv"
        elif base.endswith(".dat"):
            fmt = "dat"
        else:
            fmt = "tsv"
    if fmt == "csv":
        delim, skip_header = ",", True
    elif fmt == "dat":
        delim, skip_header = "::", False
    elif fmt == "tsv":
        delim, skip_header = "\t", False
    else:
        raise ValueError(f"unknown MovieLens format: {fmt!r}")
    t0 = time.perf_counter()
    arr = native.parse_ratings(path, delim, skip_header)
    route = "native"
    if arr is None:
        arr, route = _parse_numpy(path, delim, skip_header), "numpy"
    t1 = time.perf_counter()

    users, user_vocab = _dense_remap(arr[:, 0].astype(np.int64))
    items, item_vocab = _dense_remap(arr[:, 1].astype(np.int64))
    ratings = arr[:, 2].astype(np.float32)
    out = {
        "users": users, "items": items, "ratings": ratings,
        "user_vocab": user_vocab, "item_vocab": item_vocab,
    }
    t2 = time.perf_counter()
    if cache:
        try:
            # atomic: a crash mid-savez must not leave a truncated cache
            # newer than the source (same tmp+replace pattern as
            # layout_cache)
            tmp = cache_path + f".tmp.{os.getpid()}"
            np.savez_compressed(tmp, **out)
            os.replace(tmp if os.path.exists(tmp) else tmp + ".npz",
                       cache_path)
        except OSError:
            pass
    _log_ingest(path, route, ratings.shape[0], parse_s=t1 - t0,
                remap_s=t2 - t1, cache_s=time.perf_counter() - t2)
    out["n_users"] = int(user_vocab.shape[0])
    out["n_items"] = int(item_vocab.shape[0])
    return out


def _log_ingest(path: str, route: str, rows: int, **seconds: float) -> None:
    ingest = {"path": path, "route": route, "rows": int(rows), **seconds}
    logger.info("loaded %s: %d rows via %s (%s)", path, rows, route,
                ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()),
                extra={"ingest": ingest})


def to_csr(users: np.ndarray, items: np.ndarray, ratings: np.ndarray,
           n_users: int, n_items: int):
    """COO triplets -> scipy CSR (the reference's storage format)."""
    import scipy.sparse as sp
    return sp.csr_matrix((ratings, (users, items)), shape=(n_users, n_items))


__all__ = ["load_ratings_file", "to_csr"]
