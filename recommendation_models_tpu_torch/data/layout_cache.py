"""Packed on-disk layout cache.

At ML-25M scale the bucketed layout costs tens of seconds of host work;
``save_layout`` packs a PaddedLayout into one uncompressed ``.npz``,
``load_layout`` restores it, and ``cached_layout`` wraps a builder with an
mtime-checked cache file. The file format is the JAX package's (version
4), so a cache written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import zipfile
from typing import Callable, Optional

import numpy as np

from recommendation_models_tpu_torch.data.layout import Bucket, PaddedLayout

# v3: dense_vals float16, dense_min_degree selection
# v4: hot-column block (hot_ids + per-bucket hot_vals)
_FORMAT_VERSION = 4


def data_fingerprint(*arrays) -> str:
    """Cheap content hash of observation arrays for cache tags: shapes,
    dtypes, strided samples (<= 64k elements per array) and a global sum."""
    h = hashlib.blake2b(digest_size=8)
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(np.asarray(a.shape, np.int64).tobytes())
        h.update(str(a.dtype).encode())
        step = max(1, a.shape[0] // 65536) if a.shape[0] else 1
        h.update(a[::step].tobytes())
        if a.dtype.kind in "fiu" and a.size:
            h.update(np.float64(a.sum(dtype=np.float64)).tobytes())
    return h.hexdigest()


def config_tag(cfg) -> str:
    """Short stable hash of a DataConfig's full field set, so that any
    layout knob change is a cache miss."""
    items = sorted(dataclasses.asdict(cfg).items())
    return hashlib.blake2b(repr(items).encode(), digest_size=6).hexdigest()


def save_layout(path: str, layout: PaddedLayout) -> str:
    """Pack a PaddedLayout into one uncompressed .npz at ``path``."""
    arrays = {
        "meta": np.asarray([_FORMAT_VERSION, layout.n_rows, layout.n_cols,
                            layout.nnz, len(layout.buckets)], np.int64),
        "pads": np.asarray([b.pad for b in layout.buckets], np.int64),
    }
    if layout.dense_ids is not None:
        arrays["dense_ids"] = layout.dense_ids
        arrays["dense_vals"] = layout.dense_vals
    if layout.hot_ids is not None:
        arrays["hot_ids"] = layout.hot_ids
    for i, b in enumerate(layout.buckets):
        arrays[f"rid_{i}"] = b.row_ids
        arrays[f"idx_{i}"] = b.indices
        arrays[f"val_{i}"] = b.values
        arrays[f"msk_{i}"] = b.mask.astype(np.uint8)  # 4x smaller on disk
        if b.hot_vals is not None:
            arrays[f"hv_{i}"] = b.hot_vals
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def load_layout(path: str, mmap: bool = False) -> PaddedLayout:
    """Restore a PaddedLayout packed by ``save_layout``."""
    z = np.load(path, mmap_mode="r" if mmap else None)
    version, n_rows, n_cols, nnz, n_buckets = [int(v) for v in z["meta"]]
    if version != _FORMAT_VERSION:
        raise ValueError(f"layout cache version {version} != {_FORMAT_VERSION}")
    pads = z["pads"]
    buckets = tuple(
        Bucket(pad=int(pads[i]),
               row_ids=np.asarray(z[f"rid_{i}"]),
               indices=np.asarray(z[f"idx_{i}"]),
               values=np.asarray(z[f"val_{i}"]),
               mask=np.asarray(z[f"msk_{i}"]).astype(np.float32),
               hot_vals=(np.asarray(z[f"hv_{i}"])
                         if f"hv_{i}" in z.files else None))
        for i in range(n_buckets))
    dense_ids = np.asarray(z["dense_ids"]) if "dense_ids" in z.files else None
    dense_vals = np.asarray(z["dense_vals"]) if "dense_vals" in z.files else None
    hot_ids = np.asarray(z["hot_ids"]) if "hot_ids" in z.files else None
    return PaddedLayout(n_rows=n_rows, n_cols=n_cols, nnz=nnz,
                        buckets=buckets,
                        dense_ids=dense_ids, dense_vals=dense_vals,
                        hot_ids=hot_ids)


def cached_layout(path: Optional[str],
                  build: Callable[[], PaddedLayout],
                  source_mtime: Optional[float] = None) -> PaddedLayout:
    """Load ``path`` if fresh, else build and save. ``source_mtime``
    invalidates the cache when the source data file is newer; ``path=None``
    just builds."""
    if path is None:
        return build()
    if os.path.exists(path) and (
            source_mtime is None or os.path.getmtime(path) >= source_mtime):
        try:
            return load_layout(path)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            pass  # corrupt or stale cache: rebuild
    layout = build()
    save_layout(path, layout)
    return layout


__all__ = ["save_layout", "load_layout", "cached_layout", "data_fingerprint",
           "config_tag"]
