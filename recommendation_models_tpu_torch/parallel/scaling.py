"""Analytic scaling model of the sharded ALS: the JAX package's
``parallel/scaling.py``, the same functions and defaults.

    t_sweep(S) = t_compute_1chip / S
               + max(intra_bytes / bw_intra, inter_bytes / bw_inter)

``bytes_per_shard`` is ``ShardedALSProgram.collective_bytes_per_sweep()
['per_sweep_total']`` at the shard count. For ring and hierarchical
collectives every byte crosses every link once per phase, so the per-shard
byte counts are the per-link volumes; the phase inside a slice rides the
fast links (``ici_bytes_per_s``), the phase between slices the slower
host network (``dcn_bytes_per_s``).

The default ``LinkSpec`` is the reference's, public figures of a TPU pod
(about 200 GB/s a chip inside a slice, 25 GB/s a host between slices);
pass the links of the deployment for anything else. Nothing here is
measured.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    ici_bytes_per_s: float = 200e9    # per chip, all fast links combined
    dcn_bytes_per_s: float = 25e9     # per host NIC
    chips_per_host: int = 4


def sweep_time_model(
    compute_s_1chip: float,
    bytes_per_shard: int,
    n_shards: int,
    num_slices: int = 1,
    links: LinkSpec = LinkSpec(),
) -> Dict[str, float]:
    """Predicted per-sweep time and scaling efficiency at ``n_shards``.

    With a slice-major mesh the inter-slice share of a hierarchical
    collective is ``(num_slices - 1) / num_slices`` of one phase, striped
    over the hosts of a slice."""
    compute = compute_s_1chip / n_shards
    if n_shards == 1:
        return dict(n_shards=1, compute_s=compute, comm_s=0.0,
                    sweep_s=compute, efficiency=1.0)
    intra = bytes_per_shard / links.ici_bytes_per_s
    inter = 0.0
    if num_slices > 1:
        chips_per_slice = n_shards // num_slices
        hosts_per_slice = max(1, chips_per_slice // links.chips_per_host)
        inter = (bytes_per_shard * (num_slices - 1) / num_slices
                 / (links.dcn_bytes_per_s * hosts_per_slice))
    comm = max(intra, inter)
    sweep = compute + comm
    eff = (compute_s_1chip / n_shards) / sweep
    return dict(n_shards=n_shards, compute_s=compute, comm_s=comm,
                sweep_s=sweep, efficiency=eff)


def project_scaling(
    compute_s_1chip: float,
    bytes_fn: Callable[[int], int],
    shard_counts: List[int],
    slices_fn: Optional[Callable[[int], int]] = None,
    links: LinkSpec = LinkSpec(),
) -> List[Dict[str, float]]:
    """Efficiency table over shard counts; ``bytes_fn(S)`` gives the
    per-shard bytes at each S, ``slices_fn(S)`` the slice count (default:
    one slice per 8 shards)."""
    if slices_fn is None:
        slices_fn = lambda s: max(1, s // 8)  # noqa: E731
    return [sweep_time_model(compute_s_1chip, bytes_fn(s), s,
                             num_slices=slices_fn(s), links=links)
            for s in shard_counts]


def choose_topology(
    n_rows: int,
    n_cols: int,
    rank: int,
    n_shards: int,
    num_slices: int,
    links: LinkSpec = LinkSpec(),
) -> Dict[str, float]:
    """Per-device inter-slice bytes per half-sweep of the two topologies,
    and which to pick:

    * '1d': rows split over all devices, the opposite table gathered, each
      slice's devices sharing (D-1)/D of it;
    * '2d': rows split inside a slice, observations across slices, the
      per-row normal equations summed between slices.
    """
    D, S = num_slices, n_shards
    if D <= 1:
        return dict(dcn_1d=0.0, dcn_2d=0.0, pick="1d")
    k = rank
    per_slice = max(1, S // D)
    dcn_1d = (D - 1) / D * n_cols * k * 4 / per_slice
    rows_local = -(-n_rows // per_slice)
    dcn_2d = 2 * (D - 1) / D * rows_local * (k * k + k) * 4
    return dict(dcn_1d=dcn_1d, dcn_2d=dcn_2d,
                pick="2d" if dcn_2d < dcn_1d else "1d")


__all__ = ["LinkSpec", "sweep_time_model", "project_scaling",
           "choose_topology"]
