"""The comparison that decides ``correct``.

Each number compared has a limit of its own (``benchmark/workloads/<cell>.json``,
``limits``); a run is correct when every number is finite and at most its
limit. The numbers:

Training (a call of the window's fit against the reference's sweeps
from the same start; the set-up's first call, from the seeded warm start,
reads under these names, the window's last call under ``window_`` and
these names):

- ``loss_gap``: the widest relative gap between the training RMSE that the
  program reports after a sweep and the reference's, over the call's
  sweeps;
- ``rmse_gap``: the relative gap between the training RMSE of the
  program's returned U and V, worked out again in float64, and that of the
  reference's (it does not rest on the SSE that the program reports);
- ``factor_gap``: the widest gap of a factor row, over both tables: the
  norm of the program's row minus the reference's, over the larger of the
  reference row's norm and the table's median row norm (some rows are all
  but zero).

Serving (every answer of every call in the window, against the reference's
exact top n of the same users):

- ``bad_answers``: served items that cannot be right whatever the scores:
  an id outside the catalog, an item twice in one answer, or an item the
  user rated where the cell excludes them (limit 0);
- ``rank_gap``: the widest gap by which the reference's score of a served
  item lies below the reference's score at that rank, over the user's
  best reference score;
- ``score_gap``: the widest gap between a served score and the reference's
  score of the served item, over the user's best reference score.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.references import als as als_reference


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) of ``numbers`` against
    ``limits``; a number without a limit, or not finite, fails."""
    checks = {}
    ok = True
    for name, value in numbers.items():
        limit = limits.get(name)
        value = float(value)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, checks


def rmse(sse, nnz: int) -> np.ndarray:
    return np.sqrt(np.maximum(np.asarray(sse, np.float64), 0.0) / nnz)


def worst_row_gap(P: torch.Tensor, R: torch.Tensor) -> float:
    """max over rows of ‖P_r − R_r‖ / max(‖R_r‖, median_r ‖R_r‖), in
    float64; inf when P holds a value that is not finite."""
    P = P.to(R.device, torch.float64)
    R = R.to(torch.float64)
    if not bool(torch.isfinite(P).all()):
        return math.inf
    d = (P - R).norm(dim=1)
    n = R.norm(dim=1)
    denom = torch.clamp_min(n, float(n.median()))
    if float(denom.max()) == 0.0:
        return float(d.max())
    return float((d / torch.clamp_min(denom, 1e-300)).max())


def train_numbers(got, ref, ratings) -> dict:
    """``loss_gap``, ``rmse_gap`` and ``factor_gap`` of a call (see the
    module): ``got`` the program's (history SSE, U, V), ``ref`` the
    reference's, ``ratings`` the (users, items, values) on the reference's
    device."""
    prog_sse, prog_U, prog_V = got
    ref_sse, ref_U, ref_V = ref
    nnz = int(ratings[0].shape[0])
    prog_sse = np.asarray(prog_sse, np.float64)
    ref_rmse = rmse(ref_sse, nnz)
    if prog_sse.shape != ref_rmse.shape or not np.isfinite(prog_sse).all():
        loss_gap = math.inf
    else:
        loss_gap = float(np.max(np.abs(rmse(prog_sse, nnz) - ref_rmse)
                                / ref_rmse))
    U = prog_U.to(ref_U.device, torch.float64)
    V = prog_V.to(ref_V.device, torch.float64)
    if bool(torch.isfinite(U).all()) and bool(torch.isfinite(V).all()):
        prog_rmse = rmse([float(als_reference.sse(*ratings, U, V))], nnz)
        rmse_gap = float(abs(prog_rmse[0] - ref_rmse[-1]) / ref_rmse[-1])
    else:
        rmse_gap = math.inf
    factor_gap = max(worst_row_gap(U, ref_U), worst_row_gap(V, ref_V))
    return {"loss_gap": loss_gap, "rmse_gap": rmse_gap,
            "factor_gap": factor_gap}


def serve_numbers(users, items, scores, U, V, ref_top, seen_keys,
                  n_items: int, chunk: int = 1 << 17) -> dict:
    """``bad_answers``, ``rank_gap`` and ``score_gap`` of served answers,
    and the positions of the answers (rows) that hold a bad item.

    ``users`` (A,) the user of each answer, ``items`` and ``scores`` (A, n)
    what was served; ``U``, ``V`` the factor tables (float64, on the device
    of the comparison); ``ref_top`` (n_users, n) the reference's top-n
    scores; ``seen_keys`` the sorted ``user · n_items + item`` keys of the
    rated pairs, or None where seen items may be served."""
    dev = U.device
    bad = 0
    bad_rows = []
    rank_gap = score_gap = 0.0
    for s in range(0, users.shape[0], chunk):
        e = min(s + chunk, users.shape[0])
        u = torch.as_tensor(users[s:e], device=dev).long()
        it = torch.as_tensor(items[s:e], device=dev).long()
        sc = torch.as_tensor(scores[s:e], device=dev).double()
        inside = (it >= 0) & (it < n_items)
        srt, order = torch.sort(it, dim=1)
        dup_sorted = torch.zeros_like(inside)
        dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
        dup = torch.zeros_like(inside).scatter_(1, order, dup_sorted)
        wrong = ~inside | dup
        if seen_keys is not None:
            key = u[:, None] * n_items + it
            pos = torch.searchsorted(seen_keys, key).clamp_max_(
                seen_keys.shape[0] - 1)
            wrong |= seen_keys[pos] == key
        bad += int(wrong.sum())
        bad_rows.append(torch.nonzero(wrong.any(1)).squeeze(1).cpu().numpy()
                        + s)
        itc = it.clamp(0, n_items - 1)
        ref_sc = (U[u][:, None, :] * V[itc]).sum(-1)          # (b, n)
        best = ref_top[u]                                       # (b, n)
        scale = best[:, :1].abs().clamp_min(1e-300)
        ok = ~wrong
        if not bool(torch.isfinite(sc[ok]).all()):
            rank_gap = score_gap = math.inf
        zero = torch.zeros_like(ref_sc)
        rg = torch.where(ok, (best - ref_sc) / scale, zero)
        sg = torch.where(ok, (sc - ref_sc).abs() / scale, zero)
        if rg.numel():
            rank_gap = max(rank_gap, float(rg.max()))
            score_gap = max(score_gap, float(sg.max()))
    numbers = {"bad_answers": float(bad), "rank_gap": rank_gap,
               "score_gap": score_gap}
    return numbers, np.concatenate(bad_rows) if bad_rows else np.zeros(0)


__all__ = ["verdict", "rmse", "worst_row_gap", "train_numbers",
           "serve_numbers"]
