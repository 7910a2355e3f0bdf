"""The benchmark's inputs, made on the device from ``--seed``.

``ratings`` draws the configuration's ratings under the law of the port's
``synthetic_ratings`` (the law every record of the port used), with
``torch`` on the run's device in a few large calls:

- users uniform over ``n_users``; items by inverse-CDF sampling of
  ``p(i) ∝ (i + 1) ** -popularity_exponent``; pairs are drawn until
  ``n_ratings`` distinct (user, item) pairs have come, and the first
  ``n_ratings`` distinct pairs in draw order are kept;
- ratings from a rank-``truth_rank`` truth ``<u_f, v_f>`` with rows
  ``N(0, 1) / sqrt(truth_rank)``, plus ``noise · N(0, 1)``, standardized,
  mapped to ``rating_scale`` as ``lo + (hi - lo)(s + 2.5) / 5``, clipped and
  rounded to half stars.

The same seed gives the same arrays on the same device, and every seed
gives exactly ``n_ratings`` ratings (at ML-25M about 34 M draws give the
published 25,000,095 distinct pairs).
"""

from __future__ import annotations

import math

import torch

# ratings are scored in chunks of this many (bounds the (chunk, r) rows)
_SCORE_CHUNK = 4_000_000


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def _draw_keys(n: int, n_users: int, n_items: int, cdf, g, device):
    """``n`` draws of ``user · n_items + item`` under the law."""
    users = torch.randint(0, n_users, (n,), generator=g, device=device)
    u01 = torch.rand(n, dtype=torch.float64, generator=g, device=device)
    items = torch.searchsorted(cdf, u01, right=True).clamp_max_(n_items - 1)
    return users * n_items + items


def first_distinct(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` distinct values of ``keys`` in draw order, sorted."""
    srt, perm = torch.sort(keys, stable=True)
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    idx = torch.sort(perm[first]).values[:n]
    return torch.sort(keys[idx]).values


def ratings(cfg: dict, g: torch.Generator, device):
    """(users int64, items int64, ratings float32), sorted by (user, item),
    on ``device``: the configuration's ``n_ratings`` ratings drawn from
    ``g``."""
    n_users, n_items = int(cfg["n_users"]), int(cfg["n_items"])
    n = int(cfg["n_ratings"])
    if n > n_users * n_items:
        raise ValueError(f"{n} ratings do not fit {n_users} x {n_items}")
    pop = torch.arange(1, n_items + 1, dtype=torch.float64, device=device)
    pop = pop ** -float(cfg["popularity_exponent"])
    cdf = torch.cumsum(pop / pop.sum(), 0)
    cdf[-1] = 1.0
    keys = _draw_keys(n, n_users, n_items, cdf, g, device)
    while True:
        distinct = int(torch.unique(keys).shape[0])
        if distinct >= n:
            break
        # the draws still missing at the average rate so far, twice over
        more = 2 * keys.shape[0] * (n - distinct) // distinct + 4096
        keys = torch.cat([keys, _draw_keys(more, n_users, n_items, cdf, g,
                                           device)])
    key = first_distinct(keys, n)
    del keys
    users, items = key // n_items, key % n_items
    del key
    r = int(cfg["truth_rank"])
    uf = torch.randn((n_users, r), generator=g, device=device) / math.sqrt(r)
    vf = torch.randn((n_items, r), generator=g, device=device) / math.sqrt(r)
    n = users.shape[0]
    scores = torch.empty(n, dtype=torch.float32, device=device)
    for s in range(0, n, _SCORE_CHUNK):
        e = min(s + _SCORE_CHUNK, n)
        scores[s:e] = (uf[users[s:e]] * vf[items[s:e]]).sum(1)
    scores += float(cfg["noise"]) * torch.randn(
        n, generator=g, device=device)
    lo, hi = (float(x) for x in cfg["rating_scale"])
    z = (scores - scores.mean()) / (scores.std(correction=0) + 1e-9)
    vals = torch.clamp(lo + (hi - lo) * (z + 2.5) / 5.0, lo, hi)
    vals = torch.round(vals * 2.0) / 2.0
    return users, items, vals


def normal_table(g: torch.Generator, rows: int, cols: int, scale: float,
                 device) -> torch.Tensor:
    """A (rows, cols) float32 table of ``scale · N(0, 1)`` drawn from g."""
    return torch.randn((rows, cols), generator=g, device=device) * scale


__all__ = ["generator", "first_distinct", "ratings", "normal_table"]
