"""The needed work and the shares against the peaks, held against hand
counts at tiny sizes."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from benchmark import work
from benchmark.runners import als_train


def hand_gram(rows_cols, k):
    """FLOP and bytes of a row set's grams by counting every term."""
    flops = 0
    cols = set()
    for row in rows_cols:
        for c in row:
            cols.add(c)
            # lower triangle: a multiply and an add per entry; rhs: 2 per k
            flops += sum(2 for i in range(k) for j in range(i + 1))
            flops += 2 * k
    n_obs = sum(len(r) for r in rows_cols)
    tri = sum(1 for i in range(k) for j in range(i + 1))
    nbytes = n_obs * 8 + len(cols) * k * 4 + len(rows_cols) * (tri + k) * 4
    return flops, nbytes


@pytest.mark.parametrize("k", [1, 3, 8])
def test_gram_work_matches_a_hand_count(k):
    rows = [[0, 2, 5], [2], [1, 2, 3, 4]]
    n_obs = sum(len(r) for r in rows)
    got = work.gram_work(n_obs, len(rows), len({c for r in rows for c in r}),
                         k)
    assert got == hand_gram(rows, k)


@pytest.mark.parametrize("k", [1, 2, 6])
def test_solve_work_matches_a_hand_count(k):
    # the factor counted as k³/3, the two substitutions as 2k² (a multiply
    # and an add per entry of two triangles)
    n, hot_obs, n_hot = 5, 7, 3
    flops, nbytes = work.solve_work(n, k, hot_obs=hot_obs, n_hot=n_hot)
    assert flops == pytest.approx(n * (k ** 3 / 3 + 2 * k * k)
                                  + hot_obs * (k * (k + 1) + 2 * k))
    tri = k * (k + 1) // 2
    assert nbytes == n * (tri + k + 1 + k) * 4 + hot_obs * 8 + n_hot * k * 4


def test_sweep_flops_is_both_halves_and_every_solve():
    nnz, nu, ni, k = 11, 4, 3, 5
    assert work.sweep_flops(nnz, nu, ni, k) == pytest.approx(
        2 * nnz * (k * (k + 1) + 2 * k) + (nu + ni) * (k ** 3 / 3 + 2 * k * k))


def test_sweep_flops_at_the_cells_sizes():
    # 184.7 GFLOP a sweep at rank 64 and 802.8 at 128 at the cells' sizes
    assert work.sweep_flops(19_027_200, 162_541, 62_423, 64) / 1e9 == \
        pytest.approx(184.7, abs=0.1)
    assert work.sweep_flops(19_027_200, 162_541, 62_423, 128) / 1e9 == \
        pytest.approx(802.8, abs=0.1)


def test_topk_work_matches_a_hand_count():
    B, n_items, k, n_excl, n = 3, 7, 4, 5, 2
    flops, nbytes = work.topk_work(B, n_items, k, n_excl, n)
    assert flops == sum(2 * k for _ in itertools.product(range(B),
                                                        range(n_items)))
    assert nbytes == (B * k + n_items * k) * 4 + n_excl * 4 + B * n * 8


@pytest.mark.parametrize("flops,nbytes", [(1e12, 1.0), (1.0, 1e10),
                                          (5e11, 2e9), (0.0, 0.0)])
def test_no_share_passes_100_at_the_bound(flops, nbytes):
    least = work.least_seconds(flops, nbytes)
    if least == 0:
        assert work.roofline_share(flops, nbytes, 1e-3) == 0
        return
    assert work.roofline_share(flops, nbytes, least) == pytest.approx(100.0)
    for slower in (1.0001, 2.0, 1e3):
        assert work.roofline_share(flops, nbytes, least * slower) < 100.0
    assert work.mfu(flops, flops / work.PEAK_FLOPS) == pytest.approx(100.0)


def test_a_share_of_nothing_measured_is_none():
    assert work.roofline_share(1.0, 1.0, 0.0) is None
    assert work.mfu(1.0, 0.0) is None


class _Layout:
    def __init__(self, dense_ids=None, hot_ids=None):
        self.dense_ids = None if dense_ids is None else np.asarray(dense_ids)
        self.hot_ids = None if hot_ids is None else np.asarray(hot_ids)


def test_needed_work_splits_the_ratings_by_layer():
    # 3 users x 4 items; user side: item 0 hot; item side: item 1 dense
    u = np.array([0, 0, 0, 1, 1, 2], np.int64)
    i = np.array([0, 1, 2, 1, 3, 0], np.int64)
    cfg = {"rank": 2, "n_users": 3, "n_items": 4}
    got = als_train.needed_work(cfg, (u, i, None),
                                (_Layout(hot_ids=[0]),
                                 _Layout(dense_ids=[1])))
    k = 2
    # user side: hot obs (0,0), (2,0); bucket obs the other 4 over 3 rows
    # and items {1, 2, 3}; item side: dense row 1 holds 2 obs over users
    # {0, 1}; bucket obs 4 over items {0, 2, 3} and users {0, 1, 2}
    dense = work.gram_work(2, 1, 2, k)
    gram_u = work.gram_work(4, 2, 3, k)
    gram_i = work.gram_work(4, 3, 3, k)
    solve_u = work.solve_work(3, k, hot_obs=2, n_hot=1)
    solve_i = work.solve_work(4, k)
    assert got["dense"] == dense
    assert got["gram"] == (gram_u[0] + gram_i[0], gram_u[1] + gram_i[1])
    assert got["solve"] == (solve_u[0] + solve_i[0],
                            solve_u[1] + solve_i[1])
    assert got["sweep_flops"] == work.sweep_flops(6, 3, 4, k)
