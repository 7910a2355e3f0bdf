"""The port's default init against the reference's ``jax.random`` draw.

``recommendation_models_tpu_torch/prng.py`` reproduces, in NumPy,
``jax.random.PRNGKey``, ``split`` (bit for bit) and ``normal`` (within 4
float32 ulps: its ``log1p`` and ``sqrt`` are NumPy's, not XLA's), and
``ALS.fit`` with no warm start draws U0 and V0 from it as the reference
does, so a default-init fit follows the reference's history.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recommendation_models_tpu import ALS as RefALS
from recommendation_models_tpu_torch import ALS, prng

torch.set_num_threads(2)
CPU = jax.devices("cpu")[0]
SEEDS = (0, 7, 123456)
ULPS = 4


def _ulps(a, b):
    """Per-element distance of two float32 arrays in ulps (the float32
    values mapped to consecutive integers, across zero too)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def _ref_keys(seed):
    with jax.default_device(CPU):
        return jax.random.split(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_keys_are_bit_exact(seed):
    key = prng.prng_key(seed)
    with jax.default_device(CPU):
        ref_key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key, np.asarray(jax.random.key_data(
        ref_key)))
    got = prng.split(key)
    assert got.dtype == np.uint32 and got.shape == (2, 2)
    np.testing.assert_array_equal(got, np.asarray(jax.random.key_data(
        _ref_keys(seed))))


@pytest.mark.parametrize("shape", [(5, 3), (300, 8), (1001, 64)])
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_ulps_of_jax(seed, shape):
    """Both keys of the split: the bits bit for bit, the normals within
    ``ULPS`` (odd element count at (5, 3), the rank-64 width at
    (1001, 64))."""
    for key, ref_key in zip(prng.split(prng.prng_key(seed)),
                            _ref_keys(seed)):
        with jax.default_device(CPU):
            ref_bits = np.asarray(jax.random.bits(ref_key, shape))
            ref = np.asarray(jax.random.normal(ref_key, shape))
        np.testing.assert_array_equal(prng.random_bits(key, shape), ref_bits)
        got = prng.normal(key, shape)
        assert got.dtype == np.float32 and got.shape == shape
        assert _ulps(got, ref).max() <= ULPS


@pytest.mark.parametrize("seed", SEEDS)
def test_default_init_draws_the_reference_factors(seed):
    """``_init_factors_host`` (U, then V, scaled in float32) against the
    reference estimator's own."""
    kw = dict(rank=8, seed=seed, init_scale=0.05)
    U, V = ALS(platform="cpu", **kw)._init_factors_host(31, 17)
    with jax.default_device(CPU):
        rU, rV = RefALS(platform="cpu", **kw)._init_factors_host(31, 17)
    for got, ref in ((U, rU), (V, rV)):
        ref = np.asarray(ref)
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert _ulps(got, ref).max() <= ULPS


def _queue3_problem(seed=0):
    """300 x 200 ratings from 6,000 random (user, item, rating 1-5) draws,
    duplicates summed and clipped to 5."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 300, 6_000)
    i = rng.integers(0, 200, 6_000)
    r = rng.integers(1, 6, 6_000).astype(np.float32)
    R = sp.csr_matrix((r, (u, i)), shape=(300, 200))
    R.sum_duplicates()
    R.data = np.minimum(R.data, 5.0).astype(np.float32)
    return R


def test_default_init_fit_follows_the_reference_history():
    """A fit with no warm start, 10 sweeps, against the reference's
    default-init fit: the history within the parity tests' rtol 1e-3."""
    R = _queue3_problem()
    kw = dict(rank=8, n_sweeps=10, seed=0, sse_mode="separate",
              platform="cpu")
    got = ALS(**kw).fit(R)
    ref = RefALS(**kw).fit(R)
    assert len(got.history_) == 10
    np.testing.assert_allclose(got.history_, np.asarray(ref.history_),
                               rtol=1e-3)
