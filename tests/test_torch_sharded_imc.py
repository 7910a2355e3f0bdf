"""The port's sharded IMC (``IMC(n_shards=S)``: ``models/imc.py``'s
``sharded_sweep_fn``, the psum of ``_solve_factor`` and the sharded
serving route) against the JAX package's on the same numpy inputs, JAX on
its 8 forced CPU devices and the port on a CPU mesh:

- the fit at S = 2, 3 and 8 against the JAX package's sharded fit and
  against the port's single-device fit (tests/test_imc.py's tolerance:
  rtol 5e-3, atol 5e-3 at ``cg_iters`` 32), the objective history, and
  ``exchange_bytes_per_sweep_`` exactly;
- ``_solve_factor`` on one shard bit for bit the single-device call;
- the sweep-by-sweep path against the one-program path, ``tol > 0``,
  checkpoints and ``resume``;
- sharded ``recommend`` ids equal to the JAX package's and to single-device
  serving of the same factors (tests/test_imc.py), a padded last shard,
  pickling, and the raise where the reference fell back in silence.

The card's case (``gpu``) fits S = 4 on one card against the CPU:
``python -m pytest --noconftest -m gpu tests/test_torch_sharded_imc.py``."""

import pickle
import warnings

import numpy as np
import pytest
import torch

from recommendation_models_tpu_torch import IMC
from recommendation_models_tpu_torch.data.synthetic import (
    synthetic_imc_ratings, synthetic_side_features)
from recommendation_models_tpu_torch.models import imc as port_imc
from recommendation_models_tpu_torch.parallel.mesh import Mesh

try:
    from recommendation_models_tpu import IMC as RefIMC
except ImportError:
    # the card's machine has no JAX; there only the gpu test runs
    RefIMC = None

torch.set_num_threads(2)
TOL = dict(rtol=5e-3, atol=5e-3)      # tests/test_imc.py, cg_iters 32


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if RefIMC is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture(scope="module")
def imc_problem():
    # tests/test_torch_imc.py's problem: 60 users, 50 items
    X, Y = synthetic_side_features(60, 50, d_user=12, d_item=10, seed=1)
    users, items, r, _, _ = synthetic_imc_ratings(X, Y, n_obs=900, rank=4,
                                                  noise=0.02, seed=2)
    return X, Y, users, items, r


def _warm(X, Y, k=4, seed=4):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((X.shape[1], k)),
            0.1 * rng.standard_normal((Y.shape[1], k)))


def _both(imc_problem, warm=True, **kw):
    X, Y, users, items, r = imc_problem
    W0, H0 = _warm(X, Y) if warm else (None, None)
    kw = dict(rank=4, reg=0.1, n_sweeps=2, cg_iters=32, platform="cpu", **kw)
    m = IMC(**kw).fit((users, items, r), X, Y, W0=W0, H0=H0)
    ref = RefIMC(**kw).fit((users, items, r), X, Y, W0=W0, H0=H0)
    return m, ref


@pytest.mark.parametrize("S", [2, 3, 8])
def test_sharded_fit_matches_reference_and_single_device(imc_problem, S):
    m, ref = _both(imc_problem, n_shards=S)
    np.testing.assert_allclose(m.W_, ref.W_, **TOL)
    np.testing.assert_allclose(m.H_, ref.H_, **TOL)
    np.testing.assert_allclose(m.history_, ref.history_, rtol=5e-3)
    assert m.exchange_bytes_per_sweep_ == ref.exchange_bytes_per_sweep_
    assert m._fit_sharded_ and m._serve_mesh.size == S
    X, Y, users, items, r = imc_problem
    W0, H0 = _warm(X, Y)
    one = IMC(rank=4, reg=0.1, n_sweeps=2, cg_iters=32,
              platform="cpu").fit((users, items, r), X, Y, W0=W0, H0=H0)
    np.testing.assert_allclose(m.W_, one.W_, **TOL)
    np.testing.assert_allclose(m.H_, one.H_, **TOL)
    assert "exchange_bytes_per_sweep_" not in one.__dict__


def test_default_init_matches_reference(imc_problem):
    m, ref = _both(imc_problem, warm=False, n_shards=4, seed=3)
    np.testing.assert_allclose(m.W_, ref.W_, **TOL)
    np.testing.assert_allclose(m.H_, ref.H_, **TOL)


def test_solve_factor_on_one_shard_is_the_single_device_call(imc_problem):
    """The psum hook leaves the single-device call as it was: one shard
    through ``sharded=True`` gives the same bits."""
    from recommendation_models_tpu_torch.config import DataConfig
    from recommendation_models_tpu_torch.data.layout import layout_from_coo
    from recommendation_models_tpu_torch.solver.als_sweep import (
        device_buckets)
    X, Y, users, items, r = imc_problem
    dcfg = DataConfig(dense_whales=False, hot_cols=0)
    bk = device_buckets(layout_from_coo(users, items, r, 60, 50, dcfg), 1,
                        torch.device("cpu"))
    rng = np.random.default_rng(5)
    F = torch.from_numpy(X.astype(np.float32))
    Z = torch.from_numpy(rng.standard_normal((50, 4)).astype(np.float32))
    M0 = torch.from_numpy(0.1 * rng.standard_normal((12, 4)).astype(
        np.float32))
    a = port_imc._solve_factor(F, Z, bk, 60, M0, 0.1, 20)
    b = port_imc._solve_factor((F,), (Z,), (bk,), 60, M0, 0.1, 20,
                               sharded=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("stepwise", ["verbose", "tol"])
def test_host_loop_and_one_program(imc_problem, stepwise, capsys):
    """The host loop over sweeps (verbose, or tol > 0, which a sharded fit
    takes as the reference does) runs the same sweeps as the one-program
    fit; with tol both packages stop at the same sweep."""
    X, Y, users, items, r = imc_problem
    W0, H0 = _warm(X, Y)
    kw = dict(rank=4, reg=0.1, n_sweeps=4, cg_iters=32, n_shards=3,
              platform="cpu")
    one = IMC(**kw).fit((users, items, r), X, Y, W0=W0, H0=H0)
    if stepwise == "verbose":
        m = IMC(verbose=1, **kw).fit((users, items, r), X, Y, W0=W0, H0=H0)
        assert "[IMC] sweep 4" in capsys.readouterr().out
        np.testing.assert_array_equal(m.W_, one.W_)
        np.testing.assert_array_equal(m.history_, one.history_)
        return
    tol = abs(one.history_[2] - one.history_[1]) * 1.5
    m = IMC(tol=tol, **kw).fit((users, items, r), X, Y, W0=W0, H0=H0)
    ref = RefIMC(tol=tol, **kw).fit((users, items, r), X, Y, W0=W0, H0=H0)
    assert len(m.history_) == len(ref.history_) == 3
    np.testing.assert_array_equal(m.history_, one.history_[:3])
    np.testing.assert_allclose(m.history_, ref.history_, rtol=5e-3)


def test_checkpoint_and_resume(imc_problem, tmp_path):
    X, Y, users, items, r = imc_problem
    kw = dict(rank=4, reg=0.1, n_sweeps=3, cg_iters=32, n_shards=4,
              platform="cpu", seed=2)
    m = IMC(checkpoint_dir=str(tmp_path), checkpoint_every=1, **kw).fit(
        (users, items, r), X, Y)
    plain = IMC(**kw).fit((users, items, r), X, Y)
    np.testing.assert_array_equal(m.W_, plain.W_)
    back = IMC(checkpoint_dir=str(tmp_path), **kw)
    assert back.resume() == 3
    np.testing.assert_array_equal(back.W_, m.W_)
    np.testing.assert_array_equal(back.H_, m.H_)
    np.testing.assert_allclose(back.history_, m.history_, rtol=1e-6)
    # a resumed estimator has no features and no sharded route
    m.recommend([0], n=3)
    m.resume()
    for key in ("_fit_sharded_", "_veff_dev_cache", "_serve_mesh",
                "exchange_bytes_per_sweep_", "_X"):
        assert key not in m.__dict__
    sc, it = m.recommend([0, 1], n=3, X=X, Y=Y)
    assert it.shape == (2, 3)


@pytest.mark.parametrize("S", [3, 8])
def test_sharded_serving_matches_reference(imc_problem, S):
    """tests/test_imc.py::test_sharded_imc_serving_matches_single_device
    through both packages: the served ids equal the JAX package's and the
    port's single-device serving of the same factors; 50 items on S shards
    leave a padded last shard whose rows never become candidates."""
    X, Y, users, items, r = imc_problem
    m, ref = _both(imc_problem, warm=False, n_shards=S)
    uq = np.arange(10)
    for exclude, n in ((True, 7), (False, 5)):
        sc, it = m.recommend(uq, n=n, exclude_seen=exclude, method="exact")
        rsc, rit = ref.recommend(uq, n=n, exclude_seen=exclude,
                                 method="exact")
        np.testing.assert_array_equal(it, rit)
        np.testing.assert_allclose(sc, rsc, **TOL)
        blocks, mesh = m._veff_dev_cache[2][:2]
        per = -(-50 // S)
        assert [b.shape[0] for b in blocks] == [per] * S
        assert mesh is m._serve_mesh
        assert not blocks[-1][50 - per * (S - 1):].any()   # padded rows
        m._fit_sharded_ = False             # the same factors, one device
        sc1, it1 = m.recommend(uq, n=n, exclude_seen=exclude,
                               method="exact")
        m._fit_sharded_ = True
        np.testing.assert_array_equal(it, it1)
        np.testing.assert_allclose(sc, sc1, rtol=1e-5, atol=1e-6)
        assert (it >= 0).all() and (it < 50).all()
    for i, u in enumerate(uq):
        seen = set(items[users == u].tolist())
        _, it = m.recommend([u], n=7, exclude_seen=True, method="exact")
        assert not seen & set(it[0].tolist())


def test_unpickled_serving_mesh_raises_or_warns(imc_problem, monkeypatch):
    """The reference's serving fell back to one device in silence wherever
    its mesh could not be built. The port's unpickled estimator rebuilds
    the mesh (``platform='cpu'``: the same ids), raises where it cannot
    (no card), and on a host with fewer cards than shards only warns and
    serves on one device."""
    m, _ = _both(imc_problem, n_shards=4)
    want = m.recommend(np.arange(6), n=4, exclude_seen=True)
    back = pickle.loads(pickle.dumps(m))
    assert "_serve_mesh" not in back.__dict__ and back._fit_sharded_
    got = back.recommend(np.arange(6), n=4, exclude_seen=True)
    np.testing.assert_array_equal(got[1], want[1])
    assert back._veff_dev_cache is not None
    lost = pickle.loads(pickle.dumps(m))
    lost.platform = None                   # the card, on this host
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lost.recommend([0], n=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert lost._veff_dev_cached() is None
    assert any("fitted on 4 shards" in str(w.message)
               and "serving on one device" in str(w.message) for w in rec)
    # the live estimator keeps serving on its own mesh
    m.platform = None
    assert m._veff_dev_cached()[1] is m._serve_mesh


def test_mesh_must_match_the_shard_count(imc_problem):
    X, Y, users, items, r = imc_problem
    m = IMC(rank=4, n_sweeps=1, n_shards=4, platform="cpu")
    with pytest.raises(ValueError, match="a mesh of 2 devices"):
        m._fit((users, items, r), X, Y, None, None,
               mesh=Mesh([torch.device("cpu")] * 2))


# ----------------------------------------------------------- the card

@pytest.mark.gpu
def test_four_shards_on_the_card_match_the_cpu(imc_problem):
    """Mesh((cuda:0,) * 4): the sharded fit on the card agrees with the same
    fit on a CPU mesh, and serves the same ids through ``sharded_topk``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    X, Y, users, items, r = imc_problem
    kw = dict(rank=4, reg=0.1, n_sweeps=3, cg_iters=32, n_shards=4)
    cpu = IMC(platform="cpu", **kw).fit((users, items, r), X, Y)
    card = IMC(**kw)
    card._fit((users, items, r), X, Y, None, None,
              mesh=Mesh([torch.device("cuda", 0)] * 4))
    np.testing.assert_allclose(card.W_, cpu.W_, **TOL)
    np.testing.assert_allclose(card.H_, cpu.H_, **TOL)
    _, it = card.recommend(np.arange(10), n=5, exclude_seen=True,
                           method="exact")
    assert card._veff_dev_cache[2][0][0].is_cuda
    _, want = cpu.recommend(np.arange(10), n=5, exclude_seen=True,
                            method="exact")
    np.testing.assert_array_equal(it, want)
