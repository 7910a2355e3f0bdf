"""The port's checkpoints (``utils/checkpoint.py``) and ``ALS`` checkpoint
and resume: the single-device cases of tests/test_checkpoint.py and
tests/test_estimator_api.py, the same numpy inputs through the JAX
package's ``ALS`` where the two are compared."""

import os
import threading
import warnings

import numpy as np
import pytest
import torch

from recommendation_models_tpu import ALS as RefALS
from recommendation_models_tpu_torch import ALS
from recommendation_models_tpu_torch.utils.checkpoint import (
    load_checkpoint, load_latest, save_checkpoint, wait_pending,
)
from tests.conftest import tiny_problem

torch.set_num_threads(2)


def test_save_load_roundtrip(tmp_path):
    state = dict(U=np.arange(12, dtype=np.float32).reshape(3, 4),
                 V=np.ones((2, 4), np.float32),
                 history=np.array([1.0, 0.5], np.float32))
    save_checkpoint(str(tmp_path), step=3, state=state)
    out = load_checkpoint(str(tmp_path), 3)
    for key in state:
        assert isinstance(out[key], np.ndarray)
        assert out[key].dtype == state[key].dtype
        np.testing.assert_array_equal(out[key], state[key])


def test_tensor_state_restores_as_host_arrays(tmp_path):
    """Tensors go in as host copies (later writes to them do not reach the
    checkpoint) and come back as NumPy arrays of the same dtype."""
    U = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    ids = torch.tensor([3, 1], dtype=torch.int64)
    save_checkpoint(str(tmp_path), step=1, state=dict(U=U, ids=ids,
                                                      scale=2.5),
                    wait=False)
    U.zero_()
    wait_pending()
    out = load_checkpoint(str(tmp_path), 1)
    np.testing.assert_array_equal(out["U"], np.arange(6).reshape(2, 3))
    assert out["ids"].dtype == np.int64 and out["scale"] == 2.5


def test_load_latest_picks_max_step(tmp_path):
    for s in (1, 5, 2):
        save_checkpoint(str(tmp_path), step=s,
                        state=dict(x=np.array([float(s)])))
    step, out = load_latest(str(tmp_path))
    assert step == 5
    assert out["x"][0] == 5.0


def test_load_latest_empty_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_latest(str(tmp_path))


def test_async_save_and_crash_robust_load_latest(tmp_path):
    """wait=False saves commit on the background thread (wait_pending joins
    them); load_latest skips a directory whose save never committed, and a
    state file cut short by a crash."""
    for s in (1, 2):
        save_checkpoint(str(tmp_path), step=s,
                        state=dict(U=np.full((4, 3), float(s))), wait=False)
    wait_pending()
    os.makedirs(tmp_path / "step_00000009")      # never committed
    os.makedirs(tmp_path / "step_00000008")
    with open(tmp_path / "step_00000008" / "state.pt", "wb") as f:
        f.write(b"PK\x03\x04 truncated")         # cut short
    step, state = load_latest(str(tmp_path))
    assert step == 2
    np.testing.assert_array_equal(state["U"], np.full((4, 3), 2.0))
    for s in (8, 9):
        with pytest.raises((OSError, RuntimeError)):
            load_checkpoint(str(tmp_path), s)


def test_async_saves_from_many_threads_all_commit(tmp_path):
    """Async saves started from several threads at once: every one is on
    disk after wait_pending, with its own contents."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(t):
            for j in range(6):
                step = t * 10 + j
                save_checkpoint(str(tmp_path), step=step,
                                state=dict(x=np.full(8, step, np.int64)),
                                wait=False)
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        wait_pending()
    finally:
        sys.setswitchinterval(old)
    for t in range(8):
        for j in range(6):
            step = t * 10 + j
            assert (load_checkpoint(str(tmp_path), step)["x"] == step).all()
    assert load_latest(str(tmp_path))[0] == 75


def test_sidecar_atomic_and_orphan_cleanup(tmp_path):
    """The metadata sidecar is written by rename (no temporary file left),
    a metadata-less save removes a stale sidecar at its step, a non-padded
    directory name loads, and a 'metadata' state key is refused."""
    d = str(tmp_path / "ck")
    state = dict(U=np.ones((4, 2), np.float32))
    save_checkpoint(d, step=3, state=state, metadata={"rank": 2})
    assert load_checkpoint(d, 3)["metadata"] == {"rank": 2}
    assert not [n for n in os.listdir(d) if ".tmp." in n]
    assert not [n for n in os.listdir(os.path.join(d, "step_00000003"))
                if ".tmp." in n]
    with open(os.path.join(d, "step_00000005.meta.json"), "w") as f:
        f.write('{"rank": 99}')
    save_checkpoint(d, step=5, state=state, metadata=None)
    step, st = load_latest(d)
    assert step == 5 and "metadata" not in st
    os.rename(os.path.join(d, "step_00000005"), os.path.join(d, "step_7"))
    step, st = load_latest(d)
    assert step == 7
    np.testing.assert_array_equal(st["U"], state["U"])
    save_checkpoint(d, step=9, state=dict(metadata=np.zeros(2)),
                    metadata={"x": 1})
    with pytest.raises(ValueError, match="clobber"):
        load_checkpoint(d, 9)


# ------------------------------------------------------------- estimators

def test_als_checkpoints_and_resume(tmp_path):
    R = tiny_problem(25, 20, seed=40)
    m = ALS(rank=4, n_sweeps=4, checkpoint_dir=str(tmp_path),
            checkpoint_every=2, platform="cpu").fit(R)
    assert sorted(n for n in os.listdir(tmp_path) if "meta" not in n) == [
        "step_00000002", "step_00000004"]
    m2 = ALS(rank=4, checkpoint_dir=str(tmp_path), platform="cpu")
    assert m2.resume() == 4
    np.testing.assert_array_equal(m2.U_, m.U_)
    np.testing.assert_array_equal(m2.V_, m.V_)
    np.testing.assert_allclose(m2.history_, m.history_, rtol=1e-6)
    assert np.isfinite(m2.predict([0, 1], [0, 1])).all()
    assert (m2.n_users_, m2.n_items_) == (25, 20)
    assert len(m2.top_n(0, 5, exclude_seen=False)) == 5
    meta = load_checkpoint(str(tmp_path), 2)["metadata"]
    assert (meta["n_users"], meta["n_items"], meta["rank"]) == (25, 20, 4)


@pytest.mark.parametrize("kw", [dict(), dict(alpha=2.0),
                                dict(tol=1e-3, n_sweeps=6)])
def test_als_checkpointed_fit_equals_plain_and_reference(tmp_path, kw):
    """Checkpoints take the per-sweep host loop: the factors equal those of
    a fit without checkpoints, and the history the JAX package's (which
    also checkpoints every sweep there) within 1e-4."""
    kw = dict(dict(rank=4, reg=0.2, n_sweeps=4, seed=0), **kw)
    R = tiny_problem(30, 22, density=0.4, seed=41)
    plain = ALS(platform="cpu", **kw).fit(R)
    ck = ALS(platform="cpu", checkpoint_dir=str(tmp_path / "p"),
             checkpoint_every=1, **kw).fit(R)
    ref = RefALS(platform="cpu", checkpoint_dir=str(tmp_path / "r"),
                 checkpoint_every=1, **kw).fit(R)
    np.testing.assert_array_equal(ck.U_, plain.U_)
    np.testing.assert_array_equal(ck.V_, plain.V_)
    assert len(ck.history_) == len(ref.history_)
    np.testing.assert_allclose(ck.history_, ref.history_, rtol=1e-4)
    np.testing.assert_allclose(ck.U_, np.asarray(ref.U_), rtol=2e-4,
                               atol=3e-5 * max(np.abs(ref.U_).max(), 1.0))
    step, _ = load_latest(str(tmp_path / "p"))
    assert step == len(ck.history_)


def test_resumed_recommend_warns_on_exclude_seen(tmp_path):
    R = tiny_problem(25, 20, seed=40)
    ALS(rank=4, n_sweeps=2, checkpoint_dir=str(tmp_path),
        checkpoint_every=1, platform="cpu").fit(R)
    m2 = ALS(rank=4, checkpoint_dir=str(tmp_path), platform="cpu")
    m2.resume()
    with pytest.warns(UserWarning, match="exclude_seen"):
        m2.recommend([0], n=5, exclude_seen=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m2.recommend([0], n=5, exclude_seen=False)


def test_resume_clears_previous_fit_serving_state(tmp_path):
    """resume() after an unrelated fit drops that fit's training lists and
    device catalog: exclude_seen warns instead of using stale lists."""
    d = str(tmp_path / "ck")
    ALS(rank=4, n_sweeps=2, checkpoint_dir=d, checkpoint_every=1,
        platform="cpu").fit(tiny_problem(20, 15, seed=33))
    m = ALS(rank=4, n_sweeps=2, platform="cpu").fit(
        tiny_problem(12, 10, seed=34))
    m.recommend([0], n=3)
    assert hasattr(m, "_vdev_cache")
    m.resume(d)
    assert not hasattr(m, "_train_indptr")
    assert not hasattr(m, "_vdev_cache")
    assert (m.n_users_, m.n_items_) == (20, 15)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _, items = m.recommend([0], n=15, exclude_seen=True)
    assert any("canNOT be excluded" in str(x.message) for x in rec)
    assert sorted(items[0].tolist()) == list(range(15))


def test_resume_matches_reference_resume(tmp_path):
    """Both packages checkpoint the same fit; each resumes its own: the same
    step, and factors within the fit-parity tolerance."""
    R = tiny_problem(25, 20, density=0.4, seed=42)
    rng = np.random.default_rng(1)
    U0 = (0.1 * rng.standard_normal((25, 4))).astype(np.float32)
    V0 = (0.1 * rng.standard_normal((20, 4))).astype(np.float32)
    ALS(rank=4, n_sweeps=3, checkpoint_dir=str(tmp_path / "p"),
        checkpoint_every=3, platform="cpu").fit(R, U0=U0, V0=V0)
    RefALS(rank=4, n_sweeps=3, checkpoint_dir=str(tmp_path / "r"),
           checkpoint_every=3, platform="cpu").fit(R, U0=U0, V0=V0)
    got = ALS(rank=4, platform="cpu")
    ref = RefALS(rank=4)
    assert got.resume(str(tmp_path / "p")) == ref.resume(
        str(tmp_path / "r")) == 3
    np.testing.assert_allclose(got.U_, ref.U_, rtol=2e-4,
                               atol=3e-5 * max(np.abs(ref.U_).max(), 1.0))
    np.testing.assert_allclose(got.history_, ref.history_, rtol=1e-4)
    assert (got.n_users_, got.n_items_) == (ref.n_users_, ref.n_items_)
