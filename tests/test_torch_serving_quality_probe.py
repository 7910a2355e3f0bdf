"""The port's serving-quality probe (``probes/serving_quality.py``) against
the JAX package's ``scripts/serving_quality_probe.py``, both at ML-100K
shape on the CPU, with the JAX package's own serving-test shape (rank 32,
4 sweeps; tests/test_serving_quality.py):

- each package's model path equals its frozen exact path within 5e-4;
- the two packages' recall@10 and NDCG@10 within 0.01 of each other (as
  tests/test_torch_quality_parity.py holds them);
- the port's ``frozen_numpy_recommend`` returns the script's ids exactly
  on the same factors;
- the data and split are the script's;
- ``NPZ_OUT`` -> ``NPZ_IN`` gives the same hashes and metrics, in the port
  and with the JAX script's factors loaded into the port.
"""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import scripts.serving_quality_probe as ref_probe
from recommendation_models_tpu_torch.probes import serving_quality as sq

torch.set_num_threads(2)

SCALE, RANK, SWEEPS = "ml100k", 32, 4
BAND = 5e-4            # model path against frozen path
CROSS = 0.01           # port against JAX


def _ref_run(monkeypatch, **env):
    """The JAX script's ``main()`` at the test's shape: its JSON line."""
    for key, val in dict(SCALE=SCALE, RANK=str(RANK), SWEEPS=str(SWEEPS),
                         SEED="0", **env).items():
        monkeypatch.setenv(key, val)
    buf = io.StringIO()
    with redirect_stdout(buf):
        ref_probe.main()
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' fits, each saved with ``NPZ_OUT``."""
    d = tmp_path_factory.mktemp("sq")
    with pytest.MonkeyPatch.context() as mp:
        ref = _ref_run(mp, NPZ_OUT=str(d / "ref.npz"))
    data = sq.serving_data(SCALE)
    port = sq.run(SCALE, RANK, SWEEPS, 0, npz_out=str(d / "port.npz"),
                  platform="cpu", data=data)
    return dict(ref=ref, port=port, data=data, dir=d)


def test_model_path_equals_frozen_path_in_both_packages(runs):
    for rec in (runs["ref"], runs["port"]):
        assert rec["fit"] == "fit"
        for m in ("recall", "ndcg"):
            assert abs(rec[f"{m}_model_path"]
                       - rec[f"{m}_frozen_path"]) <= BAND, rec
    assert runs["port"]["platform"] == "cpu"
    assert set(runs["port"]) == set(runs["ref"])


def test_packages_agree_on_quality(runs):
    for key in ("recall_model_path", "ndcg_model_path",
                "recall_frozen_path", "ndcg_frozen_path"):
        assert abs(runs["port"][key] - runs["ref"][key]) <= CROSS, key


def test_split_is_the_scripts(runs):
    n_users, n_items, train, eval_users, rel_eval = runs["data"]
    from recommendation_models_tpu.data.synthetic import synthetic_ratings
    from recommendation_models_tpu.evaluate import (
        grouped_by_user, leave_n_out)
    u, i, r = synthetic_ratings(*ref_probe.SCALES[SCALE], rank=16, seed=0)
    tr, te = leave_n_out(u, i, r, n=2, seed=0)
    assert (n_users, n_items) == ref_probe.SCALES[SCALE][:2]
    assert train.nnz == int(tr.sum())
    rel_indptr, _ = grouped_by_user(u[te], i[te], n_users)
    np.testing.assert_array_equal(
        eval_users, np.flatnonzero(np.diff(rel_indptr) > 0)[:20_000])
    assert sq.SCALES == ref_probe.SCALES


def test_frozen_path_returns_the_scripts_ids(runs):
    n_users, n_items, train, eval_users, _ = runs["data"]
    with np.load(runs["dir"] / "ref.npz") as f:
        U, V = f["U"], f["V"]
    got = sq.frozen_numpy_recommend(U, V, eval_users, train, sq.K)
    want = ref_probe.frozen_numpy_recommend(U, V, eval_users, train, sq.K)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["port", "ref"])
def test_npz_round_trip(runs, which):
    """The saved factors served again through ``NPZ_IN``: the hashes and
    the frozen metrics exactly the saving run's; the model path within
    5e-4 of them (the port's served items on the JAX package's factors)."""
    rec = sq.run(SCALE, RANK, SWEEPS, 0,
                 npz_in=str(runs["dir"] / f"{which}.npz"), platform="cpu",
                 data=runs["data"])
    want = runs[which]
    assert rec["fit"] == "loaded"
    for key in ("U_hash", "V_hash", "recall_frozen_path",
                "ndcg_frozen_path"):
        assert rec[key] == want[key], key
    for m in ("recall", "ndcg"):
        assert abs(rec[f"{m}_model_path"] - want[f"{m}_model_path"]) <= BAND
    if which == "port":
        assert rec == {**want, "fit": "loaded"}


def test_the_probe_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sq.main([], env={})
