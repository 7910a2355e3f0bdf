"""The rest of the gather study in the port (``probes/split_gather.py``,
``probes/ablate_gram_layout.py``, ``probes/profile_half.py``) against the
JAX package's scripts ``scripts/probe_split_gather.py``,
``scripts/ablate_gram_layout.py`` and ``scripts/profile_half.py`` on the
same numpy inputs, at small sizes:

- the split gram equals the full gram in both packages: the two masked
  gathers only regroup the same f32 sums, so each entry agrees within
  ``1e-5 * Σ|terms|`` (f32 summation order);
- the port's ``gram_from`` against the script's (``bpk,bpl->klb`` with
  f32 accumulation): both round the weighted copy to the table's dtype
  the same way and multiply exactly in f32, so they too differ by
  summation order only: ``1e-5 * Σ|terms|`` per entry, bf16 and f32 tables;
- the port's klb (``gram_rhs_t``) and bkl (``gram_rhs``) sums over a
  layout's gathered buckets against the script's ``gram_klb`` and
  ``gram_bkl``: bf16 inputs, f32 sums of some 10^5 terms in another block
  order, rtol 1e-4;
- ``profile_half``'s table from a CPU-activity profile of a tiny
  half-sweep, whose output matches the JAX ``half_sweep`` within the sweep
  tests' rtol 1e-4, atol 1e-4 (tests/test_torch_sweep.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recommendation_models_tpu.config as rc
import recommendation_models_tpu_torch.config as pc
from recommendation_models_tpu_torch.data.layout import layout_from_coo
from recommendation_models_tpu.data.layout import (
    layout_from_coo as ref_layout_from_coo)
from recommendation_models_tpu.data.synthetic import (
    synthetic_ratings as ref_synthetic_ratings)
from recommendation_models_tpu.ops.pallas.cholesky import (
    block_batch as ref_block_batch)
from recommendation_models_tpu.solver import als_sweep as rsw
from recommendation_models_tpu_torch.ops.cholesky import block_batch
from recommendation_models_tpu_torch.probes import (
    ablate_gram_layout, profile_half, split_gather)
from recommendation_models_tpu_torch.solver import als_sweep as psw
from scripts.ablate_gram_layout import gram_bkl, gram_klb

torch.set_num_threads(2)

N, K, B, P, NBLK = 1_000, 16, 64, 24, 2
SUM_TOL = 1e-5
DT = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
      "float32": (torch.float32, jnp.float32)}


def _jax_gram_from(tbl, idx_b, w_b):
    """The script's ``gram_from`` (its lines 51-55)."""
    g = jnp.take(tbl, idx_b, axis=0)
    gw = g.astype(jnp.float32) * w_b[..., None]
    return jnp.einsum("bpk,bpl->klb", gw.astype(tbl.dtype), g,
                      preferred_element_type=jnp.float32)


def _abs_bound(V, idx, w):
    """Σ|w g gᵀ| per entry, (B, K, K), in f64."""
    g = np.abs(V[idx].astype(np.float64))
    return np.einsum("bpk,bpl->bkl", g * w[..., None], g)


@pytest.fixture(scope="module", params=sorted(DT))
def grams(request):
    dtype = request.param
    tdt, jdt = DT[dtype]
    V, idx, w = split_gather.inputs(N, NBLK, B, P, K, tdt, "cpu")
    half = (N // 2) // 8 * 8
    Vj = jnp.asarray(V.float().numpy()).astype(jdt)
    Vh = V.float().numpy().astype(np.float64)
    blocks = []
    for i in range(NBLK):
        ib, wb = idx[i], w[i]
        full = split_gather.gram_from(V, ib, wb).numpy()
        split = split_gather.split_gram(V[:half], V[half:], half, ib,
                                        wb).numpy()
        ij, wj = jnp.asarray(ib.numpy()), jnp.asarray(wb.numpy())
        m1 = ij < half
        jfull = np.asarray(_jax_gram_from(Vj, ij, wj)).transpose(2, 0, 1)
        jsplit = np.asarray(
            _jax_gram_from(Vj[:half], jnp.where(m1, ij, 0), wj * m1)
            + _jax_gram_from(Vj[half:], jnp.where(m1, 0, ij - half),
                             wj * ~m1)).transpose(2, 0, 1)
        bound = _abs_bound(Vh, ib.numpy(), wb.numpy())
        blocks.append(dict(full=full, split=split, jfull=jfull,
                           jsplit=jsplit, tol=SUM_TOL * bound + 1e-6))
    return dtype, blocks


def test_split_gram_equals_the_full_gram_in_both_packages(grams):
    _, blocks = grams
    for b in blocks:
        assert (np.abs(b["split"] - b["full"]) <= b["tol"]).all()
        assert (np.abs(b["jsplit"] - b["jfull"]) <= b["tol"]).all()


def test_port_gram_from_matches_the_scripts(grams):
    _, blocks = grams
    for b in blocks:
        assert (np.abs(b["full"] - b["jfull"]) <= b["tol"]).all()
        assert (np.abs(b["split"] - b["jsplit"]) <= b["tol"]).all()


def test_split_gather_lines_on_the_host():
    rec = split_gather.run("float32", "cpu", **split_gather.CPU_SHAPE)
    for key in ("baseline", "split", "reference"):
        assert rec[key]["ms_per_pass"] is None
        assert np.isfinite(rec[key]["sum"])
    np.testing.assert_allclose(rec["split"]["sum"], rec["baseline"]["sum"],
                               rtol=1e-5)
    assert rec["table_mb"] == pytest.approx(2_000 * 64 * 4 / 1e6)
    full = split_gather.run("bfloat16", "cpu", n=split_gather.N, b=8, p=4,
                            nblk=1, small=split_gather.SMALL, reps=1)
    # the script's sizes: the bf16 table 20.8 MB, the f32 table 41.6 MB
    assert full["table_mb"] == pytest.approx(20.805, abs=1e-3)
    assert full["half"] == 81_264


@pytest.fixture(scope="module")
def tiny_layouts():
    """The scripts' layouts (default ``DataConfig``) of a small problem in
    both packages, both sides."""
    n_users, n_items = 600, 400
    u, i, r = ref_synthetic_ratings(n_users, n_items, 30_000, rank=16,
                                    seed=0)
    out = {}
    for side, t in (("user", False), ("item", True)):
        out[side] = (
            ref_layout_from_coo(u, i, r, n_users, n_items, transpose=t),
            layout_from_coo(u, i, r, n_users, n_items, transpose=t))
    return n_users, n_items, out


@pytest.mark.parametrize("side", ["user", "item"])
def test_gram_layout_sums_match_the_scripts(tiny_layouts, side):
    n_users, n_items, lay = tiny_layouts
    rank = 8
    rl, pl_ = lay[side]
    n_opp = n_items if side == "user" else n_users
    T = profile_half.opposite_table(n_opp, rank, "cpu")
    rcfg = rc.SolveConfig(rank=rank, reg=0.1, solver="auto",
                          compute_dtype="auto")
    rbs = rsw.device_buckets(rl, ref_block_batch(rank))
    Tj = jnp.asarray(T.numpy())
    want_klb = float(gram_klb(Tj, rbs, rcfg, rank))
    want_bkl = float(gram_bkl(Tj, rbs, rcfg, rank))
    rec = ablate_gram_layout.run(pl_, side, n_opp, rank, 1, "cpu")
    np.testing.assert_allclose(rec["klb"]["sum"], want_klb, rtol=1e-4)
    np.testing.assert_allclose(rec["bkl"]["sum"], want_bkl, rtol=1e-4)
    # the batch-minor form is a transposed view of the same sums: it adds
    # no copy of its own
    assert rec["klb"]["sum"] == rec["bkl"]["sum"]
    assert rec["klb"]["copy_calls"] == rec["bkl"]["copy_calls"]
    assert rec["klb"]["ms"] is None


def test_profile_half_table_and_output_match_jax_half_sweep(tiny_layouts):
    n_users, n_items, lay = tiny_layouts
    rank = 8
    rl, pl_ = lay["item"]
    T = profile_half.opposite_table(n_users, rank, "cpu")
    cfg = pc.SolveConfig(rank=rank, reg=0.1, solver="auto",
                         compute_dtype="auto")
    bs = psw.device_buckets(pl_, block_batch(rank), "cpu")
    table, got = profile_half.profile(
        lambda: psw.half_sweep(T, bs, pl_.n_rows, cfg), torch.device("cpu"))
    ref = rsw.half_sweep(jnp.asarray(T.numpy()),
                         rsw.device_buckets(rl, ref_block_batch(rank)),
                         rl.n_rows, rc.SolveConfig(rank=rank, reg=0.1,
                                                   solver="auto",
                                                   compute_dtype="auto"))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    assert table["total_ms"] > 0 and table["lanes"]
    names = {op["name"] for lane in table["lanes"] for op in lane["ops"]}
    assert "aten::baddbmm_" in names            # the grams' products
    assert table["total_ms"] == pytest.approx(
        sum(lane["ms"] for lane in table["lanes"]))
    assert table["solve_launches"] == {}        # plain versions on the host


def test_profile_half_main_on_the_host(tmp_path, capsys):
    env = dict(ABL_SCALE="tiny", ABL_RANK="8",
               ABL_CACHE_DIR=str(tmp_path / "cache"),
               PROF_DIR=str(tmp_path / "prof"))
    assert profile_half.main(["user", "--platform", "cpu"], env=env) == 0
    assert (tmp_path / "cache" / "tiny_user.npz").exists()
    assert (tmp_path / "prof" / "user.trace.json").exists()
    import json
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["side"] == "user" and rec["event_ms"] is None
    assert all(len(lane["ops"]) <= 10 for lane in rec["lanes"])


@pytest.mark.parametrize("module", [split_gather, profile_half,
                                    ablate_gram_layout])
def test_the_gather_probes_refuse_without_a_card(monkeypatch, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if module is split_gather:
            module.main([])
        else:
            module.main([], env={"ABL_SCALE": "tiny"})
