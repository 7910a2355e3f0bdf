"""The port's top-k retrieval (``ops/topk.py``) against the JAX package's on
the same numpy inputs (cases from tests/test_topk.py): ids equal, scores
within rtol 1e-5, atol 1e-6. The ``gpu`` test at the end holds the card's
selection against the CPU's: ``python -m pytest --noconftest -m gpu
tests/test_torch_topk.py``."""

import numpy as np
import pytest
import torch

from recommendation_models_tpu_torch.ops import topk as port

try:
    import jax.numpy as jnp
    from recommendation_models_tpu.ops import topk as ref
except ImportError:
    # the card's machine has no JAX; there only the gpu test runs
    jnp = ref = None

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if ref is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")


def _case(seed, b=5, n=100, k=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, k)).astype(np.float32),
            rng.standard_normal((n, k)).astype(np.float32))


def _same(got, want):
    sc, it = got
    np.testing.assert_array_equal(np.asarray(it), np.asarray(want[1]))
    np.testing.assert_allclose(np.asarray(sc), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)


def _both(U, V, k, exclude=None, method="auto"):
    want = ref.topk_scores(jnp.asarray(U), jnp.asarray(V), k,
                           None if exclude is None else jnp.asarray(exclude),
                           method=method)
    got = port.topk_scores(torch.tensor(U), torch.tensor(V), k, exclude,
                           method=method)
    assert got[1].dtype == torch.int64 and got[0].dtype == torch.float32
    return got, want


@pytest.mark.parametrize("b,n,k,seed", [
    (5, 100, 10, 0), (3, 100, 1, 1), (4, 100, 100, 2), (7, 2_500, 17, 3),
    (2, 8_192, 40, 4),
])
def test_small_path_matches_reference(b, n, k, seed):
    U, V = _case(seed, b, n)
    _same(*_both(U, V, k))


def test_small_path_matches_numpy():
    U, V = _case(0)
    sc, it = port.topk_scores(torch.tensor(U), torch.tensor(V), 10)
    full = U @ V.T
    expect = np.argsort(-full, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(it.numpy(), expect)


@pytest.mark.parametrize("k,n_valid", [
    (10, None), (100, None), (130, None), (100, 40), (7, 70), (3, 0),
])
def test_chunked_matches_reference(k, n_valid):
    """Both packages' chunked selectors at block 64: k below and above the
    block, and a masked tail (n_valid) with fewer than k valid rows."""
    U, V = _case(5, b=6, n=300)
    want = ref._topk_exact_chunked(jnp.asarray(U), jnp.asarray(V), k,
                                   block=64, n_valid=n_valid)
    got = port._topk_exact_chunked(torch.tensor(U), torch.tensor(V), k,
                                   block=64, n_valid=n_valid)
    _same(got, want)


def test_chunked_default_block_through_topk_scores():
    # a catalog wider than _SMALL_N takes the chunked path at full block
    U, V = _case(6, b=3, n=20_000)
    _same(*_both(U, V, 12))


def test_wide_row_ties_take_the_lower_index():
    """Equal scores (zero item vectors) across a selection's boundary: the
    lower index comes first, as in lax.top_k, on the sorted and the
    topk-then-check widths."""
    U, V = _case(7, b=4, n=6_000)
    U, V = np.abs(U), -np.abs(V)        # every real score is negative
    V[100:3_000] = 0.0                  # and these all score +0.0
    _same(*_both(U, V, 25))
    got = port._top_k(torch.zeros(3, 5_000), 7)
    np.testing.assert_array_equal(got[1].numpy(), np.tile(np.arange(7),
                                                           (3, 1)))


def test_exclude_matches_reference():
    U, V = _case(0)
    exclude = np.array([[0, 1, -1], [5, -1, -1], [-1, -1, -1],
                        [2, 3, 4], [99, 98, 97]], np.int32)
    got, want = _both(U, V, 10, exclude)
    _same(got, want)
    for r in range(5):
        assert not set(exclude[r][exclude[r] >= 0]) & set(got[1][r].tolist())


def test_exclude_overfetch_clamp_keeps_inf_ties():
    """A user who has seen all but 3 of 20 items, k = 5: overfetch clamps to
    the catalog and the last two slots are -inf, whose ids must follow
    lax.top_k's order."""
    U, V = _case(1, b=2, n=20, k=4)
    exclude = np.full((2, 17), -1, np.int32)
    exclude[0] = np.arange(17)
    exclude[1, :3] = [4, 9, 11]
    got, want = _both(U, V, 5, exclude, method="exact")
    _same(got, want)
    assert np.isneginf(got[0][0, 3:].numpy()).all()


def test_exclude_overfetch_keeps_exactness():
    U, V = _case(2, b=2, n=30, k=4)
    exclude = np.full((2, 25), -1, np.int32)
    exclude[0, :3] = [0, 1, 2]
    exclude[1] = np.arange(25)
    got, want = _both(U, V, 5, exclude, method="exact")
    _same(got, want)
    full = U @ V.T
    for r in range(2):
        banned = set(exclude[r][exclude[r] >= 0])
        order = [i for i in np.argsort(-full[r]) if i not in banned][:5]
        np.testing.assert_array_equal(got[1][r].numpy(), order)


def test_whale_width_matches_reference():
    """An exclusion width of 2,048 over a 2,000-item catalog: overfetch is
    the whole catalog, and the filter never builds (B, overfetch, E)."""
    rng = np.random.default_rng(8)
    U, V = _case(8, b=4, n=2_000, k=6)
    exclude = np.full((4, 2_048), -1, np.int32)
    for r, deg in enumerate((1_990, 1_500, 37, 0)):
        exclude[r, :deg] = rng.choice(2_000, deg, replace=False)
    _same(*_both(U, V, 10, exclude))


def test_filter_seen_memory_is_linear(monkeypatch):
    """No tensor of _filter_seen's has more than B * (overfetch + E)
    elements: the (B, overfetch, E) comparison is never built."""
    b, of, e = 8, 60, 50
    rng = np.random.default_rng(9)
    sc = torch.tensor(-np.sort(-rng.standard_normal((b, of)), axis=1),
                      dtype=torch.float32)
    ix = torch.tensor(np.stack([rng.permutation(500)[:of]
                                for _ in range(b)]))
    ex = torch.tensor(rng.integers(-1, 500, (b, e)), dtype=torch.int32)
    biggest = []
    for name in ("sort", "searchsorted", "gather"):
        fn = getattr(torch, name)

        def spy(*a, _fn=fn, **kw):
            out = _fn(*a, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            biggest.extend(t.numel() for t in outs)
            return out
        monkeypatch.setattr(torch, name, spy)
    got = port._filter_seen(sc, ix, ex, 5)
    monkeypatch.undo()
    want = ref._filter_seen(jnp.asarray(sc.numpy()), jnp.asarray(ix.numpy()),
                            jnp.asarray(ex.numpy()), 5)
    _same(got, want)
    assert max(biggest) <= b * (of + e)


def test_approx_method_matches_exact():
    U, V = _case(3, b=4, n=500, k=6)
    e = port.topk_scores(torch.tensor(U), torch.tensor(V), 5, method="exact")
    a = port.topk_scores(torch.tensor(U), torch.tensor(V), 5,
                         method="approx", recall_target=0.5)
    np.testing.assert_array_equal(a[1].numpy(), e[1].numpy())
    assert port._resolve_method("auto", 10 ** 6, 10) == "exact"
    assert port._resolve_method("approx", 10 ** 6, 10) == "approx"


@pytest.mark.parametrize("method", ["fastest", "APPROX", ""])
def test_unknown_method_raises(method):
    U, V = _case(0)
    with pytest.raises(ValueError, match="unknown top-k method"):
        port.topk_scores(torch.tensor(U), torch.tensor(V), 5, method=method)
    with pytest.raises(ValueError, match="unknown top-k method"):
        ref.topk_scores(jnp.asarray(U), jnp.asarray(V), 5, method=method)


@pytest.mark.parametrize("k", [0, 11, -1])
def test_k_out_of_range_raises(k):
    U, V = np.ones((3, 4), np.float32), np.ones((10, 4), np.float32)
    with pytest.raises(ValueError, match=r"k must be in \[1, n_items=10\]"):
        port.topk_scores(torch.tensor(U), torch.tensor(V), k)


def _grouped(pkg, n_users, n_items, k, indptr, indices, seed):
    rng = np.random.default_rng(seed)
    Uq = rng.standard_normal((n_users, 5)).astype(np.float32)
    V = rng.standard_normal((n_items, 5)).astype(np.float32)
    if pkg is ref:
        Vd = jnp.asarray(V)
        rows = lambda ids: jnp.asarray(Uq[np.asarray(ids)])       # noqa: E731
    else:
        Vd = torch.tensor(V)
        rows = lambda ids: torch.tensor(Uq[np.asarray(ids)])      # noqa: E731

    def topk(u, kk, excl):
        return pkg.topk_scores(u, Vd, kk, excl, method="exact")
    return pkg.grouped_exclusion_topk(np.arange(n_users), k, indptr,
                                      indices, rows, topk)


def test_grouped_exclusion_all_zero_degree_users():
    indptr = np.zeros(5, np.int64)
    indices = np.empty(0, np.int64)
    got = _grouped(port, 4, 30, 6, indptr, indices, 3)
    want = _grouped(ref, 4, 30, 6, indptr, indices, 3)
    _same(got, want)


def test_grouped_exclusion_matches_reference():
    rng = np.random.default_rng(4)
    n_users, n_items = 40, 300
    degs = rng.integers(0, 200, n_users)
    degs[3] = 290                                        # a whale
    indices = np.concatenate([rng.choice(n_items, d, replace=False)
                              for d in degs])
    indptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
    got = _grouped(port, n_users, n_items, 12, indptr, indices, 4)
    want = _grouped(ref, n_users, n_items, 12, indptr, indices, 4)
    _same(got, want)


def test_grouped_exclusion_widths_are_geometric_levels():
    rng = np.random.default_rng(5)
    n_users, n_items = 30, 64
    degs = rng.integers(1, 40, n_users)
    indptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
    indices = rng.integers(0, n_items, int(degs.sum()))
    widths = []

    def topk(u, k, excl):
        widths.append(excl.shape[1])
        return (torch.zeros((u.shape[0], k)),
                torch.zeros((u.shape[0], k), dtype=torch.int64))

    port.grouped_exclusion_topk(np.arange(n_users), 3, indptr, indices,
                                lambda ids: torch.ones((len(ids), 4)), topk)
    assert set(widths) <= {32, 128, 512} and 128 in widths


@pytest.mark.parametrize("n", [999, 1_000, 1, 62_423])
def test_serving_permutation_is_the_reference_bitwise(n):
    pb, pf = port.serving_permutation(n)
    rb, rf = ref.serving_permutation(n)
    assert pb.dtype == rb.dtype and pf.dtype == rf.dtype
    np.testing.assert_array_equal(pb, rb)
    np.testing.assert_array_equal(pf, rf)
    np.testing.assert_array_equal(pb[pf], np.arange(n))


def test_permuted_topk_plumbing_matches_reference():
    pb, pf = port.serving_permutation(1_000)
    calls = {}

    def fake_topk(Uq, k, excl):
        calls["excl"] = None if excl is None else np.asarray(excl)
        it = np.tile(np.arange(k), (Uq.shape[0], 1))
        return np.zeros((Uq.shape[0], k), np.float32), it

    Uq = np.zeros((3, 4), np.float32)
    excl = np.asarray([[5, -1], [7, 8], [-1, -1]], np.int32)
    got = port.permuted_topk(fake_topk, pb, pf)(Uq, 6, excl)
    got_excl = calls["excl"]
    want = ref.permuted_topk(fake_topk, pb, pf)(Uq, 6, excl)
    np.testing.assert_array_equal(got_excl, calls["excl"])
    np.testing.assert_array_equal(got_excl,
                                  np.where(excl >= 0, pf[np.maximum(excl, 0)],
                                           -1))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[1], np.tile(pb[:6], (3, 1)))
    port.permuted_topk(fake_topk, pb, pf)(Uq, 6, None)
    assert calls["excl"] is None


def test_permuted_topk_maps_padded_rows_to_minus_one():
    """A served row past the catalog (a padded table's tail) maps to -1 in
    the port; the JAX package raises IndexError there (ROADMAP Queue 3)."""
    pb, pf = port.serving_permutation(10)

    def padded_topk(Uq, k, excl):
        it = np.array([[3, 10, 12, 0]])
        return np.zeros((1, 4), np.float32), it

    _, it = port.permuted_topk(padded_topk, pb, pf)(np.zeros((1, 2)), 4,
                                                   None)
    np.testing.assert_array_equal(it, [[pb[3], -1, -1, pb[0]]])
    with pytest.raises(IndexError):
        ref.permuted_topk(padded_topk, pb, pf)(np.zeros((1, 2)), 4, None)


@pytest.mark.gpu
def test_topk_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from recommendation_models_tpu_torch.ops.gram import full_f32
    full_f32()
    U, V = _case(10, b=300, n=20_000, k=64)
    rng = np.random.default_rng(10)
    exclude = np.where(rng.random((300, 128)) < 0.7,
                       rng.integers(0, 20_000, (300, 128)), -1)
    for ex in (None, exclude):
        c = port.topk_scores(torch.tensor(U), torch.tensor(V), 10, ex)
        g = port.topk_scores(torch.tensor(U, device="cuda"),
                             torch.tensor(V, device="cuda"), 10, ex)
        np.testing.assert_array_equal(g[1].cpu().numpy(), c[1].numpy())
        np.testing.assert_allclose(g[0].cpu().numpy(), c[0].numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_the_masked_exclusion_on_the_card_makes_no_host_sync():
    """The exclusion step (the batch's pairs gathered from the device lists
    and masked into two item blocks) under ``set_sync_debug_mode("error")``,
    and the masked selection on the card against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from recommendation_models_tpu_torch.ops.gram import full_f32
    full_f32()
    n_items, b = 20_000, 300
    U, V = _case(11, b=b, n=n_items, k=64)
    rng = np.random.default_rng(11)
    degs = rng.integers(0, 400, b + 7)
    indptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
    indices = rng.integers(0, n_items, int(degs.sum())).astype(np.int32)
    _, pf = port.serving_permutation(n_items)
    ids = rng.permutation(b + 7)[:b].astype(np.int64)
    total = int(degs[ids].sum())
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    lists = port.seen_lists(indptr, indices, pf, cuda)
    u = torch.tensor(U, device=cuda)
    Vd = torch.tensor(V, device=cuda)
    blocks = [port._scores(u, Vd[:port._EXACT_BLOCK]),
              port._scores(u, Vd[port._EXACT_BLOCK:])]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        seen = port.seen_pairs(
            lists, torch.from_numpy(ids).to(cuda, non_blocking=True), total)
        port._mask_seen(blocks[0], seen, 0)
        port._mask_seen(blocks[1], seen, port._EXACT_BLOCK)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    seen_c = port.seen_pairs(port.seen_lists(indptr, indices, pf, cpu),
                             torch.from_numpy(ids), total)
    assert seen_c[0].shape[0] == total
    for x, y in zip(seen, seen_c):
        np.testing.assert_array_equal(x.cpu().numpy(), y.numpy())
    masked = torch.cat(blocks, 1).cpu().numpy()
    q, j = seen_c[0].numpy(), seen_c[1].numpy()
    assert np.isneginf(masked[q, j]).all()
    assert np.isneginf(masked).sum() == np.unique(q * n_items + j).shape[0]
    g = port._topk_unseen(u, Vd, 10, seen=seen)
    c = port._topk_unseen(torch.tensor(U), torch.tensor(V), 10, seen=seen_c)
    np.testing.assert_array_equal(g[1].cpu().numpy(), c[1].numpy())
    np.testing.assert_allclose(g[0].cpu().numpy(), c[0].numpy(),
                               rtol=1e-5, atol=1e-5)
