"""The port's MovieLens loader (``data/movielens.py``) and native parser
(``data/native/``) against the JAX package's on the same files: every case
of tests/test_movielens.py, each run through both loaders with equal
arrays (same keys, dtypes and values); the two native parsers bitwise
equal on a file of several 4 MB chunks, with no trailing newline, with
CRLF and with malformed lines; the port's library under ``build/native/``.

Both loaders write the same cache name (``<path>[.<fmt>].rmtpu.npz``), so a
test that compares them with the cache on gives each its own copy of the
file."""

import os
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from recommendation_models_tpu.data import movielens as ref_ml
from recommendation_models_tpu.data import native as ref_native
from recommendation_models_tpu_torch.data import movielens
from recommendation_models_tpu_torch.data import native

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = [(1, 10, 4.0), (1, 20, 3.5), (2, 10, 5.0), (3, 30, 1.0)]
HEADER = "userId,movieId,rating,timestamp"
FORMATS = {"u.data": ("\t", None), "ratings.dat": ("::", None),
           "ratings.csv": (",", HEADER)}


@pytest.fixture(scope="module", autouse=True)
def _native_parsers():
    """Both native parsers must build here: the tests hold them against
    each other, and a silent fallback would compare NumPy with NumPy. The
    JAX package builds its parser in place at first use, so another test
    process may be writing it: its load is tried again after a pause."""
    assert native.available(), "the port's native parser did not build"
    for _ in range(3):
        if ref_native._load() is not None:
            return
        ref_native._tried = False
        time.sleep(2)
    pytest.fail("the JAX package's native parser did not build")


def _write(tmp_path, name, sep, header=None):
    p = tmp_path / name
    lines = [] if header is None else [header]
    lines += [sep.join(str(x) for x in (u, i, r)) + sep + "881250949"
              for u, i, r in ROWS]
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def _check(out):
    assert out["n_users"] == 3 and out["n_items"] == 3
    np.testing.assert_array_equal(out["user_vocab"], [1, 2, 3])
    np.testing.assert_array_equal(out["item_vocab"], [10, 20, 30])
    np.testing.assert_allclose(out["ratings"], [4.0, 3.5, 5.0, 1.0])
    # dense remap: first row is user 1 -> 0, item 10 -> 0
    assert out["users"][0] == 0 and out["items"][0] == 0


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def _twin(path):
    """A copy of ``path`` in a sibling directory, for the JAX loader."""
    d = os.path.join(os.path.dirname(path), "ref")
    os.makedirs(d, exist_ok=True)
    return shutil.copy2(path, d)


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_formats_match_reference(tmp_path, name):
    path = _write(tmp_path, name, *FORMATS[name])
    got = movielens.load_ratings_file(path, cache=False)
    _check(got)
    _same(got, ref_ml.load_ratings_file(path, cache=False))
    assert not os.path.exists(path + ".rmtpu.npz")


def test_cache_roundtrip(tmp_path):
    path = _write(tmp_path, "ratings.csv", ",", header=HEADER)
    ref_path = _twin(path)
    a = movielens.load_ratings_file(path, cache=True)
    assert os.path.exists(path + ".rmtpu.npz")
    os.remove(path)                      # the cache alone serves it now
    b = movielens.load_ratings_file(path, cache=True)
    _same(b, a)
    _same(a, ref_ml.load_ratings_file(ref_path, cache=True))
    # the cache file holds the same arrays as the JAX loader's
    with np.load(path + ".rmtpu.npz") as z, \
            np.load(ref_path + ".rmtpu.npz") as zr:
        assert sorted(z.files) == sorted(zr.files)
        for k in z.files:
            np.testing.assert_array_equal(z[k], zr[k])


def test_native_parser_matches_fallback_and_reference(tmp_path):
    path = _write(tmp_path, "ratings.csv", ",", header=HEADER)
    arr = native.parse_ratings(path, ",", True)
    assert arr.shape == (4, 3) and arr.dtype == np.float64
    np.testing.assert_allclose(arr[:, 2], [4.0, 3.5, 5.0, 1.0])
    np.testing.assert_array_equal(arr, movielens._parse_numpy(path, ",", True))
    np.testing.assert_array_equal(arr, ref_native.parse_ratings(path, ",",
                                                                True))


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_native_equals_numpy_fallback_per_format(tmp_path, name):
    sep, header = FORMATS[name]
    path = _write(tmp_path, name, sep, header)
    np.testing.assert_array_equal(
        native.parse_ratings(path, sep, header is not None),
        movielens._parse_numpy(path, sep, header is not None))


def test_to_csr(tmp_path):
    path = _write(tmp_path, "u.data", "\t")
    out = movielens.load_ratings_file(path, cache=False)
    R = movielens.to_csr(out["users"], out["items"], out["ratings"],
                         out["n_users"], out["n_items"])
    assert R.shape == (3, 3) and R.nnz == 4
    ref = ref_ml.to_csr(out["users"], out["items"], out["ratings"],
                        out["n_users"], out["n_items"])
    assert (R != ref).nnz == 0


def test_native_parser_chunked_streaming(tmp_path):
    """The streaming parser crosses its 4 MB chunk boundaries cleanly: every
    row of a >8 MB csv parses exactly as written, bitwise as the JAX
    package's parser does."""
    rng = np.random.default_rng(0)
    n = 400_000
    u = rng.integers(1, 5_000, n)
    i = rng.integers(1, 8_000, n)
    r = rng.integers(1, 11, n) / 2.0
    path = tmp_path / "big_ratings.csv"
    with open(path, "w") as f:
        f.write(HEADER + "\n")
        f.write("\n".join(f"{a},{b},{c},123456789"
                          for a, b, c in zip(u, i, r)) + "\n")
    assert path.stat().st_size > 8 << 20   # > two 4MB chunks
    arr = native.parse_ratings(str(path), ",", skip_header=True)
    assert arr.shape == (n, 3)
    np.testing.assert_array_equal(arr[:, 0], u)
    np.testing.assert_array_equal(arr[:, 1], i)
    np.testing.assert_array_equal(arr[:, 2], r)
    np.testing.assert_array_equal(
        arr, ref_native.parse_ratings(str(path), ",", skip_header=True))


@pytest.mark.parametrize("body,want", [
    # no trailing newline
    ("userId,movieId,rating\n1,2,3.5\n7,8,4.0", [[1, 2, 3.5], [7, 8, 4.0]]),
    # CRLF line ends
    ("userId,movieId,rating,timestamp\r\n1,2,3.5,9\r\n7,8,4.0,9\r\n",
     [[1, 2, 3.5], [7, 8, 4.0]]),
    # malformed lines: short, empty, text, binary; skipped
    ("userId,movieId,rating\n1,2,3.5\n5,6\n\nfoo,bar,baz\n\x00\x01\n"
     "7,8,4.0\n", [[1, 2, 3.5], [7, 8, 4.0]]),
    # a header only, and then nothing
    ("userId,movieId,rating\n", np.zeros((0, 3))),
])
def test_native_parsers_agree_on_edge_files(tmp_path, body, want):
    path = tmp_path / "r.csv"
    path.write_bytes(body.encode())
    arr = native.parse_ratings(str(path), ",", skip_header=True)
    ref = ref_native.parse_ratings(str(path), ",", skip_header=True)
    assert arr.shape == ref.shape == np.shape(want)
    np.testing.assert_array_equal(arr, want)
    np.testing.assert_array_equal(arr, ref)


def test_cache_corruption_recovers_and_fmt_keys(tmp_path):
    """A truncated cache re-parses (not BadZipFile forever); an explicit fmt
    keys its own cache entry instead of serving a different format's
    parse; both as the JAX loader does."""
    p = str(tmp_path / "u.data")
    with open(p, "w") as f:
        f.write("1\t10\t4.0\t0\n2\t20\t3.0\t0\n")
    ref_p = _twin(p)
    d1 = movielens.load_ratings_file(p)
    assert d1["n_users"] == 2
    # corrupt the cache in place
    with open(p + ".rmtpu.npz", "wb") as f:
        f.write(b"NOT A ZIP")
    os.utime(p + ".rmtpu.npz", (time.time() + 10, time.time() + 10))
    d2 = movielens.load_ratings_file(p)               # falls through to re-parse
    np.testing.assert_array_equal(d2["users"], d1["users"])
    with np.load(p + ".rmtpu.npz") as z:              # and rewrote it
        np.testing.assert_array_equal(z["users"], d1["users"])
    d3 = movielens.load_ratings_file(p, fmt="tsv")
    assert os.path.exists(p + ".tsv.rmtpu.npz")
    np.testing.assert_array_equal(d3["ratings"], d1["ratings"])
    _same(d1, ref_ml.load_ratings_file(ref_p))
    _same(d3, ref_ml.load_ratings_file(ref_p, fmt="tsv"))
    with pytest.raises(ValueError, match="unknown MovieLens format"):
        movielens.load_ratings_file(p, fmt="xml", cache=False)


def test_fallback_warns_once_and_matches(tmp_path, monkeypatch, caplog):
    """With the native parser unavailable the loader warns, naming the
    reason, and its NumPy parse equals the JAX loader's."""
    path = _write(tmp_path, "ratings.dat", "::")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("RMTPU_NO_NATIVE", "1")
    with caplog.at_level("INFO", logger="recommendation_models_tpu_torch"):
        got = movielens.load_ratings_file(path, cache=False)
        movielens.load_ratings_file(path, cache=False)
    warns = [r for r in caplog.records if r.levelname == "WARNING"]
    assert len(warns) == 1 and "RMTPU_NO_NATIVE" in warns[0].getMessage()
    routes = [r.ingest["route"] for r in caplog.records
              if hasattr(r, "ingest")]
    assert routes == ["numpy", "numpy"]
    _check(got)
    _same(got, ref_ml.load_ratings_file(path, cache=False))


def test_build_failure_warns_with_the_error(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.delenv("RMTPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "LIB", tmp_path / "_ratings_parser.so")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "SRC", tmp_path / "missing.cpp")
    with caplog.at_level("WARNING", logger="recommendation_models_tpu_torch"):
        assert native.parse_ratings(str(tmp_path / "x.csv"), ",", True) is None
    assert len(caplog.records) == 1
    assert "g++" in caplog.records[0].getMessage()


def test_ingest_record_names_route_and_seconds(tmp_path, caplog):
    path = _write(tmp_path, "ratings.csv", ",", header=HEADER)
    with caplog.at_level("INFO", logger="recommendation_models_tpu_torch"):
        movielens.load_ratings_file(path)
        movielens.load_ratings_file(path)
    got = [r.ingest for r in caplog.records if hasattr(r, "ingest")]
    assert [g["route"] for g in got] == ["native", "cache"]
    assert got[0]["rows"] == 4 and set(got[0]) >= {
        "parse_s", "remap_s", "cache_s"}


_MAPS = textwrap.dedent("""
    import sys
    from recommendation_models_tpu_torch.data import movielens, native
    out = movielens.load_ratings_file(sys.argv[1], cache=False)
    assert out["n_users"] == 3, out
    maps = open("/proc/self/maps").read()
    print("LIB", native.LIB)
    print("PORT_SO", str(native.LIB) in maps)
    print("REF_SO", "recommendation_models_tpu/data/native" in maps)
    print("JAX", "jax" in sys.modules)
""")


def test_library_under_build_native_and_reference_so_never_loaded(tmp_path):
    if not os.path.exists("/proc/self/maps"):
        pytest.skip("needs /proc/self/maps to list the loaded libraries")
    path = _write(tmp_path, "u.data", "\t")
    res = subprocess.run([sys.executable, "-c", _MAPS, path], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert f"LIB {os.path.join(REPO, 'build', 'native')}" in res.stdout
    assert "PORT_SO True" in res.stdout
    assert "REF_SO False" in res.stdout
    assert "JAX False" in res.stdout
