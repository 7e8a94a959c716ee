"""The port's host data plane against the JAX package's, on the CPU: the
LIBSVM reader (one file through both packages and both of the port's
engines, malformed input, a fixed-width file as ``chip_smoke.py``'s path 8
writes it), the port's own native loader, ``IndexMap`` and ``MmapIndexMap``
saved by one package and loaded by the other, and the date-range paths.

Everything here is exact (tests/test_data.py:116-138, 229, 270-368 and
tests/test_paths.py compare arrays, ids and paths for equality).
"""

import datetime
import os

import numpy as np
import pytest

from photon_ml_tpu.data import IndexMap as JIndexMap
from photon_ml_tpu.data import MmapIndexMap as JMmapIndexMap
from photon_ml_tpu.data import read_libsvm as j_read
from photon_ml_tpu.data.paths import daily_paths as j_daily_paths
from photon_ml_tpu.data.paths import expand_input_paths as j_expand
from photon_ml_tpu.data.paths import parse_date_range as j_parse_date_range
from photon_ml_tpu.data.paths import parse_days_ago as j_parse_days_ago
from photon_ml_tpu_torch.data import IndexMap, MmapIndexMap, feature_key, read_libsvm
from photon_ml_tpu_torch.data import index_map as im_mod
from photon_ml_tpu_torch.data import native
from photon_ml_tpu_torch.data.libsvm import write_libsvm
from photon_ml_tpu_torch.data.paths import (
    daily_paths,
    expand_input_paths,
    parse_date_range,
    parse_days_ago,
)
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.ops.sparse import SparseBatch

ENGINES = ["python", "native"]


@pytest.fixture(scope="module")
def native_lib():
    if native.load_native() is None:
        pytest.skip("no g++ to build the native parser")
    return native.load_native()


def _same(a, b):
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.cols, b.cols)
    np.testing.assert_array_equal(a.values, b.values)
    assert a.num_features == b.num_features


def _mixed_file(tmp_path, seed=0):
    """Comments, blank lines, {-1, 1} labels and trailing comments."""
    rng = np.random.default_rng(seed)
    lines = ["# header comment", ""]
    X = (rng.random((200, 30)) < 0.3) * rng.normal(size=(200, 30))
    y = np.where(rng.random(200) < 0.5, -1, 1)
    for i in range(200):
        feats = " ".join(f"{j + 1}:{X[i, j]:.6f}" for j in np.nonzero(X[i])[0])
        lines.append(f"{y[i]} {feats}{' # trailing' if i % 7 == 0 else ''}")
    p = tmp_path / "t.libsvm"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("zero_based", [False, True])
def test_one_file_reads_the_same_in_both_packages(tmp_path, native_lib, engine, zero_based):
    path = _mixed_file(tmp_path)
    want = j_read(path, zero_based=zero_based, engine="python")
    _same(read_libsvm(path, zero_based=zero_based, engine=engine), want)
    _same(read_libsvm(path, zero_based=zero_based, engine="auto"), want)


@pytest.mark.parametrize("content", ["1 3: 5\n", "1 3:\n-1 2:5\n", "1 3:abc\n", "x 3:1\n",
                                     "1 0:2\n", "1 2:3#comment\n"])
@pytest.mark.parametrize("engine", ENGINES)
def test_malformed_input_raises_in_both_packages(tmp_path, native_lib, content, engine):
    p = tmp_path / "bad.libsvm"
    p.write_text(content)
    with pytest.raises(ValueError):
        j_read(str(p), engine=engine)
    with pytest.raises(ValueError):
        read_libsvm(str(p), engine=engine)


@pytest.mark.parametrize("content", ["1 2:3\v4:5\n", "1\n0\n", "", "# only a comment\n",
                                     "1 2:3\r-1 4:5\r", "+1 1:0.5 # ok\n"])
def test_edge_files_read_as_the_reference_reads_them(tmp_path, native_lib, content):
    p = tmp_path / "e.libsvm"
    p.write_text(content)
    for engine in ENGINES:
        _same(read_libsvm(str(p), engine=engine), j_read(str(p), engine=engine))


def test_a_fixed_width_file_reads_back_as_written(tmp_path, native_lib):
    """``write_libsvm``'s zero-padded columns and signed values (path 8's
    writer) parse to the draws as written in both packages and engines."""
    rng = np.random.default_rng(3)
    n, d = 500, 12_345
    rows = np.sort(rng.integers(0, n, size=4000))  # rows without features too
    cols = rng.integers(0, d, size=4000)
    values = rng.normal(size=4000) * 30
    values[:3] = (0.0, -1e-7, 99999.99996)  # a zero, a negative zero, a carry
    labels = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    path = str(tmp_path / "fixed.libsvm")
    written = write_libsvm(path, values, rows, cols, labels)
    np.testing.assert_array_equal(written, np.round(values, 4))
    head = open(path).readline().split()
    assert len(head[0]) == len("+1.0000") and all(len(t) == len(head[1]) for t in head[1:])
    for data in [read_libsvm(path, engine=e) for e in ENGINES] + [j_read(path)]:
        np.testing.assert_array_equal(data.rows, rows)
        np.testing.assert_array_equal(data.cols, cols)
        np.testing.assert_array_equal(data.values, written)
        np.testing.assert_array_equal(data.labels, (labels > 0) * 1.0)
    with pytest.raises(ValueError, match="sorted"):
        write_libsvm(path, values, rows[::-1], cols, labels)


@pytest.mark.parametrize("layout", ["csr", "sparse"])
def test_to_batch_puts_the_intercept_last_as_the_reference(tmp_path, layout):
    p = tmp_path / "small.libsvm"
    p.write_text("+1 1:0.5 3:2.0\n-1 2:1.0\n+1 1:1.5\n0 \n")
    want = j_read(str(p), binary_labels_to_01=False).to_batch(add_intercept=True)
    data = read_libsvm(str(p), binary_labels_to_01=False)
    assert data.intercept_index == 3
    batch = data.to_batch(add_intercept=True, layout=layout, device="cpu")
    assert isinstance(batch, CSRBatch if layout == "csr" else SparseBatch)
    assert batch.num_features == want.num_features == 4
    np.testing.assert_array_equal(batch.to_dense(), want.to_dense()[:4])
    np.testing.assert_array_equal(batch.labels.numpy(), np.asarray(want.labels)[:4])
    wide = data.to_batch(num_features=10, add_intercept=False, device="cpu")
    assert wide.num_features == 10
    with pytest.raises(ValueError, match="layout"):
        data.to_batch(layout="ell", device="cpu")


def test_native_engine_raises_and_auto_falls_back_without_the_library(tmp_path, monkeypatch):
    path = _mixed_file(tmp_path, seed=1)
    monkeypatch.setenv("PHOTON_NO_NATIVE", "1")
    assert native.load_native() is None
    with pytest.raises(RuntimeError, match="native parser unavailable"):
        read_libsvm(path, engine="native")
    _same(read_libsvm(path, engine="auto"), j_read(path, engine="python"))
    with pytest.raises(ValueError, match="engine"):
        read_libsvm(path, engine="rust")


def test_the_native_library_is_the_ports_own(native_lib):
    """Built from native/fast_parse.cpp alone into build/native/, never into
    native/ and never the JAX side's libphoton_native.so."""
    path = native._LIB_PATH
    assert os.path.exists(path)
    assert os.path.basename(os.path.dirname(path)) == "native"
    assert os.path.basename(os.path.dirname(os.path.dirname(path))) == "build"
    assert native_lib._name == path


def _keys():
    return [feature_key("age"), feature_key("country", "us"), feature_key("country", "de"),
            "plainfeature", "ünïcode\x01term"]


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_index_maps_load_in_the_other_package(tmp_path, saver):
    keys = _keys() * 3
    if saver == "jax":
        made, build = JIndexMap.build(keys, add_intercept=True), (IndexMap, MmapIndexMap)
    else:
        made, build = IndexMap.build(keys, add_intercept=True), (JIndexMap, JMmapIndexMap)
    d = str(tmp_path / "idx")
    made.save(d)
    loaded, mm = build[0].load(d), build[1](d)
    assert loaded.names == made.names == sorted(made.names)
    assert len(mm) == len(made) == 6
    for k in made:
        assert mm.get(k) == loaded[k] == made[k]
        assert mm.name_of(made[k]) == k
    got = mm.get_many(list(made.names) + ["nope"])
    np.testing.assert_array_equal(got, list(range(len(made))) + [-1])
    for f in ("hashes.npy", "ids.npy"):
        other = str(tmp_path / "again")
        (JIndexMap if saver == "port" else IndexMap)(made.names).save(other)
        assert open(os.path.join(d, f), "rb").read() == open(os.path.join(other, f),
                                                             "rb").read()


def test_index_map_save_detects_a_hash_collision(tmp_path, monkeypatch):
    monkeypatch.setattr(im_mod, "_hash64", lambda key: 42)
    with pytest.raises(ValueError, match="collision"):
        IndexMap(["featA", "featB"]).save(str(tmp_path / "idx"))
    with pytest.raises(ValueError, match="duplicate"):
        IndexMap(["a", "a"])


@pytest.mark.parametrize("spec", ["20160101-20160131", "20160131-20160101", "2016-01-01",
                                  "20160230-20160301"])
def test_parse_date_range_matches_the_reference(spec):
    try:
        want = j_parse_date_range(spec)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            parse_date_range(spec)
        assert str(got.value) == str(exc)
        return
    assert parse_date_range(spec) == want


@pytest.mark.parametrize("spec", ["31-1", "1-31", "x-1", "0-0"])
def test_parse_days_ago_matches_the_reference(spec):
    today = datetime.date(2016, 2, 1)
    try:
        want = j_parse_days_ago(spec, today=today)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            parse_days_ago(spec, today=today)
        assert str(got.value) == str(exc)
        return
    assert parse_days_ago(spec, today=today) == want


def test_daily_paths_and_expand_match_the_reference(tmp_path):
    root = tmp_path / "daily"
    for d in (1, 2, 4):  # day 3 missing
        os.makedirs(root / "2016" / "01" / f"{d:02d}")
    args = (str(root), datetime.date(2016, 1, 1), datetime.date(2016, 1, 4))
    assert daily_paths(*args) == j_daily_paths(*args)
    assert [p[-10:] for p in daily_paths(*args)] == ["2016/01/01", "2016/01/02", "2016/01/04"]
    for fn in (daily_paths, j_daily_paths):
        with pytest.raises(FileNotFoundError):
            fn(*args, error_on_missing=True)
    today = datetime.date(2016, 1, 5)
    for kw in (dict(date_range="20160101-20160104"), dict(date_range_days_ago="4-1"), {}):
        assert (expand_input_paths([str(root)], today=today, **kw)
                == j_expand([str(root)], today=today, **kw))
    for kw, err in ((dict(date_range="20200101-20200102"), FileNotFoundError),
                    (dict(date_range="20160101-20160102", date_range_days_ago="3-1"),
                     ValueError)):
        for fn in (expand_input_paths, j_expand):
            with pytest.raises(err):
                fn([str(root)], **kw)


def test_the_data_package_exports_the_references_names():
    import photon_ml_tpu.data as jpkg
    import photon_ml_tpu_torch.data as tpkg

    modules = {"index_map", "libsvm", "normalization", "stats", "validators", "native",
               "avro", "avro_native", "model_store", "paths", "projection"}
    names = {n for n in dir(jpkg) if not n.startswith("_") and n not in modules}
    assert names <= set(dir(tpkg))
