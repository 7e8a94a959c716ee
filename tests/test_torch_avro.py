"""The port's Avro codec and readers against the JAX package's, on the CPU:

- a container written by either package, in both codecs, reads back equal
  in both (records crossing a block boundary, varint edge values);
- the TrainingExampleAvro reader with shard merging, unknown features
  dropped, and weight 0 with the null-id fallback gives the JAX reader's
  dataset array for array: labels, offsets, weights, each shard's COO, id
  codes and vocabulary, and the index maps key for key;
- the native reader (``build/native/libphoton_avro.so``) against the
  pure-Python one within the port, over several files and both codecs,
  the columnar native writer, and the ``PHOTON_NO_NATIVE`` toggle;
- scoring results, feature summaries and the Bayesian model, each written
  by one package and read by the other.

Tolerances: the readers' arrays are equal exactly (tests/test_avro.py
holds the native and Python readers to atol 0); a feature summary reads
the same in both packages, its mean and variance within the reference
test's rtol 1e-4 of float64 numpy, its max exactly.
"""

import numpy as np
import pytest

from photon_ml_tpu.data import avro as JA
from photon_ml_tpu.data.index_map import IndexMap as JIndexMap
from photon_ml_tpu_torch.data import avro as TA
from photon_ml_tpu_torch.data import avro_native as TAN
from photon_ml_tpu_torch.data import native as TN
from photon_ml_tpu_torch.data.index_map import INTERCEPT_KEY, IndexMap, feature_key

PACKAGES = {"jax": JA, "port": TA}


def _example(i, features, user=None):
    return {
        "uid": str(i),
        "label": float(i % 2),
        "features": [{"name": n, "term": t, "value": float(v)} for n, t, v in features],
        "metadataMap": {"userId": str(user)} if user is not None else None,
        "weight": 1.0 + 0.1 * i,
        "offset": 0.5 * i,
    }


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_container_round_trip_across_packages(tmp_path, codec, writer):
    recs = [_example(i, [("f", str(j), (i + 1) * (j + 1)) for j in range(i % 4)], user=i % 3)
            for i in range(257)]  # crosses a block boundary at block_records=100
    p = str(tmp_path / "t.avro")
    assert PACKAGES[writer].write_avro(p, JA.TRAINING_EXAMPLE_AVRO, recs, codec=codec,
                                       block_records=100) == 257
    assert list(JA.read_avro(p)) == recs
    assert list(TA.read_avro(p)) == recs


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_varint_edge_values_across_packages(tmp_path, writer):
    schema = {"name": "E", "type": "record", "fields": [
        {"name": "l", "type": "long"}, {"name": "d", "type": "double"},
        {"name": "s", "type": "string"}, {"name": "b", "type": "boolean"},
        {"name": "u", "type": ["null", "long"]}]}
    vals = [0, -1, 1, 63, -64, 64, -65, 2**31, -(2**31), 2**62, -(2**62), 2**63 - 1, -(2**63)]
    recs = [{"l": v, "d": v * 1.5, "s": f"v{v}", "b": v % 2 == 0,
             "u": None if v % 3 == 0 else v} for v in vals]
    p = str(tmp_path / "e.avro")
    PACKAGES[writer].write_avro(p, schema, recs)
    assert list(JA.read_avro(p)) == recs
    assert list(TA.read_avro(p)) == recs
    assert open(p, "rb").read() == _written_by(JA if writer == "port" else TA, tmp_path,
                                               schema, recs)


def _written_by(pkg, tmp_path, schema, recs) -> bytes:
    p = str(tmp_path / "other.avro")
    pkg.write_avro(p, schema, recs)
    return open(p, "rb").read()


def _same_dataset(t, j, t_maps=None, j_maps=None):
    """The port's dataset equals the JAX reader's, array for array."""
    np.testing.assert_array_equal(t.response, np.asarray(j.response))
    np.testing.assert_array_equal(t.offset, np.asarray(j.offset))
    np.testing.assert_array_equal(t.weight, np.asarray(j.weight))
    assert sorted(t.feature_shards) == sorted(j.feature_shards)
    for name, ts in t.feature_shards.items():
        js = j.shard(name)
        assert ts.num_features == js.num_features
        assert ts.values.dtype == np.float32
        np.testing.assert_array_equal(ts.values, np.asarray(js.values))
        np.testing.assert_array_equal(ts.rows, np.asarray(js.rows))
        np.testing.assert_array_equal(ts.cols, np.asarray(js.cols))
    assert sorted(t.id_columns) == sorted(j.id_columns)
    for c, tc in t.id_columns.items():
        np.testing.assert_array_equal(tc.codes, np.asarray(j.id_columns[c].codes))
        np.testing.assert_array_equal(tc.vocab, np.asarray(j.id_columns[c].vocab))
    if t_maps is not None:
        assert sorted(t_maps) == sorted(j_maps)
        for shard, m in t_maps.items():
            assert list(m.items()) == list(j_maps[shard].items())


def _read_both(paths, **kw):
    t = TA.read_game_dataset_from_avro(paths, return_index_maps=True, device="cpu", **kw)
    j = JA.read_game_dataset_from_avro(paths, return_index_maps=True, **kw)
    return t, j


def test_shard_merging_equals_the_jax_reader(tmp_path):
    schema = {**JA.TRAINING_EXAMPLE_AVRO, "fields": JA.TRAINING_EXAMPLE_AVRO["fields"] + [
        {"name": "userFeatures", "type": {"type": "array", "items": "FeatureAvro"},
         "default": []}]}
    recs = []
    for i in range(6):
        rec = _example(i, [("g", "a", i + 1), ("g", "b", 2 * i + 1)], user=i % 2)
        rec["userFeatures"] = [{"name": "u", "term": "x", "value": float(i)}]
        recs.append(rec)
    p = str(tmp_path / "m.avro")
    JA.write_avro(p, schema, recs)
    kw = dict(feature_shards={"global": ("features", "userFeatures"), "user": ("userFeatures",)},
              id_columns=["userId"])
    (t, t_maps), (j, j_maps) = _read_both(p, **kw)
    _same_dataset(t, j, t_maps, j_maps)
    assert t.shard("global").num_features == 4  # g|a, g|b, u|x + intercept
    assert t.shard("user").num_features == 2
    np.testing.assert_allclose(t.offset, 0.5 * np.arange(6))
    assert t.id_columns["userId"].num_entities == 2


def test_unknown_features_dropped_as_in_the_jax_reader(tmp_path):
    p = str(tmp_path / "d.avro")
    TA.write_avro(p, TA.TRAINING_EXAMPLE_AVRO,
                  [_example(i, [("known", "", 1.0), ("unknown", "", 9.0)]) for i in range(3)])
    keys = [feature_key("known", ""), INTERCEPT_KEY]
    t = TA.read_game_dataset_from_avro(p, feature_shards={"f": ("features",)},
                                       index_maps={"f": IndexMap(keys)}, device="cpu")
    j = JA.read_game_dataset_from_avro(p, feature_shards={"f": ("features",)},
                                       index_maps={"f": JIndexMap(keys)})
    _same_dataset(t, j)
    assert t.shard("f").values.sum() == pytest.approx(6.0)  # the 9.0s are dropped


def test_weight_zero_and_null_id_fallback_as_in_the_jax_reader(tmp_path):
    schema = {**JA.TRAINING_EXAMPLE_AVRO, "fields": JA.TRAINING_EXAMPLE_AVRO["fields"] + [
        {"name": "userId", "type": ["null", "string"], "default": None}]}
    recs = [{**_example(0, [("f", "", 1.0)], user=7), "weight": 0.0, "userId": None},
            {**_example(1, [("f", "", 1.0)], user=8), "weight": 2.0, "userId": "9"}]
    p = str(tmp_path / "w.avro")
    JA.write_avro(p, schema, recs)
    (t, t_maps), (j, j_maps) = _read_both(p, id_columns=["userId"])
    _same_dataset(t, j, t_maps, j_maps)
    np.testing.assert_array_equal(t.weight, [0.0, 2.0])
    idc = t.id_columns["userId"]
    assert list(idc.vocab[idc.codes]) == ["7", "9"]


def _random_files(tmp_path, rng):
    n = 300
    users = rng.integers(0, 9, size=n)

    def recs(lo, hi):
        for i in range(lo, hi):
            feats = [{"name": f"f{rng.integers(0, 40)}", "term": "t" if i % 3 else "",
                      "value": float(rng.normal())} for _ in range(int(rng.integers(1, 6)))]
            yield {"uid": str(i) if i % 4 else None, "label": float(i % 2), "features": feats,
                   "metadataMap": {"userId": str(users[i]), "junk": "x"},
                   "weight": 2.0 if i % 5 == 0 else None,
                   "offset": 0.25 if i % 7 == 0 else None}

    p1, p2 = str(tmp_path / "a.avro"), str(tmp_path / "b.avro")
    JA.write_avro(p1, JA.TRAINING_EXAMPLE_AVRO, recs(0, 200), block_records=64)
    TA.write_avro(p2, TA.TRAINING_EXAMPLE_AVRO, recs(200, 300), codec="null")
    return [p1, p2]


@pytest.fixture()
def avro_lib():
    lib = TN.load_avro_native()
    if lib is None:
        pytest.skip("g++ or zlib unavailable: the native Avro library cannot be built")
    return lib


def test_native_reader_matches_python_and_the_jax_reader(tmp_path, avro_lib, monkeypatch):
    from photon_ml_tpu_torch import telemetry

    paths = _random_files(tmp_path, np.random.default_rng(5))
    telemetry.reset()
    (native, n_maps), (jax_ds, j_maps) = _read_both(paths, id_columns=("userId",))
    assert telemetry.snapshot()["counters"] == {"avro.native_reads": 1}
    _same_dataset(native, jax_ds, n_maps, j_maps)
    monkeypatch.setattr(TAN, "read_game_arrays_native", lambda *a, **k: None)
    python, p_maps = TA.read_game_dataset_from_avro(paths, id_columns=("userId",),
                                                    return_index_maps=True, device="cpu")
    assert telemetry.snapshot()["counters"]["avro.python_reads"] == 1
    _same_dataset(python, jax_ds, p_maps, j_maps)
    telemetry.reset()


def test_native_writer_reads_back_in_both_packages(tmp_path, avro_lib):
    rng = np.random.default_rng(3)
    n = 500
    nnz = rng.integers(0, 5, size=n)
    starts = np.concatenate([[0], np.cumsum(nnz)])
    names = [f"f{j}" for j in range(30)] + ["u0", "u1"]
    fe = (starts, rng.integers(0, 30, starts[-1]), rng.normal(size=starts[-1]))
    ustarts = np.arange(n + 1) * 2
    ue = (ustarts, np.tile([30, 31], n), rng.normal(size=2 * n))
    users = rng.integers(0, 12, size=n)
    labels = (rng.random(n) < 0.5).astype(float)
    p = str(tmp_path / "fast.avro")
    written = TA.write_training_examples_fast(
        p, labels, {"global": fe, "user": ue}, names,
        {"userId": (users, [str(u) for u in range(12)])}, block_records=128)
    assert written == n
    shards = {"global": ("global",), "user": ("user",)}
    (t, t_maps), (j, j_maps) = _read_both(p, feature_shards=shards, id_columns=("userId",),
                                          add_intercept=False)
    _same_dataset(t, j, t_maps, j_maps)
    recs = list(TA.read_avro(p))
    assert [r["metadataMap"]["userId"] for r in recs] == [str(u) for u in users]
    np.testing.assert_array_equal([r["label"] for r in recs], labels)
    for r in (0, 17, n - 1):
        want = [(names[k], float(v)) for k, v in zip(fe[1][starts[r]:starts[r + 1]],
                                                      fe[2][starts[r]:starts[r + 1]])]
        assert [(f["name"], f["value"]) for f in recs[r]["global"]] == want


def test_no_native_toggle_hides_the_library_and_reads_the_same(tmp_path, avro_lib,
                                                               monkeypatch):
    paths = _random_files(tmp_path, np.random.default_rng(8))
    native, maps = TA.read_game_dataset_from_avro(paths, id_columns=("userId",),
                                                  return_index_maps=True, device="cpu")
    monkeypatch.setenv("PHOTON_NO_NATIVE", "1")
    assert TN.load_avro_native() is None
    assert TAN.read_game_arrays_native(paths, {"features": ("features",)}, None, ()) is None
    python = TA.read_game_dataset_from_avro(paths, index_maps=maps, id_columns=("userId",),
                                            device="cpu")
    _same_dataset(python, native)
    monkeypatch.delenv("PHOTON_NO_NATIVE")
    assert TN.load_avro_native() is avro_lib


def test_the_avro_library_is_the_ports_own(avro_lib):
    """Built from native/avro_*.cpp into build/native/libphoton_avro.so,
    apart from the LIBSVM parser's library, never into native/."""
    assert avro_lib._name == TN._AVRO_LIB_PATH
    assert TN._AVRO_LIB_PATH.endswith("/build/native/libphoton_avro.so")
    assert TN._AVRO_LIB_PATH != TN._LIB_PATH
    assert hasattr(avro_lib, "avro_parse") and hasattr(avro_lib, "avro_write_training_blocks")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_scoring_results_across_packages(tmp_path, writer):
    import torch

    scores = np.asarray([0.1, -2.5, 3.25, 1e-300])
    labels = np.asarray([1.0, 0.0, 1.0, 0.0])
    p = str(tmp_path / "scores.avro")
    arg = torch.from_numpy(scores) if writer == "port" else scores
    assert PACKAGES[writer].write_scoring_results(p, arg, model_id="best", labels=labels) == 4
    for reader in (JA, TA):
        recs = reader.read_scoring_results(p)
        np.testing.assert_array_equal([r["predictionScore"] for r in recs], scores)
        np.testing.assert_array_equal([r["label"] for r in recs], labels)
        assert all(r["modelId"] == "best" for r in recs)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_feature_summary_across_packages(tmp_path, writer):
    from photon_ml_tpu.data.stats import summarize as j_summarize
    from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
    from photon_ml_tpu_torch.data.stats import summarize
    from photon_ml_tpu_torch.ops.csr import CSRBatch

    rng = np.random.default_rng(2)
    n, d = 60, 5
    X = rng.normal(size=(n, d)) * (rng.random((n, d)) < 0.7)
    keys = [feature_key("f", str(j)) for j in range(d)]
    rows, cols = np.nonzero(X)
    if writer == "port":
        summary = summarize(CSRBatch.from_coo(X[rows, cols], rows, cols, np.zeros(n), d,
                                              device="cpu"))
    else:
        summary = j_summarize(JSparse.from_dense(X, np.zeros(n)))
    p = str(tmp_path / "stats.avro")
    assert PACKAGES[writer].write_feature_summary(p, summary, IndexMap(keys)) == d
    got = [JA.read_feature_summary(p), TA.read_feature_summary(p)]
    assert got[0] == got[1]
    stats = got[1]
    assert set(stats) == set(keys)
    for j, k in enumerate(keys):
        assert stats[k]["max"] == np.float32(X[:, j].max())
        assert stats[k]["mean"] == pytest.approx(X[:, j].mean(), rel=1e-4, abs=1e-5)
        assert stats[k]["variance"] == pytest.approx(X[:, j].var(ddof=1), rel=1e-4)
        assert stats[k]["numNonzeros"] == np.count_nonzero(X[:, j])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bayesian_model_across_packages(tmp_path, writer):
    rng = np.random.default_rng(4)
    keys = [feature_key("f", str(j)) for j in range(12)]
    imap, jmap = IndexMap.build(keys, add_intercept=True), JIndexMap.build(keys,
                                                                          add_intercept=True)
    means = rng.normal(size=len(imap))
    means[3] = 0.0  # the sparse representation drops zeros
    variances = np.abs(rng.normal(size=len(imap))) + 0.1
    p = str(tmp_path / "model.avro")
    PACKAGES[writer].write_bayesian_linear_model(
        p, means, imap if writer == "port" else jmap, model_id="m1", variances=variances,
        loss_function="logistic")
    for reader, m in ((JA, jmap), (TA, imap)):
        m2, v2, meta = reader.read_bayesian_linear_model(p, m)
        np.testing.assert_array_equal(m2, means)
        np.testing.assert_array_equal(v2, variances)
        assert meta == {"modelId": "m1", "modelClass": None, "lossFunction": "logistic"}


def test_training_examples_export_reads_back(tmp_path):
    """A dataset exported by ``write_training_examples`` reads back, in both
    packages, as the dataset it was."""
    paths = _random_files(tmp_path, np.random.default_rng(6))
    ds, maps = TA.read_game_dataset_from_avro(paths, id_columns=("userId",),
                                              return_index_maps=True, device="cpu")
    p = str(tmp_path / "export.avro")
    TA.write_training_examples(p, ds, "features", maps["features"], id_columns=("userId",))
    (t, _), (j, _) = _read_both(p, id_columns=("userId",), index_maps=maps)
    _same_dataset(t, j)
    _same_dataset(t, ds)
