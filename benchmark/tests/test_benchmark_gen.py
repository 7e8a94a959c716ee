"""The generators are deterministic by seed and draw bench.py's model."""

import torch

from benchmark import gen

BIG_SEED = 2**31 + 12345


def test_glm_rows_repeat_by_seed():
    a = gen.glm_rows(9, BIG_SEED, 0, 500, 100, 5, "cpu")
    b = gen.glm_rows(9, BIG_SEED, 0, 500, 100, 5, "cpu")
    assert torch.equal(a.cols, b.cols) and torch.equal(a.vals, b.vals)
    assert torch.equal(a.labels, b.labels)


def test_glm_rows_differ_by_seed_and_shard():
    a = gen.glm_rows(9, 7, 0, 500, 100, 5, "cpu")
    assert not torch.equal(a.vals, gen.glm_rows(9, 8, 0, 500, 100, 5, "cpu").vals)
    assert not torch.equal(a.vals, gen.glm_rows(9, 7, 1, 500, 100, 5, "cpu").vals)


def test_seeds_orient_the_same_rows():
    """Every seed gives the fit the same rows, each feature's values times a
    sign of the seed's: the same magnitudes, columns and labels."""
    a = gen.glm_rows(9, 7, 0, 500, 100, 5, "cpu")
    b = gen.glm_rows(9, BIG_SEED, 0, 500, 100, 5, "cpu")
    assert torch.equal(a.cols, b.cols) and torch.equal(a.labels, b.labels)
    assert torch.equal(a.vals.abs(), b.vals.abs()) and not torch.equal(a.vals, b.vals)
    flip = (a.vals != b.vals)
    # a sign belongs to a feature: a column is flipped everywhere or nowhere
    per_col = torch.zeros(100).index_add_(0, a.cols.long(), flip.float())
    seen = torch.bincount(a.cols.long(), minlength=100).float()
    assert torch.equal(per_col[seen > 0] == 0, per_col[seen > 0] != seen[seen > 0])
    assert not torch.equal(gen.glm_rows(10, 7, 0, 500, 100, 5, "cpu").vals.abs().sort().values,
                           a.vals.abs().sort().values)


def test_shards_share_the_planted_model():
    assert torch.equal(gen.planted(7, 100, "cpu"), gen.planted(7, 100, "cpu"))
    assert not torch.equal(gen.planted(7, 100, "cpu"), gen.planted(8, 100, "cpu"))


def test_glm_rows_shapes_and_ranges():
    r = gen.glm_rows(9, 3, 0, 400, 50, 20, "cpu")
    assert r.cols.dtype == torch.int32 and r.cols.numel() == 400 * 20
    assert int(r.cols.min()) >= 0 and int(r.cols.max()) < 50
    assert set(r.labels.unique().tolist()) <= {0.0, 1.0}
    assert r.row_ptr().tolist()[:3] == [0, 20, 40] and int(r.row_ptr()[-1]) == 8000
    part = r.rows(100, 150)
    assert part.num_rows == 50 and torch.equal(part.vals, r.vals[2000:3000])


def test_labels_follow_the_planted_model():
    r = gen.glm_rows(9, 5, 0, 20000, 200, 20, "cpu")
    # the planted model as the seed orients it
    w = gen.planted(9, 200, "cpu") * gen.feature_signs(5, 200, "cpu")
    m = gen.sparse_margins(r.cols, r.vals, w, 20)
    # rows with large margins are mostly positive, small mostly negative
    assert float(r.labels[m > 3].mean()) > 0.9 and float(r.labels[m < -3].mean()) < 0.1


def test_every_seed_gives_the_fit_the_same_work(small_cell):
    """The seeds' orientations are an exact symmetry of the fit: the same
    data passes, the same objective bit for bit, each coefficient's
    magnitude bit for bit."""
    from benchmark import harness

    cell, devices = small_cell("glm1-lbfgs-32m")
    driver = harness.load_module("drivers", cell.driver)
    runs = [driver.prepare(harness.Bench(cell, seed, devices)) for seed in (3, BIG_SEED)]
    (wa, va), (wb, vb) = (r.answers.groups[-1][1] for r in runs)
    assert runs[0].passes == runs[1].passes
    assert torch.equal(va, vb) and torch.equal(wa.abs(), wb.abs()) and not torch.equal(wa, wb)
