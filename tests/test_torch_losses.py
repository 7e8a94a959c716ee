"""photon_ml_tpu_torch.ops.losses against photon_ml_tpu.ops.losses.

The same margins and labels (numpy, seeded) go through both packages; every
loss's value and first two derivatives agree to float32 tolerance.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu_torch.ops import losses as tl

LOSSES = ["logistic", "squared", "poisson", "smoothed_hinge"]


def _inputs(seed=7, n=512):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=n).astype(np.float32) * 3.0
    # hit the hinge's breakpoints and both label conventions
    z[:4] = [0.0, 1.0, -1.0, 0.5]
    y01 = (rng.random(n) > 0.5).astype(np.float32)
    ypm = np.where(y01 > 0.5, 1.0, -1.0).astype(np.float32)
    ycount = rng.poisson(2.0, size=n).astype(np.float32)
    return z, {"01": y01, "pm1": ypm, "count": ycount}


@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("labels", ["01", "pm1", "count"])
@pytest.mark.parametrize("part", ["loss", "dz", "d2z"])
def test_loss_parts_match_reference(name, labels, part):
    z, ys = _inputs()
    y = ys[labels]
    want = np.asarray(getattr(jl.get_loss(name), part)(jnp.asarray(z), jnp.asarray(y)))
    got = getattr(tl.get_loss(name), part)(torch.from_numpy(z), torch.from_numpy(y))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", LOSSES)
def test_loss_and_dz_and_flags_match_reference(name):
    z, ys = _inputs(seed=11)
    y = ys["01"]
    jloss, tloss = jl.get_loss(name), tl.get_loss(name)
    assert tloss.name == jloss.name
    assert tloss.has_hessian == jloss.has_hessian
    l_t, d_t = tloss.loss_and_dz(torch.from_numpy(z), torch.from_numpy(y))
    l_j, d_j = jloss.loss_and_dz(jnp.asarray(z), jnp.asarray(y))
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "alias,name",
    [
        ("logistic_regression", "logistic"),
        ("LINEAR_REGRESSION", "squared"),
        ("poisson_regression", "poisson"),
        ("smoothed_hinge_loss_linear_svm", "smoothed_hinge"),
    ],
)
def test_task_aliases(alias, name):
    assert tl.get_loss(alias).name == jl.get_loss(alias).name == name


def test_unknown_loss_raises_like_reference():
    with pytest.raises(ValueError, match="Unknown loss"):
        tl.get_loss("hinge")
    with pytest.raises(ValueError, match="Unknown loss"):
        jl.get_loss("hinge")


def test_logistic_is_stable_at_large_margins():
    z = torch.tensor([-200.0, -50.0, 50.0, 200.0])
    y = torch.tensor([1.0, 0.0, 1.0, 0.0])
    loss = tl.get_loss("logistic")
    assert torch.isfinite(loss.loss(z, y)).all()
    np.testing.assert_allclose(loss.loss(z, y).numpy(), [200.0, 0.0, 0.0, 200.0], atol=1e-6)
