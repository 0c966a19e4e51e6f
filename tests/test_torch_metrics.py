"""The port's metrics and the Mask transform against the JAX package's:
every registered metric the port added for the model hub, aggregate-only and
per variable (through evaluate_batch's keys), on the same numpy inputs,
rtol 1e-4; masked_mse with a wired mask, a per-call mask and a mask cropped
to a smaller target."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbit2_tpu.metrics.metrics import MetricsMetaInfo as JaxMetaInfo
from orbit2_tpu.registry import METRICS_REGISTRY as JAX_METRICS
from orbit2_tpu.training.train import evaluate_batch as jax_evaluate_batch
from orbit2_tpu.transforms.transforms import Mask as JaxMask
from orbit2_tpu_torch.metrics.metrics import METRICS_REGISTRY, MetricsMetaInfo
from orbit2_tpu_torch.training.train import evaluate_batch
from orbit2_tpu_torch.transforms.transforms import Mask

OUT = ["tas", "pr", "z500"]
NEW = ["mae", "lat_mse", "lat_mae", "lat_rmse", "acc", "lat_acc", "lat_nrmses", "lat_nrmseg",
       "lat_nrmse", "imagegradient", "quantile", "masked_mse"]


def inputs(seed=0, shape=(4, 3, 8, 16)):
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=shape).astype(np.float32)
    target = (0.7 * pred + 0.5 * rng.normal(size=shape)).astype(np.float32)
    lat = np.linspace(-80, 80, shape[2]).astype(np.float32)
    lon = np.linspace(0, 350, shape[3]).astype(np.float32)
    clim = (0.3 * rng.normal(size=shape[1:]) + 0.1).astype(np.float32)
    return pred, target, lat, lon, clim


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("aggregate_only", [True, False], ids=["aggregate", "per_variable"])
def test_metric_matches_jax(name, aggregate_only):
    pred, target, lat, lon, clim = inputs()
    if name.startswith("lat_nrmse"):  # ClimateBench: one variable, a scalar normalization
        pred, target, clim = pred[:, :1], target[:, :1], np.asarray([[0.8]], np.float32)
    out = OUT[:pred.shape[1]]
    jm = JAX_METRICS[name](aggregate_only=aggregate_only,
                           metainfo=JaxMetaInfo(out, out, lat, lon, clim))
    tm = METRICS_REGISTRY[name](aggregate_only=aggregate_only,
                                metainfo=MetricsMetaInfo(out, out, lat, lon, clim))
    if aggregate_only:
        want = np.asarray(jm(jnp.asarray(pred), jnp.asarray(target)))
        got = tm(torch.from_numpy(pred), torch.from_numpy(target)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
        return
    want = jax_evaluate_batch(jnp.asarray(pred), jnp.asarray(target), "test", [jm], None, out)
    got = evaluate_batch(torch.from_numpy(pred), torch.from_numpy(target), "test", [tm], None,
                         out)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["mse", "imagegradient", "masked_mse", "lat_mse"])
def test_weighted_train_losses_match_jax(name):
    """The train losses as the train step calls them: var_names and
    var_weights (channel weights)."""
    pred, target, lat, lon, clim = inputs(1)
    weights = {"tas": 10.0, "z500": 0.5}
    jm = JAX_METRICS[name](aggregate_only=True, metainfo=JaxMetaInfo(OUT, OUT, lat, lon, clim))
    tm = METRICS_REGISTRY[name](aggregate_only=True,
                                metainfo=MetricsMetaInfo(OUT, OUT, lat, lon, clim))
    want = jm(jnp.asarray(pred), jnp.asarray(target), var_names=OUT, var_weights=weights)
    got = tm(torch.from_numpy(pred), torch.from_numpy(target), var_names=OUT,
             var_weights=weights)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def test_masked_mse_with_a_wired_mask_matches_jax():
    """set_mask's full-grid [H, W] mask (cropped top-left to a smaller
    target, as the steps crop), then a per-call mask, against JAX's."""
    pred, target, lat, lon, clim = inputs(2)
    mask = (np.random.default_rng(3).random((10, 18)) > 0.3).astype(np.float32)
    jm = JAX_METRICS["masked_mse"](metainfo=JaxMetaInfo(OUT, OUT, lat, lon, clim)).set_mask(mask)
    tm = METRICS_REGISTRY["masked_mse"](metainfo=MetricsMetaInfo(OUT, OUT, lat, lon, clim))
    assert tm.set_mask(mask) is tm
    want = jm(jnp.asarray(pred), jnp.asarray(target))
    got = tm(torch.from_numpy(pred), torch.from_numpy(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    plain = METRICS_REGISTRY["mse"]()(torch.from_numpy(pred), torch.from_numpy(target))
    assert not np.allclose(got.numpy(), plain.numpy(), rtol=1e-3)
    call_mask = mask[:8, :16] * 0 + (np.arange(16) % 2)[None]
    want = jm(jnp.asarray(pred), jnp.asarray(target), mask=jnp.asarray(call_mask))
    got = tm(torch.from_numpy(pred), torch.from_numpy(target), mask=call_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    tm.set_mask(None)
    np.testing.assert_allclose(tm(torch.from_numpy(pred), torch.from_numpy(target)).numpy(),
                               plain.numpy(), rtol=1e-6)


def test_mask_transform_matches_jax():
    pred = inputs(4)[0]
    mask = (np.random.default_rng(5).random((8, 16)) > 0.5).astype(np.float32)
    for val in (0, -1.5):
        want = np.asarray(JaxMask(mask, val)(jnp.asarray(pred)))
        np.testing.assert_array_equal(Mask(mask, val)(torch.from_numpy(pred)).numpy(), want)
