"""The ClimateBench data module and driver of the PyTorch port against the
JAX package: the data module against JAX's on tests/test_climatebench.py's
arrays, and `python -m orbit2_tpu_torch.climatebench`'s run for one epoch
per model against examples/climatebench.py's run from the same weights
(dropout 0; the models at small widths, the ViT at its head dim 32): best
val and the NRMSE trio, rtol 2e-4."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbit2_tpu.data.climatebench import ClimateBenchDataModule as JaxClimateBench
from orbit2_tpu_torch import climatebench
from orbit2_tpu_torch.data.climatebench import ClimateBenchDataModule
from orbit2_tpu_torch.training.checkpoint import state_dict_from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cb_arrays():
    """tests/test_climatebench.py's arrays."""
    rng = np.random.default_rng(0)
    t, c, h, w = 200, 4, 8, 16
    dict_x = {"ssp245": rng.normal(size=(t, c, h, w)).astype(np.float32)}
    dict_y = {"ssp245": rng.normal(15, 3, size=(t, 1, h, w)).astype(np.float32)}
    return dict_x, dict_y, np.linspace(-88, 88, h), np.linspace(0, 358, w)


def cb_modules():
    kw = dict(history=10, batch_size=8, list_train_simu=("ssp245",), list_test_simu=("ssp245",))
    return (ClimateBenchDataModule(_arrays=cb_arrays(), **kw),
            JaxClimateBench(_arrays=cb_arrays(), **kw))


def test_climatebench_module_matches_jax():
    dm, jdm = cb_modules()
    assert dm.get_data_dims() == jdm.get_data_dims()
    assert dm.get_data_variables() == jdm.get_data_variables()
    np.testing.assert_array_equal(dm.get_climatology()["tas"], jdm.get_climatology()["tas"])
    for split in ("train", "val", "test"):
        for (x, y, *_), (jx, jy, *_) in zip(getattr(dm, f"{split}_dataloader")(),
                                            getattr(jdm, f"{split}_dataloader")()):
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)


CB_OVERRIDES = {
    "resnet": dict(n_blocks=2, hidden_channels=16, dropout=0.0),
    "unet": dict(hidden_channels=4, n_blocks=1, ch_mults=(1,), is_attn=(False,),
                 dropout=0.0),
    "vit": dict(img_size=(8, 16), depth=1, drop_rate=0.0, drop_path=0.0),
}


@pytest.mark.parametrize("model", ["resnet", "unet", "vit"])
def test_climatebench_run_matches_jax(model):
    """One epoch of each model (the ViT at its head dim 32, on the plain
    attention path), from JAX's initial weights: the best val/mse and the
    test NRMSE trio."""
    spec = importlib.util.spec_from_file_location(
        "examples_climatebench", os.path.join(ROOT, "examples", "climatebench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    dm, jdm = cb_modules()
    jm = mod.build_model(model, CB_OVERRIDES[model])
    in_size, _ = jdm.get_data_dims()
    variables = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((1,) + in_size[1:]),
                                          deterministic=True))(jax.random.PRNGKey(0))
    state = state_dict_from_jax_params(jax.tree.map(np.asarray, variables["params"]), 2,
                                       batch_stats=variables.get("batch_stats"))
    want_val, want = mod.run(jdm, model, max_epochs=1, patience=1,
                             model_overrides=CB_OVERRIDES[model])
    next(iter(dm.train_dataloader()))  # JAX's run draws one train batch to init its model
    history = []
    got_val, got = climatebench.run(dm, model, max_epochs=1, patience=1,
                                    model_overrides=CB_OVERRIDES[model], device="cpu",
                                    state_dict=state, history=history)
    assert [h["steps"] for h in history] == [3]
    np.testing.assert_allclose(got_val, want_val, rtol=2e-4)
    assert set(got) == set(want) == {f"test/{n}:{v}" for n in ("lat_nrmses", "lat_nrmseg",
                                                               "lat_nrmse")
                                     for v in ("tas", "aggregate")}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, err_msg=k)
