"""Forecasting and the model hub's factories of the PyTorch port against the
JAX package (the ClimateBench driver: tests/test_torch_climatebench.py).

  * Trainer.fit at task forecasting and continuous-forecasting (the
    rasp-theurey-2020 preset) against JAX Trainer.fit from JAX's initial
    weights and BatchNorm statistics: per-epoch losses rtol 2e-4, the
    validation means rtol 2e-4; Evaluator.test on JAX's trained weights
    against JAX Trainer.test, rtol 1e-4. The preset is built at a tiny width
    (hidden 8, 2 blocks) and without dropout in both packages by patching
    the class their factories build: its 19 blocks of 128 channels would
    take minutes here, and dropout masks differ between the packages.
  * load_architecture's presets (parameter names and counts key for key
    against JAX's trees) and refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbit2_tpu.config import load_config as jax_load_config
from orbit2_tpu.training.trainer import Trainer as JaxTrainer
from orbit2_tpu.utils import loaders as jax_loaders
from orbit2_tpu_torch.config import load_config
from orbit2_tpu_torch.evaluate import Evaluator, make_data_module
from orbit2_tpu_torch.training.checkpoint import state_dict_from_jax_params
from orbit2_tpu_torch.training.trainer import Trainer
from orbit2_tpu_torch.utils import loaders

IN_VARS = ["2m_temperature", "geopotential_500", "temperature_850"]
OUT_VARS = ["geopotential_500", "temperature_850"]


@pytest.fixture(scope="module")
def forecast_dataset(tmp_path_factory):
    """One 8 x 16 grid (forecasting: low_res_dir == high_res_dir) in the
    reference npz layout: 2 shards of 10 steps a split."""
    root = tmp_path_factory.mktemp("forecast")
    rng = np.random.default_rng(0)
    for split in ("train", "val", "test"):
        (root / split).mkdir()
        for i in range(2):
            np.savez(root / split / f"shard_{i}.npz",
                     **{v: rng.normal(280, 10, size=(10, 1, 8, 16)).astype(np.float32)
                        for v in IN_VARS})
        np.savez(root / split / "climatology.npz",
                 **{v: rng.normal(0, 1, size=(1, 8, 16)).astype(np.float32) for v in IN_VARS})
    np.save(root / "lat.npy", np.linspace(-80, 80, 8).astype(np.float32))
    np.save(root / "lon.npy", np.linspace(0, 337.5, 16).astype(np.float32))
    np.savez(root / "normalize_mean.npz", **{v: np.array([280.0], np.float32) for v in IN_VARS})
    np.savez(root / "normalize_std.npz", **{v: np.array([10.0], np.float32) for v in IN_VARS})
    return str(root)


def forecast_raw(root, task="forecasting"):
    """configs/forecast.yaml's sections at a tiny size, on one device."""
    data = {"low_res_dir": {"ERA5": root}, "high_res_dir": {"ERA5": root},
            "spatial_resolution": {"ERA5": 625}, "default_vars": IN_VARS,
            "dict_in_variables": {"ERA5": IN_VARS}, "dict_out_variables": {"ERA5": OUT_VARS},
            "var_weights": {}, "src": "era5", "history": 2, "window": 1, "pred_range": 2}
    if task == "continuous-forecasting":
        # a fixed lead time: with random_lead_time the lead times come from an
        # unseeded numpy generator (data/reader.py::ContinuousForecast), in
        # both packages, so no two runs see the same batches
        data.update(pred_range=3, max_pred_range=3, random_lead_time=False)
    return {
        "trainer": {"max_epochs": 2, "batch_size": 4, "buffer_size": 8, "num_workers": 0,
                    "data_type": "float32", "train_loss": "lat_mse", "task": task,
                    "interval_epochs": 1},
        "parallelism": {"fsdp": 1, "simple_ddp": 1, "tensor_par": 1, "seq_par": 1},
        "tiling": {"do_tiling": False},
        "model": {"preset": "rasp-theurey-2020", "lr": 5e-4, "weight_decay": 1e-5,
                  "beta_1": 0.9, "beta_2": 0.99, "warmup_epochs": 1, "drop_rate": 0.0},
        "data": data,
    }


@pytest.fixture
def tiny_presets(monkeypatch):
    """Both factories' ResNet (and Unet) at hidden 8, 2 blocks, no dropout."""
    from orbit2_tpu.models.resnet import ResNet as JaxResNet
    from orbit2_tpu.models.unet import Unet as JaxUnet
    from orbit2_tpu_torch.models.resnet import ResNet
    from orbit2_tpu_torch.models.unet import Unet

    small = dict(hidden_channels=8, n_blocks=2, dropout=0.0)
    unet = dict(hidden_channels=4, ch_mults=(1, 2), is_attn=(False, False), n_blocks=1,
                dropout=0.0)
    monkeypatch.setattr(jax_loaders, "ResNet", lambda **kw: JaxResNet(**{**kw, **small}))
    monkeypatch.setattr(jax_loaders, "Unet", lambda **kw: JaxUnet(**{**kw, **unet}))
    monkeypatch.setattr(loaders, "ResNet", lambda *a, **kw: ResNet(*a, **{**kw, **small}))
    monkeypatch.setattr(loaders, "Unet", lambda *a, **kw: Unet(*a, **{**kw, **unet}))


def jax_state(jt, prefix=""):
    """The JAX Trainer's parameters and BatchNorm statistics as a port state dict."""
    return state_dict_from_jax_params(jax.tree.map(np.asarray, jt.params), 2,
                                      batch_stats=jax.tree.map(np.asarray,
                                                               jt.aux["batch_stats"]),
                                      prefix=prefix)


@pytest.mark.parametrize("task", ["forecasting", "continuous-forecasting"])
def test_forecasting_fit_validation_and_test_match_jax_trainer(forecast_dataset, tmp_path,
                                                               tiny_presets, task):
    raw = forecast_raw(forecast_dataset, task)
    jt = JaxTrainer(jax_load_config(raw), checkpoint_dir=str(tmp_path / "ck"),
                    run_validation=True)
    jt.test(max_batches=0)  # builds the model and draws its weights and statistics
    init = jax_state(jt)
    want = jt.fit(max_epochs=2, max_steps_per_epoch=3)

    trainer = Trainer(load_config(raw), "cpu", state_dict=init, run_validation=True)
    got = trainer.fit(max_epochs=2, max_steps_per_epoch=3)
    assert [r["batches"] for r in got] == [3, 3]
    assert [r["lr"] for r in got] == [r["lr"] for r in want]
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want], rtol=2e-4)
    means, jmeans = trainer.last_validation["means"], jt.last_validation["means"]
    assert set(means) == set(jmeans) and len(means) == 9  # lat_rmse, lat_acc, lat_mse x 3
    assert trainer.last_validation["samples"] == jt.last_validation["samples"]
    for k in jmeans:
        # the anomaly correlation of these random fields is ~1e-3: its
        # trajectory error is held in absolute terms, on its [-1, 1] scale
        np.testing.assert_allclose(means[k], jmeans[k], rtol=2e-4,
                                   atol=1e-4 if "acc" in k else 0, err_msg=k)
    # the BatchNorm running averages moved with training (their values are
    # held step by step in tests/test_torch_hub.py)
    trained = trainer.model.state_dict()
    jtrained = jax_state(jt)
    running = [k for k in jtrained if "running" in k]
    assert running and all(not torch.equal(trained[k], init[k]) for k in running)

    jtest = jt.test()
    ev = Evaluator(load_config(raw), "cpu", state_dict=jtrained)
    assert ev.quant_modes == ("none",) and not ev.model.training
    test = ev.test()
    assert set(test) == set(jtest) and len(test) == 6  # lat_rmse, lat_acc x 3
    for k in jtest:
        # the same weights: the near-zero anomaly correlation is held in
        # absolute terms, its sums cancel to ~1e-3
        np.testing.assert_allclose(test[k], jtest[k], rtol=1e-4,
                                   atol=1e-5 if "acc" in k else 0, err_msg=k)
    with pytest.raises(ValueError, match="no quantized serving path"):
        ev.test(quant="w8a8")
    with pytest.raises(ValueError, match="no quantized serving path"):
        Evaluator(load_config(raw), "cpu", quant_modes=("none", "w8a8"))


def test_forecasting_refuses_tiling(forecast_dataset):
    raw = forecast_raw(forecast_dataset)
    raw["tiling"] = {"do_tiling": True, "div": 2, "overlap": 2}
    with pytest.raises(ValueError, match="downscaling-only"):
        Evaluator(load_config(raw), "cpu")


def _count(tree):
    return sum(int(np.prod(np.shape(a))) for a in jax.tree.leaves(tree))


@pytest.mark.parametrize("preset", ["rasp-theurey-2020", "linear-regression", "persistence",
                                    "climatology"])
def test_forecasting_presets_match_jax_trees(forecast_dataset, preset):
    """The full rasp-theurey-2020 preset (19 blocks, 128 channels) and the
    baselines: every JAX parameter (and BatchNorm statistic) has a port key
    of its shape, and nothing else, by jax.eval_shape (nothing drawn)."""
    raw = forecast_raw(forecast_dataset)
    dm = make_data_module(load_config(raw), "ERA5", 1, 0)
    jdm = JaxTrainer(jax_load_config(raw), checkpoint_dir=None)._make_data_module("ERA5")
    jdm.setup()
    jm = jax_loaders.load_architecture("forecasting", jdm, preset)
    with torch.device("meta"):
        tm = loaders.load_architecture(dm, preset, task="forecasting")
    in_shape, out_shape = dm.get_data_dims()
    x = torch.zeros((2,) + tuple(in_shape[1:]))
    if preset in ("persistence", "climatology"):
        got = tm(x)
        want = jm.apply({}, jnp.zeros(x.shape))
        assert tuple(got.shape) == tuple(want.shape) == (2,) + tuple(out_shape[1:])
        return
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros(x.shape)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = state_dict_from_jax_params(zeros["params"], batch_stats=zeros.get("batch_stats"))
    got = tm.state_dict()
    assert set(got) == set(want)
    assert all(tuple(got[k].shape) == tuple(want[k].shape) for k in want)
    n = sum(p.numel() for p in tm.parameters())
    assert n == _count(shapes["params"])
    if preset == "rasp-theurey-2020":
        assert len(tm.blocks) == 19 and tm.image_proj.conv.in_channels == 2 * 3


def test_downscaling_presets_and_refusals(synth_dataset, forecast_dataset):
    """The downscaling presets behind PreInterpolated (vit, unet, resnet),
    the interpolation baselines, and JAX's refusals."""
    from orbit2_tpu_torch.models.baselines import Interpolation
    from orbit2_tpu_torch.utils.loaders import PreInterpolated

    raw = {"trainer": {"batch_size": 2, "num_workers": 0, "data_type": "float32"},
           "parallelism": {"fsdp": 1, "simple_ddp": 1, "tensor_par": 1},
           "tiling": {"do_tiling": False}, "model": {"preset": "vit"},
           "data": {"low_res_dir": {"S": synth_dataset["low"]},
                    "high_res_dir": {"S": synth_dataset["high"]},
                    "spatial_resolution": {"S": 625},
                    "default_vars": synth_dataset["in_vars"],
                    "dict_in_variables": {"S": synth_dataset["in_vars"]},
                    "dict_out_variables": {"S": synth_dataset["out_vars"]}}}
    dm = make_data_module(load_config(raw), "S", 1, 0)
    with torch.device("meta"):
        for arch in ("vit", "unet", "resnet"):
            m = loaders.load_architecture(dm, arch, embed_dim=64, depth=1, num_heads=2)
            assert isinstance(m, PreInterpolated) and m.interpolation.scale_factor == 4.0
        vit = loaders.load_architecture(dm, "vit", embed_dim=64, depth=1, num_heads=2)
        assert tuple(vit.backbone.pos_embed.shape) == (1, 32 * 64, 64)
        assert vit.backbone.pos_embed.requires_grad
        with pytest.raises(RuntimeError, match="match the input variables"):
            loaders.load_architecture(dm, "bilinear-interpolation")
        with pytest.raises(NotImplementedError, match="not an implemented architecture"):
            loaders.load_architecture(dm, "rasp-theurey-2020")
        with pytest.raises(NotImplementedError, match="not an implemented architecture"):
            loaders.load_architecture(dm, "vit", task="nowcasting")
        with pytest.raises(ValueError, match="no quantized serving path"):
            loaders.load_architecture(dm, "unet", quant="w8a8")
    # the interpolation baselines need out variables == in variables
    same = forecast_raw(forecast_dataset, "downscaling")
    same["data"]["dict_out_variables"]["ERA5"] = IN_VARS
    dm_same = make_data_module(load_config(same), "ERA5", 1, 0)
    m = loaders.load_architecture(dm_same, "nearest-interpolation")
    assert isinstance(m, Interpolation) and m.mode == "nearest" and m.scale_factor == 1.0


def test_persistence_refuses_outputs_outside_the_inputs(forecast_dataset):
    raw = forecast_raw(forecast_dataset)
    raw["data"]["dict_in_variables"]["ERA5"] = IN_VARS[:2]
    raw["data"]["dict_out_variables"]["ERA5"] = IN_VARS[1:]
    dm = make_data_module(load_config(raw), "ERA5", 1, 0, "test")
    with pytest.raises(RuntimeError, match="subset"):
        loaders.load_architecture(dm, "persistence", task="forecasting")
