"""The downscaling presets of the model hub (vit, unet, resnet behind a
bilinear upsample) and the fine-tune losses of the PyTorch port against the
JAX package.

  * Trainer.fit for each preset, with a loss of the fine-tune CLI's (mse,
    imagegradient, quantile, masked_mse with the data module's validity
    mask), against JAX Trainer.fit from JAX's initial weights and BatchNorm
    statistics: per-epoch losses rtol 2e-4. The Unet (one level; its two-level
    form is held in tests/test_torch_hub.py) and ResNet are built at tiny
    widths (patched in both factories) and without dropout, the ViT with
    the config's dropout 0, on a 4 x 8 -> 16 x 32 synthetic field.
  * `python -m orbit2_tpu_torch.finetune --arch vit|unet|resnet` with the
    three new losses, from a checkpoint of the same preset: every key
    imported, one epoch of finite losses. The presets' full widths are held
    key for key in tests/test_torch_forecast.py and run on the card
    (chip_smoke.py, phase hub).
"""

import os
import shutil

import jax
import numpy as np
import pytest
import yaml

from orbit2_tpu.config import load_config as jax_load_config
from orbit2_tpu.training.trainer import Trainer as JaxTrainer
from orbit2_tpu_torch.config import load_config
from orbit2_tpu_torch.training.checkpoint import restore_checkpoint, state_dict_from_jax_params
from orbit2_tpu_torch.training.trainer import Trainer

IN_VARS = ["land_sea_mask", "orography", "lattitude", "landcover",
           "total_precipitation_24hr", "2m_temperature_min", "2m_temperature_max"]
OUT_VARS = IN_VARS[4:]


@pytest.fixture(scope="module")
def small_field(tmp_path_factory):
    """4 x 8 -> 16 x 32 in the reference npz layout (2 shards of 8 fields a
    split), and a copy whose targets carry a validity mask (mask.npy)."""
    root = tmp_path_factory.mktemp("small_field")
    rng = np.random.default_rng(0)
    for base, (h, w), variables in ((root / "low", (4, 8), IN_VARS),
                                    (root / "high", (16, 32), OUT_VARS)):
        for split in ("train", "val", "test"):
            (base / split).mkdir(parents=True)
            for i in range(2):
                np.savez(base / split / f"shard_{i}.npz",
                         **{v: rng.normal(280, 10, size=(8, 1, h, w)).astype(np.float32)
                            for v in variables})
            np.savez(base / split / "climatology.npz",
                     **{v: rng.normal(280, 1, size=(1, h, w)).astype(np.float32)
                        for v in variables})
        np.save(base / "lat.npy", np.linspace(-60, 60, h).astype(np.float32))
        np.save(base / "lon.npy", np.linspace(0, 350, w).astype(np.float32))
        np.savez(base / "normalize_mean.npz", **{v: np.array([280.0], np.float32)
                                                 for v in variables})
        np.savez(base / "normalize_std.npz", **{v: np.array([10.0], np.float32)
                                                for v in variables})
    shutil.copytree(root / "high", root / "high_masked")
    np.save(root / "high_masked" / "mask.npy",
            (rng.random((16, 32)) > 0.25).astype(np.float32))
    return root


def raw_config(root, preset, loss, masked=False):
    return {
        "trainer": {"max_epochs": 2, "batch_size": 4, "buffer_size": 8, "num_workers": 0,
                    "data_type": "float32", "train_loss": loss, "interval_epochs": 1},
        "parallelism": {"fsdp": 1, "simple_ddp": 1, "tensor_par": 1},
        "tiling": {"do_tiling": False},
        "model": {"preset": preset, "lr": 2e-4, "weight_decay": 1e-5, "beta_1": 0.9,
                  "beta_2": 0.99, "warmup_epochs": 1, "patch_size": 2, "embed_dim": 64,
                  "depth": 2, "decoder_depth": 2, "num_heads": 2, "drop_path": 0.0,
                  "drop_rate": 0.0, "attention_impl": "auto"},
        "data": {"low_res_dir": {"S": str(root / "low")},
                 "high_res_dir": {"S": str(root / ("high_masked" if masked else "high"))},
                 "spatial_resolution": {"S": 4}, "default_vars": IN_VARS,
                 "dict_in_variables": {"S": IN_VARS}, "dict_out_variables": {"S": OUT_VARS},
                 "var_weights": {"2m_temperature_min": 10, "2m_temperature_max": 10}},
    }


@pytest.fixture
def tiny_presets(monkeypatch):
    from orbit2_tpu.models.resnet import ResNet as JaxResNet
    from orbit2_tpu.models.unet import Unet as JaxUnet
    from orbit2_tpu.utils import loaders as jax_loaders
    from orbit2_tpu_torch.models.resnet import ResNet
    from orbit2_tpu_torch.models.unet import Unet
    from orbit2_tpu_torch.utils import loaders

    resnet = dict(hidden_channels=8, n_blocks=2, dropout=0.0)
    unet = dict(hidden_channels=4, ch_mults=(1,), is_attn=(False,), mid_attn=True,
                n_blocks=1, dropout=0.0)
    monkeypatch.setattr(jax_loaders, "ResNet", lambda **kw: JaxResNet(**{**kw, **resnet}))
    monkeypatch.setattr(jax_loaders, "Unet", lambda **kw: JaxUnet(**{**kw, **unet}))
    monkeypatch.setattr(loaders, "ResNet", lambda *a, **kw: ResNet(*a, **{**kw, **resnet}))
    monkeypatch.setattr(loaders, "Unet", lambda *a, **kw: Unet(*a, **{**kw, **unet}))


@pytest.mark.parametrize("preset,loss,masked", [
    ("vit", "mse", False), ("unet", "imagegradient", False), ("resnet", "quantile", False),
    ("vit", "masked_mse", True)], ids=["vit-mse", "unet-imagegradient", "resnet-quantile",
                                        "vit-masked_mse"])
def test_downscaling_preset_fit_matches_jax_trainer(small_field, tmp_path, tiny_presets,
                                                    preset, loss, masked):
    raw = raw_config(small_field, preset, loss, masked)
    jt = JaxTrainer(jax_load_config(raw), checkpoint_dir=str(tmp_path / "ck"))
    jt.test(max_batches=0)  # builds the model and draws its weights
    stats = jt.aux.get("batch_stats")
    init = state_dict_from_jax_params(
        jax.tree.map(np.asarray, jt.params), 2, prefix="backbone.",
        batch_stats=None if stats is None else jax.tree.map(np.asarray, stats))
    want = jt.fit(max_epochs=2, max_steps_per_epoch=3)
    trainer = Trainer(load_config(raw), "cpu", state_dict=init)
    got = trainer.fit(max_epochs=2, max_steps_per_epoch=3)
    assert [r["batches"] for r in got] == [3, 3]
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want], rtol=2e-4)
    if masked:
        assert trainer.train_loss.mask is not None
    if preset == "vit":  # the target grid's 8 x 16 tokens, pos_embed learned
        assert tuple(trainer.model.backbone.pos_embed.shape) == (1, 128, 64)


def test_masked_mse_refuses_tiling(small_field):
    raw = raw_config(small_field, "vit", "masked_mse", masked=True)
    raw["tiling"] = {"do_tiling": True, "div": 2, "overlap": 0}
    with pytest.raises(ValueError, match="full-grid"):
        Trainer(load_config(raw), "cpu").fit(max_epochs=1, max_steps_per_epoch=1)


@pytest.mark.parametrize("arch,loss", [("vit", "imagegradient"), ("unet", "masked_mse"),
                                       ("resnet", "quantile")])
def test_finetune_cli_trains_each_hub_preset(small_field, tmp_path, tiny_presets, arch, loss):
    """finetune --arch/--loss from a checkpoint of the same preset (a
    Trainer's epoch_0): every key imported, nothing dropped or resized, one
    epoch of finite losses (the Unet and ResNet at the tiny widths)."""
    from orbit2_tpu_torch import finetune

    raw = raw_config(small_field, arch, "mse", masked=loss == "masked_mse")
    Trainer(load_config(raw), "cpu", checkpoint_dir=str(tmp_path / "pre")).fit(
        max_epochs=1, max_steps_per_epoch=1)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    out = finetune.main([str(path), "--arch", arch, "--loss", loss, "--pretrain",
                         str(tmp_path / "pre" / "epoch_0"), "--max-epochs", "1",
                         "--max-steps-per-epoch", "2", "--checkpoint-dir", str(tmp_path / "ft"),
                         "--device", "cpu"])
    pre = restore_checkpoint(str(tmp_path / "pre" / "epoch_0"))["model"]
    rep = out["pretrain"]
    assert set(rep["used"]) == set(pre) and not rep["dropped"] and not rep["resized"]
    assert out["history"][0]["batches"] == 2 and np.isfinite(out["history"][0]["loss"])
    assert os.listdir(tmp_path / "ft") == ["epoch_0"]
