"""TILES tiling on the port's serving path: `Evaluator.test` on the div x div
halo tiles of a 32 x 64 synthetic set against the JAX `Trainer.test` on the
same tiles and weights (fp32: metrics rtol 1e-4; w8a8: rtol 1e-3), and the
JAX Trainer's tile check in the Evaluator and in Trainer.fit.

The weights are the JAX Trainer's, perturbed by noise of std 0.3: at their
init scale the trunk moves the metrics by ~1e-6 (the CNN residual path
dominates), too little for w8a8 to show."""

import json

import jax
import numpy as np
import pytest
import yaml

from orbit2_tpu.config import load_config as jax_load_config
from orbit2_tpu.training.trainer import Trainer as JaxTrainer
from orbit2_tpu_torch.config import load_config
from orbit2_tpu_torch.data.reader import tile_shapes
from orbit2_tpu_torch.evaluate import Evaluator, main
from orbit2_tpu_torch.training.checkpoint import state_dict_from_jax_params
from orbit2_tpu_torch.training.trainer import Trainer

IN_VARS = ["land_sea_mask", "orography", "lattitude", "landcover",
           "total_precipitation_24hr", "2m_temperature_min", "2m_temperature_max"]
OUT_VARS = IN_VARS[4:]
H, W, MAG = 32, 64, 4


@pytest.fixture(scope="module")
def synth_32x64(tmp_path_factory):
    """tests/conftest.py's synthetic layout at 32 x 64 -> 128 x 256, 4 time
    steps a shard."""
    root = tmp_path_factory.mktemp("synth_32x64")
    rng = np.random.default_rng(0)

    def field(v, h, w):
        if v == "total_precipitation_24hr":
            return rng.gamma(0.3, 0.004, size=(4, 1, h, w))
        if v in ("land_sea_mask", "landcover"):
            return rng.integers(0, 2, size=(4, 1, h, w)).astype(np.float64)
        return rng.normal(280, 10, size=(4, 1, h, w))

    for base, (h, w), variables in ((root / "low", (H, W), IN_VARS),
                                    (root / "high", (H * MAG, W * MAG), OUT_VARS)):
        for split in ("train", "val", "test"):
            (base / split).mkdir(parents=True)
            np.savez(base / split / "shard_0.npz",
                     **{v: field(v, h, w).astype(np.float32) for v in variables})
            np.savez(base / split / "climatology.npz",
                     **{v: rng.normal(280, 1, size=(1, h, w)).astype(np.float32)
                        for v in variables})
        np.save(base / "lat.npy", np.linspace(-88, 88, h).astype(np.float32))
        np.save(base / "lon.npy", np.linspace(0, 358, w).astype(np.float32))
        np.savez(base / "normalize_mean.npz", **{v: np.array([280.0], np.float32) for v in variables})
        np.savez(base / "normalize_std.npz", **{v: np.array([10.0], np.float32) for v in variables})
    return {"low": str(root / "low"), "high": str(root / "high")}


def tiled_raw(ds, div, overlap, data_type="float32"):
    return {
        "trainer": {"max_epochs": 1, "batch_size": 4, "buffer_size": 8, "num_workers": 0,
                    "data_type": data_type, "train_loss": "bayesian_tv", "remat": False},
        "parallelism": {"fsdp": 1, "simple_ddp": 1, "tensor_par": 1},
        "tiling": {"do_tiling": True, "div": div, "overlap": overlap},
        "model": {"preset": "res_slimvit", "lr": 1e-3, "warmup_epochs": 1,
                  "superres_mag": MAG, "patch_size": 2, "embed_dim": 32, "depth": 1,
                  "decoder_depth": 1, "num_heads": 2, "drop_path": 0.0, "drop_rate": 0.0,
                  "attention_impl": "auto"},
        "data": {
            "low_res_dir": {"S": ds["low"]},
            "high_res_dir": {"S": ds["high"]},
            "spatial_resolution": {"S": 625},
            "default_vars": IN_VARS,
            "dict_in_variables": {"S": IN_VARS},
            "dict_out_variables": {"S": OUT_VARS},
            "var_weights": {},
        },
    }


@pytest.mark.parametrize("quant,rtol", [("none", 1e-4), ("w8a8", 1e-3)], ids=["fp32", "w8a8"])
@pytest.mark.parametrize("div,overlap", [(2, 2), (4, 2)], ids=["div2", "div4"])
def test_tiled_evaluator_matches_jax_trainer_test(synth_32x64, tmp_path, div, overlap, quant,
                                                  rtol):
    raw = tiled_raw(synth_32x64, div, overlap)
    trainer = JaxTrainer(jax_load_config(raw), checkpoint_dir=str(tmp_path / "ck"))
    trainer.test(max_batches=1)  # draws the params
    rng = np.random.default_rng(1)
    trainer.params = jax.tree.map(
        lambda a: np.asarray(a) + 0.3 * rng.normal(size=a.shape).astype(np.float32),
        trainer.params)
    want = trainer.test(max_batches=2, quant=quant)

    ev = Evaluator(load_config(raw), "cpu",
                   state_dict=state_dict_from_jax_params(trainer.params, patch_size=2))
    tile_in, tile_out = tile_shapes(div, overlap, H, W, H * MAG, W * MAG)
    in_shape, out_shape = ev.data_module.get_data_dims()
    assert tuple(in_shape[2:]) == tile_in and tuple(out_shape[2:]) == tile_out
    got = ev.test(max_batches=2, quant=quant)
    assert list(got) == list(want) and len(got) == 12
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=rtol, atol=1e-6, err_msg=k)
    if quant != "none":
        # the int8 trunk moves the metrics further than the packages differ
        worst = lambda m: max(abs(m[k] - float(want[k])) / abs(float(want[k])) for k in want)
        assert worst(ev.test(max_batches=2)) > 10 * worst(got)


def test_tile_check_matches_jax(synth_32x64, tmp_path):
    """div 2, overlap 1 cuts 17 x 34 tiles: odd for patch 2, so both packages
    refuse with the same increase-the-overlap hint."""
    raw = tiled_raw(synth_32x64, 2, 1)
    assert tile_shapes(2, 1, H, W, H * MAG, W * MAG)[0] == (17, 34)
    with pytest.raises(ValueError) as want:
        JaxTrainer(jax_load_config(raw), checkpoint_dir=str(tmp_path / "ck")).test(max_batches=1)
    with pytest.raises(ValueError, match="increase tiling.overlap by 1") as got:
        Evaluator(load_config(raw), "cpu")
    assert str(got.value) == str(want.value)


def test_trainer_tile_check_matches_jax(synth_32x64, tmp_path):
    """Trainer.fit on 17 x 34 tiles: both packages refuse before the first
    step with the same hint (tests/test_training.py::
    test_trainer_tiling_divisibility_error)."""
    raw = tiled_raw(synth_32x64, 2, 1)
    with pytest.raises(ValueError) as want:
        JaxTrainer(jax_load_config(raw), checkpoint_dir=str(tmp_path / "ck")).fit(
            max_epochs=1, max_steps_per_epoch=1)
    with pytest.raises(ValueError, match="increase tiling.overlap by 1") as got:
        Trainer(load_config(raw), "cpu").fit(max_epochs=1, max_steps_per_epoch=1)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_evaluate_cli_serves_tiles_in_bf16(synth_32x64, tmp_path, monkeypatch, capsys, quant):
    monkeypatch.chdir(tmp_path)  # the CLI searches checkpoints/climate under it
    path = tmp_path / "tiled.yaml"
    path.write_text(yaml.safe_dump(tiled_raw(synth_32x64, 4, 2, data_type="bfloat16")))
    main([str(path), "--max-batches", "2", "--quant", quant, "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert len(out) == 12 and all(np.isfinite(v) for v in out.values())


def test_evaluate_cli_w8a8_metrics_close_to_fp(synth_32x64, tmp_path, monkeypatch, capsys):
    """`--quant w8a8` serves the same weights through the int8 trunk: the
    metrics stay finite and every rmse within 5% of the fp one (the
    counterpart of tests/test_drivers.py::test_evaluate_driver_w8a8_quantized_serving)."""
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "tiled.yaml"
    path.write_text(yaml.safe_dump(tiled_raw(synth_32x64, 2, 2)))
    runs = {}
    for quant in ("none", "w8a8"):
        main([str(path), "--max-batches", "2", "--quant", quant, "--device", "cpu"])
        runs[quant] = json.loads(capsys.readouterr().out)
    fp, q8 = runs["none"], runs["w8a8"]
    assert set(q8) == set(fp) and all(np.isfinite(v) for v in q8.values())
    rmse = [k for k in fp if "rmse" in k]
    assert rmse
    for k in rmse:
        assert abs(q8[k] - fp[k]) <= 0.05 * abs(fp[k]) + 1e-3, (k, fp[k], q8[k])
