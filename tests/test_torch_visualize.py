"""Stitched full-field inference, the visualize CLI, inference dumps, image
metrics and MC dropout of the port, against the JAX package where the two
can be held together: `stitched_inference` bit for bit with one numpy
forward, the CLI's stitched field against examples/visualize.py on the same
weights at fp32 (atol 1e-5, rtol 1e-4; PSNR/SSIM rtol 1e-4), psnr / ssim /
rank_histogram on the same arrays, `test_on_many_images` file for file.
The port's dropout bits differ from JAX's by design, so MC dropout is held to
its own properties (the counterparts of tests/test_utils.py's)."""

import copy
import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from orbit2_tpu.data.itermodule import IterDataModule as JaxIterDataModule
from orbit2_tpu.transforms.transforms import Denormalize as JaxDenormalize
# modules, not their test_on_many_images: pytest would collect that as a test
from orbit2_tpu.utils import image_metrics as jim
from orbit2_tpu.utils import inference as jax_inference
from orbit2_tpu.utils import visualize as jvis
from orbit2_tpu_torch import visualize as vis_cli
from orbit2_tpu_torch.config import load_config
from orbit2_tpu_torch.data.itermodule import IterDataModule
from orbit2_tpu_torch.evaluate import Evaluator
from orbit2_tpu_torch.models import ResSlimViT
from orbit2_tpu_torch.ops.quant import quantize_weight
from orbit2_tpu_torch.training.checkpoint import state_dict_from_jax_params
from orbit2_tpu_torch.transforms.transforms import Denormalize
from orbit2_tpu_torch.utils import inference
from orbit2_tpu_torch.utils.image_metrics import psnr, ssim
from orbit2_tpu_torch.utils.mc_dropout import get_monte_carlo_predictions
from orbit2_tpu_torch.utils.visualize import (
    dataset_flips, rank_histogram, stitched_inference, visualize_at_index)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def halo_sensitive_forward(mag):
    """A numpy 'model' [1, C, h, w] -> [1, 2, h*mag, w*mag] whose every pixel
    depends on the whole tile (its mean), so a halo cropped or placed wrong
    changes the stitched field."""
    def forward(tile):
        t = np.asarray(tile, np.float32)
        y = np.tanh(t[:, :2]) + t.mean(axis=(1, 2, 3), keepdims=True)
        return np.repeat(np.repeat(y, mag, axis=2), mag, axis=3)
    return forward


@pytest.mark.parametrize("overlap", [0, 1, 2, 3])
@pytest.mark.parametrize("div", [1, 2, 4])
def test_stitched_inference_bit_equal_to_jax(div, overlap):
    x = np.random.default_rng(div * 10 + overlap).normal(size=(3, 32, 64)).astype(np.float32)
    fwd = halo_sensitive_forward(4)
    want = jvis.stitched_inference(fwd, x, div, overlap, 4)
    got = stitched_inference(fwd, x, div, overlap, 4)
    assert got.shape == (2, 128, 256) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_stitched_inference_identity_upsample():
    """With an exact 2x nearest-upsample 'model', stitching reproduces the
    upsampled field regardless of tiling."""
    x = np.random.default_rng(0).normal(size=(2, 16, 32)).astype(np.float32)

    def fake_forward(tile):  # [1, C, h, w] -> [1, C, 2h, 2w]
        return np.repeat(np.repeat(tile, 2, axis=2), 2, axis=3)

    full = fake_forward(x[None])[0]
    np.testing.assert_allclose(stitched_inference(fake_forward, x, div=2, overlap=2, mag=2), full)


def _load_jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tiled_cfg(synth_dataset, tmp_path):
    """tests/test_drivers.py's tiled inference config on one device, written
    to a yaml file."""
    ds = synth_dataset
    raw = {
        "trainer": {"max_epochs": 1, "batch_size": 2, "buffer_size": 4, "num_workers": 0,
                    "data_type": "float32", "train_loss": "bayesian_tv", "remat": False},
        "parallelism": {"fsdp": 1},
        "tiling": {"do_tiling": True, "div": 2, "overlap": 2},
        "model": {"preset": "res_slimvit", "lr": 1e-3, "warmup_epochs": 1,
                  "superres_mag": 4, "patch_size": 2, "embed_dim": 32, "depth": 1,
                  "decoder_depth": 1, "num_heads": 2, "drop_path": 0.0, "drop_rate": 0.0,
                  "attention_impl": "auto"},
        "data": {
            "low_res_dir": {"S": ds["low"]},
            "high_res_dir": {"S": ds["high"]},
            "spatial_resolution": {"S": 625},
            "default_vars": list(ds["in_vars"]),
            "dict_in_variables": {"S": list(ds["in_vars"])},
            "dict_out_variables": {"S": list(ds["out_vars"])},
            "var_weights": {},
        },
    }
    path = tmp_path / "vis.yaml"
    path.write_text(yaml.safe_dump(raw))
    return raw, path


def _jax_driver_weights(raw, path):
    """The params examples/visualize.py draws for `raw` (the JAX Trainer's
    init from trainer.seed on the tiled module), saved as a reference-layout
    npz for --torch-npz."""
    from orbit2_tpu.config import load_config as jax_load_config
    from orbit2_tpu.training.trainer import Trainer

    trainer = Trainer(jax_load_config(raw))
    dm = trainer._make_data_module("S")
    dm.setup()
    trainer._build_model(dm, "S")
    params = trainer._init_params(trainer._phase_model(dm, "S"), dm)
    sd = state_dict_from_jax_params(jax.tree.map(np.asarray, params), patch_size=2)
    np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    return str(path)


def test_visualize_cli_matches_jax_driver(tiled_cfg, tmp_path, monkeypatch):
    """The port's CLI stitches the FULL field ([3, 64, 128] from the untiled
    [7, 16, 32] sample, not one 10 x 20 halo tile) and agrees with
    examples/visualize.py on the same weights."""
    raw, cfg_path = tiled_cfg
    monkeypatch.chdir(tmp_path)
    npz = _jax_driver_weights(raw, tmp_path / "w.npz")
    monkeypatch.setattr(sys, "argv", ["visualize.py", str(cfg_path), "--index", "1",
                                      "--out-dir", str(tmp_path / "viz_jax")])
    want = _load_jax_example("visualize").main()
    got = vis_cli.main([str(cfg_path), "--torch-npz", npz, "--index", "1",
                        "--out-dir", str(tmp_path / "viz"), "--device", "cpu"])

    assert got["inputs"].shape == (7, 16, 32)
    assert got["preds"].shape == got["groundtruth"].shape == (3, 64, 128)
    np.testing.assert_array_equal(got["inputs"], want["inputs"])
    np.testing.assert_allclose(got["groundtruth"], want["groundtruth"], rtol=1e-6)
    np.testing.assert_allclose(got["preds"], np.asarray(want["preds"]), atol=1e-5, rtol=1e-4)
    for var, m in want["metrics"].items():
        for name in ("psnr", "ssim"):
            np.testing.assert_allclose(got["metrics"][var][name], m[name], rtol=1e-4,
                                       err_msg=f"{var} {name}")
    dumped = np.load(tmp_path / "viz" / "pred_total_precipitation_24hr_1.npy")
    assert dumped.shape == (64, 128)


def test_visualize_cli_w8a8_stitches_close_to_fp(tiled_cfg, tmp_path):
    _, cfg_path = tiled_cfg
    common = [str(cfg_path), "--index", "1", "--device", "cpu"]
    fp = vis_cli.main(common + ["--out-dir", str(tmp_path / "fp")])
    q8 = vis_cli.main(common + ["--out-dir", str(tmp_path / "q8"), "--quant", "w8a8"])
    a, b = fp["preds"], q8["preds"]
    assert a.shape == b.shape == (3, 64, 128)
    rel = float(np.sqrt(np.mean((a - b) ** 2)) / (np.std(a) + 1e-9))
    assert rel < 0.05, rel
    assert not np.allclose(a, b)  # int8 actually ran


def test_quant_eval_does_not_poison_fp_state(tiled_cfg):
    raw, _ = tiled_cfg
    ev = Evaluator(load_config(raw), "cpu")
    fp1 = ev.test(max_batches=1)
    q8 = ev.test(max_batches=1, quant="w8a8")
    assert all(np.isfinite(v) for v in q8.values())
    assert all(t.is_floating_point() for t in ev.model.state_dict().values())
    assert ev.serving_model("w8a8") is ev.serving_model("w8a8")  # built once
    assert ev.test(max_batches=1) == fp1
    assert ev.test(max_batches=1, quant="w8a8") == q8


def test_bf16_evaluator_quantizes_from_the_fp32_weights(tiled_cfg):
    """A bf16 Evaluator serves its parameters in bf16, yet its w8a8 twin
    takes the fp32 weights it was given: the int8 weights and scales equal
    quantize_weight of the fp32 tensors (those of their bf16 cast differ),
    and the bias is the fp32 one."""
    raw, _ = tiled_cfg
    fp32 = Evaluator(load_config(copy.deepcopy(raw)), "cpu").model.state_dict()
    raw = copy.deepcopy(raw)
    raw["trainer"]["data_type"] = "bfloat16"
    ev = Evaluator(load_config(raw), "cpu", state_dict=fp32)
    assert all(p.dtype == torch.bfloat16 for p in ev.model.parameters())
    sd = ev.serving_model("w8a8").state_dict()
    paths = [k[:-len(".weight_q")] for k in sd if k.endswith(".weight_q")]
    assert len(paths) == 4  # depth 1: qkv, proj, fc1, fc2
    for path in paths:
        wq, scale = quantize_weight(fp32[f"{path}.weight"])
        assert torch.equal(sd[f"{path}.weight_q"], wq), path
        assert torch.equal(sd[f"{path}.weight_scale"], scale), path
        cast = quantize_weight(fp32[f"{path}.weight"].bfloat16())[1]
        assert not torch.equal(cast, scale), path
        assert sd[f"{path}.bias"].dtype == torch.float32
        assert torch.equal(sd[f"{path}.bias"], fp32[f"{path}.bias"]), path


def _untiled(module_cls, ds):
    dm = module_cls("downscaling", ds["low"], ds["high"], list(ds["in_vars"]),
                    out_vars=list(ds["out_vars"]), batch_size=2, buffer_size=4, num_workers=0,
                    div=1, overlap=0)
    dm.setup()
    return dm


def _upsample3(x):
    return np.repeat(np.repeat(np.asarray(x), 4, axis=2), 4, axis=3)[:, :3]


def test_visualize_untiled_module_matches_direct_forward(synth_dataset):
    """With an untiled module and a geometry-agnostic forward, the stitched
    prediction is exactly the forward applied to the full sample."""
    res = visualize_at_index(_upsample3, _untiled(IterDataModule, synth_dataset), index=0,
                             div=2, overlap=2, mag=4)
    full = _upsample3(res["inputs"][None])[0]
    np.testing.assert_allclose(stitched_inference(_upsample3, res["inputs"], 2, 2, 4), full,
                               rtol=1e-6)
    assert res["preds"].shape == full.shape


def test_visualize_dataset_derived_flip(synth_dataset):
    """Ascending-latitude storage (the synthetic set) flips north-up by
    default; flip=False keeps storage order; pred and truth stay aligned."""
    dm = _untiled(IterDataModule, synth_dataset)
    assert dataset_flips(dm)
    auto = visualize_at_index(_upsample3, dm, index=0, div=1, overlap=0, mag=4)
    raw = visualize_at_index(_upsample3, dm, index=0, div=1, overlap=0, mag=4, flip=False)
    np.testing.assert_allclose(auto["preds"], raw["preds"][:, ::-1])
    np.testing.assert_allclose(auto["groundtruth"], raw["groundtruth"][:, ::-1])

    class DescendingLat:
        def get_lat_lon(self):
            return np.linspace(88, -88, 16), np.linspace(0, 358, 32)

    assert not dataset_flips(DescendingLat())


def test_psnr_identity_and_noise():
    rng = np.random.default_rng(0)
    img = rng.normal(size=(32, 32))
    assert psnr(img, img) == float("inf")
    assert psnr(img + 0.1 * rng.normal(size=img.shape), img) > psnr(
        img + rng.normal(size=img.shape), img)


def test_ssim_bounds():
    rng = np.random.default_rng(1)
    img = rng.normal(size=(32, 32))
    assert ssim(img, img) == pytest.approx(1.0, abs=1e-6)
    assert ssim(rng.normal(size=(32, 32)), img) < 0.3


def test_rank_histogram_uniform_for_calibrated():
    rng = np.random.default_rng(0)
    counts = rank_histogram(rng.normal(size=(9, 1000)), rng.normal(size=(1000,)))
    assert counts.sum() == 1000 and counts.shape == (10,)
    assert counts.max() < 3 * counts.min() + 30


@pytest.mark.parametrize("name", ["psnr", "ssim", "rank_histogram"])
def test_image_metrics_equal_jax(name):
    rng = np.random.default_rng(4)
    truth = rng.normal(280, 10, size=(64, 128))
    pred = truth + rng.normal(size=truth.shape)
    if name == "rank_histogram":
        ens = truth[None] + rng.normal(size=(7,) + truth.shape)
        np.testing.assert_array_equal(rank_histogram(ens, truth),
                                      jvis.rank_histogram(ens, truth))
    else:
        fn = {"psnr": (psnr, jim.psnr), "ssim": (ssim, jim.ssim)}[name]
        assert fn[0](pred, truth) == fn[1](pred, truth)


@pytest.mark.parametrize("denormalize", [False, True], ids=["raw", "denormalized"])
def test_on_many_images_writes_what_jax_writes(synth_dataset, tmp_path, denormalize):
    dm, jdm = _untiled(IterDataModule, synth_dataset), _untiled(JaxIterDataModule, synth_dataset)
    n = inference.test_on_many_images(_upsample3, dm, str(tmp_path / "port"), max_batches=2,
                            denormalize=Denormalize(dm) if denormalize else None)
    jn = jax_inference.test_on_many_images(_upsample3, jdm, str(tmp_path / "jax"), max_batches=2,
                                 denormalize=JaxDenormalize(jdm) if denormalize else None)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert n == jn == 2 and sorted(os.listdir(tmp_path / "port")) == files and len(files) == 6
    for f in files:
        np.testing.assert_allclose(np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f),
                                   rtol=1e-6, err_msg=f)


# ---------------------------------------------------------------- MC dropout

MC_VARS = ("land_sea_mask", "orography", "lattitude", "landcover",
           "total_precipitation_24hr", "2m_temperature_min", "2m_temperature_max")
MC_OUT = MC_VARS[4:]


def _mc_model(drop_rate, drop_path):
    # depth 2, so the linspace drop-path schedule has a non-zero tail rate
    return ResSlimViT(MC_VARS, (8, 16), 7, 3, superres_mag=2, patch_size=2, embed_dim=32,
                      depth=2, decoder_depth=1, num_heads=2, learn_pos_emb=True,
                      drop_rate=drop_rate, drop_path=drop_path,
                      generator=torch.Generator().manual_seed(0)).eval()


def _mc_input():
    return torch.from_numpy(np.random.default_rng(0).normal(size=(2, 7, 8, 16))
                            .astype(np.float32))


def test_mc_dropout_shape_and_mode():
    model, x = _mc_model(0.1, 0.0), _mc_input()
    ens = get_monte_carlo_predictions(model, x, MC_VARS, MC_OUT, n_samples=3)
    assert ens.shape == (3, 2, 3, 16, 32)
    assert not model.training  # the caller's mode is restored


def test_mc_dropout_rate_zero_is_the_deterministic_forward():
    model, x = _mc_model(0.0, 0.0), _mc_input()
    with torch.no_grad():
        want = model(x, MC_VARS, MC_OUT)
    ens = get_monte_carlo_predictions(model, x, MC_VARS, MC_OUT, n_samples=3)
    for member in ens:
        assert torch.equal(member, want)


def test_mc_dropout_droppath_inert_dropout_varies():
    """Reference enable_dropout flips ONLY Dropout to train mode; stochastic
    depth stays off. drop_path 0.9 without dropout: identical members;
    drop_rate 0.5: members differ."""
    x = _mc_input()
    ens = get_monte_carlo_predictions(_mc_model(0.0, 0.9), x, MC_VARS, MC_OUT, n_samples=4)
    assert torch.equal(ens[0], ens[1]) and torch.equal(ens[0], ens[3])
    ens2 = get_monte_carlo_predictions(_mc_model(0.5, 0.0), x, MC_VARS, MC_OUT, n_samples=4)
    assert (ens2[0] - ens2[1]).abs().max().item() > 1e-6


def test_mc_dropout_is_seeded_by_its_generator():
    model, x = _mc_model(0.1, 0.1), _mc_input()
    run = lambda seed: get_monte_carlo_predictions(model, x, MC_VARS, MC_OUT, n_samples=2,
                                                   generator=torch.Generator().manual_seed(seed))
    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
