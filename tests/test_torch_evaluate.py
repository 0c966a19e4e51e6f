"""The serving slice as a whole: the port's `Evaluator.test` against the JAX
`Trainer.test` on the same weights and the same synthetic test split, plus the
eval pieces it is built from (clip, denormalize, the three test metrics)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbit2_tpu.config import load_config as jax_load_config
from orbit2_tpu.metrics import functional as JF
from orbit2_tpu.training.checkpoint import export_torch_state_dict
from orbit2_tpu.training.train import clip_replace_constant as jax_clip
from orbit2_tpu.training.trainer import Trainer
from orbit2_tpu_torch.config import load_config
from orbit2_tpu_torch.evaluate import Evaluator, main
from orbit2_tpu_torch.metrics import functional as TF
from orbit2_tpu_torch.training.checkpoint import state_dict_from_jax_params
from orbit2_tpu_torch.training.train import clip_replace_constant


def tiny_raw(ds, **parallelism):
    """tests/test_training.py's tiny_config on one device."""
    return {
        "trainer": {"max_epochs": 2, "batch_size": 4, "buffer_size": 8,
                    "num_workers": 0, "data_type": "float32",
                    "train_loss": "bayesian_tv", "remat": False, "interval_epochs": 1},
        "parallelism": {"fsdp": 1, "simple_ddp": 1, "tensor_par": 1, **parallelism},
        "tiling": {"do_tiling": False},
        "model": {"preset": "res_slimvit", "lr": 1e-3, "warmup_epochs": 1,
                  "superres_mag": 4, "patch_size": 2, "embed_dim": 32,
                  "depth": 1, "decoder_depth": 1, "num_heads": 2,
                  "drop_path": 0.0, "drop_rate": 0.0, "attention_impl": "xla"},
        "data": {
            "low_res_dir": {"SYNTH": ds["low"]},
            "high_res_dir": {"SYNTH": ds["high"]},
            "spatial_resolution": {"SYNTH": 625},
            "default_vars": list(ds["in_vars"]),
            "dict_in_variables": {"SYNTH": list(ds["in_vars"])},
            "dict_out_variables": {"SYNTH": list(ds["out_vars"])},
            "var_weights": {"2m_temperature_min": 10, "2m_temperature_max": 10,
                            "total_precipitation_24hr": 1},
        },
    }


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_evaluator_matches_jax_trainer_test(synth_dataset, tmp_path, impl):
    raw = tiny_raw(synth_dataset)
    trainer = Trainer(jax_load_config(raw), checkpoint_dir=str(tmp_path / "ck"))
    want = trainer.test(max_batches=2)

    raw["model"]["attention_impl"] = impl
    sd = state_dict_from_jax_params(trainer.params, patch_size=2)
    got = Evaluator(load_config(raw), "cpu", state_dict=sd).test(max_batches=2)
    assert list(got) == list(want)
    assert len(got) == 12  # 3 metrics x (3 variables + aggregate)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4, atol=1e-6, err_msg=k)


def test_state_dict_equals_export_of_trainer_params(synth_dataset, tmp_path):
    trainer = Trainer(jax_load_config(tiny_raw(synth_dataset)),
                      checkpoint_dir=str(tmp_path / "ck"))
    trainer.test(max_batches=1)
    want = export_torch_state_dict(trainer.params, patch_size=2)
    got = state_dict_from_jax_params(trainer.params, patch_size=2)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_evaluator_cli_prints_metrics(synth_dataset, tmp_path, monkeypatch, capsys):
    import json

    import yaml

    monkeypatch.chdir(tmp_path)  # the CLI searches checkpoints/climate under it
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(tiny_raw(synth_dataset)))
    main([str(path), "--max-batches", "1", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert len(out) == 12 and all(np.isfinite(v) for v in out.values())


@pytest.mark.parametrize("overrides", [
    {"parallelism": {"fsdp": 2}},
    {"model": {"moe_experts": 2, "moe_every": 1}, "parallelism": {"expert_par": 2}},
], ids=["mesh", "expert_par"])
def test_evaluator_rejects_unported_configs(synth_dataset, overrides):
    """Without a process group a config mesh above one device raises JAX's
    ValueError, as examples/evaluate.py does on one device (its make_mesh,
    orbit2_tpu/parallel/mesh.py:53-57): the serving CLIs scale no mesh down."""
    from orbit2_tpu.parallel.mesh import mesh_from_config as jax_mesh_from_config

    raw = tiny_raw(synth_dataset)
    for section, override in overrides.items():
        raw[section].update(override)
    cfg = load_config(raw)
    with pytest.raises(ValueError) as jax_err:
        jax_mesh_from_config(cfg.parallelism, devices=jax.devices()[:1])
    with pytest.raises(ValueError) as err:
        Evaluator(cfg, "cpu")
    assert str(err.value) == str(jax_err.value)


def _pred_target(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(3, 4, 5, 6)).astype(np.float32),
            rng.normal(size=(3, 4, 5, 6)).astype(np.float32))


@pytest.mark.parametrize("name,kw", [
    ("rmse", {}), ("pearson", {}), ("mean_bias", {}), ("mse", {}), ("bayesian_tv", {}),
    ("mse", {"var_names": ["a", "b", "c", "d"], "var_weights": {"b": 10, "d": 0.5}}),
    ("bayesian_tv", {"var_names": ["a", "b", "c", "d"], "var_weights": {"b": 10, "d": 0.5}}),
], ids=["rmse", "pearson", "mean_bias", "mse", "bayesian_tv", "mse-weighted",
        "bayesian_tv-weighted"])
def test_metric_matches_jax(name, kw):
    p, t = _pred_target()
    want = np.asarray(getattr(JF, name)(jnp.asarray(p), jnp.asarray(t), **kw))
    got = getattr(TF, name)(torch.from_numpy(p), torch.from_numpy(t), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_clip_replace_constant_matches_jax():
    out_vars = ["total_precipitation_24hr", "orography", "2m_temperature_min", "lattitude"]
    yhat, y = _pred_target(1)
    want = np.asarray(jax_clip(jnp.asarray(y), jnp.asarray(yhat), out_vars))
    got = clip_replace_constant(torch.from_numpy(y), torch.from_numpy(yhat), out_vars)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("entry", ["evaluator", "trainer"])
def test_entry_points_default_to_the_card(entry):
    """Evaluator and Trainer run on the card unless the caller passes "cpu",
    as the CLIs do (--device cuda)."""
    import inspect

    from orbit2_tpu_torch.training.trainer import Trainer as TorchTrainer

    cls = {"evaluator": Evaluator, "trainer": TorchTrainer}[entry]
    assert inspect.signature(cls.__init__).parameters["device"].default == "cuda"
