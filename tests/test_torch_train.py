"""The training slice of the PyTorch port against the JAX package.

A tiny ResSlimViT (embed 64, depth 2, 2 heads, fp32, dropout and drop-path
0: the JAX side's dropout bits come from jax.random and cannot match) on the
same weights, carried across with `state_dict_from_jax_params`, which maps
JAX gradients onto the port's parameter names the same way:
  * one train step's loss and gradients: atol 1e-5, rtol 1e-4;
  * a 5-step loss trajectory: rtol 2e-4, atol 1e-6, the bar of
    tests/test_reference_model_parity.py:307;
  * Trainer.fit's per-epoch losses on tests/conftest.py's synthetic dataset:
    rtol 2e-4, and the same lr records.
The sums run in different orders on the two sides, so fp32 rounding is the
whole of the difference.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from orbit2_tpu.config import load_config as jax_load_config
from orbit2_tpu.models import ResSlimViT as JaxResSlimViT
from orbit2_tpu.registry import METRICS_REGISTRY as JAX_METRICS
from orbit2_tpu.training.optim import make_optimizer as jax_make_optimizer
from orbit2_tpu.training.train import clip_replace_constant as jax_clip
from orbit2_tpu.training.train import make_train_step as jax_make_train_step
from orbit2_tpu.training.trainer import Trainer as JaxTrainer
from orbit2_tpu_torch.config import load_config
from orbit2_tpu_torch.data.reader import tile_shapes
from orbit2_tpu_torch.evaluate import make_data_module, model_kwargs
from orbit2_tpu_torch.metrics.metrics import METRICS_REGISTRY
from orbit2_tpu_torch.models import ResSlimViT
from orbit2_tpu_torch.train import main
from orbit2_tpu_torch.training.checkpoint import state_dict_from_jax_params
from orbit2_tpu_torch.training.optim import make_optimizer
from orbit2_tpu_torch.training.train import make_train_step
from orbit2_tpu_torch.training.trainer import Trainer
from orbit2_tpu_torch.utils.loaders import load_architecture

DEFAULT_VARS = (
    "land_sea_mask", "orography", "lattitude", "landcover",
    "total_precipitation_24hr", "2m_temperature_min", "2m_temperature_max",
)
OUT_VARS = DEFAULT_VARS[4:]
VAR_WEIGHTS = {"2m_temperature_min": 10, "2m_temperature_max": 10, "total_precipitation_24hr": 1}
HP = {"lr": 2e-3, "weight_decay": 1e-5, "betas": (0.9, 0.99)}
TINY = dict(img_size=(8, 16), in_channels=7, out_channels=3, superres_mag=4, patch_size=2,
            embed_dim=64, depth=2, decoder_depth=1, num_heads=2, learn_pos_emb=True,
            spatial_resolution=625.0)


def jax_params(seed=0):
    jm = JaxResSlimViT(default_vars=DEFAULT_VARS, attention_impl="xla", drop_rate=0.0,
                       drop_path=0.0, **TINY)
    x = jnp.zeros((2, 7, 8, 16), jnp.float32)
    params = jax.jit(lambda k: jm.init({"params": k}, x, DEFAULT_VARS, OUT_VARS))(
        jax.random.PRNGKey(seed))["params"]
    rng = np.random.default_rng(seed)
    # noise so the zero-initialised var_query/var_embed and unit LN scales hide no path
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32), params)
    return jm, params


def torch_model(params, drop=0.0, attention_impl="auto"):
    tm = ResSlimViT(DEFAULT_VARS, attention_impl=attention_impl, drop_rate=drop, drop_path=drop,
                    **TINY)
    tm.load_state_dict(state_dict_from_jax_params(params, patch_size=2), strict=True)
    return tm


def batches(n, batch=4, seed=1):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        x = rng.normal(size=(batch, 7, 8, 16)).astype(np.float32)
        y = (rng.normal(size=(batch, 3, 32, 64)) * 0.5).astype(np.float32)
        yield x, y


def torch_step(tm, grad_accum=1):
    loss = METRICS_REGISTRY["bayesian_tv"](aggregate_only=True)
    opt = make_optimizer("adamw", HP, tm.named_parameters())
    return make_train_step(tm, loss, VAR_WEIGHTS, opt, DEFAULT_VARS, OUT_VARS, grad_accum)


def test_one_step_loss_and_gradients_match_jax():
    jm, params = jax_params()
    x, y = next(batches(1))
    jloss = JAX_METRICS["bayesian_tv"](aggregate_only=True)

    def loss_fn(p):  # make_train_step's loss (orbit2_tpu/training/train.py:94-128)
        yhat = jm.apply({"params": p}, jnp.asarray(x), DEFAULT_VARS, OUT_VARS,
                        deterministic=False, rngs={"dropout": jax.random.PRNGKey(0),
                                                   "drop_path": jax.random.PRNGKey(1)})
        yhat = jax_clip(jnp.asarray(y), yhat.astype(jnp.float32), OUT_VARS)
        return jloss(yhat, jnp.asarray(y), var_names=list(OUT_VARS), var_weights=VAR_WEIGHTS)

    jp = jax.tree.map(jnp.asarray, params)
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    tx = jax_make_optimizer("adamw", HP)
    jstep = jax_make_train_step(jm, jloss, VAR_WEIGHTS, tx, DEFAULT_VARS, OUT_VARS)
    new_params, _, step_loss = jstep(jp, tx.init(jp), jnp.asarray(x), jnp.asarray(y),
                                     jax.random.PRNGKey(2))
    np.testing.assert_allclose(float(step_loss), float(want_loss), rtol=1e-6)

    tm = torch_model(params)
    loss = torch_step(tm)(torch.from_numpy(x), torch.from_numpy(y), torch.Generator(), None)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5, rtol=1e-4)
    want_g = state_dict_from_jax_params(jax.tree.map(np.asarray, want_grads), patch_size=2)
    got_g = {k: p.grad for k, p in tm.named_parameters()}
    assert set(got_g) == set(want_g)
    for k in want_g:
        np.testing.assert_allclose(got_g[k].numpy(), want_g[k].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=k)
    # and the update that follows
    want_p = state_dict_from_jax_params(jax.tree.map(np.asarray, new_params), patch_size=2)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[k].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_five_step_loss_trajectory_matches_jax():
    jm, params = jax_params(seed=3)
    jloss = JAX_METRICS["bayesian_tv"](aggregate_only=True)
    tx = jax_make_optimizer("adamw", HP)
    jstep = jax_make_train_step(jm, jloss, VAR_WEIGHTS, tx, DEFAULT_VARS, OUT_VARS)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tm = torch_model(params)
    step = torch_step(tm)
    losses_j, losses_t = [], []
    for i, (x, y) in enumerate(batches(5, seed=4)):
        jp, state, loss = jstep(jp, state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(i))
        losses_j.append(float(loss))
        losses_t.append(step(torch.from_numpy(x), torch.from_numpy(y), torch.Generator(),
                             None).item())
    assert losses_t[-1] < losses_t[0]
    np.testing.assert_allclose(losses_j, losses_t, rtol=2e-4, atol=1e-6)


def test_grad_accum_two_equals_one():
    _, params = jax_params(seed=5)
    x, y = (torch.from_numpy(a) for a in next(batches(1, seed=6)))
    grads, losses = [], []
    for accum in (1, 2):
        tm = torch_model(params)
        losses.append(torch_step(tm, accum)(x, y, torch.Generator(), None).item())
        grads.append({k: p.grad for k, p in tm.named_parameters()})
    assert losses[0] == pytest.approx(losses[1], abs=1e-5)
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], atol=1e-5, rtol=1e-5, msg=k)


def test_dropout_step_is_deterministic_in_its_generators():
    _, params = jax_params(seed=7)
    x, y = (torch.from_numpy(a) for a in next(batches(1, seed=8)))

    def run(drop, seed):
        tm = torch_model(params, drop=drop)
        loss = torch_step(tm)(x, y, torch.Generator().manual_seed(seed),
                              torch.Generator().manual_seed(seed + 1))
        return loss.item(), tm.state_dict()

    a, b, c, plain = run(0.1, 0), run(0.1, 0), run(0.1, 10), run(0.0, 0)
    assert a[0] == b[0] and all(torch.equal(a[1][k], b[1][k]) for k in a[1])
    assert a[0] != c[0]
    assert a[0] != plain[0]


def tiny_raw(ds):
    """tests/test_torch_evaluate.py's one-device config at embed 64, depth 2."""
    return {
        "trainer": {"max_epochs": 2, "batch_size": 4, "buffer_size": 8, "num_workers": 0,
                    "data_type": "float32", "train_loss": "bayesian_tv", "remat": False,
                    "interval_epochs": 1},
        "parallelism": {"fsdp": 1, "simple_ddp": 1, "tensor_par": 1},
        "tiling": {"do_tiling": False},
        "model": {"preset": "res_slimvit", "lr": 1e-3, "warmup_epochs": 1, "superres_mag": 4,
                  "patch_size": 2, "embed_dim": 64, "depth": 2, "decoder_depth": 1,
                  "num_heads": 2, "drop_path": 0.0, "drop_rate": 0.0, "attention_impl": "auto"},
        "data": {
            "low_res_dir": {"SYNTH": ds["low"]}, "high_res_dir": {"SYNTH": ds["high"]},
            "spatial_resolution": {"SYNTH": 625}, "default_vars": list(ds["in_vars"]),
            "dict_in_variables": {"SYNTH": list(ds["in_vars"])},
            "dict_out_variables": {"SYNTH": list(ds["out_vars"])},
            "var_weights": VAR_WEIGHTS,
        },
    }


def test_trainer_fit_matches_jax_trainer(synth_dataset, tmp_path):
    raw = tiny_raw(synth_dataset)
    jt = JaxTrainer(jax_load_config(raw), checkpoint_dir=str(tmp_path / "ck"))
    jt.test(max_batches=0)  # builds the model and draws the initial parameters
    init = state_dict_from_jax_params(jax.tree.map(np.asarray, jt.params), patch_size=2)
    want = jt.fit(max_epochs=2, max_steps_per_epoch=3)

    got = Trainer(load_config(raw), "cpu", state_dict=init).fit(max_epochs=2,
                                                                 max_steps_per_epoch=3)
    assert [r["epoch"] for r in got] == [0, 1] and [r["batches"] for r in got] == [3, 3]
    assert [r["lr"] for r in got] == [r["lr"] for r in want]
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want], rtol=2e-4)
    for r in got:
        assert set(r) == {"epoch", "data_key", "loss", "batches", "seconds", "lr",
                          "data_wait_s", "fence_wait_s", "h2d_bytes"}
        assert r["h2d_bytes"] == 3 * 4 * (7 * 16 * 32 + 3 * 64 * 128) * 4


def fit_both(raw, tmp_path, max_epochs=2, max_steps=3):
    """(port Trainer.fit, JAX Trainer.fit) of `raw` from the JAX Trainer's
    initial parameters."""
    jt = JaxTrainer(jax_load_config(raw), checkpoint_dir=str(tmp_path / "ck"))
    jt.test(max_batches=0)  # builds the model and draws the initial parameters
    init = state_dict_from_jax_params(jax.tree.map(np.asarray, jt.params), patch_size=2)
    want = jt.fit(max_epochs=max_epochs, max_steps_per_epoch=max_steps)
    trainer = Trainer(load_config(raw), "cpu", state_dict=init)
    return trainer, trainer.fit(max_epochs=max_epochs, max_steps_per_epoch=max_steps), want


def test_tiled_trainer_fit_with_remat_matches_jax_trainer(synth_dataset, tmp_path):
    """Training on div 2 / overlap 2 TILES tiles with per-Block remat, the
    counterpart of tests/test_training.py::test_trainer_with_tiling, against
    JAX Trainer.fit on the same config: the same tile batches, per-epoch
    losses within rtol 2e-4. Whole epochs: where an epoch stops early, how
    far the loader's thread read ahead (and so the next epoch's shuffle)
    depends on timing, in both packages."""
    raw = tiny_raw(synth_dataset)
    raw["tiling"] = {"do_tiling": True, "div": 2, "overlap": 2}
    raw["trainer"]["remat"] = True
    trainer, got, want = fit_both(raw, tmp_path, max_steps=None)
    assert trainer.model.remat and trainer.model.remat_policy == "full"
    (h, w), (oh, ow) = tile_shapes(2, 2, 16, 32, 64, 128)
    in_shape, out_shape = trainer._data_modules["SYNTH"].get_data_dims()
    assert tuple(in_shape[2:]) == (h, w) and tuple(out_shape[2:]) == (oh, ow)
    # 16 fields of 4 tiles, 4 tiles a batch
    assert [r["batches"] for r in got] == [16, 16] and all(np.isfinite(r["loss"]) for r in got)
    assert [r["lr"] for r in got] == [r["lr"] for r in want]
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want], rtol=2e-4)
    for r in got:
        assert r["h2d_bytes"] == 16 * 4 * (7 * h * w + 3 * oh * ow) * 4


def test_trainer_fit_with_unfed_default_vars_matches_jax_trainer(synth_dataset, tmp_path):
    """default_vars beyond the phase's in-variables (as in interm_1b.yaml:
    23 defaults, 7 PRISM inputs): their token embeddings get no gradient.
    optax treats it as zero (weight decay still moves them); so does the
    port's AdamW, which used to refuse the step."""
    raw = tiny_raw(synth_dataset)
    raw["data"]["default_vars"] = list(synth_dataset["in_vars"]) + ["10m_u_component_of_wind"]
    raw["model"]["weight_decay"] = 0.5  # a decay the unfed weights show in fp32
    trainer, got, want = fit_both(raw, tmp_path, max_steps=2)
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want], rtol=2e-4)
    unfed = trainer.model.token_embeds[7].proj.weight
    assert unfed.grad is None
    init = trainer.state_dict["token_embeds.7.proj.weight"]
    assert not torch.equal(unfed.detach(), init)


def test_trainer_builds_from_a_state_dict_without_drawing(synth_dataset, monkeypatch):
    """Given a state dict (here bf16, as a serving model holds it), the
    Trainer builds its model on the meta device, draws no initial weights
    (the 1B config's take seconds to draw on the host), and trains fp32
    masters filled from it."""
    raw = tiny_raw(synth_dataset)
    cfg = load_config(raw)
    dm = make_data_module(cfg, "SYNTH", 1, 0)
    state = {k: v.bfloat16() for k, v in load_architecture(
        dm, "res_slimvit", **model_kwargs(cfg)).state_dict().items()}
    drawn_on = []
    reset = ResSlimViT.reset_parameters
    monkeypatch.setattr(ResSlimViT, "reset_parameters", lambda self, generator=None: (
        drawn_on.append(self.var_embed.device.type), reset(self, generator))[1])
    trainer = Trainer(cfg, "cpu", state_dict=state)
    trainer.fit(max_epochs=1, max_steps_per_epoch=1)
    assert drawn_on == ["meta"]
    assert all(p.dtype == torch.float32 and p.device.type == "cpu"
               for p in trainer.model.parameters())


def test_train_cli_runs_on_cpu(synth_dataset, tmp_path, capsys):
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(tiny_raw(synth_dataset)))
    main([str(path), "--device", "cpu", "--max-epochs", "1", "--max-steps-per-epoch", "2",
          "--checkpoint-dir", str(tmp_path / "ck")])
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(records) == 1 and records[0]["batches"] == 2
    assert np.isfinite(records[0]["loss"])


@pytest.mark.parametrize("override,section,kwargs", [
    ({"fsdp": 2}, "parallelism", {}),
    ({"pipeline": 2}, "parallelism", {}),
], ids=["mesh", "pipeline"])
def test_trainer_rejects_what_is_not_ported(synth_dataset, override, section, kwargs):
    """At world 1 a mesh of 2 devices (an fsdp or a pipeline axis of 2) is
    larger than the world: JAX make_mesh's ValueError, before any refusal of
    what is not ported (tests/test_torch_mesh.py holds those)."""
    raw = tiny_raw(synth_dataset)
    raw[section].update(override)
    with pytest.raises(ValueError, match="> 1 devices"):
        Trainer(load_config(raw), "cpu", **kwargs).fit(max_epochs=1, max_steps_per_epoch=1)


def resume_both(raw, tmp_path, first, total, max_steps=None):
    """JAX Trainer.fit to `first` epochs with a checkpoint_dir, then a fresh
    JAX Trainer on the same directory to `total` (it resumes at `first`);
    the port the same, from the JAX Trainer's initial parameters. Returns
    (port records, JAX records) of the resumed fits."""
    jt = JaxTrainer(jax_load_config(raw), checkpoint_dir=str(tmp_path / "jax"))
    jt.test(max_batches=0)  # builds the model and draws the initial parameters
    init = state_dict_from_jax_params(jax.tree.map(np.asarray, jt.params), patch_size=2)
    jt.fit(max_epochs=first, max_steps_per_epoch=max_steps)
    want = JaxTrainer(jax_load_config(raw), checkpoint_dir=str(tmp_path / "jax")).fit(
        max_epochs=total, max_steps_per_epoch=max_steps)

    ck_dir = str(tmp_path / "port")
    Trainer(load_config(raw), "cpu", state_dict=init, checkpoint_dir=ck_dir).fit(
        max_epochs=first, max_steps_per_epoch=max_steps)
    got = Trainer(load_config(raw), "cpu", checkpoint_dir=ck_dir).fit(
        max_epochs=total, max_steps_per_epoch=max_steps)
    return got, want


@pytest.mark.parametrize("tiled", [False, True], ids=["plain", "tiled-remat"])
def test_resumed_fit_matches_jax_resumed_fit(synth_dataset, tmp_path, tiled):
    """A fit that resumes from the newest checkpoint of its directory goes on
    at the next epoch with the saved parameters, moments, count and epoch:
    its epochs, lr and losses are the JAX Trainer's resumed fit's (losses
    within rtol 2e-4). Both draw dropout afresh at a resume (0 here) and
    start the loader's shuffle afresh, so each holds the other's resumed
    run, not an uninterrupted one. Whole epochs (see the tiled fit test)."""
    raw = tiny_raw(synth_dataset)
    first, total = (2, 4)
    if tiled:
        raw["tiling"] = {"do_tiling": True, "div": 2, "overlap": 2}
        raw["trainer"]["remat"] = True
        first, total = (1, 2)
    got, want = resume_both(raw, tmp_path, first, total)
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == list(range(first, total))
    assert [r["lr"] for r in got] == [r["lr"] for r in want]
    assert all(r["batches"] == (16 if tiled else 4) for r in got)
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want], rtol=2e-4)
    assert sorted(os.listdir(tmp_path / "port")) == [f"epoch_{e}" for e in range(total)]


def test_validation_matches_jax_validation(synth_dataset, tmp_path):
    """run_validation after each epoch: the val losses' sample-weighted means
    within rtol 1e-4 of JAX Trainer.validate's, over the same samples. At
    batch 3 the 16 val samples end in a partial batch of 1, which JAX pads
    and slices and the port takes as it is."""
    raw = tiny_raw(synth_dataset)
    raw["trainer"]["batch_size"] = 3
    jt = JaxTrainer(jax_load_config(raw), checkpoint_dir=str(tmp_path / "jax"),
                    run_validation=True)
    jt.test(max_batches=0)
    init = state_dict_from_jax_params(jax.tree.map(np.asarray, jt.params), patch_size=2)
    jt.fit(max_epochs=1, max_steps_per_epoch=2)
    trainer = Trainer(load_config(raw), "cpu", state_dict=init, run_validation=True)
    trainer.fit(max_epochs=1, max_steps_per_epoch=2)
    want, got = jt.last_validation, trainer.last_validation
    assert got["samples"] == want["samples"] == 16
    assert list(got["means"]) == list(want["means"]) and len(got["means"]) == 16
    for k, v in want["means"].items():
        np.testing.assert_allclose(got["means"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    # no history key of its own: JAX's record has none for validation
    assert set(trainer.history[0]) == {k for k in jt.history[0] if not k.startswith("hbm_")}


def test_trainer_saves_and_prunes_like_jax(synth_dataset, tmp_path):
    """keep_last_checkpoints 1 leaves the newest epoch, async or not, as the
    JAX Trainer's prune does; no checkpoint_dir writes nothing."""
    raw = tiny_raw(synth_dataset)
    for async_save in (False, True):
        d = tmp_path / f"async{async_save}"
        Trainer(load_config(raw), "cpu", checkpoint_dir=str(d), keep_last_checkpoints=1,
                async_checkpoints=async_save).fit(max_epochs=3, max_steps_per_epoch=1)
        assert os.listdir(d) == ["epoch_2"]
    JaxTrainer(jax_load_config(raw), checkpoint_dir=str(tmp_path / "jax"),
               keep_last_checkpoints=1).fit(max_epochs=3, max_steps_per_epoch=1)
    assert os.listdir(tmp_path / "jax") == ["epoch_2"]
