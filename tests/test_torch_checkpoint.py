"""Checkpoints of the PyTorch port (training/checkpoint.py, AdamW's state
dict) against the JAX package on the same inputs.

CPU, each from the JAX package's parameters carried across with
`state_dict_from_jax_params`, the optimizers stepped on the same gradients
drawn with numpy:
  * save/restore round trips bit for bit, over fp32 and bf16 moments and
    sync and async saves (an async save is followed at once by another
    step, which must not reach the file), and the restored moments, keyed
    by name, are optax's after the same two steps (atol 1e-5 / rtol 1e-4 in
    fp32, one bf16 ulp in bf16);
  * resume across the mu and the nu dtype (tests/test_training.py:165,
    :243): an fp32-moment checkpoint restores under bf16 moments and the
    reverse, the restored moments equal JAX's Orbax restore of the same
    state (within one bf16 ulp: the two sides' fp32 moments differ in the
    last bits), and the next step gives JAX's parameters (atol 1e-5 /
    rtol 1e-4);
  * latest_checkpoint / prune_checkpoints against JAX's on the same
    directory listings;
  * load_pretrained_params against JAX's on a state from another grid:
    merged values atol 1e-5 / rtol 1e-4 (test_torch_res_slimvit.py:82-92),
    the same used / dropped / resized counts, strict=True raising;
  * the finetune CLI from a checkpoint of the train CLI and from an npz of
    another grid (tests/test_drivers.py:184-208);
  * the evaluate CLI on an npz of another grid against examples/evaluate.py
    (rtol 1e-4, atol 1e-6, the bar of test_torch_evaluate.py).

The JAX package is imported inside the tests that use it, so that the
`cuda` cases (a card-resident Trainer's round trip, an async save while the
next step runs; skipped without a card) run on a machine without it:
`python -m pytest --noconftest -m cuda tests/test_torch_checkpoint.py`.
"""

import functools
import importlib.util
import json
import logging
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml

from orbit2_tpu_torch.config import load_config
from orbit2_tpu_torch.models import ResSlimViT
from orbit2_tpu_torch.training import checkpoint as ck
from orbit2_tpu_torch.training.optim import make_optimizer
from orbit2_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_VARS = (
    "land_sea_mask", "orography", "lattitude", "landcover",
    "total_precipitation_24hr", "2m_temperature_min", "2m_temperature_max",
)
OUT_VARS = DEFAULT_VARS[4:]
HP = {"lr": 2e-3, "weight_decay": 1e-5, "betas": (0.9, 0.99)}
TINY = dict(in_channels=7, out_channels=3, superres_mag=4, patch_size=2, embed_dim=64, depth=2,
            decoder_depth=1, num_heads=2, learn_pos_emb=True, spatial_resolution=625.0)
IMG = (8, 16)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_ULP = 2.0 ** -7


@functools.lru_cache(maxsize=None)
def jax_init(img):
    """The JAX model at `img` and its jitted init (compiled once a size)."""
    import jax
    import jax.numpy as jnp

    from orbit2_tpu.models import ResSlimViT as JaxResSlimViT

    jm = JaxResSlimViT(default_vars=DEFAULT_VARS, attention_impl="xla", drop_rate=0.0,
                       drop_path=0.0, img_size=img, **TINY)
    x = jnp.zeros((2, 7) + img, jnp.float32)
    return jm, jax.jit(lambda k: jm.init({"params": k}, x, DEFAULT_VARS, OUT_VARS))


def jax_params(img=IMG, seed=0):
    import jax

    jm, init = jax_init(img)
    params = init(jax.random.PRNGKey(seed))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32), params)
    return jm, params


def torch_state(params):
    return ck.state_dict_from_jax_params(params, patch_size=2)


def gradients(params, n, seed=1):
    """n gradient trees of the JAX params' layout, drawn with numpy: the
    optimizer's state depends on nothing else."""
    rng = np.random.default_rng(seed)
    return [gradients_like(params, rng) for _ in range(n)]


def gradients_like(tree, rng):
    if isinstance(tree, dict):
        return {k: gradients_like(v, rng) for k, v in tree.items()}
    return (0.1 * rng.normal(size=np.shape(tree))).astype(np.float32)


def port_run(state_dict, hp, grads, device="cpu"):
    """The port's model from `state_dict` and its AdamW (from
    named_parameters) after one step on each of `grads` (reference
    layout), and the step."""
    tm = ResSlimViT(DEFAULT_VARS, img_size=IMG, drop_rate=0.0, drop_path=0.0, **TINY)
    tm.load_state_dict(state_dict, strict=True)
    tm.to(device)
    opt = make_optimizer("adamw", hp, tm.named_parameters())

    def step(g):
        for name, p in tm.named_parameters():
            p.grad = g[name].to(device)
        opt.step()

    for g in grads:
        step(g)
    return tm, opt, step


def jax_run(params, hp, grads):
    """optax's params and state after the same steps (JAX layout grads)."""
    import jax
    import jax.numpy as jnp
    import optax

    from orbit2_tpu.training.optim import make_optimizer as jax_make_optimizer

    tx = jax_make_optimizer("adamw", hp)
    update = jax.jit(lambda g, st, p: (lambda u, st2: (optax.apply_updates(p, u), st2))(
        *tx.update(g, st, p)))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        jp, state = update(jax.tree.map(jnp.asarray, g), state, jp)
    return tx, jp, state


def moments_of(state):
    """optax's (mu, nu) trees in the port's reference layout."""
    import jax

    adam = state.inner_state[0]
    return tuple(torch_state(jax.tree.map(lambda a: np.asarray(a.astype("float32")), t))
                 for t in (adam.mu, adam.nu))


def assert_close_by_dtype(got, want, dtype, what):
    tol = dict(atol=1e-5, rtol=1e-4) if dtype == torch.float32 else dict(atol=1e-6,
                                                                         rtol=BF16_ULP)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), err_msg=what, **tol)


def snapshot(state):
    return ck._map_tensors(state, lambda t: t.detach().cpu().clone())


def assert_equal_states(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_equal_states(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want.cpu()), where
    else:
        assert got == want, where


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_round_trip_bit_for_bit(tmp_path, moments, async_save):
    _, params = jax_params()
    hp = dict(HP, mu_dtype=moments, nu_dtype=moments)
    grads = gradients(params, 3)
    tm, opt, step = port_run(torch_state(params), hp, [torch_state(g) for g in grads[:2]])
    state = {"model": tm.state_dict(), "optimizer": opt.state_dict(), "epoch": 1}
    want = snapshot(state)
    path = str(tmp_path / "epoch_1")
    ck.save_checkpoint(path, state, async_save=async_save)
    # training goes on at once; an async save must still write the state above
    step(torch_state(grads[2]))
    ck.wait_for_async_saves()
    assert sorted(os.listdir(tmp_path)) == ["epoch_1"]
    assert os.listdir(path) == [ck.CHECKPOINT_FILE]

    got = ck.restore_checkpoint(path, template=state)
    assert_equal_states(got, want)
    assert got["optimizer"]["mu"]["var_query"].dtype == DTYPES[moments]

    fresh = make_optimizer("adamw", hp, tm.named_parameters())
    fresh.load_state_dict(got["optimizer"])
    assert_equal_states(fresh.state_dict(), want["optimizer"])

    # the moments, keyed by name, are JAX's after the same two steps
    _, _, jstate = jax_run(params, hp, grads[:2])
    for key, jax_moment in zip(("mu", "nu"), moments_of(jstate)):
        for name, t in got["optimizer"][key].items():
            assert_close_by_dtype(t, jax_moment[name], DTYPES[moments], f"{key}/{name}")


def test_save_replaces_a_checkpoint_and_leaves_no_temporaries(tmp_path):
    path = str(tmp_path / "epoch_0")
    ck.save_checkpoint(path, {"w": torch.zeros(3), "epoch": 0})
    ck.save_checkpoint(path, {"w": torch.ones(3), "epoch": 0})
    assert os.listdir(tmp_path) == ["epoch_0"]
    assert torch.equal(ck.restore_checkpoint(path)["w"], torch.ones(3))


@pytest.mark.parametrize("moment,saved,resumed", [
    ("mu", "float32", "bfloat16"), ("nu", "float32", "bfloat16"),
    ("mu", "bfloat16", "float32"), ("nu", "bfloat16", "float32"),
], ids=["mu-down", "nu-down", "mu-up", "nu-up"])
def test_resume_across_the_moment_dtype(tmp_path, moment, saved, resumed):
    import jax
    import jax.numpy as jnp

    from orbit2_tpu.training import checkpoint as jck
    from orbit2_tpu.training.optim import make_optimizer as jax_make_optimizer

    _, params = jax_params(seed=2)
    grads = gradients(params, 2, seed=3)
    hp_saved = dict(HP, **{f"{moment}_dtype": saved})
    hp_resumed = dict(HP, **{f"{moment}_dtype": resumed})

    # JAX: Orbax casts to the template's dtype
    _, jp, jstate = jax_run(params, hp_saved, grads[:1])
    jck.save_checkpoint(str(tmp_path / "jax"), {"params": jp, "opt_state": jstate, "epoch": 0})
    tx = jax_make_optimizer("adamw", hp_resumed)
    template = {"params": jp, "opt_state": tx.init(jp), "epoch": 0}
    restored = jck.restore_checkpoint(str(tmp_path / "jax"), template)
    want = dict(zip(("mu", "nu"), moments_of(restored["opt_state"])))
    jax_dtype = getattr(restored["opt_state"].inner_state[0], moment)["var_query"].dtype

    # the port
    tm, opt, step = port_run(torch_state(params), hp_saved, [torch_state(grads[0])])
    ck.save_checkpoint(str(tmp_path / "port"), {"model": tm.state_dict(),
                                                 "optimizer": opt.state_dict(), "epoch": 0})
    opt2 = make_optimizer("adamw", hp_resumed, tm.named_parameters())
    state = ck.restore_checkpoint(str(tmp_path / "port"),
                                  {"model": tm.state_dict(), "optimizer": opt2.state_dict()})
    assert all(t.dtype == DTYPES[resumed] for t in state["optimizer"][moment].values())
    assert str(jax_dtype) == resumed
    opt2.load_state_dict(state["optimizer"])
    assert opt2.count == 1 and all(t.dtype == DTYPES[resumed]
                                   for t in opt2.state_dict()[moment].values())
    for key in ("mu", "nu"):  # `moment` went through bf16 on both sides
        for name, t in opt2.state_dict()[key].items():
            assert_close_by_dtype(t, want[key][name],
                                  torch.bfloat16 if key == moment else torch.float32,
                                  f"{key}/{name}")

    # and both step on from there, to the same parameters
    updates, _ = tx.update(jax.tree.map(jnp.asarray, grads[1]), restored["opt_state"], jp)
    want_p = torch_state(jax.tree.map(lambda p, u: np.asarray(p + u), jp, updates))
    for name, p in tm.named_parameters():
        p.grad = torch_state(grads[1])[name]
    opt2.step()
    assert opt2.count == 2
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


LISTING = ["epoch_0", "epoch_1", "epoch_2", "epoch_3", "epoch_5", "epoch_12", "epoch_x",
           "epoch_", "epoch_3.tmp", ".epoch_6.abc", "other_7", "epoch_07"]


def make_listing(root):
    root.mkdir()
    for name in LISTING:
        (root / name).mkdir()
    return str(root)


@pytest.mark.parametrize("current_epoch", [None, 5, 12], ids=["by-count", "epoch5", "epoch12"])
@pytest.mark.parametrize("keep_last", [0, 1, 3])
def test_prune_matches_jax(tmp_path, keep_last, current_epoch):
    from orbit2_tpu.training import checkpoint as jck

    want, got = make_listing(tmp_path / "jax"), make_listing(tmp_path / "port")
    jck.prune_checkpoints(want, keep_last, current_epoch=current_epoch)
    ck.prune_checkpoints(got, keep_last, current_epoch=current_epoch)
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    if keep_last == 0:
        assert sorted(os.listdir(got)) == sorted(LISTING)


def test_latest_checkpoint_matches_jax(tmp_path):
    from orbit2_tpu.training import checkpoint as jck

    root = make_listing(tmp_path / "d")
    for prefix in ("epoch_", "other_", "none_"):
        want, got = jck.latest_checkpoint(root, prefix), ck.latest_checkpoint(root, prefix)
        assert got == want
    assert ck.latest_checkpoint(root) == os.path.join(root, "epoch_12")
    assert ck.latest_checkpoint(str(tmp_path / "missing")) is None
    shutil.rmtree(root)
    os.mkdir(root)
    assert ck.latest_checkpoint(root) is None and jck.latest_checkpoint(root) is None


def other_grid_sources(shape_drop: bool):
    """(JAX source tree, port source dict) from a model at 16 x 32 (pos_embed
    of 8 x 16 tokens), with a key the target lacks and, if asked, a key of
    another shape."""
    _, src = jax_params(img=(16, 32), seed=4)
    port_src = dict(torch_state(src))
    src = dict(src, extra=np.ones(3, np.float32))
    port_src["extra.weight"] = torch.ones(3)
    if shape_drop:
        src["var_query"] = np.ones((1, 1, 32), np.float32)
        port_src["var_query"] = torch.ones(1, 1, 32)
    return src, port_src


def test_load_pretrained_params_matches_jax():
    from orbit2_tpu.training import checkpoint as jck

    _, tgt = jax_params(seed=5)
    src, port_src = other_grid_sources(shape_drop=True)
    want, wrep = jck.load_pretrained_params(tgt, src, patch_size=2, img_size=IMG)
    got, rep = ck.load_pretrained_params(torch_state(tgt), port_src, 2, img_size=IMG)

    want_sd = torch_state(want)
    assert set(got) == set(want_sd)
    for k in want_sd:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), want_sd[k].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=k)
    assert rep["resized"] == ["pos_embed"] and wrep["resized"] == [("pos_embed",)]
    assert sorted(rep["dropped"]) == [("missing", "extra.weight"), ("shape", "var_query")]
    assert sorted((r, k[0]) for r, k in wrep["dropped"]) == [("missing", "extra"),
                                                              ("shape", "var_query")]
    # JAX stacks the 7 token embeddings' kernels and biases into 2 leaves,
    # which the reference layout keeps as 2 x 7 keys; every other leaf is a key
    assert len(rep["used"]) == len(wrep["used"]) - 2 + 2 * len(DEFAULT_VARS)
    assert len(rep["used"]) == len(got) - 2  # all but pos_embed and var_query
    # the shape-dropped key keeps the target's value
    assert torch.equal(got["var_query"], torch_state(tgt)["var_query"])


def test_load_pretrained_params_strict_and_stacked_raise():
    from orbit2_tpu.training import checkpoint as jck

    _, tgt = jax_params(seed=5)
    src, port_src = other_grid_sources(shape_drop=True)
    with pytest.raises(ValueError, match="shape mismatch for var_query"):
        ck.load_pretrained_params(torch_state(tgt), port_src, 2, img_size=IMG, strict=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        jck.load_pretrained_params(tgt, src, patch_size=2, img_size=IMG, strict=True)
    # without img_size, pos_embed of another grid is a shape drop too
    _, rep = ck.load_pretrained_params(torch_state(tgt), port_src, 2)
    _, wrep = jck.load_pretrained_params(tgt, src, patch_size=2)
    assert ("shape", "pos_embed") in rep["dropped"] and ("shape", ("pos_embed",)) in wrep["dropped"]
    # a source in the JAX pipeline's stacked layout is unstacked, not refused
    state = torch_state(tgt)
    depth = sum(k.endswith(".attn.qkv.weight") for k in state)
    stacked = torch.stack([state[f"blocks.{i}.attn.qkv.weight"] + 1 for i in range(depth)])
    got, rep = ck.load_pretrained_params(state, {"blocks_stacked.attn.qkv.weight": stacked}, 2)
    assert sorted(rep["used"]) == sorted(f"blocks.{i}.attn.qkv.weight" for i in range(depth))
    assert all(torch.equal(got[f"blocks.{i}.attn.qkv.weight"], stacked[i]) for i in range(depth))


def test_interpolate_pos_embed_checkpoint_keeps_the_type():
    from orbit2_tpu.ops.pos_embed import interpolate_pos_embed_checkpoint as jax_resize

    from orbit2_tpu_torch.ops.pos_embed import interpolate_pos_embed_checkpoint

    pe = np.random.default_rng(0).normal(size=(1, 128, 16)).astype(np.float32)
    want = jax_resize(pe, 2, (8, 16))
    got = interpolate_pos_embed_checkpoint(pe, 2, (8, 16))
    assert isinstance(got, np.ndarray) and got.shape == (1, 32, 16)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    got_t = interpolate_pos_embed_checkpoint(torch.from_numpy(pe), 2, (8, 16))
    assert isinstance(got_t, torch.Tensor) and got_t.dtype == torch.float32
    np.testing.assert_array_equal(got_t.numpy(), got)


def tiny_cfg(ds, tmp_path, name="tiny.yaml", **trainer):
    raw = {
        "trainer": {"max_epochs": 1, "batch_size": 4, "buffer_size": 8, "num_workers": 0,
                    "data_type": "float32", "train_loss": "bayesian_tv", "remat": False,
                    **trainer},
        "parallelism": {"fsdp": 1, "simple_ddp": 1, "tensor_par": 1},
        "tiling": {"do_tiling": False},
        "model": {"preset": "res_slimvit", "lr": 1e-3, "warmup_epochs": 1, "superres_mag": 4,
                  "patch_size": 2, "embed_dim": 32, "depth": 1, "decoder_depth": 1,
                  "num_heads": 2, "drop_path": 0.0, "drop_rate": 0.0, "attention_impl": "auto"},
        "data": {
            "low_res_dir": {"S": ds["low"]}, "high_res_dir": {"S": ds["high"]},
            "spatial_resolution": {"S": 625}, "default_vars": list(ds["in_vars"]),
            "dict_in_variables": {"S": list(ds["in_vars"])},
            "dict_out_variables": {"S": list(ds["out_vars"])}, "var_weights": {},
        },
    }
    path = tmp_path / name
    path.write_text(yaml.safe_dump(raw))
    return raw, str(path)


def jax_npz_at(raw, img, path):
    """The JAX model of `raw` drawn at another image size (its pos_embed on
    another token grid), saved as a reference-layout npz."""
    import jax
    import jax.numpy as jnp

    from orbit2_tpu.models import ResSlimViT as JaxResSlimViT

    m = raw["model"]
    jm = JaxResSlimViT(default_vars=tuple(raw["data"]["default_vars"]), img_size=img,
                       in_channels=7, out_channels=3, superres_mag=4, patch_size=2,
                       embed_dim=m["embed_dim"], depth=m["depth"], decoder_depth=1,
                       num_heads=m["num_heads"], learn_pos_emb=True, attention_impl="xla",
                       drop_rate=0.0, drop_path=0.0, spatial_resolution=625.0)
    params = jm.init({"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 7) + img),
                     DEFAULT_VARS, OUT_VARS)["params"]
    rng = np.random.default_rng(3)
    params = jax.tree.map(  # zero var_query/var_embed would hide the variable aggregation
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    np.savez(path, **{k: v.numpy() for k, v in torch_state(params).items()})
    return str(path)


def test_finetune_cli_imports_pretrained_weights(synth_dataset, tmp_path, caplog, capsys,
                                                monkeypatch):
    """The train CLI writes epoch_0; finetune --pretrain epoch_0 imports it
    (used > 0, nothing dropped or resized) and writes its own epoch_0; an
    npz of another grid has its pos_embed resized."""
    from orbit2_tpu_torch import finetune, train

    _, cfg = tiny_cfg(synth_dataset, tmp_path)
    pre_dir = tmp_path / "pre"
    train.main([cfg, "--device", "cpu", "--max-epochs", "1", "--max-steps-per-epoch", "2",
                "--checkpoint-dir", str(pre_dir)])
    assert os.listdir(pre_dir) == ["epoch_0"]

    ft_dir = tmp_path / "ft"
    with caplog.at_level(logging.INFO, logger="orbit2_tpu_torch"):
        out = finetune.main([cfg, "--pretrain", str(pre_dir / "epoch_0"), "--max-epochs", "1",
                             "--max-steps-per-epoch", "2", "--checkpoint-dir", str(ft_dir),
                             "--device", "cpu"])
    imports = [r for r in caplog.records if "pretrain import" in r.getMessage()]
    assert imports and imports[0].args[0] > 0
    rep = out["pretrain"]
    assert not rep["dropped"] and not rep["resized"]
    assert os.listdir(ft_dir) == ["epoch_0"]
    assert [r["epoch"] for r in out["history"]] == [0] and np.isfinite(out["history"][0]["loss"])
    # the fine-tune started from the pretrained weights
    pre = ck.restore_checkpoint(str(pre_dir / "epoch_0"))["model"]
    assert set(rep["used"]) == set(pre)

    raw, _ = tiny_cfg(synth_dataset, tmp_path)
    npz = jax_npz_at(raw, (8, 16), tmp_path / "other.npz")
    out = finetune.main([cfg, "--pretrain", npz, "--max-epochs", "1", "--max-steps-per-epoch",
                         "1", "--checkpoint-dir", str(tmp_path / "ft_npz"), "--device", "cpu"])
    assert out["pretrain"]["resized"] == ["pos_embed"] and not out["pretrain"]["dropped"]
    assert np.isfinite(out["history"][0]["loss"])
    capsys.readouterr()
    # the model hub's presets fine-tune too (tests/test_torch_hub_train.py
    # holds them against JAX; here the Unet at hidden 8 over two levels, to
    # stay quick); LPIPS is not ported
    from orbit2_tpu_torch.models.unet import Unet
    from orbit2_tpu_torch.utils import loaders

    monkeypatch.setattr(loaders, "Unet", lambda *a, **kw: Unet(*a, **{
        **kw, "hidden_channels": 8, "ch_mults": (1, 2), "is_attn": (False, False)}))
    out = finetune.main([cfg, "--arch", "unet", "--max-epochs", "1", "--max-steps-per-epoch", "1",
                         "--checkpoint-dir", str(tmp_path / "ft_unet"), "--device", "cpu"])
    assert np.isfinite(out["history"][0]["loss"]) and out["history"][0]["batches"] == 1
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        finetune.main([cfg, "--loss", "perceptual", "--device", "cpu"])


def test_moe_model_saves_resumes_and_finetunes(synth_dataset, tmp_path):
    """A tiny MoE model (2 experts in every Block, bf16 moments): the epoch
    checkpoint restores its parameters, moments, count and lr bit for bit,
    AdamW's moments keyed by name, the routers' among them in the
    configured dtype; a second Trainer resumes from it at the next epoch;
    the finetune CLI imports every key of it. AdamW decays every parameter,
    the router and the 2-D expert biases too, as optax's
    add_decayed_weights without a mask does."""
    from orbit2_tpu_torch import finetune

    raw, _ = tiny_cfg(synth_dataset, tmp_path, adam_mu_dtype="bfloat16",
                      adam_nu_dtype="bfloat16")
    raw["model"].update(moe_experts=2, moe_every=1, weight_decay=0.5)
    path = tmp_path / "moe.yaml"
    path.write_text(yaml.safe_dump(raw))
    ck_dir = tmp_path / "ck"
    trainer = Trainer(load_config(raw), "cpu", checkpoint_dir=str(ck_dir))
    trainer.fit(max_epochs=1, max_steps_per_epoch=2)
    want = snapshot({"model": trainer.model.state_dict(),
                     "optimizer": trainer.optimizer.state_dict()})
    got = ck.restore_checkpoint(str(ck_dir / "epoch_0"))
    assert got["epoch"] == 0
    assert_equal_states({"model": got["model"], "optimizer": got["optimizer"]}, want)
    moe_keys = [k for k in got["model"] if ".moe_mlp." in k]
    assert len(moe_keys) == 5 and "blocks.0.moe_mlp.router_kernel" in moe_keys
    for key in ("mu", "nu"):
        assert set(got["optimizer"][key]) == set(got["model"])
        assert got["optimizer"][key]["blocks.0.moe_mlp.router_kernel"].dtype == torch.bfloat16
    assert got["model"]["blocks.0.moe_mlp.router_kernel"].dtype == torch.float32

    resumed = Trainer(load_config(raw), "cpu", checkpoint_dir=str(ck_dir))
    history = resumed.fit(max_epochs=2, max_steps_per_epoch=1)
    assert [r["epoch"] for r in history] == [1] and np.isfinite(history[0]["loss"])

    out = finetune.main([str(path), "--pretrain", str(ck_dir / "epoch_0"), "--max-epochs", "1",
                         "--max-steps-per-epoch", "1", "--checkpoint-dir", str(tmp_path / "ft"),
                         "--device", "cpu"])
    assert set(out["pretrain"]["used"]) == set(got["model"]) and not out["pretrain"]["dropped"]
    assert np.isfinite(out["history"][0]["loss"])

    model = resumed.model
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    resumed.optimizer.step()
    for k in ("blocks.0.moe_mlp.router_kernel", "blocks.0.moe_mlp.bi", "blocks.0.moe_mlp.bo"):
        moved = model.get_parameter(k).detach()
        assert not torch.equal(moved, before[k]) or not before[k].any(), k
    assert not torch.equal(model.get_parameter("blocks.0.moe_mlp.router_kernel"),
                           before["blocks.0.moe_mlp.router_kernel"])


def load_jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_evaluate_cli_serves_an_npz_of_another_grid_like_jax(synth_dataset, tmp_path,
                                                            monkeypatch, capsys):
    """A reference-layout npz drawn at 8 x 16 (pos_embed of 4 x 8 tokens)
    serves through the port's evaluate CLI at 16 x 32: its pos_embed is
    resized as examples/evaluate.py resizes it, and the metrics agree; the
    visualize CLI stitches a field from it."""
    from orbit2_tpu_torch import evaluate

    raw, cfg = tiny_cfg(synth_dataset, tmp_path)
    npz = jax_npz_at(raw, (8, 16), tmp_path / "other.npz")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["evaluate.py", cfg, "--torch-npz", npz,
                                      "--max-batches", "2"])
    capsys.readouterr()
    load_jax_example("evaluate").main()
    want = json.loads(capsys.readouterr().out)
    evaluate.main([cfg, "--torch-npz", npz, "--max-batches", "2", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert list(got) == list(want) and len(got) == 12
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    # the stitching CLI takes the same npz
    from orbit2_tpu_torch import visualize

    res = visualize.main([cfg, "--torch-npz", npz, "--out-dir", str(tmp_path / "viz"),
                          "--device", "cpu"])
    assert res["preds"].shape == (3, 64, 128) and np.isfinite(res["preds"]).all()


def test_serving_clis_take_a_checkpoint(synth_dataset, tmp_path, monkeypatch, capsys):
    """--checkpoint, then trainer.checkpoint, then the newest epoch_N under
    checkpoints/climate: each serves the trained weights, not drawn ones."""
    from orbit2_tpu_torch import evaluate, train, visualize

    monkeypatch.chdir(tmp_path)
    _, cfg = tiny_cfg(synth_dataset, tmp_path)
    train.main([cfg, "--device", "cpu", "--max-epochs", "2", "--max-steps-per-epoch", "2"])
    assert sorted(os.listdir(tmp_path / "checkpoints" / "climate")) == ["epoch_0", "epoch_1"]
    capsys.readouterr()

    def metrics(args, path=cfg):
        evaluate.main([path, "--max-batches", "1", "--device", "cpu", *args])
        return json.loads(capsys.readouterr().out)

    newest = metrics([])
    epoch0 = str(tmp_path / "checkpoints" / "climate" / "epoch_0")
    assert metrics(["--checkpoint", str(tmp_path / "checkpoints" / "climate" / "epoch_1")]) == newest
    first = metrics(["--checkpoint", epoch0])
    assert first != newest
    _, by_config = tiny_cfg(synth_dataset, tmp_path, "by_config.yaml", checkpoint=epoch0)
    assert metrics([], by_config) == first

    ev = evaluate.Evaluator(load_config(cfg), "cpu",
                            state_dict=evaluate.serving_weights(load_config(cfg)))
    trained = ck.restore_checkpoint(str(tmp_path / "checkpoints" / "climate" / "epoch_1"))
    for k, v in trained["model"].items():
        assert torch.equal(ev.model.state_dict()[k].cpu(), v), k
    res = visualize.main([cfg, "--checkpoint", epoch0, "--out-dir", str(tmp_path / "viz"),
                          "--device", "cpu"])
    assert res["preds"].shape == (3, 64, 128) and np.isfinite(res["preds"]).all()


def test_an_orbax_epoch_in_the_directory_is_skipped(synth_dataset, tmp_path, monkeypatch,
                                                   capsys, caplog):
    """The JAX package's Orbax epoch_N in checkpoints/climate, newer than
    the port's: latest_checkpoint returns it, as JAX's does, but the serving
    CLI and the Trainer skip it with a log line and take the newest port
    checkpoint."""
    from orbit2_tpu.training import checkpoint as jck
    from orbit2_tpu_torch import evaluate, train

    monkeypatch.chdir(tmp_path)
    raw, cfg = tiny_cfg(synth_dataset, tmp_path)
    train.main([cfg, "--device", "cpu", "--max-epochs", "2", "--max-steps-per-epoch", "1"])
    root = tmp_path / "checkpoints" / "climate"
    jck.save_checkpoint(str(root / "epoch_7"), {"params": {"w": np.ones(3, np.float32)},
                                                "epoch": 7})
    assert ck.latest_checkpoint(str(root)) == jck.latest_checkpoint(str(root)) == str(
        root / "epoch_7")
    assert ck.latest_port_checkpoint(str(root)) == str(root / "epoch_1")
    capsys.readouterr()

    def metrics(args):
        evaluate.main([cfg, "--max-batches", "1", "--device", "cpu", *args])
        return json.loads(capsys.readouterr().out)

    with caplog.at_level(logging.WARNING, logger="orbit2_tpu_torch"):
        assert metrics([]) == metrics(["--checkpoint", str(root / "epoch_1")])
    assert any("skipping" in r.getMessage() and "epoch_7" in r.getMessage()
               for r in caplog.records)
    history = Trainer(load_config(raw), "cpu", checkpoint_dir=str(root)).fit(
        max_epochs=3, max_steps_per_epoch=1)
    assert [r["epoch"] for r in history] == [2]


def test_evaluator_draws_only_the_keys_its_state_dict_lacks(synth_dataset, tmp_path):
    """A state dict without var_query: the Evaluator takes every key it has
    and draws var_query as an Evaluator without a state dict draws it."""
    from orbit2_tpu_torch.evaluate import Evaluator

    raw, _ = tiny_cfg(synth_dataset, tmp_path)
    drawn = Evaluator(load_config(raw), "cpu").model.state_dict()
    rng = np.random.default_rng(4)
    given = {k: torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32))
             for k, v in drawn.items() if k != "var_query"}
    got = Evaluator(load_config(raw), "cpu", state_dict=given).model.state_dict()
    assert torch.equal(got["var_query"], drawn["var_query"])
    for k, v in given.items():
        assert torch.equal(got[k], v), k


def test_finetune_readme_invocation(synth_dataset, tmp_path, monkeypatch, capsys):
    """README's `finetune my_config.yaml --pretrain checkpoints/climate/epoch_N
    --loss bayesian_tv --max-epochs M` after the train CLI's defaults: the
    fine-tune trains from epoch 0 in checkpoints/finetune, from the
    pretrained weights; pointing --checkpoint-dir at the directory that
    holds --pretrain is refused, since the fit would resume over them."""
    from orbit2_tpu_torch import finetune, train

    monkeypatch.chdir(tmp_path)
    _, cfg = tiny_cfg(synth_dataset, tmp_path)
    train.main([cfg, "--device", "cpu", "--max-epochs", "2", "--max-steps-per-epoch", "1"])
    pretrain = os.path.join("checkpoints", "climate", "epoch_1")
    out = finetune.main([cfg, "--pretrain", pretrain, "--loss", "bayesian_tv", "--max-epochs",
                         "2", "--max-steps-per-epoch", "1", "--device", "cpu"])
    assert [r["epoch"] for r in out["history"]] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in out["history"])
    assert set(out["pretrain"]["used"]) == set(ck.restore_checkpoint(pretrain)["model"])
    assert sorted(os.listdir(tmp_path / "checkpoints" / "finetune")) == ["epoch_0", "epoch_1"]
    assert sorted(os.listdir(tmp_path / "checkpoints" / "climate")) == ["epoch_0", "epoch_1"]
    capsys.readouterr()
    with pytest.raises(ValueError, match="directory of its own"):
        finetune.main([cfg, "--pretrain", pretrain, "--checkpoint-dir",
                       os.path.join("checkpoints", "climate"), "--device", "cpu"])


def test_finetune_starts_from_the_merged_weights(synth_dataset, tmp_path, monkeypatch):
    """The model the fine-tune fits holds the npz's tensors, pos_embed
    resized to the config's grid, whatever the model would have drawn."""
    from orbit2_tpu_torch import finetune
    from orbit2_tpu_torch.ops.pos_embed import interpolate_pos_embed_checkpoint

    raw, cfg = tiny_cfg(synth_dataset, tmp_path)
    npz = jax_npz_at(raw, (8, 16), tmp_path / "other.npz")
    started = {}

    def fit(self, *a):
        started.update(self.model.state_dict())
        return []

    monkeypatch.setattr(finetune.Trainer, "fit", fit)
    finetune.main([cfg, "--pretrain", npz, "--checkpoint-dir", str(tmp_path / "ft"),
                   "--device", "cpu"])
    source = ck.load_state_npz(npz)
    assert started.keys() == source.keys()
    for k, v in source.items():
        want = interpolate_pos_embed_checkpoint(v, 2, (16, 32)) if k == "pos_embed" else v
        assert torch.equal(started[k], want), k


def write_tiny_dataset(root, t=8, h=16, w=32, mag=4):
    """tests/conftest.py's synthetic layout, for the cases that run without
    its fixtures (--noconftest on the card's machine)."""
    rng = np.random.default_rng(0)
    in_vars = list(DEFAULT_VARS)
    out_vars = list(OUT_VARS)
    for base, hh, ww, variables in ((root / "low", h, w, in_vars),
                                    (root / "high", h * mag, w * mag, out_vars)):
        for split in ("train", "val", "test"):
            d = base / split
            d.mkdir(parents=True)
            np.savez(d / "shard_0.npz", **{v: rng.normal(280, 10, (t, 1, hh, ww)).astype(
                np.float32) for v in variables})
            np.savez(d / "climatology.npz", **{v: rng.normal(280, 1, (1, hh, ww)).astype(
                np.float32) for v in variables})
        np.save(base / "lat.npy", np.linspace(-88, 88, hh).astype(np.float32))
        np.save(base / "lon.npy", np.linspace(0, 358, ww).astype(np.float32))
        np.savez(base / "normalize_mean.npz", **{v: np.array([280.0], np.float32)
                                                 for v in variables})
        np.savez(base / "normalize_std.npz", **{v: np.array([10.0], np.float32)
                                                for v in variables})
    return {"low": str(root / "low"), "high": str(root / "high"), "in_vars": in_vars,
            "out_vars": out_vars}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_resident_trainer_round_trip(cuda, tmp_path):
    ds = write_tiny_dataset(tmp_path / "data")
    raw, _ = tiny_cfg(ds, tmp_path, data_type="bfloat16", adam_mu_dtype="bfloat16",
                      adam_nu_dtype="bfloat16")
    trainer = Trainer(load_config(raw), "cuda", checkpoint_dir=str(tmp_path / "ck"))
    trainer.fit(max_epochs=1, max_steps_per_epoch=2)
    assert trainer.model.var_query.device.type == "cuda"
    got = ck.restore_checkpoint(str(tmp_path / "ck" / "epoch_0"))
    assert_equal_states(got, {"model": trainer.model.state_dict(),
                              "optimizer": trainer.optimizer.state_dict(), "epoch": 0})
    resumed = Trainer(load_config(raw), "cuda", checkpoint_dir=str(tmp_path / "ck"))
    history = resumed.fit(max_epochs=2, max_steps_per_epoch=2)
    assert [r["epoch"] for r in history] == [1] and np.isfinite(history[0]["loss"])


@pytest.mark.cuda
def test_async_save_on_card_writes_the_state_before_the_next_step(cuda, tmp_path):
    drawn = ResSlimViT(DEFAULT_VARS, img_size=IMG, drop_rate=0.0, drop_path=0.0,
                       generator=torch.Generator().manual_seed(0), **TINY).state_dict()
    rng = np.random.default_rng(5)
    grads = [{k: torch.from_numpy(gradients_like(v, rng)) for k, v in drawn.items()}
             for _ in range(3)]
    tm, opt, step = port_run(drawn, dict(HP, mu_dtype="bfloat16", nu_dtype="bfloat16"),
                             grads[:1], device="cuda")
    state = {"model": tm.state_dict(), "optimizer": opt.state_dict(), "epoch": 0}
    want = snapshot(state)
    ck.save_checkpoint(str(tmp_path / "epoch_0"), state, async_save=True)
    for g in grads[1:]:  # runs while the writer writes
        step(g)
    torch.cuda.synchronize()
    ck.wait_for_async_saves()
    assert not torch.equal(tm.var_query.detach().cpu(), want["model"]["var_query"])
    assert_equal_states(ck.restore_checkpoint(str(tmp_path / "epoch_0")), want)

