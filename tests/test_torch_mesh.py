"""The port's mesh, sharding table and train-CLI scale-down against the JAX
package, in one process (the multi-process steps are in
tests/test_torch_distributed.py):
  * the rank grid of parallel/mesh.py is JAX make_mesh's device layout;
  * spec_for on every parameter of a tiny dense and a tiny MoE ResSlimViT is
    JAX spec_for on the same path and shape, the dropped-axis rule included;
  * the train CLI scales all nine shipped configs' meshes as
    examples/train.py does at world 1, 2, 4 and 8; at world 1 its Trainer
    accepts the seven JAX's driver brings to one device and refuses the
    pipeline and MoE configs with JAX's ValueError; a config at its
    shipped mesh trains a step through `python -m orbit2_tpu_torch.train`;
  * the Trainer's refusals of the axes not ported yet;
  * DropPath's slice of the global batch's mask and the seed folds.
"""

import glob
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from orbit2_tpu.config import load_config as jax_load_config
from orbit2_tpu.models import ResSlimViT as JaxResSlimViT
from orbit2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from orbit2_tpu.parallel.sharding import spec_for as jax_spec_for
from orbit2_tpu_torch import train as train_cli
from orbit2_tpu_torch.config import load_config
from orbit2_tpu_torch.evaluate import check_mesh, check_scope
from orbit2_tpu_torch.models.components.blocks import DropPath
from orbit2_tpu_torch.ops.kernel_prng import fold_seed
from orbit2_tpu_torch.parallel.mesh import rank_grid
from orbit2_tpu_torch.parallel.sharding import spec_for
from orbit2_tpu_torch.training.checkpoint import state_dict_from_jax_params
from orbit2_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
AXES = ("fsdp", "simple_ddp", "tensor_par", "seq_par", "pipeline", "expert_par")
DEFAULT_VARS = (
    "land_sea_mask", "orography", "lattitude", "landcover",
    "total_precipitation_24hr", "2m_temperature_min", "2m_temperature_max",
)
OUT_VARS = DEFAULT_VARS[4:]
TINY = dict(img_size=(8, 16), in_channels=7, out_channels=3, superres_mag=4, patch_size=2,
            embed_dim=64, depth=2, decoder_depth=1, num_heads=2, learn_pos_emb=True)


# -- (1) the mesh ------------------------------------------------------------


@pytest.mark.parametrize("axes", [dict(replica=2, fsdp=2, tensor=2), dict(fsdp=4, tensor=2),
                                  dict(fsdp=2, tensor=2)],
                         ids=["2x2x2", "4x2", "2x2_of_8"])
def test_rank_grid_is_jax_device_layout(axes):
    """Over 8 devices; a smaller mesh takes the first ones, as JAX's does."""
    want = np.vectorize(lambda d: d.id)(jax_make_mesh(**axes).devices)
    np.testing.assert_array_equal(rank_grid(world=8, **axes), want)


def test_mesh_larger_than_the_world_raises_jax_value_error():
    with pytest.raises(ValueError, match=r"mesh 1x1x4x1x1x2=8 > 4 devices"):
        rank_grid(fsdp=4, tensor=2, world=4)
    with pytest.raises(ValueError, match=r"mesh 1x1x4x1x1x2=8 > 4 devices"):
        jax_make_mesh(fsdp=4, tensor=2, devices=jax.devices()[:4])


# -- (2) the sharding table --------------------------------------------------


def _jax_leaves(model):
    x = jnp.zeros((2, 7, 8, 16), jnp.float32)
    tree = jax.eval_shape(lambda k: model.init({"params": k}, x, DEFAULT_VARS, OUT_VARS),
                          jax.random.PRNGKey(0))["params"]
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), leaf.shape)
            for path, leaf in flat]


def _torch_dims(key, jax_shape, torch_shape):
    """Which JAX dim each torch dim of `key` is (None: a dim JAX lacks), as
    training/checkpoint.py::state_dict_from_jax_params lays them out."""
    if key.startswith("token_embeds."):  # [D, 1, p, p] <- one variable of [V, p*p, D]
        return [2, None, None, None] if key.endswith("weight") else [1]
    if len(torch_shape) == 4:  # conv OIHW <- HWIO
        return [3, 2, 0, 1]
    if len(torch_shape) == 2 and "moe_mlp" not in key:
        return [1, 0]  # a Linear's weight is its kernel transposed
    return list(range(len(torch_shape)))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_spec_for_is_jax_spec_for_on_every_parameter(moe):
    kw = dict(moe_experts=4, moe_every=1) if moe else {}
    leaves = _jax_leaves(JaxResSlimViT(default_vars=DEFAULT_VARS, attention_impl="xla", **TINY,
                                       **kw))
    # every JAX leaf filled with its index, so each port tensor names its leaf
    params = {}
    for i, (path, shape) in enumerate(leaves):
        node = params
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = np.full(shape, i, np.float32)
    state = state_dict_from_jax_params(params, patch_size=2)
    mesh = jax_make_mesh(replica=2, fsdp=2, tensor=2) if not moe else \
        jax_make_mesh(expert=2, fsdp=2, tensor=2)
    sizes = dict(mesh.shape)
    seen = set()
    for key, t in state.items():
        i = int(t.reshape(-1)[0])
        path, shape = leaves[i]
        seen.add(i)
        want = tuple(jax_spec_for(path, shape, mesh))
        want = want + (None,) * (len(shape) - len(want))
        got = spec_for(key, tuple(t.shape), sizes)
        dims = _torch_dims(key, shape, tuple(t.shape))
        assert got == tuple(None if d is None else want[d] for d in dims), (key, path)
    assert seen == set(range(len(leaves)))


def test_spec_rules_mirror_jax_test_spec_rules():
    """tests/test_parallel.py::test_spec_rules on the port's names."""
    sizes = dict(fsdp=2, tensor=2, replica=2)
    assert spec_for("blocks.0.attn.qkv.weight", (192, 64), sizes) == ("tensor", "fsdp")
    assert spec_for("blocks.0.attn.proj.weight", (64, 64), sizes) == ("fsdp", "tensor")
    assert spec_for("blocks.0.mlp.fc1.weight", (256, 64), sizes) == ("tensor", "fsdp")
    assert spec_for("blocks.0.mlp.fc2.weight", (64, 256), sizes) == ("fsdp", "tensor")
    assert spec_for("blocks.0.norm1.weight", (64,), sizes) == (None,)
    # non-divisible dims drop the axis instead of failing
    assert spec_for("blocks.0.attn.qkv.weight", (192, 63), sizes) == ("tensor", None)


# -- (3) the scale-down ------------------------------------------------------


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_scaled(path, world, monkeypatch):
    """examples/train.py's parallelism for `path` on `world` devices: JAX's
    device count patched, its Trainer a stub that keeps the config."""
    import orbit2_tpu.training.trainer as jax_trainer

    got = {}

    class Capture:
        def __init__(self, cfg, **_):
            got["cfg"] = cfg

        def fit(self):
            pass

    monkeypatch.setattr(jax_trainer, "Trainer", Capture)
    monkeypatch.setattr(jax, "device_count", lambda: world)
    monkeypatch.setattr(sys, "argv", ["train.py", path])
    _load_example("train").main()
    return {a: getattr(got["cfg"].parallelism, a) for a in AXES}


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_scale_down_equals_jax_driver_on_every_shipped_config(world, monkeypatch):
    """The scaled parallelism, and whether its mesh fits the world: at world
    3 the data axes halve to a mesh smaller than the world, which JAX builds
    on the first devices and the port on the first ranks."""
    from orbit2_tpu.parallel.mesh import mesh_from_config

    for path in CONFIGS:
        want = _jax_scaled(path, world, monkeypatch)
        cfg = train_cli.scale_parallelism(load_config(path), world)
        assert {a: getattr(cfg.parallelism, a) for a in AXES} == want, (path, world)
        try:
            mesh_from_config(cfg.parallelism, devices=jax.devices()[:world])
            jax_fits = True
        except ValueError:
            jax_fits = False
        try:
            check_mesh(cfg, world)
            fits = True
        except ValueError:
            fits = False
        assert fits == jax_fits, (path, world)


def test_cli_accepts_the_configs_jax_brings_to_one_device(monkeypatch):
    """The CLI's scale-down, then the Trainer's scope checks, at world 1
    (the Trainer's fit stubbed: the 10B config cannot be built here)."""
    monkeypatch.setattr(Trainer, "fit", lambda self, *a: [])
    refused = {}
    for path in CONFIGS:
        try:
            train_cli.main([path, "--device", "cpu"])
        except ValueError as e:
            refused[os.path.basename(path)] = str(e)
        # JAX's Trainer builds its mesh from the scaled config (make_mesh)
        jcfg = jax_load_config(path)
        scaled = train_cli.scale_parallelism(load_config(path), 1).parallelism
        for a in AXES:
            setattr(jcfg.parallelism, a, getattr(scaled, a))
        jax_refused = False
        try:
            from orbit2_tpu.parallel.mesh import mesh_from_config
            mesh_from_config(jcfg.parallelism, devices=jax.devices()[:1])
        except ValueError:
            jax_refused = True
        assert jax_refused == (os.path.basename(path) in refused), path
    assert sorted(refused) == ["interm_1b_moe.yaml", "interm_1b_pp.yaml"]
    assert all("> 1 devices" in m for m in refused.values())


def tiny_raw(ds, parallelism):
    return {
        "trainer": {"max_epochs": 1, "batch_size": 8, "buffer_size": 8, "num_workers": 0,
                    "data_type": "float32", "train_loss": "bayesian_tv"},
        "parallelism": parallelism,
        "tiling": {"do_tiling": False},
        "model": {"preset": "res_slimvit", "lr": 1e-3, "warmup_epochs": 1, "superres_mag": 4,
                  "patch_size": 2, "embed_dim": 64, "depth": 2, "decoder_depth": 1,
                  "num_heads": 2, "drop_path": 0.1, "drop_rate": 0.1, "attention_impl": "auto"},
        "data": {
            "low_res_dir": {"SYNTH": ds["low"]}, "high_res_dir": {"SYNTH": ds["high"]},
            "spatial_resolution": {"SYNTH": 625}, "default_vars": list(ds["in_vars"]),
            "dict_in_variables": {"SYNTH": list(ds["in_vars"])},
            "dict_out_variables": {"SYNTH": list(ds["out_vars"])},
        },
    }


def test_train_driver_scales_down_parallelism(synth_dataset, tmp_path, monkeypatch, capsys):
    """tests/test_drivers.py::test_train_driver_scales_down_parallelism on
    the port's CLI: a config sized for 16 devices trains on the one here."""
    path = tmp_path / "train16.yaml"
    path.write_text(yaml.safe_dump(tiny_raw(
        synth_dataset, {"fsdp": 4, "simple_ddp": 2, "tensor_par": 2})))
    monkeypatch.chdir(tmp_path)
    trainer = train_cli.main([str(path), "--device", "cpu", "--max-epochs", "1",
                              "--max-steps-per-epoch", "1"])
    assert os.path.isdir(tmp_path / "checkpoints" / "climate" / "epoch_0")
    assert trainer.mesh is None
    assert all(getattr(trainer.cfg.parallelism, a) == 1 for a in AXES)
    records = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert records[0]["batches"] == 1 and np.isfinite(records[0]["loss"])


def test_shipped_117m_mesh_trains_a_step_through_the_module_cli(synth_dataset, tmp_path):
    """interm_117m.yaml's own mesh (fsdp 4 x simple_ddp 4), its model cut to
    the tests' tiny size, on synthetic data: `python -m
    orbit2_tpu_torch.train` scales it to the one device and trains."""
    raw = yaml.safe_load(open(os.path.join(ROOT, "configs", "interm_117m.yaml")))
    tiny = tiny_raw(synth_dataset, raw["parallelism"])
    raw["model"].update(tiny["model"])
    raw["data"] = tiny["data"]
    raw["trainer"].update(batch_size=8, buffer_size=8, num_workers=0, data_type="float32",
                          checkpoint=None)
    raw["tiling"] = tiny["tiling"]
    path = tmp_path / "interm_117m_tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    assert (raw["parallelism"]["fsdp"], raw["parallelism"]["simple_ddp"]) == (4, 4)
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    out = subprocess.run(
        [sys.executable, "-m", "orbit2_tpu_torch.train", str(path), "--device", "cpu",
         "--max-epochs", "1", "--max-steps-per-epoch", "1", "--checkpoint-dir",
         str(tmp_path / "ck")], cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    logged = next(l for l in out.stderr.splitlines() if "parallelism {" in l)
    par = json.loads(logged[logged.index("{"):])
    assert "world 1," in logged and all(par[a] == 1 for a in AXES)
    records = [json.loads(l) for l in out.stdout.splitlines()]
    assert len(records) == 1 and records[0]["batches"] == 1
    assert np.isfinite(records[0]["loss"])


# -- the Trainer's scope -----------------------------------------------------


@pytest.mark.parametrize("axis,world", [("pipeline", 2), ("seq_par", 2), ("expert_par", 2),
                                        ("auto", 1)])
def test_trainer_refuses_axes_not_ported(synth_dataset, axis, world):
    """parallelism.auto is refused; the seq and expert axes and the
    pipeline, ported since, are taken."""
    raw = tiny_raw(synth_dataset, {"fsdp": 1, "simple_ddp": 1, "tensor_par": 1})
    raw["parallelism"][axis] = True if axis == "auto" else 2
    if axis == "expert_par":
        raw["model"].update(moe_experts=2, moe_every=1)
    cfg = load_config(raw)
    check_mesh(cfg, world)  # the mesh fits the world: the refusal is the axis's
    if axis in ("seq_par", "expert_par", "pipeline"):
        check_scope(cfg)
        return
    with pytest.raises(NotImplementedError, match="auto resolves"):
        check_scope(cfg)


@pytest.mark.parametrize("what,sizes", [
    ("moe", {"tensor": 2}), ("hub", {"fsdp": 2}), ("stage", {"stage": 2}),
    ("seq", {"seq": 2}), ("expert", {"expert": 2})])
def test_shard_model_refuses_what_it_does_not_split(what, sizes):
    """A stage axis under a model built without pipeline_stages, a seq axis
    under a model built without seq_shard and an expert axis over a trunk
    without MoE Blocks are refused; an MoE trunk under tensor parallelism
    and a model-hub preset on a data mesh are taken."""
    from orbit2_tpu_torch.models import ResSlimViT
    from orbit2_tpu_torch.models.resnet import ResNet
    from orbit2_tpu_torch.parallel.sharding import check_shardable

    with torch.device("meta"):
        model = (ResNet(7, 3, history=1) if what == "hub" else
                 ResSlimViT(DEFAULT_VARS, **TINY, moe_experts=2 if what == "moe" else 0))
    refusal = {"stage": (ValueError, "pipeline_stages=1 but the mesh's stage axis is 2"),
               "seq": (ValueError, "seq_shard=True"),
               "expert": (ValueError, "needs MoE Blocks")}.get(what)
    if refusal is None:
        check_shardable(model, sizes)
        return
    with pytest.raises(refusal[0], match=refusal[1]):
        check_shardable(model, sizes)


# -- DropPath and the seed folds ----------------------------------------------


def test_drop_path_takes_its_data_rank_slice_of_the_global_mask():
    x = torch.ones(8, 3, 2)
    full = DropPath(0.5).train()(x, torch.Generator().manual_seed(4))
    parts = []
    for rank in range(4):
        dp = DropPath(0.5).train()
        dp.batch_slice = (rank, 4)
        parts.append(dp(x[2 * rank:2 * rank + 2], torch.Generator().manual_seed(4)))
    assert torch.equal(torch.cat(parts), full)
    assert 0 < int((full == 0).all(dim=(1, 2)).sum()) < 8


def test_fold_seed_is_the_seed_without_coordinates_and_distinct_with_them():
    seed = 0x0123456789ABCDEF
    assert fold_seed(seed) == seed
    folds = {fold_seed(seed, c) for c in [(0,), (1,), (0, 0), (0, 1), (1, 0)]}
    assert len(folds) == 5 and all(0 <= f < 2 ** 64 for f in folds)
