"""The port's device meshes in real processes: 4 gloo ranks on the CPU.

Two launches of tests/torch_mesh_worker.py, 4 processes each:
  * "steps": the tiny ResSlimViT (embed 64, depth 2, 2 heads, fp32) on
    JAX's weights (state_dict_from_jax_params) under fsdp 2 x tensor 2 and
    replica 2 x fsdp 2 (HSDP), dropout 0: the forward, the loss and the
    whole gradients against the one-process port step (atol 1e-5 / rtol
    1e-4) and JAX's single-device step (tests/test_parallel.py's bars:
    forward 2e-4, gradients atol 5e-4 / rtol 5e-3); the mesh-built draw
    against the one-process draw, bit for bit; the packed qkv and kv split
    by heads; then dropout and drop-path 0.1 with remat: the parameters
    replicated across the tensor axis stay bit-equal on both tensor ranks,
    and K6 steps aside; an MoE trunk trains on the data axes.
  * "cli": `python -m orbit2_tpu_torch.train` as torchrun starts it, on a
    config meshed fsdp 2 x tensor 2 over an uneven synthetic set: the data
    ranks read disjoint files and the tensor ranks the same ones, the epoch
    is clamped to the least rank's batches, validation counts every sample,
    rank 0 writes the one checkpoint, and a resume on the mesh and one at
    world 1 restore it bit for bit (the seams of tests/test_distributed.py);
    then a config the scale-down brings to a mesh of 2 of the 4 ranks: the
    first 2 train, the other 2 stay idle.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from orbit2_tpu.metrics.metrics import METRICS_REGISTRY as JAX_METRICS
from orbit2_tpu.models import ResSlimViT as JaxResSlimViT
from orbit2_tpu.training.train import clip_replace_constant as jax_clip
from orbit2_tpu_torch.config import load_config
from orbit2_tpu_torch.metrics.metrics import METRICS_REGISTRY
from orbit2_tpu_torch.models import ResSlimViT
from orbit2_tpu_torch.train import scale_parallelism
from orbit2_tpu_torch.training.checkpoint import state_dict_from_jax_params
from orbit2_tpu_torch.training.optim import make_optimizer
from orbit2_tpu_torch.training.train import make_train_step
from orbit2_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")
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
MESHES = ["fsdp2_tensor2", "replica2_fsdp2"]
WORLD = 4
TIMEOUT = 240


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(mode, *args):
    """The 4 ranks of one worker launch; each must exit 0 in TIMEOUT s."""
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, mode, str(r), str(WORLD), port, *args],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{logs[r][-4000:]}"


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


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The "steps" launch, and the same batch through JAX and one port process."""
    out = tmp_path_factory.mktemp("mesh_steps")
    jm, params = jax_params()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 7, 8, 16)).astype(np.float32)
    y = (rng.normal(size=(8, 3, 32, 64)) * 0.5).astype(np.float32)
    state = state_dict_from_jax_params(params, patch_size=2)
    np.savez(out / "in.npz", x=x, y=y, **{k: v.numpy() for k, v in state.items()})
    _launch("steps", str(out / "in.npz"), str(out))

    jloss = JAX_METRICS["bayesian_tv"](aggregate_only=True)
    jp = jax.tree.map(jnp.asarray, params)

    def loss_fn(p):  # make_train_step's loss (orbit2_tpu/training/train.py:94-128)
        yhat = jm.apply({"params": p}, jnp.asarray(x), DEFAULT_VARS, OUT_VARS)
        yhat = jax_clip(jnp.asarray(y), yhat.astype(jnp.float32), OUT_VARS)
        return jloss(yhat, jnp.asarray(y), var_names=list(OUT_VARS), var_weights=VAR_WEIGHTS)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    jax_out = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(x), DEFAULT_VARS,
                                                    OUT_VARS))(jp))
    jax_grads = state_dict_from_jax_params(jax.tree.map(np.asarray, want_grads), patch_size=2)

    tm = ResSlimViT(DEFAULT_VARS, attention_impl="auto", drop_rate=0.0, drop_path=0.0, **TINY)
    tm.load_state_dict(state, strict=True)
    with torch.no_grad():
        tm.train()
        port_out = tm(torch.from_numpy(x), DEFAULT_VARS, OUT_VARS).numpy()
    opt = make_optimizer("adamw", HP, tm.named_parameters())
    step = make_train_step(tm, METRICS_REGISTRY["bayesian_tv"](aggregate_only=True), VAR_WEIGHTS,
                           opt, DEFAULT_VARS, OUT_VARS)
    port_loss = step(torch.from_numpy(x), torch.from_numpy(y), torch.Generator(), None).item()
    port_grads = {k: p.grad.numpy() for k, p in tm.named_parameters() if p.grad is not None}
    reports = [json.loads((out / f"steps_{r}.json").read_text()) for r in range(WORLD)]
    return dict(out=out, state=state, reports=reports,
                jax=dict(out=jax_out, loss=float(want_loss), grads=jax_grads),
                port=dict(out=port_out, loss=port_loss, grads=port_grads),
                mesh={m: np.load(out / f"{m}.npz") for m in MESHES})


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_forward_and_loss_match_one_process_and_jax(steps, mesh):
    got = steps["mesh"][mesh]
    np.testing.assert_allclose(got["out"], steps["port"]["out"], atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(float(got["loss"]), steps["port"]["loss"], atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got["out"], steps["jax"]["out"], atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(float(got["loss"]), steps["jax"]["loss"], atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_gradients_match_one_process_and_jax(steps, mesh):
    got = {k[len("grad/"):]: steps["mesh"][mesh][k] for k in steps["mesh"][mesh].files
           if k.startswith("grad/")}
    assert set(got) == set(steps["port"]["grads"])
    for k, g in got.items():
        np.testing.assert_allclose(g, steps["port"]["grads"][k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(g, steps["jax"]["grads"][k].numpy(), atol=5e-4, rtol=5e-3,
                                   err_msg=k)


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_draw_equals_the_one_process_draw(steps, mesh):
    assert all(r[mesh]["draw_equal"] for r in steps["reports"])


@pytest.mark.parametrize("mesh,shape", [("fsdp2_tensor2", (1, 1, 2, 1, 1, 2)),
                                        ("replica2_fsdp2", (1, 2, 2, 1, 1, 1))])
def test_rank_coordinates_follow_jax_layout(steps, mesh, shape):
    for rank, report in enumerate(steps["reports"]):
        coords = report[mesh]["coords"]
        want = np.unravel_index(rank, shape)
        assert [coords[a] for a in ("stage", "replica", "fsdp", "expert", "seq", "tensor")] == \
            [int(c) for c in want]
        assert report[mesh]["data_rank"] == want[1] * shape[2] + want[2]


def test_packed_qkv_and_kv_are_split_by_heads(steps):
    for rank, report in enumerate(steps["reports"]):
        assert report["heads"] == {"blocks.0.attn.qkv.weight": True,
                                   "blocks.1.attn.qkv.weight": True,
                                   "var_agg.kv.weight": True}, rank


def test_tensor_replicas_stay_bit_equal_with_dropout(steps):
    for rank, report in enumerate(steps["reports"]):
        d = report["dropout"]
        assert d["checked"] > 0 and d["equal"] == d["checked"], rank
        assert d["tensor_losses_equal"] and all(np.isfinite(d["losses"]))
        # DropPath takes its data rank's slice of the global batch's mask
        assert d["drop_path_slices"] == [[report["fsdp2_tensor2"]["data_rank"], 2]]
        assert d["fused_off"]  # K6 steps aside on a mesh of more than one device


def test_moe_trunk_trains_on_the_data_axes(steps):
    """An MoE trunk on replica 2 x fsdp 2: the forward is the one-process
    one (capacity is per batch row, so the data split changes no routing),
    and a step moves the expert weights."""
    for report in steps["reports"]:
        moe = report["moe"]
        assert moe["forward_err"] <= 1e-5 and np.isfinite(moe["loss"])
        assert moe["experts_moved"] > 0


# -- the CLI on a mesh -------------------------------------------------------


def _write_uneven_dataset(root, in_vars, out_vars, lens=(4, 10), h=16, w=32, mag=4):
    """Two files per split with unequal sample counts: unequal batch counts
    on the 2 data ranks."""
    rng = np.random.default_rng(3)

    def write(base, hh, ww, variables):
        for split in ("train", "val", "test"):
            d = base / split
            d.mkdir(parents=True, exist_ok=True)
            for i, t in enumerate(lens):
                np.savez(d / f"shard_{i}.npz", **{
                    v: (rng.gamma(0.3, 0.004, size=(t, 1, hh, ww))
                        if v == "total_precipitation_24hr"
                        else rng.normal(280, 10, size=(t, 1, hh, ww))).astype(np.float32)
                    for v in variables})
            np.savez(d / "climatology.npz",
                     **{v: rng.normal(280, 1, size=(1, hh, ww)).astype(np.float32)
                        for v in variables})
        np.save(base / "lat.npy", np.linspace(-88, 88, hh).astype(np.float32))
        np.save(base / "lon.npy", np.linspace(0, 358, ww).astype(np.float32))
        np.savez(base / "normalize_mean.npz",
                 **{v: np.array([280.0], dtype=np.float32) for v in variables})
        np.savez(base / "normalize_std.npz",
                 **{v: np.array([10.0], dtype=np.float32) for v in variables})

    write(root / "low", h, w, in_vars)
    write(root / "high", h * mag, w * mag, out_vars)
    return str(root / "low"), str(root / "high")


def mesh_raw(low, high, in_vars, out_vars):
    return {
        "trainer": {"max_epochs": 1, "batch_size": 4, "buffer_size": 8, "num_workers": 0,
                    "data_type": "float32", "train_loss": "bayesian_tv", "interval_epochs": 1},
        "parallelism": {"fsdp": 2, "simple_ddp": 1, "tensor_par": 2},
        "tiling": {"do_tiling": False},
        "model": {"preset": "res_slimvit", "lr": 1e-3, "warmup_epochs": 1, "superres_mag": 4,
                  "patch_size": 2, "embed_dim": 64, "depth": 2, "decoder_depth": 1,
                  "num_heads": 2, "drop_path": 0.1, "drop_rate": 0.1, "attention_impl": "auto"},
        "data": {
            "low_res_dir": {"SYNTH": low}, "high_res_dir": {"SYNTH": high},
            "spatial_resolution": {"SYNTH": 625}, "default_vars": list(in_vars),
            "dict_in_variables": {"SYNTH": list(in_vars)},
            "dict_out_variables": {"SYNTH": list(out_vars)},
            "var_weights": VAR_WEIGHTS,
        },
    }


@pytest.fixture(scope="module")
def cli(tmp_path_factory, synth_dataset):
    root = tmp_path_factory.mktemp("mesh_cli")
    low, high = _write_uneven_dataset(root, synth_dataset["in_vars"], synth_dataset["out_vars"])
    path = root / "mesh.yaml"
    path.write_text(yaml.safe_dump(mesh_raw(low, high, synth_dataset["in_vars"],
                                            synth_dataset["out_vars"])))
    ck = root / "ck"
    _launch("cli", str(path), str(ck), str(root))
    return dict(path=str(path), ck=ck,
                reports=[json.loads((root / f"cli_{r}.json").read_text()) for r in range(WORLD)],
                params=np.load(root / "cli_params.npz"))


def test_cli_data_ranks_read_disjoint_files_and_tensor_ranks_the_same(cli):
    by_data = {}
    for r in cli["reports"]:
        assert r["batch_size"] == 2  # the global batch of 4 over 2 data ranks
        for split in ("train", "val"):
            files = tuple(r["files"][split])
            assert files, split
            by_data.setdefault((split, r["data_rank"]), set()).add(files)
    for split in ("train", "val"):
        a, b = by_data[(split, 0)], by_data[(split, 1)]
        assert len(a) == 1 and len(b) == 1  # both tensor ranks read the same files
        assert not set(next(iter(a))) & set(next(iter(b)))  # the data ranks, disjoint ones


def test_cli_clamps_the_epoch_to_the_global_minimum(cli):
    firsts = [r["counts"]["train"][0] for r in cli["reports"]]
    assert len(set(firsts)) == 2  # the uneven files: 4 and 10 samples, batches of 2
    for r in cli["reports"]:
        assert [h["batches"] for h in r["history"]] == [min(firsts)]
        assert np.isfinite(r["history"][0]["loss"])
    assert len({r["history"][0]["loss"] for r in cli["reports"]}) == 1


def test_cli_validation_counts_every_sample(cli):
    for r in cli["reports"]:
        assert r["validation"]["samples"] == 14
        assert all(np.isfinite(v) for v in r["validation"]["means"].values())
    assert len({json.dumps(r["validation"], sort_keys=True) for r in cli["reports"]}) == 1


def test_cli_checkpoint_resumes_on_the_mesh_bit_for_bit(cli):
    for r in cli["reports"]:
        assert r["resumed_epoch"] == 1 and r["restored"] and r["moments"]


def test_cli_rank0_checkpoint_resumes_at_world_1_bit_for_bit(cli):
    assert sorted(os.listdir(cli["ck"])) == ["epoch_0"]
    cfg = scale_parallelism(load_config(cli["path"]), 1)
    assert (cfg.parallelism.fsdp, cfg.parallelism.tensor_par) == (1, 1)
    trainer = Trainer(cfg, "cpu", checkpoint_dir=str(cli["ck"]))
    assert trainer._start(trainer.data_module("SYNTH")) == 1
    got = trainer.model.state_dict()
    assert set(got) == set(cli["params"].files)
    for k in cli["params"].files:
        assert torch.equal(got[k], torch.from_numpy(cli["params"][k])), k
    assert trainer.optimizer.count == 2


def test_cli_mesh_smaller_than_the_world_leaves_the_last_ranks_idle(cli):
    """As JAX's make_mesh takes the first devices: fsdp 8 at world 4 and a
    batch of 2 scale to fsdp 2 on ranks 0 and 1; ranks 2 and 3 return."""
    idle = [r["idle"] for r in cli["reports"]]
    assert [i["in_mesh"] for i in idle] == [True, True, False, False]
    assert all(i["mesh_size"] == 2 and i["fsdp"] == 2 for i in idle)
    assert [len(i["history"]) for i in idle] == [1, 1, 0, 0]
    trained = [i["history"][0] for i in idle[:2]]
    assert all(h["batches"] == 1 and np.isfinite(h["loss"]) for h in trained)
    assert trained[0]["loss"] == trained[1]["loss"]
