"""The model hub on the port's device mesh (training/trainer.py,
evaluate.py, finetune.py and the train CLI with the resnet, unet and vit
presets), against the JAX package.

The multi-process cases read tests/test_torch_seq.py's one launch of
tests/torch_mesh_worker.py (`seqexpert`, 4 gloo ranks on the CPU;
`run_hubmesh`), whose JAX side runs this file as a process of its own
beside the ranks (`jax_side`): it writes the data, the configs and each
model's initial weights (JAX's draw at small widths: the Unet and ResNet
patched alike in both packages' factories, the ViT at embed 64, 2 heads)
and the two train batches, which the ranks wait for, then runs JAX's
Trainer on each case's mesh over the 8 fake CPU devices while the ranks
run. Each case trains 2 epochs of one step at dropout 0, epoch e on batch
e (each data rank its slice: the batch is the global one, as JAX's
one-process mesh takes it), then serves the test split (4 samples, one
round on every mesh) with Evaluator.test:
  * fsdp 2, replica 2 x fsdp 2 and tensor 2 (the CNNs replicated over it,
    the ViT's Blocks split) for the ResNet, the ViT and (but tensor 2) the
    Unet, and seq 2 x fsdp 2 for the ResNet, which JAX trains repeating the
    work over seq: losses and parameters at rtol 2e-4, the BatchNorm
    running averages within atol 1e-5 / rtol 1e-4 of JAX's batch_stats and
    bit-equal on every rank; test() on the mesh, from JAX's trained weights,
    at rtol 1e-4 of JAX's Trainer.test. A per-channel bias added just before
    the model's last BatchNorm (the last residual block's norm2 and
    shortcut biases) has a gradient of 0 in exact arithmetic, which Adam
    turns into steps of up to lr driven by rounding: in both packages
    alike, so those are held by that bound alone, and the trained models
    differ by them at ~1e-4 of the test metrics (hence test() from one set
    of weights);
  * the ResNet on fsdp 2 again with each rank's own BatchNorm statistics
    (the sync switched off by the worker, not in the package): its losses
    miss JAX's, so the parity case sees that fault;
  * the fsdp 2 checkpoints resume on the mesh bit for bit, load into one
    process, and `python -m orbit2_tpu_torch.finetune --arch ... --pretrain`
    imports every key, the running averages too, on the mesh; the evaluate
    CLI serves the ViT's; on fsdp 2 at dropout 0.1 the two data ranks draw
    different masks for the same sample; MC dropout and the stitched field
    of the ViT on tensor 2 against one process;
  * configs/forecast.yaml (the rasp-theurey-2020 ResNet, bf16, batch 32) on
    a small forecasting grid through the train CLI at world 2, as `torchrun
    --nproc-per-node 2` starts it: the scale-down to fsdp 2, one step, the
    running averages equal on both ranks. JAX's make_mesh takes the same
    scaled mesh on 2 devices (test_torch_mesh.py's
    test_cli_accepts_the_configs_jax_brings_to_one_device at world 2).
JAX's refusals of a stage or an expert axis under a hub preset (ConfigError)
are the port's.
"""

import json
import os
import sys

import numpy as np
import pytest
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_mesh_worker as worker  # noqa: E402
from test_torch_seq import seqexpert  # noqa: E402,F401

IN_VARS = worker.DEFAULT_VARS
OUT_VARS = worker.OUT_VARS
CASES = list(worker.HUB_CASES)
KINDS = ("resnet", "unet", "vit")
LOSS_RTOL = PARAM_RTOL = 2e-4
STATS_TOL = dict(atol=1e-5, rtol=1e-4)
TEST_RTOL = 1e-4
PEARSON_ATOL = 1e-6
LOW, MAG = (4, 8), 4
# the test split: 4 files of one sample, a batch of 4: rank r of D data
# ranks reads files r * 4 / D ..., so every mesh's one round is JAX's batch
TEST_FILES = 4
FORECAST_GRID, FORECAST_T = (8, 16), 120
LR = 2e-3
# the biases added just before each CNN's last BatchNorm: a gradient of 0
# (the BatchNorm takes the batch mean out), so rounding drives their steps
ZERO_GRADIENT = {"resnet": ("backbone.blocks.1.norm2.bias",),
                 "unet": ("backbone.up.1.res.norm2.bias", "backbone.up.1.res.shortcut.bias"),
                 "vit": ()}


def write_hub_dataset(root):
    """LOW -> LOW x MAG fields in tests/conftest.py::synth_dataset's layout:
    TEST_FILES files of one sample a split, each its own field."""
    rng = np.random.default_rng(21)

    def write(base, h, w, variables):
        for split in ("train", "val", "test"):
            d = base / split
            d.mkdir(parents=True, exist_ok=True)
            for i in range(TEST_FILES):
                np.savez(d / f"shard_{i}.npz", **{
                    v: (rng.gamma(0.3, 0.004, size=(1, 1, h, w)) if v ==
                        "total_precipitation_24hr" else rng.normal(280, 10, size=(1, 1, h, w))
                        ).astype(np.float32) for v in variables})
            np.savez(d / "climatology.npz",
                     **{v: rng.normal(280, 1, size=(1, h, w)).astype(np.float32)
                        for v in variables})
        np.save(base / "lat.npy", np.linspace(-60, 60, h).astype(np.float32))
        np.save(base / "lon.npy", np.linspace(0, 350, w).astype(np.float32))
        np.savez(base / "normalize_mean.npz",
                 **{v: np.array([280.0], np.float32) for v in variables})
        np.savez(base / "normalize_std.npz",
                 **{v: np.array([10.0], np.float32) for v in variables})

    write(root / "low", *LOW, IN_VARS)
    write(root / "high", LOW[0] * MAG, LOW[1] * MAG, OUT_VARS)
    return str(root / "low"), str(root / "high")


def hub_raw(low, high, kind, parallelism):
    return {
        "trainer": {"max_epochs": worker.HUB_EPOCHS, "batch_size": 4, "buffer_size": 8,
                    "num_workers": 0, "data_type": "float32", "train_loss": "mse",
                    "interval_epochs": 1},
        "parallelism": parallelism,
        "tiling": {"do_tiling": False},
        "model": {"preset": kind, "lr": LR, "weight_decay": 1e-5, "beta_1": 0.9,
                  "beta_2": 0.99, "warmup_epochs": 1, "drop_path": 0.0, "drop_rate": 0.0,
                  "attention_impl": "auto", "superres_mag": MAG, **worker.HUB_VIT},
        "data": {"low_res_dir": {"S": low}, "high_res_dir": {"S": high},
                 "spatial_resolution": {"S": 4}, "default_vars": list(IN_VARS),
                 "dict_in_variables": {"S": list(IN_VARS)},
                 "dict_out_variables": {"S": list(OUT_VARS)},
                 "var_weights": {"2m_temperature_min": 10, "2m_temperature_max": 10}},
    }


def forecast_raw(root):
    """configs/forecast.yaml as shipped, on a small synthetic grid of its
    variables."""
    raw = yaml.safe_load(open(os.path.join(ROOT, "configs", "forecast.yaml")))
    data = raw["data"]
    key = next(iter(data["low_res_dir"]))
    rng = np.random.default_rng(5)
    base = root / "forecast_data"
    h, w = FORECAST_GRID
    variables = data["dict_in_variables"][key]
    for split in ("train", "val", "test"):
        (base / split).mkdir(parents=True)
        for i in range(2):
            np.savez(base / split / f"shard_{i}.npz",
                     **{v: rng.normal(280, 10, size=(FORECAST_T, 1, h, w)).astype(np.float32)
                        for v in variables})
        np.savez(base / split / "climatology.npz",
                 **{v: rng.normal(280, 1, size=(1, h, w)).astype(np.float32) for v in variables})
    np.save(base / "lat.npy", np.linspace(-80, 80, h).astype(np.float32))
    np.save(base / "lon.npy", np.linspace(0, 337.5, w).astype(np.float32))
    np.savez(base / "normalize_mean.npz", **{v: np.array([280.0], np.float32) for v in variables})
    np.savez(base / "normalize_std.npz", **{v: np.array([10.0], np.float32) for v in variables})
    data["low_res_dir"], data["high_res_dir"] = {key: str(base)}, {key: str(base)}
    return raw


def _tiny_jax_presets():
    from orbit2_tpu.models.resnet import ResNet as JaxResNet
    from orbit2_tpu.models.unet import Unet as JaxUnet
    from orbit2_tpu.utils import loaders as jax_loaders

    worker.hub_widths(jax_loaders, JaxResNet, JaxUnet)


def _jax_trainer(raw, ck, run_validation=False):
    from orbit2_tpu.config import load_config as jax_load_config
    from orbit2_tpu.training.trainer import Trainer as JaxTrainer

    return JaxTrainer(jax_load_config(raw), checkpoint_dir=str(ck), run_validation=run_validation)


def _port_state(params, aux):
    import jax

    from orbit2_tpu_torch.training.checkpoint import state_dict_from_jax_params

    stats = (aux or {}).get("batch_stats")
    return state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), worker.HUB_VIT["patch_size"], prefix="backbone.",
        batch_stats=None if stats is None else jax.tree.map(np.asarray, stats))


def jax_side(root):
    """The JAX side of the hub cases, a process of its own beside the ranks
    (`python tests/test_torch_hub_mesh.py ROOT`, started by
    tests/test_torch_seq.py's launch): ROOT/hub_<case>.yaml, ROOT/forecast.yaml
    and ROOT/hub_in.npz (each kind's initial weights, JAX's draw, port-named,
    and the train batches), which the ranks wait for; then JAX's Trainer.fit
    and test() of every case on its mesh (ROOT/hub_jax.npz: the trained
    parameters and running averages, port-named; ROOT/hub_jax.json: losses,
    validation and test means)."""
    import jax

    from orbit2_tpu.data.itermodule import IterDataModule as JaxDataModule
    from orbit2_tpu.training.trainer import Trainer as JaxTrainer

    _tiny_jax_presets()
    low, high = write_hub_dataset(root / "hub_data")
    raws = {name: hub_raw(low, high, kind, par) for name, (kind, par) in worker.HUB_CASES.items()}
    for name, raw in raws.items():
        (root / f"hub_{name}.yaml").write_text(yaml.safe_dump(raw))
    (root / "forecast.yaml").write_text(yaml.safe_dump(forecast_raw(root)))
    rng = np.random.default_rng(9)
    batches = [(rng.normal(size=(4, len(IN_VARS)) + LOW).astype(np.float32),
                (0.5 * rng.normal(size=(4, len(OUT_VARS), LOW[0] * MAG, LOW[1] * MAG))
                 ).astype(np.float32)) for _ in range(worker.HUB_EPOCHS)]
    inputs = {f"batch/{t}{e}": a for e, b in enumerate(batches) for t, a in zip("xy", b)}
    initial = {}
    for kind in KINDS:  # JAX's draw, as examples/finetune.py makes it
        jt = _jax_trainer(raws[f"{kind}_fsdp2"], root / f"jax_hub_draw_{kind}")
        dm = jt._make_data_module("S")
        dm.setup()
        jt._build_model(dm, "S")
        params = jt._init_params(jt._phase_model(dm, "S"), dm)
        initial[kind] = jax.tree.map(np.asarray, params)  # a fit donates its arrays
        inputs.update({f"{kind}/{k}": t.numpy()
                       for k, t in _port_state(params, jt.aux).items()})
    np.savez(root / "hub_in.tmp.npz", **inputs)
    os.replace(root / "hub_in.tmp.npz", root / "hub_in.npz")

    def epoch_batch(self):
        e = self.hub_epoch = getattr(self, "hub_epoch", -1) + 1
        yield batches[e]

    JaxDataModule.train_dataloader = epoch_batch
    JaxTrainer._save = lambda self, epoch: None  # its Orbax checkpoints are not held here
    arrays, report = {}, {}
    for name, (kind, _) in worker.HUB_CASES.items():
        jt = _jax_trainer(raws[name], root / f"jax_hub_ck_{name}",
                          run_validation=name == worker.HUB_VALIDATED)
        jt.params = initial[kind]
        history = jt.fit(max_epochs=worker.HUB_EPOCHS, max_steps_per_epoch=1)
        report[name] = {"losses": [r["loss"] for r in history], "test": jt.test(),
                        "validation": getattr(jt, "last_validation", None), "mesh": dict(jt.mesh.shape)}
        arrays.update({f"{name}/{k}": t.numpy() for k, t in _port_state(jt.params,
                                                                         jt.aux).items()})
    (root / "hub_jax.json").write_text(json.dumps(report))
    np.savez(root / "hub_jax.tmp.npz", **arrays)
    os.replace(root / "hub_jax.tmp.npz", root / "hub_jax.npz")


# -- the cases ---------------------------------------------------------------


@pytest.fixture(scope="module")
def hub(seqexpert):
    root, out = seqexpert["root"], seqexpert["root"] / "out"
    world = len(seqexpert["reports"])
    return dict(root=root, port=[json.loads((out / f"hub_{r}.json").read_text())
                                 for r in range(world)],
                arrays=[np.load(out / f"hub_{r}.npz") for r in range(world)],
                jax=json.loads((root / "hub_jax.json").read_text()),
                jax_arrays=np.load(root / "hub_jax.npz"),
                forecast=[json.loads((out / f"forecast_{r}.json").read_text()) for r in (0, 1)])


def _mesh_ranks(hub, label):
    ranks = [r for r, rep in enumerate(hub["port"]) if not rep[label]["idle"]]
    size = int(np.prod(list(worker.HUB_CASES[label if label in worker.HUB_CASES
                                              else worker.HUB_FAULT][1].values())))
    assert ranks == list(range(size)), (label, ranks)
    return ranks


def _losses(hub, label, rank):
    history = hub["port"][rank][label]["history"]
    assert [r["batches"] for r in history] == [1] * worker.HUB_EPOCHS, history
    return [r["loss"] for r in history]


@pytest.mark.parametrize("name", CASES)
def test_hub_fit_on_a_mesh_matches_jax(hub, name):
    """Every rank of the mesh records JAX's losses; the parameters and the
    BatchNorm running averages after the fit are JAX's, and the running
    averages are the same on every rank, bit for bit; the ranks past the
    mesh are idle."""
    want = hub["jax"][name]
    ranks = _mesh_ranks(hub, name)
    for r in ranks:
        np.testing.assert_allclose(_losses(hub, name, r), want["losses"], rtol=LOSS_RTOL,
                                   err_msg=f"{name} rank {r}")
    kind, par = worker.HUB_CASES[name]
    data = par.get("fsdp", 1) * par.get("simple_ddp", 1)
    assert hub["port"][0][name]["sync"] == [data > 1] * len(hub["port"][0][name]["sync"])
    assert bool(hub["port"][0][name]["sync"]) == (kind != "vit")
    got, jax_arrays = hub["arrays"][0], hub["jax_arrays"]
    params = [k.split("/param/", 1)[1] for k in got.files if k.startswith(f"{name}/param/")]
    assert params and set(params) == {k.split("/", 1)[1] for k in jax_arrays.files
                                      if k.startswith(name + "/")}
    for k in params:
        g, w = got[f"{name}/param/{k}"], jax_arrays[f"{name}/{k}"]
        if k.endswith("num_batches_tracked"):
            continue
        if k in ZERO_GRADIENT[kind]:  # rounding-driven Adam steps of at most lr each
            bound = worker.HUB_EPOCHS * LR
            assert np.abs(g).max() <= bound and np.abs(w).max() <= bound, (k, g, w)
            continue
        tol = STATS_TOL if k.endswith(("running_mean", "running_var")) else dict(
            rtol=PARAM_RTOL, atol=PARAM_RTOL * float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, err_msg=f"{name} {k}", **tol)
    buffers = [k for k in got.files if k.startswith(f"{name}/buffer/")]
    assert bool(buffers) == (kind != "vit")
    for k in buffers:
        for r in ranks[1:]:
            np.testing.assert_array_equal(hub["arrays"][r][k], got[k], err_msg=f"{k} rank {r}")


def _means(got, want, name):
    """Each metric within TEST_RTOL of JAX's; mean_bias, a mean of signed
    errors of fields near 280 K that cancel, within TEST_RTOL x the
    variable's rmse besides, and pearson, near 0 at these weights, within
    PEARSON_ATOL."""
    keys = list(want)
    assert keys and set(got) == set(keys), (name, sorted(got))
    for k in keys:
        stage, var = k.split("/")[0], k.split(":")[1]
        atol = (TEST_RTOL * want[f"{stage}/rmse:{var}"] if "mean_bias" in k
                else PEARSON_ATOL if "pearson" in k else 0.0)
        np.testing.assert_allclose(got[k], want[k], rtol=TEST_RTOL, atol=atol,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", CASES)
def test_hub_test_on_a_mesh_matches_jax(hub, name):
    """Evaluator.test on the mesh, from JAX's trained weights and running
    averages, against JAX's Trainer.test after its fit: the same metrics on
    every rank, the test split's 4 samples; the ranks past the mesh serve
    nothing."""
    want = hub["jax"][name]["test"]
    for r in _mesh_ranks(hub, name):
        rep = hub["port"][r][name]
        assert rep["samples"] == TEST_FILES
        _means(rep["test"], want, f"{name} rank {r}")


def test_per_rank_batchnorm_statistics_miss_jax(hub):
    """The fault the parity case must see: each rank's BatchNorms taking
    their own slice's statistics. Its losses miss JAX's beyond the bound,
    and the ranks' running averages part."""
    label = "fault_per_rank_statistics"
    want = hub["jax"][worker.HUB_FAULT]["losses"]
    ranks = _mesh_ranks(hub, label)
    assert hub["port"][0][label]["sync"] and not any(hub["port"][0][label]["sync"])
    got = _losses(hub, label, 0)
    assert abs(got[0] - want[0]) > LOSS_RTOL * abs(want[0]), (got, want)
    a, b = (hub["arrays"][r] for r in ranks)
    parted = [k for k in a.files if k.startswith(f"{label}/buffer/") and "running_" in k
              and not np.array_equal(a[k], b[k])]
    assert parted


def test_hub_validation_on_a_mesh_matches_jax(hub):
    """The ViT on replica 2 x fsdp 2 validates after each epoch, its val
    losses summed over the data ranks, as JAX's Trainer validates."""
    name = worker.HUB_VALIDATED
    want = hub["jax"][name]["validation"]
    for r in _mesh_ranks(hub, name):
        got = hub["port"][r][name]["validation"]
        assert got["samples"] == want["samples"] == TEST_FILES
        _means(got["means"], want["means"], f"{name} validation rank {r}")


@pytest.mark.parametrize("kind", KINDS)
def test_hub_checkpoint_resumes_on_the_mesh_and_loads_in_one_process(hub, kind):
    """The fsdp 2 fit's last checkpoint holds the whole model, its running
    averages too, in the one-device layout: a Trainer on the mesh resumes
    it bit for bit at the next epoch, and one process loads it strictly."""
    name = f"{kind}_fsdp2"
    for r in _mesh_ranks(hub, name):
        rep = hub["port"][r][f"checkpoint/{name}"]
        assert rep["resumed_epoch"] == worker.HUB_EPOCHS
        assert rep["resumed_equal"] and rep["one_process_equal"], rep
        assert any(k.endswith("running_var") for k in rep["saved"]) == (kind != "vit")
    assert all(f"checkpoint/{name}" not in rep for rep in hub["port"][2:])


@pytest.mark.parametrize("kind", KINDS)
def test_finetune_cli_on_a_mesh_imports_every_key(hub, kind):
    """`python -m orbit2_tpu_torch.finetune --arch KIND --pretrain
    epoch_N` on fsdp 2: every key of the checkpoint imported, a conv
    model's running averages too (examples/finetune.py:55-57), nothing
    dropped, one finite step; the ranks past the mesh import nothing."""
    saved = hub["port"][0][f"checkpoint/{kind}_fsdp2"]["saved"]
    for rank, rep in enumerate(hub["port"]):
        r = rep[f"finetune/{kind}"]
        if rank >= 2:
            assert r["used"] is None and r["history"] == []
            continue
        assert r["used"] == saved and r["dropped"] == []
        assert [h["batches"] for h in r["history"]] == [1] and np.isfinite(r["history"][0]["loss"])


def test_evaluate_cli_on_a_mesh_serves_the_checkpoint(hub):
    """`python -m orbit2_tpu_torch.evaluate --checkpoint` on the ViT's fsdp 2
    checkpoint (the port's trained model) prints, on rank 0 alone, JAX's
    Trainer.test metrics after the same fit."""
    printed = [rep["evaluate_cli"] for rep in hub["port"]]
    assert printed[1:] == ["", "", ""]
    _means(json.loads(printed[0]), hub["jax"]["vit_fsdp2"]["test"], "evaluate CLI")


@pytest.mark.parametrize("kind", KINDS)
def test_hub_dropout_folds_the_data_rank(hub, kind):
    """At dropout 0.1 on fsdp 2, both data ranks given the same sample: their
    masks differ (the ResidualBlock sites and the ViT's pos_drop and Blocks
    fold the data coordinate), and the same seed repeats the output."""
    for r in (0, 1):
        rep = hub["port"][r][f"dropout/{kind}"]
        assert rep["ranks_differ"] and rep["repeats"], rep


def test_hub_vit_mc_dropout_and_field_on_tensor2(hub):
    """The ViT on tensor 2: MC dropout at its rate 0 is the deterministic
    prediction; the stitched field is one process's from the same weights."""
    for r in (0, 1):
        rep = hub["port"][r]
        assert rep["mc"]["rate0_equals_eval"]
        assert rep["field_max_diff"] < 1e-5, rep["field_max_diff"]


def test_forecast_yaml_trains_through_the_cli_at_world_2(hub):
    """configs/forecast.yaml's ResNet (19 blocks, 128 channels, bf16, batch
    32) through `orbit2_tpu_torch.train` at world 2: scaled down to fsdp 2,
    one finite step on each rank, its BatchNorms synced and their running
    averages moved and equal on both ranks. JAX's make_mesh builds the same
    scaled mesh on 2 devices."""
    import jax

    from orbit2_tpu.config import load_config as jax_load_config
    from orbit2_tpu.parallel.mesh import mesh_from_config
    from orbit2_tpu_torch import train as train_cli
    from orbit2_tpu_torch.config import load_config

    for rep in hub["forecast"]:
        assert rep["world"] == 2 and rep["preset"] == "rasp-theurey-2020" and rep["blocks"] == 19
        assert rep["parallelism"] == {"fsdp": 2, "simple_ddp": 1, "tensor_par": 1, "seq_par": 1,
                                      "pipeline": 1, "expert_par": 1}
        assert rep["synced"] and rep["stats_equal"] and rep["stats_moved"]
        assert [h["batches"] for h in rep["history"]] == [1]
        assert np.isfinite(rep["history"][0]["loss"])
    assert hub["forecast"][0]["history"][0]["loss"] == hub["forecast"][1]["history"][0]["loss"]
    path = os.path.join(ROOT, "configs", "forecast.yaml")
    scaled = train_cli.scale_parallelism(load_config(path), 2).parallelism
    jcfg = jax_load_config(path)
    for a in ("fsdp", "simple_ddp", "tensor_par", "seq_par"):
        setattr(jcfg.parallelism, a, getattr(scaled, a))
    mesh = mesh_from_config(jcfg.parallelism, devices=jax.devices()[:2])
    assert dict(mesh.shape)["fsdp"] == 2 and mesh.size == 2


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("parallelism,match", [
    ({"pipeline": 2}, "only supported for the res_slimvit trunk"),
    ({"expert_par": 2}, "needs model.moe_experts > 0")], ids=["stage", "expert"])
def test_hub_stage_and_expert_axes_refused_as_jax(tmp_path, package, kind, parallelism, match):
    raw = hub_raw(str(tmp_path / "low"), str(tmp_path / "high"), kind, parallelism)
    if package == "jax":
        from orbit2_tpu.config import ConfigError as JaxConfigError
        from orbit2_tpu.config import load_config as jax_load_config

        with pytest.raises(JaxConfigError, match=match):
            jax_load_config(raw)
    else:
        from orbit2_tpu_torch.config import ConfigError, load_config

        with pytest.raises(ConfigError, match=match):
            load_config(raw)


if __name__ == "__main__":  # the JAX side of the shared launch (jax_side)
    from pathlib import Path

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
    import jax

    jax.config.update("jax_platforms", "cpu")
    try:
        jax_side(Path(sys.argv[1]))
    except BaseException:  # the ranks waiting for its files stop at once
        import traceback

        (Path(sys.argv[1]) / worker.HUB_FAILED).write_text(traceback.format_exc())
        raise
