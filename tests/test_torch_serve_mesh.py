"""Serving on the port's device mesh (evaluate.py::Evaluator, the serving
CLIs, MC dropout, stitched inference), against the JAX package.

The multi-process cases read tests/test_torch_seq.py's one launch of
tests/torch_mesh_worker.py (`seqexpert`, 4 gloo ranks on the CPU), whose
JAX side for their inputs runs this file as a process of its own
(`jax_side`) beside the ranks: the configs and the weights (each tiny
model's JAX draw, perturbed: at the draw the CNN path sets the metrics), on
a test split of four files of 3, 2, 2 and 1 samples (batch 4). The ranks
serve every SERVE_CASES config; after the launch this module's process
runs JAX's `Trainer.test` on each config's mesh over the 8 fake CPU devices
(once for two configs that are its same program as another's: `JAX_SAME`),
w8a8 once for each kind of model, `visualize_at_index` on tensor 2 and
examples/evaluate.py's main on tensor 2 with the weights as a --torch-npz
(`jax_served`). The cases:
  * meshes whose data axes are 1 (tensor 2 x seq 2 under gather and ring,
    expert 2 x tensor 2 on an MoE trunk, stage 2 x tensor 2 under GPipe and
    interleaved, and tensor 2 and stage 2 alone, whose meshes leave ranks 2
    and 3 idle): every rank reads the whole batch, so test() equals JAX's
    at fp32 (rtol 1e-4), and w8a8 (rtol 1e-3) where JAX serves it; where
    JAX raises, the port raises the same;
  * data meshes (fsdp 2 x tensor 2, replica 2 x fsdp 2): the data ranks read
    file shards of unequal length (a padding round, a partial tail), so the
    rounds differ from JAX's one-process batches: the samples and mean_bias
    (sample-linear) against JAX, every metric against the port's
    one-process evaluate_batch over the rounds the ranks gathered;
  * MC dropout (rate 0 equals the deterministic prediction, a seeded
    ensemble repeats bit for bit), the stitched field on tensor 2 against
    JAX's, the evaluate CLI on tensor 2 against examples/evaluate.py (rtol
    1e-4, atol 1e-6) and the visualize CLI against JAX's field (rank 0
    alone prints and writes), test_on_many_images on fsdp 2 x tensor 2
    (rank 0 writes every sample once).
"""

import contextlib
import io
import json
import os
import pickle
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_mesh_worker as worker  # noqa: E402
from test_torch_seq import raw_config, seqexpert  # noqa: E402,F401

DEFAULT_VARS, OUT_VARS = worker.DEFAULT_VARS, worker.OUT_VARS
RTOL = 1e-4
W8A8_RTOL = 1e-3
PEARSON_ATOL = 1e-6
# the test split's files: 8 samples, batch 4; at two data ranks of batch 2
# rank 0 reads 5 (2, 2, 1) and rank 1 reads 3 (2, 1, then a padding round)
FILE_SAMPLES = (3, 2, 2, 1)
PERTURB = 0.05
DATA_MESHES = ("fsdp2_tensor2", "replica2_fsdp2")
CASES = list(worker.SERVE_CASES)
# w8a8 on the JAX side: one case of each kind (the others serve the same
# weights on the same data, so their w8a8 is held against these)
JAX_W8A8 = {"tensor2_seq2_gather": "tensor2_seq2_gather", "tensor2_seq2_ring":
            "tensor2_seq2_gather", "expert2_tensor2": "expert2_tensor2",
            "stage2_tensor2_gpipe": "stage2_tensor2_gpipe", "stage2_tensor2_interleaved":
            "stage2_tensor2_gpipe", "stage2": "stage2_tensor2_gpipe",
            "fsdp2_tensor2": "fsdp2_tensor2", "replica2_fsdp2": "fsdp2_tensor2",
            "tensor2": "fsdp2_tensor2"}
# configs that are JAX's same program on the same mesh as another's: its
# attention on the CPU is XLA's whatever seq_impl says, and its loaders drop
# pipeline_interleave (ROADMAP §3), so JAX serves these once
JAX_SAME = {"tensor2_seq2_ring": "tensor2_seq2_gather",
            "stage2_tensor2_interleaved": "stage2_tensor2_gpipe"}
# what JAX's Trainer.test(quant="w8a8") raises, and the port's refusal of it
W8A8_REFUSALS = {"ValueError": "ValueError",  # an MoE trunk
                 "ScopeParamShapeError": "ValueError"}  # a pipelined one


def write_serve_dataset(root, h=16, w=32, mag=4):
    """The test split of FILE_SAMPLES samples a file, every sample its own
    field, in tests/conftest.py::synth_dataset's layout."""
    rng = np.random.default_rng(11)

    def write(base, hh, ww, variables):
        files = []
        for t in FILE_SAMPLES:
            arrays = {}
            for v in variables:
                if v == "total_precipitation_24hr":
                    a = rng.gamma(0.3, 0.004, size=(t, 1, hh, ww))
                elif v in ("land_sea_mask", "landcover"):
                    a = rng.integers(0, 2, size=(t, 1, hh, ww)).astype(np.float64)
                else:
                    a = rng.normal(280, 10, size=(t, 1, hh, ww))
                arrays[v] = a.astype(np.float32)
            files.append(arrays)
        clim = {v: rng.normal(280, 1, size=(1, hh, ww)).astype(np.float32) for v in variables}
        for split in ("train", "val", "test"):  # the loaders read every split's climatology
            d = base / split
            d.mkdir(parents=True, exist_ok=True)
            for i, arrays in enumerate(files):
                np.savez(d / f"shard_{i}.npz", **arrays)
            np.savez(d / "climatology.npz", **clim)
        np.save(base / "lat.npy", np.linspace(-88, 88, hh).astype(np.float32))
        np.save(base / "lon.npy", np.linspace(0, 358, ww).astype(np.float32))
        np.savez(base / "normalize_mean.npz",
                 **{v: np.array([280.0], dtype=np.float32) for v in variables})
        np.savez(base / "normalize_std.npz",
                 **{v: np.array([10.0], dtype=np.float32) for v in variables})

    write(root / "low", h, w, DEFAULT_VARS)
    write(root / "high", h * mag, w * mag, OUT_VARS)
    return str(root / "low"), str(root / "high")


def serve_raws(root):
    """{case: raw config} of SERVE_CASES on the serving dataset."""
    low, high = write_serve_dataset(root / "serve_data")
    out = {}
    for name, (kind, par, drop) in worker.SERVE_CASES.items():
        raw = raw_config(low, high, DEFAULT_VARS, OUT_VARS, par, worker.SERVE_MODELS[kind])
        raw["model"]["drop_rate"] = drop
        out[name] = raw
    return out


def _perturbed(params, seed):
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + PERTURB * rng.standard_normal(np.shape(a))
                                   ).astype(np.asarray(a).dtype), params)


def _jax_trainer(raw, root, name):
    """JAX's Trainer of `raw`, and the list its test() logs its samples to."""
    from orbit2_tpu.config import load_config as jax_load_config
    from orbit2_tpu.training.trainer import Trainer as JaxTrainer

    jt = JaxTrainer(jax_load_config(raw), checkpoint_dir=str(root / f"jax_ck_{name}"))
    samples = []
    log = jt.metrics.log
    jt.metrics.log = lambda event, **f: (samples.append(f.get("samples")), log(event, **f))[1]
    return jt, samples


def jax_side(root):
    """The JAX side of the serving cases' inputs, in a process of its own
    beside the ranks (`python tests/test_torch_serve_mesh.py ROOT`, started
    by tests/test_torch_seq.py's launch): ROOT/serve_<case>.yaml, each model
    kind's weights (the JAX draw of its first case's config, perturbed) as
    JAX trees (ROOT/serve_params.pkl), port-named (ROOT/serve_in.npz, which
    the ranks wait for) and the dense ones as a reference-layout npz for the
    CLIs (ROOT/serve_dense.npz). JAX serves the cases in the test process,
    after the launch (`jax_served`)."""
    import jax
    import yaml

    from orbit2_tpu_torch.training.checkpoint import state_dict_from_jax_params

    raws = serve_raws(root)
    for name, raw in raws.items():
        (root / f"serve_{name}.yaml").write_text(yaml.safe_dump(raw))
    params, inputs = {}, {}
    for i, kind in enumerate(worker.SERVE_MODELS):
        name = next(n for n, (k, _, _) in worker.SERVE_CASES.items() if k == kind)
        jt, _ = _jax_trainer(raws[name], root, name)
        jt.test(max_batches=0)  # builds the model and draws the parameters
        params[kind] = _perturbed(jax.tree.map(np.asarray, jt.params), seed=100 + i)
        patch = worker.SERVE_MODELS[kind].get("patch_size", worker.TINY["patch_size"])
        for k, t in state_dict_from_jax_params(params[kind], patch_size=patch).items():
            inputs[f"{kind}/{k}"] = t.numpy()
    (root / "serve_params.pkl").write_bytes(pickle.dumps(params))
    np.savez(root / "serve_dense.npz", **{k.split("/", 1)[1]: v for k, v in inputs.items()
                                           if k.startswith("dense/")})
    np.savez(root / "serve_in.tmp.npz", **inputs)
    os.replace(root / "serve_in.tmp.npz", root / "serve_in.npz")


def jax_served(root):
    """JAX's serving of every SERVE_CASES config on its mesh over the 8 fake
    CPU devices, from jax_side's weights: {case: {means, samples, w8a8 or
    w8a8_error}, "cli": examples/evaluate.py's metrics on tensor 2 with the
    dense weights as a --torch-npz}, and the field visualize_at_index
    stitches on tensor 2."""
    import jax
    import yaml

    from orbit2_tpu.parallel import shard_params
    from orbit2_tpu.utils.visualize import visualize_at_index

    params = pickle.loads((root / "serve_params.pkl").read_bytes())
    results, field = {}, None
    for name, (kind, _, _) in worker.SERVE_CASES.items():
        if name in JAX_SAME:
            results[name] = results[JAX_SAME[name]]
            continue
        raw = yaml.safe_load((root / f"serve_{name}.yaml").read_text())
        jt, samples = _jax_trainer(raw, root, name)
        jt.params = params[kind]
        res = {"means": jt.test(), "samples": samples[-1]}
        if JAX_W8A8[name] == name:
            try:
                res["w8a8"] = jt.test(quant="w8a8")
            except Exception as e:  # noqa: BLE001 - the error is the result
                res["w8a8_error"] = [type(e).__name__, str(e)]
        results[name] = res
        if name == "tensor2":  # the stitched field on the same mesh
            key = next(iter(jt.cfg.data.low_res_dir))
            dm = jt._make_data_module(key, div=1, overlap=0)
            dm.setup("test")
            model = jt._phase_model(dm, key)
            sharded = shard_params(jax.tree.map(np.asarray, params[kind]), jt.mesh)
            fwd = jax.jit(lambda x: model.apply({"params": sharded}, x, DEFAULT_VARS, OUT_VARS,
                                                deterministic=True))
            with jt.mesh:
                field = visualize_at_index(fwd, dm, index=1, div=1, overlap=0,
                                           mag=worker.TINY["superres_mag"])["preds"]
    # examples/evaluate.py on tensor 2 with the dense weights as a --torch-npz
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import evaluate as jax_cli

    out = io.StringIO()
    argv = sys.argv
    sys.argv = ["evaluate.py", str(root / "serve_tensor2.yaml"), "--torch-npz",
                str(root / "serve_dense.npz")]
    try:
        with contextlib.redirect_stdout(out):
            jax_cli.main()
    finally:
        sys.argv = argv
    results["cli"] = json.loads(out.getvalue())
    return results, field


def _means(got, want, rtol, name, only=""):
    """Each metric (of those whose name holds `only`) within `rtol` of JAX's;
    mean_bias, a mean of signed errors that cancel, within rtol x the
    variable's rmse besides, and pearson, a correlation near 0 on random
    weights, within PEARSON_ATOL."""
    keys = [k for k in want if only in k]
    assert keys and set(keys) <= set(got), (name, sorted(got))
    for k in keys:
        var = k.split(":")[1]
        atol = (rtol * want[f"test/rmse:{var}"] if "mean_bias" in k
                else PEARSON_ATOL if "pearson" in k else 0.0)
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=f"{name} {k}")


@pytest.fixture(scope="module")
def serve(seqexpert):
    root = seqexpert["root"]
    jax_results, field = jax_served(root)
    return dict(port=seqexpert["serve_reports"], arrays=seqexpert["serve_arrays"],
                jax=jax_results, jax_field=field, root=root)


@pytest.mark.parametrize("name", [n for n in CASES if n not in DATA_MESHES])
def test_serving_on_a_mesh_with_data_axes_one_matches_jax(serve, name):
    """Every rank of the mesh returns JAX's Trainer.test metrics on the same
    mesh and weights; the ranks past the mesh are idle."""
    want = serve["jax"][name]
    for rank, report in enumerate(serve["port"]):
        r = report[name]
        if r["idle"]:
            assert rank >= 2 and r["means"] == {}, (name, rank)
            continue
        _means(r["means"], want["means"], RTOL, f"{name} rank {rank}")
        assert r["samples"] == want["samples"] == sum(FILE_SAMPLES)
    assert sum(not rep[name]["idle"] for rep in serve["port"]) == worker.serve_world(name)


@pytest.mark.parametrize("name", CASES)
def test_w8a8_on_a_mesh_serves_or_refuses_as_jax(serve, name):
    """Where JAX's w8a8 raises (an MoE trunk, a pipelined one), the port
    refuses; elsewhere it serves JAX's w8a8 metrics (on a data mesh the
    sample-linear mean_bias)."""
    want = serve["jax"][JAX_W8A8[name]]
    served = 0
    for report in serve["port"]:
        r = report[name]
        if r["idle"]:
            continue
        if "w8a8_error" in want:
            assert r.get("w8a8_error", [None])[0] == W8A8_REFUSALS[want["w8a8_error"][0]], (
                name, r, want["w8a8_error"])
            continue
        served += 1
        _means(r["w8a8"], want["w8a8"], W8A8_RTOL, f"{name} w8a8",
               "mean_bias" if name in DATA_MESHES else "")
    assert served == (0 if "w8a8_error" in want else worker.serve_world(name))


@pytest.mark.parametrize("name", DATA_MESHES)
def test_data_mesh_serving_gathers_the_global_batch(serve, name):
    """The samples and mean_bias against JAX's one-process batches; every
    metric against the port's one-process evaluate_batch over the rounds the
    data ranks gathered (padding rows dropped); the same on every rank."""
    import torch

    from orbit2_tpu_torch.config import load_config
    from orbit2_tpu_torch.evaluate import load_module, make_data_module, model_kwargs
    from orbit2_tpu_torch.training.train import evaluate_batch

    want = serve["jax"][name]
    port = [rep[name] for rep in serve["port"]]
    assert all(r["samples"] == want["samples"] == sum(FILE_SAMPLES) for r in port)
    assert all(r["means"] == port[0]["means"] for r in port)
    _means(port[0]["means"], want["means"], RTOL, name, "mean_bias")

    cfg = load_config(str(serve["root"] / f"serve_{name}.yaml"))
    dm = make_data_module(cfg, next(iter(cfg.data.low_res_dir)), 1, 0, "test")
    with torch.device("meta"):
        _, _, _, losses, _, _, transforms = load_module(cfg, dm, dict(model_kwargs(cfg),
                                                                      generator=None))
    arrays = serve["arrays"][0]
    rounds = sorted({int(k.split("/")[2]) for k in arrays.files if k.startswith(f"{name}/round/")})
    reals = [int(arrays[f"{name}/round/{i}/real"]) for i in rounds]
    assert reals == worker.SERVE_ROUND_REALS[name]
    agg, n = {}, 0
    for i, real in zip(rounds, reals):
        yhat, y = (torch.from_numpy(arrays[f"{name}/round/{i}/{t}"]) for t in ("yhat", "y"))
        assert yhat.shape[0] == y.shape[0] == real
        for k, v in evaluate_batch(yhat, y, "test", losses, transforms, OUT_VARS).items():
            agg[k] = agg.get(k, 0.0) + v.item() * real
        n += real
    one = {k: v / n for k, v in agg.items()}
    for k, v in one.items():
        np.testing.assert_allclose(port[0]["means"][k], v, rtol=RTOL, err_msg=f"{name} {k}")


def test_mesh_smaller_than_the_world_leaves_the_last_ranks_idle(serve):
    """The repaired fault: make_mesh(stage=2) and make_mesh(tensor=2) at
    world 4 build on ranks 2 and 3 (a DeviceMesh slice of the data dims
    failed there), which are idle; ranks 0 and 1 serve."""
    for rank, report in enumerate(serve["port"]):
        for axes, r in report["idle_meshes"].items():
            assert r["in_mesh"] == (rank < 2), (axes, rank)
            if rank < 2:
                assert r["data_size"] == 1 and r["data_rank"] == 0, (axes, r)
        for name in ("tensor2", "stage2"):
            assert report[name]["idle"] == (rank >= 2)


def test_mc_dropout_on_a_mesh(serve):
    """At dropout 0 the ensemble's members are the deterministic prediction;
    at 0.1 a seeded ensemble repeats bit for bit and its members differ."""
    for report in serve["port"][:2]:
        r = report["mc"]
        assert r["rate0_equals_eval"] and r["repeats"] and r["members_differ"], r


def test_stitched_field_on_a_mesh_matches_jax(serve):
    want = serve["jax_field"]
    for rank in (0, 1):
        got = serve["arrays"][rank][f"field/{rank}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    assert serve["port"][0]["field_files"] and not serve["port"][1]["field_files"]


def test_evaluate_cli_on_a_mesh_matches_jax_example(serve):
    """`python -m orbit2_tpu_torch.evaluate` under the launch's group on
    tensor 2, weights from --torch-npz, against examples/evaluate.py on the
    same config and weights: rank 0 prints, the other ranks do not."""
    want = serve["jax"]["cli"]
    printed = [rep["cli"] for rep in serve["port"]]
    assert printed[1:] == ["", "", ""]
    got = json.loads(printed[0])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_visualize_cli_on_a_mesh_matches_jax_field(serve):
    """`python -m orbit2_tpu_torch.visualize` on tensor 2 (index 1, weights
    from --torch-npz): rank 0 prints and writes the stitched field, JAX's
    visualize_at_index field on the same mesh and weights; the other ranks
    print and write nothing."""
    reports = [rep["viz_cli"] for rep in serve["port"]]
    assert reports[0]["printed"] and reports[0]["files"]
    assert all(r["printed"] == "" and r["files"] == [] for r in reports[1:])
    np.testing.assert_allclose(serve["arrays"][0]["viz_cli"], serve["jax_field"], rtol=RTOL,
                               atol=1e-5)


def test_on_many_images_on_a_mesh_writes_each_sample_once(serve):
    """fsdp 2 x tensor 2: rank 0 writes the gathered rounds, whose targets
    are the test split's samples, each once."""
    report = serve["port"][0]["many"]
    assert report["written"] == len(worker.SERVE_ROUND_REALS["fsdp2_tensor2"])
    assert report["samples"] == sum(FILE_SAMPLES) and report["unique_targets"] == sum(
        FILE_SAMPLES)
    assert all(rep["many"]["files"] == 0 for rep in serve["port"][1:])


if __name__ == "__main__":  # the JAX side of the shared launch (jax_side)
    from pathlib import Path

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax_side(Path(sys.argv[1]))
