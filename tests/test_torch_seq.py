"""The seq axis of the port's device mesh, against the JAX package.

One launch of tests/torch_mesh_worker.py ("seqexpert", 4 gloo ranks on the
CPU) serves this file and tests/test_torch_expert.py (`seqexpert`, made
once per test run whichever file asks first). Before the launch the JAX
Trainer draws the initial parameters of a tiny seq model (embed 128, 2
heads: head dim 64, the flash path; 16 x 32 fields at patch 1, 512 tokens)
and of a tiny MoE model (4 experts in each Block); while the ranks run, the
JAX side computes what they are held against:
  * seq_flash_attention under gather, Ulysses and ring at seq 2 and 4 (and
    ring at N 768, N/s 384: three of the kernels' 128-row tiles, the case
    JAX's non-divisible-blocks test covers), forward and input gradients,
    against JAX's seq_flash_attention and ring_flash_attention on the 8 fake
    CPU devices and against the unsharded plain attention (fp32, atol 1e-5 /
    rtol 1e-4);
  * one train step at seq 2 x fsdp 2 under each impl: the loss and every
    gradient against JAX's (atol 1e-5 / rtol 1e-4);
  * Trainer.fit at seq 2 x fsdp 2 under each impl, 3 epochs of one step,
    against JAX's Trainer.fit on the same mesh (rtol 2e-4). The mesh's data
    ranks read disjoint file shards where JAX's one process reads every
    file (JAX splits files by process, trainer.py:153), so the train split
    repeats one field: every batch is the same whichever rank reads which
    file;
  * dropout: the seq ranks' masks differ on equal inputs, a key's output is
    deterministic, and at seq 2 x tensor 2 with dropout and drop-path the
    parameters replicated over seq and tensor stay bit-equal.
JAX's refusals are the port's: Ulysses' head divisibility, ring's
N_local % 128, MoE x seq and pipeline x seq. The launch also runs the stage
axis's cases of tests/test_torch_pipeline.py, whose JAX side runs as a
process of its own beside this file's (`test_torch_pipeline.jax_side`),
the serving cases of tests/test_torch_serve_mesh.py, whose JAX side is
another (`test_torch_serve_mesh.jax_side`), and the model hub's cases of
tests/test_torch_hub_mesh.py, with a third (`test_torch_hub_mesh.jax_side`).
"""

import fcntl
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_mesh_worker as worker  # noqa: E402

from orbit2_tpu_torch.config import ConfigError, load_config  # noqa: E402
from orbit2_tpu_torch.ops.flash_attention import flash_attention_reference  # noqa: E402
from orbit2_tpu_torch.ops.ring_attention import ring_flash_attention  # noqa: E402
from orbit2_tpu_torch.ops.seq_attention import seq_flash_attention  # noqa: E402
from orbit2_tpu_torch.parallel.tensor import SeqSplit  # noqa: E402

WORLD = 4
TIMEOUT = 420
TOL = dict(atol=1e-5, rtol=1e-4)
FIT_EPOCHS = worker.FIT["max_epochs"]
VAR_WEIGHTS = worker.VAR_WEIGHTS
IMPLS = worker.SEQ_IMPLS


# -- the shared launch -------------------------------------------------------


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def write_constant_dataset(root, in_vars, out_vars, h=16, w=32, mag=4, t=4):
    """Two files a split, every sample of both the same field (per
    variable), in tests/conftest.py::synth_dataset's layout."""
    rng = np.random.default_rng(7)

    def write(base, hh, ww, variables):
        field = {v: (rng.gamma(0.3, 0.004, size=(1, 1, hh, ww))
                     if v == "total_precipitation_24hr"
                     else rng.normal(280, 10, size=(1, 1, hh, ww))).astype(np.float32)
                 for v in variables}
        for split in ("train", "val", "test"):
            d = base / split
            d.mkdir(parents=True, exist_ok=True)
            for i in range(2):
                np.savez(d / f"shard_{i}.npz", **{v: np.repeat(a, t, 0) for v, a in field.items()})
            np.savez(d / "climatology.npz", **{v: a[0] for v, a in field.items()})
        np.save(base / "lat.npy", np.linspace(-88, 88, hh).astype(np.float32))
        np.save(base / "lon.npy", np.linspace(0, 358, ww).astype(np.float32))
        np.savez(base / "normalize_mean.npz",
                 **{v: np.array([280.0], dtype=np.float32) for v in variables})
        np.savez(base / "normalize_std.npz",
                 **{v: np.array([10.0], dtype=np.float32) for v in variables})

    write(root / "low", h, w, in_vars)
    write(root / "high", h * mag, w * mag, out_vars)
    return str(root / "low"), str(root / "high")


def raw_config(low, high, in_vars, out_vars, parallelism, model):
    tiny = dict(worker.TINY, **model)
    keys = ("superres_mag", "patch_size", "embed_dim", "depth", "decoder_depth", "num_heads",
            "moe_experts", "moe_every")
    return {
        "trainer": {"max_epochs": FIT_EPOCHS, "batch_size": 4, "buffer_size": 8,
                    "num_workers": 0, "data_type": "float32", "train_loss": "bayesian_tv",
                    "interval_epochs": 1},
        "parallelism": parallelism,
        "tiling": {"do_tiling": False},
        "model": {"preset": "res_slimvit", "lr": 1e-3, "warmup_epochs": 1, "drop_path": 0.0,
                  "drop_rate": 0.0, "attention_impl": "auto",
                  **{k: tiny[k] for k in keys if k in tiny}},
        "data": {
            "low_res_dir": {"SYNTH": low}, "high_res_dir": {"SYNTH": high},
            "spatial_resolution": {"SYNTH": 625}, "default_vars": list(in_vars),
            "dict_in_variables": {"SYNTH": list(in_vars)},
            "dict_out_variables": {"SYNTH": list(out_vars)},
            "var_weights": VAR_WEIGHTS,
        },
    }


def configs(root, ds):
    """{name: raw config} of the worker's fits."""
    out = {}
    seq_low, seq_high = write_constant_dataset(root / "seq_data", ds["in_vars"], ds["out_vars"])
    moe_low, moe_high = write_constant_dataset(root / "moe_data", ds["in_vars"], ds["out_vars"],
                                               h=8, w=16)
    for impl in IMPLS:
        out[f"seq_{impl}"] = raw_config(seq_low, seq_high, ds["in_vars"], ds["out_vars"],
                                        {"fsdp": 2, "seq_par": 2, "seq_impl": impl},
                                        worker.SEQ_MODEL)
    for name, par in (("moe_ep_fsdp", {"fsdp": 2, "expert_par": 2}),
                      ("moe_ep_tp", {"expert_par": 2, "tensor_par": 2})):
        out[name] = raw_config(moe_low, moe_high, ds["in_vars"], ds["out_vars"], par,
                               worker.MOE_MODEL)
    return out


def jax_trainer(raw, ck):
    from orbit2_tpu.config import load_config as jax_load_config
    from orbit2_tpu.training.trainer import Trainer as JaxTrainer

    jt = JaxTrainer(jax_load_config(raw), checkpoint_dir=str(ck))
    jt.test(max_batches=0)  # builds the model and draws the initial parameters
    return jt


def jax_step(raw, params, x, y, aux_weight=0.01):
    """JAX's loss and gradients of the worker's train step (make_train_step's
    loss: bayesian_tv, the MoE aux term weighted 0.01) at `params`, on one
    device, as port-named numpy arrays."""
    import jax
    import jax.numpy as jnp

    from orbit2_tpu.models import ResSlimViT as JaxResSlimViT
    from orbit2_tpu.registry import METRICS_REGISTRY as JAX_METRICS
    from orbit2_tpu.training.train import clip_replace_constant as jax_clip
    from orbit2_tpu_torch.training.checkpoint import state_dict_from_jax_params

    m = raw["model"]
    moe = {k: m[k] for k in ("moe_experts", "moe_every") if k in m}
    tiny = dict(worker.TINY, **{k: m[k] for k in ("patch_size", "embed_dim", "depth",
                                                  "num_heads")},
                img_size=tuple(x.shape[2:]), **moe)
    jm = JaxResSlimViT(default_vars=worker.DEFAULT_VARS, attention_impl="xla", drop_rate=0.0,
                       drop_path=0.0, **tiny)
    jloss = JAX_METRICS["bayesian_tv"](aggregate_only=True)
    out_vars = worker.OUT_VARS

    def loss_fn(p):
        yhat, sown = jm.apply({"params": p}, jnp.asarray(x), worker.DEFAULT_VARS, out_vars,
                              mutable=["moe_loss"])
        yhat = jax_clip(jnp.asarray(y), yhat.astype(jnp.float32), out_vars)
        loss = jloss(yhat, jnp.asarray(y), var_names=list(out_vars), var_weights=VAR_WEIGHTS)
        leaves = jax.tree.leaves(sown.get("moe_loss", {}))
        return loss + (aux_weight * sum(leaves) / len(leaves) if leaves else 0.0)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, params))
    return float(loss), {k: v.numpy() for k, v in state_dict_from_jax_params(
        jax.tree.map(np.asarray, grads), patch_size=m["patch_size"]).items()}


def jax_attention(x):
    """JAX's side of the attention cases: for each, its seq_flash_attention
    (ring: ring_flash_attention under shard_map) on the fake CPU mesh, and
    the unsharded softmax attention in plain jnp; the output and the input
    gradients of sum(o^2)."""
    import jax
    import jax.numpy as jnp

    from orbit2_tpu.ops.ring_attention import ring_flash_attention as jax_ring
    from orbit2_tpu.ops.seq_attention import seq_flash_attention as jax_seq
    from orbit2_tpu.parallel import make_mesh

    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    def plain(q, k, v):
        s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
        return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v)

    def with_grads(fn):
        def loss(q, k, v):
            o = fn(q, k, v)
            return jnp.sum(o ** 2), o
        return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))

    for i, (impl, s, b, n, h, d) in enumerate(worker.ATTENTION_CASES):
        q, k, v = (jnp.asarray(t.numpy()) for t in worker.attention_inputs(b, n, h, d, seed=i))
        mesh = make_mesh(seq=s)
        if impl == "ring":
            spec = P(None, "seq", None, None)
            fn = shard_map(lambda a, c, e: jax_ring(a, c, e, "seq"), mesh=mesh,
                           in_specs=(spec, spec, spec), out_specs=spec, check_vma=False)
        else:
            fn = lambda a, c, e, impl=impl: jax_seq(a, c, e, impl=impl)  # noqa: E731
        with jax.set_mesh(mesh):
            (_, o), grads = with_grads(fn)(q, k, v)
        (_, o_plain), plain_grads = with_grads(plain)(q, k, v)
        key = f"attn/{impl}{s}_n{n}"
        for name, got, want in zip(("o", "dq", "dk", "dv"), (o, *grads), (o_plain, *plain_grads)):
            x[f"{key}/{name}"] = np.asarray(got)
            x[f"{key}/plain_{name}"] = np.asarray(want)


def _launch(root, in_dir, out_dir):
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, worker.__file__, "seqexpert", str(r), str(WORLD),
                              port, str(in_dir), str(out_dir)], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]


def _wait(procs):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    sides = ("the pipeline's JAX side", "the serving cases' JAX side",
             "the model hub's JAX side")
    for r, p in enumerate(procs):  # the stage axis's and the serving's JAX sides, the ranks
        who = sides[r] if r < len(sides) else f"rank {r - len(sides)}"
        assert p.returncode == 0, f"{who} exited {p.returncode}:\n{logs[r][-4000:]}"


def _prepare_and_run(root, ds):
    import jax

    from orbit2_tpu_torch.training.checkpoint import state_dict_from_jax_params

    # the stage axis's, the serving cases' and the model hub's JAX sides
    # (tests/test_torch_pipeline.py, test_torch_serve_mesh.py,
    # test_torch_hub_mesh.py), processes of their own from the start: the
    # ranks wait for their inputs after this file's cases
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", side), str(root)],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for side in ("test_torch_pipeline.py", "test_torch_serve_mesh.py",
                     "test_torch_hub_mesh.py")]
    try:
        raws = configs(root, ds)
        for name, raw in raws.items():
            (root / f"{name}.yaml").write_text(yaml.safe_dump(raw))
        trainers = {name: jax_trainer(raws[name], root / f"jax_ck_{name}")
                    for name in ("seq_gather", "moe_ep_fsdp", "moe_ep_tp")}
        params = {kind: jax.tree.map(np.asarray, trainers[name].params)
                  for kind, name in (("seq", "seq_gather"), ("moe", "moe_ep_fsdp"),
                                     ("moetp", "moe_ep_tp"))}
        rng = np.random.default_rng(1)
        batches = {"seq": (rng.normal(size=(4, 7, 16, 32)),
                           rng.normal(size=(4, 3, 64, 128)) * 0.5),
                   "moe": (rng.normal(size=(4, 7, 8, 16)), rng.normal(size=(4, 3, 32, 64)) * 0.5)}
        batches = {k: tuple(a.astype(np.float32) for a in v) for k, v in batches.items()}
        inputs = {f"{kind}_{n}": a for kind, b in batches.items() for n, a in zip("xy", b)}
        for kind, p in params.items():
            patch = worker.SEQ_MODEL["patch_size"] if kind == "seq" else worker.TINY["patch_size"]
            for k, t in state_dict_from_jax_params(p, patch_size=patch).items():
                inputs[f"{kind}/{k}"] = t.numpy()
        np.savez(root / "in.npz", **inputs)
        out = root / "out"
        out.mkdir()
        procs += _launch(root, root, out)
        # the JAX side while the ranks run
        want = {}
        jax_attention(want)
        hist = {}
        for name, jt in trainers.items():
            hist[name] = [r["loss"] for r in jt.fit(**worker.FIT)]
        for name in ("seq_ulysses", "seq_ring"):  # JAX's plain attention under seq: one path
            hist[name] = hist["seq_gather"]
        for kind, name in (("seq", "seq_gather"), ("moe", "moe_ep_fsdp")):
            loss, grads = jax_step(raws[name], params[kind], *batches[kind])
            want[f"step/{kind}/loss"] = np.float32(loss)
            want.update({f"step/{kind}/grad/{k}": g for k, g in grads.items()})
        np.savez(root / "jax.npz", **want)
        (root / "jax.json").write_text(json.dumps({"fit": hist}))
    finally:
        _wait(procs)


@pytest.fixture(scope="module")
def seqexpert(tmp_path_factory, synth_dataset):
    """The worker's and JAX's results, made once per test run: the first
    module to ask launches (under a lock in the run's shared temporary
    directory, which xdist's workers share), the others read."""
    base = tmp_path_factory.getbasetemp()
    root = (base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base) / "seqexpert_run"
    root.mkdir(exist_ok=True)
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (root / "done").exists():
            for stale in root.iterdir():  # an earlier module's failed attempt
                if stale.name != "lock":
                    shutil.rmtree(stale) if stale.is_dir() else stale.unlink()
            _prepare_and_run(root, synth_dataset)
            (root / "done").write_text("ok")
    return dict(root=root, port=np.load(root / "out" / "seqexpert.npz"),
                jax=np.load(root / "jax.npz"),
                jax_fit=json.loads((root / "jax.json").read_text())["fit"],
                reports=[json.loads((root / "out" / f"seqexpert_{r}.json").read_text())
                         for r in range(WORLD)],
                pipeline=[np.load(root / "out" / f"pipeline_{r}.npz") for r in range(WORLD)],
                pipeline_reports=[json.loads((root / "out" / f"pipeline_{r}.json").read_text())
                                  for r in range(WORLD)],
                pipeline_jax=np.load(root / "pp_jax.npz"),
                pipeline_jax_fit=json.loads((root / "pp_jax.json").read_text())["fit"],
                pipeline_jax_validation=json.loads(
                    (root / "pp_jax.json").read_text())["validation"],
                serve_reports=[json.loads((root / "out" / f"serve_{r}.json").read_text())
                               for r in range(WORLD)],
                serve_arrays=[np.load(root / "out" / f"serve_{r}.npz") for r in range(WORLD)])


# -- seq_flash_attention -----------------------------------------------------


@pytest.mark.parametrize("case", worker.ATTENTION_CASES, ids=lambda c: f"{c[0]}{c[1]}_n{c[3]}")
def test_seq_flash_attention_matches_jax_and_unsharded(seqexpert, case):
    impl, s, _, n, _, _ = case
    key = f"attn/{impl}{s}_n{n}"
    got, want = seqexpert["port"], seqexpert["jax"]
    for name in ("o", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[f"{key}/{name}"], want[f"{key}/{name}"], err_msg=name,
                                   **TOL)
        np.testing.assert_allclose(got[f"{key}/{name}"], want[f"{key}/plain_{name}"],
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("impl", ["gather", "ulysses"])
def test_seq_dropout_decorrelated_across_shards(seqexpert, impl):
    """Both seq ranks hold equal queries and the same gathered keys: without
    dropout their halves of the output are equal, with it their masks (the
    seed folded with the seq coordinate) differ, and a seed's output is
    deterministic."""
    got = seqexpert["port"]
    clean, drop, drop2 = (got[f"dropout/{impl}/{k}"] for k in ("clean", "drop", "drop2"))
    half = clean.shape[1] // 2
    np.testing.assert_array_equal(clean[:, :half], clean[:, half:])
    assert np.abs(drop[:, :half] - drop[:, half:]).max() > 1e-3
    assert np.abs(drop - clean).max() > 1e-3
    np.testing.assert_array_equal(drop, drop2)


def test_ulysses_refuses_heads_the_seq_axis_does_not_divide():
    q = torch.zeros(2, 64, 2, 32)
    with pytest.raises(ValueError, match="ulysses seq impl needs local heads"):
        seq_flash_attention(q, q, q, SeqSplit(None, 4, 0, "ulysses"))


def test_ring_refuses_n_local_off_128():
    q = torch.zeros(1, 192, 2, 32)
    with pytest.raises(ValueError, match="N_local % 128"):
        ring_flash_attention(q, q, q, SeqSplit(None, 2, 0, "ring"))
    with pytest.raises(ValueError, match="N_local % 128"):
        seq_flash_attention(q, q, q, SeqSplit(None, 2, 0, "ring"))


def test_ring_with_dropout_takes_the_gather_path(monkeypatch):
    """As JAX's: ring with dropout all-gathers k/v (one-rank group here)."""
    import orbit2_tpu_torch.ops.seq_attention as seq_mod

    calls = []
    monkeypatch.setattr(seq_mod, "gather_seq", lambda t, split: calls.append(t.shape) or t)
    q = torch.randn(1, 128, 2, 32, generator=torch.Generator().manual_seed(0))
    got = seq_mod.seq_flash_attention(q, q, q, SeqSplit(None, 2, 0, "ring"), dropout_rate=0.2,
                                      seed=3)
    assert len(calls) == 2
    from orbit2_tpu_torch.ops.flash_attention import attention_mult

    want = flash_attention_reference(q, q, q, None, attention_mult(q, q, 0.2, 3))[0]
    torch.testing.assert_close(got, want)


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("parallelism,match", [
    ({"seq_par": 2, "pipeline": 2}, "seq_par inside a pipelined trunk"),
    ({"seq_par": 2}, "moe_experts with parallelism.seq_par"),
])
def test_seq_config_refusals_match_jax(synth_dataset, package, parallelism, match):
    raw = raw_config(synth_dataset["low"], synth_dataset["high"], synth_dataset["in_vars"],
                     synth_dataset["out_vars"], parallelism,
                     worker.MOE_MODEL if "moe" in match else worker.SEQ_MODEL)
    if package == "jax":
        from orbit2_tpu.config import ConfigError as JaxConfigError
        from orbit2_tpu.config import load_config as jax_load_config

        with pytest.raises(JaxConfigError, match=match):
            jax_load_config(raw)
    else:
        with pytest.raises(ConfigError, match=match):
            load_config(raw)


# -- the seq model on the mesh -----------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_seq_train_step_matches_jax(seqexpert, impl):
    """One step at seq 2 x fsdp 2: the loss and every gradient (the trunk's
    summed over seq, the embedding's and head's whole) against JAX's."""
    got, want = seqexpert["port"], seqexpert["jax"]
    np.testing.assert_allclose(float(got[f"step/seq_{impl}/loss"]), float(want["step/seq/loss"]),
                               **TOL)
    grads = {k.rsplit("/grad/", 1)[1] for k in got.files if k.startswith(f"step/seq_{impl}/grad/")}
    assert grads == {k.rsplit("/grad/", 1)[1] for k in want.files if k.startswith("step/seq/grad/")}
    for k in grads:
        np.testing.assert_allclose(got[f"step/seq_{impl}/grad/{k}"], want[f"step/seq/grad/{k}"],
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_seq_trainer_fit_matches_jax(seqexpert, impl):
    got = [r["loss"] for r in seqexpert["reports"][0][f"fit/seq_{impl}"]]
    assert len(got) == FIT_EPOCHS and all(r["batches"] == 1
                                          for r in seqexpert["reports"][0][f"fit/seq_{impl}"])
    np.testing.assert_allclose(got, seqexpert["jax_fit"][f"seq_{impl}"], rtol=2e-4)
    # every rank records the same trajectory
    assert all([r["loss"] for r in rep[f"fit/seq_{impl}"]] == got for rep in seqexpert["reports"])


def test_seq_replicas_stay_bit_equal_with_dropout(seqexpert):
    """seq 2 x tensor 2, dropout and drop-path 0.1, two steps: every
    parameter is whole on both seq ranks (the Blocks' gradients summed over
    seq), and those not split over tensor on both tensor ranks, bit for bit."""
    for report in seqexpert["reports"]:
        r = report["replicas/seq2_tensor2"]
        for axis in ("seq", "tensor"):
            checked, equal = r["checked"][axis]
            assert checked > 0 and equal == checked, (axis, r)
        assert all(np.isfinite(r["losses"]))
