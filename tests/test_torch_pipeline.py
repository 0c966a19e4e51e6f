"""The stage axis of the port's device mesh (parallel/pipeline.py), against
the JAX package.

The multi-process cases read tests/test_torch_seq.py's one launch of
tests/torch_mesh_worker.py (`seqexpert`, 4 gloo ranks on the CPU), whose
JAX side for them runs this file as a process of its own (`jax_side`),
beside the ranks and the launch's other JAX side:
  * JAX tests/test_pipeline.py's tiny model (embed 64, depth 4, 4 heads,
    16 x 32 fields) under GPipe (M 2, M 4) and the interleaved schedule (V
    2, M 4), at stage 2 x fsdp 2 and stage 2 x tensor 2: the forward, the
    input gradients and every parameter's gradient on every rank against
    JAX's pipelined model on the same mesh of the 8 fake CPU devices and
    against the port's unpipelined model on one process (fp32, atol 1e-5 /
    rtol 1e-4); each rank holds the Blocks (v*S + s)*dc + j of its stage;
  * Trainer.fit at stage 2 x fsdp 2, GPipe and interleaved, 3 epochs of one
    step, against JAX's GPipe Trainer.fit on the same mesh (rtol 2e-4), and
    the GPipe fit's validation against JAX's. JAX's loaders drop
    `pipeline_interleave` (utils/loaders.py:189-216 takes no such
    argument), so JAX's interleaved config would train GPipe at M 4, the
    same function at dropout 0; its one GPipe fit serves both;
  * the GPipe fit's checkpoints: the whole model in the reference layout,
    resumed on the mesh bit for bit, loaded into one process whose forward
    matches the pipelined one;
  * dropout and drop-path 0.1: two microbatches of equal samples get
    different masks, remat changes no bit, the parameters outside the
    trunk stay bit-equal on both stages after two steps, and a pipelined
    step at stage 2 equals one process sweeping the same microbatches with
    the same (microbatch, Block) folds.
Single-process cases: the tick bookkeeping against JAX's formulas, the
Blocks a stage holds against JAX's [V, S, dc] layout, the stacked layouts
into the port's state dict and through load_pretrained_params, the
sequential fallback against JAX's, the refusals, and the train CLI's
scale-down of configs/interm_1b_pp.yaml.
"""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_mesh_worker as worker  # noqa: E402
from test_torch_seq import TOL, raw_config, seqexpert, write_constant_dataset  # noqa: E402,F401

from orbit2_tpu_torch.config import ConfigError, load_config  # noqa: E402
from orbit2_tpu_torch.models import ResSlimViT  # noqa: E402
from orbit2_tpu_torch.parallel.pipeline import (  # noqa: E402
    STACKED_IV_KEY, STACKED_KEY, admission, banked, block_stage, owned_blocks,
    stack_block_params, to_interleaved, unstack_block_params, written)
from orbit2_tpu_torch.training.checkpoint import (  # noqa: E402
    load_pretrained_params, state_dict_from_jax_params)

WORLD = 4
DEFAULT_VARS, OUT_VARS = worker.DEFAULT_VARS, worker.OUT_VARS
MODEL = dict(worker.TINY, **worker.PIPE_MODEL)
CASES = [(mesh, case) for mesh in worker.PIPE_MESHES for case, _, _ in worker.PIPE_CASES]
FITS = list(worker.PIPE_FITS)


def jax_model(**kw):
    from orbit2_tpu.models import ResSlimViT as JaxResSlimViT

    return JaxResSlimViT(default_vars=DEFAULT_VARS, attention_impl="xla", drop_rate=0.0,
                         drop_path=0.0, **dict(MODEL, **kw))


def batch():
    """JAX test_pipeline.py's x (8 samples) and y."""
    x = np.random.default_rng(0).normal(size=(8, 7, 16, 32)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(8, 3, 64, 128)).astype(np.float32)
    return x, y


@functools.lru_cache(maxsize=1)
def vanilla_params():
    """JAX's vanilla tiny model's parameters (PRNGKey 0), as numpy: made
    once, not to be changed."""
    import jax
    import jax.numpy as jnp

    x, _ = batch()
    return jax.tree.map(np.asarray, jax_model().init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x[:2]), DEFAULT_VARS, OUT_VARS,
        deterministic=True)["params"])


def pipelined_tree(pv, v):
    """JAX's pipelined layout of vanilla params: blocks_stacked, or at V > 1
    blocks_stacked_iv (JAX's converters)."""
    from orbit2_tpu.parallel.pipeline import stack_block_params as jax_stack
    from orbit2_tpu.parallel.pipeline import to_interleaved as jax_to_interleaved

    tree = jax_stack(pv)
    if v > 1:
        tree[STACKED_IV_KEY] = jax_to_interleaved(tree.pop(STACKED_KEY), 2, v)
    return tree


# -- the JAX side of the shared launch ---------------------------------------


def jax_side(root):
    """The JAX side of the stage axis's cases, in a process of its own beside
    the ranks (`python tests/test_torch_pipeline.py ROOT`, started by
    tests/test_torch_seq.py's launch): first ROOT/pp_*.yaml and
    ROOT/pp_in.npz, which the ranks wait for (the fits' configs, the JAX
    Trainer's initial parameters, which the GPipe and the interleaved fit
    share, the batch), then ROOT/pp_jax.npz (JAX's pipelined model under
    each case on its mesh: output, input gradient and the parameters'
    gradients, port-named) and ROOT/pp_jax.json (JAX's fits)."""
    import jax
    import jax.numpy as jnp
    import yaml

    from orbit2_tpu.parallel import batch_sharding, make_mesh, shard_params
    from test_torch_seq import jax_trainer

    low, high = write_constant_dataset(root / "pp_data", DEFAULT_VARS, OUT_VARS)
    raws = {}
    for name, par in worker.PIPE_FITS.items():
        raw = raw_config(low, high, DEFAULT_VARS, OUT_VARS, par, worker.PIPE_MODEL)
        raw["trainer"]["batch_size"] = 8  # M 4 microbatches of each data rank's 4
        raws[name] = raw
        (root / f"{name}.yaml").write_text(yaml.safe_dump(raw))
    # JAX's loaders drop pipeline_interleave: both fits' configs draw this model
    trainers = {"pp_gpipe": jax_trainer(raws["pp_gpipe"], root / "jax_ck_pp_gpipe")}
    params = jax.tree.map(np.asarray, trainers["pp_gpipe"].params)
    pv = unstack_block_params(params)  # the cases' vanilla tree
    x, y = batch()
    inputs = {"pp_x": x, "pp_y": y}
    inputs.update({f"pp/{k}": t.numpy() for k, t in state_dict_from_jax_params(
        params, patch_size=MODEL["patch_size"]).items()})
    np.savez(root / "pp_in.tmp.npz", **inputs)
    os.replace(root / "pp_in.tmp.npz", root / "pp_in.npz")

    want, hist = {}, {}
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    for mesh_name, axes in worker.PIPE_MESHES.items():
        for case, m, v in worker.PIPE_CASES:
            mp = jax_model(pipeline_stages=2, pipeline_microbatches=m, pipeline_interleave=v)

            def loss(p, xx, mp=mp):
                out = mp.apply({"params": p}, xx, DEFAULT_VARS, OUT_VARS, deterministic=True)
                return jnp.mean((out - yj) ** 2), out

            mesh = make_mesh(**axes)
            with mesh:
                sp = shard_params(pipelined_tree(pv, v), mesh)
                xs = jax.device_put(xj, batch_sharding(mesh))
                (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1), has_aux=True))(sp, xs)
            key = f"{mesh_name}/{case}"
            want[f"{key}/out"], want[f"{key}/dx"] = np.asarray(out), np.asarray(gx)
            for k, g in state_dict_from_jax_params(jax.device_get(gp),
                                                   patch_size=MODEL["patch_size"]).items():
                want[f"{key}/grad/{k}"] = g.numpy()
    # one JAX fit serves both port fits: JAX's loaders drop
    # pipeline_interleave, so its interleaved config would train this GPipe
    # schedule at M 4, the same function at dropout 0
    jt = trainers["pp_gpipe"]
    jt.run_validation = True  # as the port's GPipe fit does
    hist["pp_gpipe"] = [r["loss"] for r in jt.fit(**worker.FIT)]
    np.savez(root / "pp_jax.npz", **want)
    (root / "pp_jax.json").write_text(json.dumps(
        {"fit": hist, "validation": jt.last_validation}))


# -- one process (first: they need no launch) --------------------------------


def _jax_tick(t, stage, S, M, V):
    """JAX pipeline.py:257-302 at tick t on `stage`: (v, m) as it clips
    them, whether stage 0 banks and into which slot, and the write-out's
    slot and whether it writes."""
    q = t - stage
    v = int(np.clip(q // M, 0, V - 1))
    m = int(np.clip(q, 0, V * M - 1) % M)
    q_in = t - S
    bank = stage == 0 and 0 <= q_in < (V - 1) * M
    bm = int(np.clip(q_in, 0, V * M - 1) % M)
    widx = t - (S - 1) - (V - 1) * M
    return (v, m), (bank, bm), (int(np.clip(widx, 0, M - 1)), stage == S - 1 and widx >= 0)


SCHEDULES = [(S, V, M) for S in (2, 4) for V in (1, 2) for M in (S, 2 * S)]


@pytest.mark.parametrize("S,V,M", SCHEDULES, ids=[f"S{s}V{v}M{m}" for s, v, m in SCHEDULES])
def test_tick_bookkeeping_matches_jax(S, V, M):
    """Tick by tick, where a stage has work its (v, m) is JAX's; stage 0
    banks what JAX banks; the last stage writes where JAX writes. Then the
    schedule run on labels: every microbatch goes through the global Blocks
    in order and comes out of the last stage once."""
    depth = S * V * 2
    dc = depth // (S * V)
    T = V * M + S - 1
    held = {s: [] for s in range(S)}  # the Blocks each stage's activations went through
    y = {s: None for s in range(S)}
    waiting, outs = {}, {}
    for t in range(T):
        for s in range(S):
            (jv, jm), (jbank, jbm), (jw, jwrite) = _jax_tick(t, s, S, M, V)
            work = admission(t, s, S, M, V)
            q = t - s
            assert (work is not None) == (0 <= q < V * M)
            if work is not None:
                assert work == (jv, jm)
            assert (banked(t, s, S, M, V) is not None) == jbank
            if jbank:
                assert banked(t, s, S, M, V) == jbm
            w = written(t, s, S, M, V)
            if s == S - 1:
                assert (w is not None) == jwrite
            if w is not None:
                assert w == jw
        # the tick on labels: (m, Blocks so far)
        new = {}
        for s in range(S):
            prev = y[(s - 1) % S] if (s > 0 or V > 1) else None
            if s == 0 and banked(t, 0, S, M, V) is not None:
                waiting[banked(t, 0, S, M, V)] = prev
            work = admission(t, s, S, M, V)
            if work is None:
                new[s] = None
                continue
            v, m = work
            if s == 0:
                x = (m, []) if v == 0 else waiting[m]
            else:
                x = prev
            assert x[0] == m
            x = (m, x[1] + [(v * S + s) * dc + j for j in range(dc)])
            held[s].extend(x[1][-dc:])
            new[s] = x
            w = written(t, s, S, M, V)
            if s == S - 1 and w is not None:
                assert w == m and m not in outs
                outs[m] = x[1]
        y = new
    assert outs == {m: list(range(depth)) for m in range(M)}
    for s in range(S):
        assert sorted(set(held[s])) == sorted(owned_blocks(depth, S, V, s))


@pytest.mark.parametrize("S,V,depth", [(2, 1, 4), (2, 2, 4), (2, 2, 8), (4, 2, 16), (4, 1, 8)])
def test_owned_blocks_are_jax_interleaved_layout(S, V, depth):
    """Stage s holds [v, s, j] of JAX's C-order [V, S, dc] reshape of the
    global Blocks (pipeline.py:75-84), as JAX's P("stage") places them."""
    from orbit2_tpu.parallel.pipeline import to_interleaved as jax_to_interleaved

    layout = np.asarray(jax_to_interleaved({"g": np.arange(depth)}, S, V)["g"]) if V > 1 else \
        np.arange(depth).reshape(1, S, -1)
    for s in range(S):
        assert owned_blocks(depth, S, V, s) == layout[:, s].ravel().tolist()
        assert all(block_stage(g, depth, S, V) == s for g in owned_blocks(depth, S, V, s))


def test_stack_block_params_match_jax():
    from orbit2_tpu.parallel.pipeline import stack_block_params as jax_stack
    from orbit2_tpu.parallel.pipeline import unstack_block_params as jax_unstack

    pv = vanilla_params()
    got, want = stack_block_params(pv), jax_stack(pv)
    qkv = ("attn", "qkv", "kernel")
    a, b = got[STACKED_KEY], want[STACKED_KEY]
    for k in qkv:
        a, b = a[k], b[k]
    np.testing.assert_array_equal(a, np.asarray(b))
    back, jback = unstack_block_params(got), jax_unstack(want)
    np.testing.assert_array_equal(back["blocks_3"]["mlp"]["fc1"]["kernel"],
                                  np.asarray(jback["blocks_3"]["mlp"]["fc1"]["kernel"]))
    iv = to_interleaved(got[STACKED_KEY], 2, 2)
    assert iv["attn"]["qkv"]["kernel"].shape[:3] == (2, 2, 1)
    with pytest.raises(ValueError, match="non-contiguous"):
        stack_block_params({"blocks_0": {"w": np.zeros(2)}, "blocks_2": {"w": np.zeros(2)}})


@pytest.mark.parametrize("v", [1, 2], ids=["blocks_stacked", "blocks_stacked_iv"])
def test_state_dict_from_jax_params_unstacks(v):
    """A pipelined model's tree (JAX's own layouts, made by JAX's
    converters) maps onto the vanilla tree's state dict, key for key."""
    pv = vanilla_params()
    want = state_dict_from_jax_params(pv, patch_size=MODEL["patch_size"])
    got = state_dict_from_jax_params(pipelined_tree(pv, v), patch_size=MODEL["patch_size"])
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def _stacked_state(state, v):
    """The port state dict with its Blocks in a stacked layout's keys:
    blocks_stacked.<key> [depth, ...] or blocks_stacked_iv.<key> [V, S,
    dc, ...]."""
    depth = MODEL["depth"]
    out = {k: t for k, t in state.items() if not k.startswith("blocks.")}
    names = {k.split(".", 2)[2] for k in state if k.startswith("blocks.")}
    for name in names:
        a = np.stack([state[f"blocks.{i}.{name}"].numpy() for i in range(depth)])
        key = STACKED_KEY if v == 1 else STACKED_IV_KEY
        out[f"{key}.{name}"] = a if v == 1 else a.reshape(v, 2, depth // (2 * v), *a.shape[1:])
    return out


@pytest.mark.parametrize("v", [1, 2], ids=["stacked", "interleaved"])
def test_pretrain_import_across_layouts(v):
    """JAX test_pipeline.py:253 and :432: vanilla weights into a pipelined
    model, and a stacked source into a vanilla one; both forwards equal the
    vanilla model's."""
    x = torch.from_numpy(batch()[0][:4])
    vanilla = ResSlimViT(DEFAULT_VARS, attention_impl="auto", drop_rate=0.0, drop_path=0.0,
                         generator=torch.Generator().manual_seed(0), **MODEL)
    with torch.no_grad():
        ref = vanilla.eval()(x, DEFAULT_VARS, OUT_VARS)
    pipelined = ResSlimViT(DEFAULT_VARS, attention_impl="auto", drop_rate=0.0, drop_path=0.0,
                           pipeline_stages=2, pipeline_interleave=v, pipeline_microbatches=2,
                           generator=torch.Generator().manual_seed(7), **MODEL)
    merged, report = load_pretrained_params(pipelined.state_dict(), vanilla.state_dict(),
                                            patch_size=MODEL["patch_size"])
    assert not report["dropped"]
    pipelined.load_state_dict(merged)
    target = ResSlimViT(DEFAULT_VARS, attention_impl="auto", drop_rate=0.0, drop_path=0.0,
                        generator=torch.Generator().manual_seed(8), **MODEL)
    merged_v, report_v = load_pretrained_params(
        target.state_dict(), _stacked_state(vanilla.state_dict(), v),
        patch_size=MODEL["patch_size"])
    assert not report_v["dropped"]
    target.load_state_dict(merged_v)
    with torch.no_grad():
        for model in (pipelined, target):
            torch.testing.assert_close(model.eval()(x, DEFAULT_VARS, OUT_VARS), ref, rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("v,m", [(1, 2), (1, 4), (2, 4)], ids=["gpipe_m2", "gpipe_m4",
                                                            "interleaved_m4"])
def test_sequential_fallback_matches_jax(v, m):
    """Without a stage axis the pipelined model sweeps its microbatches
    through the Blocks on one process (JAX's apply_stacked_sequential):
    the output and gradients of JAX's pipelined model off a mesh."""
    import jax
    import jax.numpy as jnp

    pv = vanilla_params()
    x, y = batch()
    mp = jax_model(pipeline_stages=2, pipeline_microbatches=m, pipeline_interleave=v)

    def loss(p):
        out = mp.apply({"params": p}, jnp.asarray(x), DEFAULT_VARS, OUT_VARS, deterministic=True)
        return jnp.mean((out - jnp.asarray(y)) ** 2), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(pipelined_tree(pv, v))
    want = state_dict_from_jax_params(jax.device_get(g), patch_size=MODEL["patch_size"])
    model = ResSlimViT(DEFAULT_VARS, attention_impl="auto", drop_rate=0.0, drop_path=0.0,
                       pipeline_stages=2, pipeline_microbatches=m, pipeline_interleave=v, **MODEL)
    model.load_state_dict(state_dict_from_jax_params(pv, patch_size=MODEL["patch_size"]))
    got = model.train()(torch.from_numpy(x), DEFAULT_VARS, OUT_VARS)
    ((got - torch.from_numpy(y)) ** 2).mean().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    for k, p in model.named_parameters():
        if k in want:
            np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), err_msg=k, **TOL)


def _config(**par):
    return dict(
        trainer=dict(task="downscaling", batch_size=8),
        model=dict(preset="res_slimvit", depth=4, num_heads=4),
        data=dict(default_vars=list(DEFAULT_VARS), dict_in_variables={"d": list(DEFAULT_VARS)},
                  dict_out_variables={"d": list(OUT_VARS)}, low_res_dir={"d": "/tmp/x"},
                  high_res_dir={"d": "/tmp/y"}, spatial_resolution={"d": 625.0}),
        parallelism=par)


# JAX test_pipeline.py:285-311 and :461-485
REFUSALS = [
    ({"pipeline": 2, "seq_par": 2}, None, "seq_par"),
    ({"pipeline": 3}, None, "divisible by"),
    ({"pipeline": 4}, {"batch_size": 6}, "batch_size"),
    ({"pipeline_interleave": 2}, None, "pipeline > 1"),
    ({"pipeline": 2, "pipeline_interleave": 4, "pipeline_microbatches": 4}, None, "divisible by"),
    ({"pipeline": 4, "pipeline_interleave": 2, "pipeline_microbatches": 2}, {"depth": 16},
     "microbatches"),
    ({"pipeline": 2}, {"moe_experts": 2}, "moe_experts inside a pipelined trunk"),
]


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("par,change,match", REFUSALS,
                         ids=["seq", "depth", "batch", "interleave_alone", "depth_iv",
                              "microbatches", "moe"])
def test_pipeline_config_refusals_match_jax(package, par, change, match):
    raw = _config(**par)
    for k, v in (change or {}).items():
        raw["trainer" if k == "batch_size" else "model"][k] = v
    if package == "jax":
        from orbit2_tpu.config import ConfigError as JaxConfigError
        from orbit2_tpu.config import load_config as jax_load_config

        with pytest.raises(JaxConfigError, match=match):
            jax_load_config(raw)
    else:
        with pytest.raises(ConfigError, match=match):
            load_config(raw)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_pipelined_model_refuses_seq_shard(package):
    """JAX test_pipeline.py:314: the pair raises ValueError (JAX at init,
    the port at construction); so do MoE Blocks in a pipelined trunk and a
    depth that stages x interleave does not divide."""
    if package == "jax":
        import jax
        import jax.numpy as jnp

        m = jax_model(pipeline_stages=2, seq_shard=True)
        with pytest.raises(ValueError, match="seq_shard"):
            m.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 7, 16, 32)), DEFAULT_VARS,
                   OUT_VARS, deterministic=True)
        return
    for kw, match in ((dict(seq_shard=True), "seq_shard"),
                      (dict(moe_experts=2), "moe_experts inside a pipelined trunk"),
                      (dict(pipeline_interleave=4), "not divisible by pipeline_stages")):
        with pytest.raises(ValueError, match=match):
            ResSlimViT(DEFAULT_VARS, pipeline_stages=2, **dict(MODEL, **kw))


@pytest.mark.parametrize("world", [2, 4, 8, 16, 32])
def test_cli_trains_interm_1b_pp_only_at_its_world(world, monkeypatch):
    """configs/interm_1b_pp.yaml (stage 2 x fsdp 4 x tensor 2) scaled as
    examples/train.py scales it, which leaves the stage axis as it is: its
    mesh fits 16 devices alone (at 32 the data axes grow to a mesh of 64);
    elsewhere the Trainer's mesh check raises JAX's ValueError, at 16 the
    Trainer's scope takes it."""
    from test_torch_mesh import AXES, _jax_scaled

    from orbit2_tpu_torch import train as train_cli
    from orbit2_tpu_torch.evaluate import check_mesh, check_scope

    path = os.path.join(ROOT, "configs", "interm_1b_pp.yaml")
    want = _jax_scaled(path, world, monkeypatch)
    cfg = train_cli.scale_parallelism(load_config(path), world)
    assert {a: getattr(cfg.parallelism, a) for a in AXES} == want
    assert cfg.parallelism.pipeline == 2 and cfg.parallelism.pipeline_interleave == 2
    if world == 16:
        check_mesh(cfg, world)
        check_scope(cfg)
        return
    with pytest.raises(ValueError, match="devices"):
        check_mesh(cfg, world)


# -- the stage axis on the mesh -----------------------------------------------


def _rank_grads(arrays, key):
    prefix = f"{key}/grad/"
    return {k[len(prefix):]: arrays[k] for k in arrays.files if k.startswith(prefix)}


@pytest.mark.parametrize("mesh,case", CASES, ids=[f"{m}-{c}" for m, c in CASES])
def test_pipelined_step_matches_jax_and_unpipelined(seqexpert, mesh, case):
    """The forward and input gradients (gathered over the data ranks), and
    on every rank the gradient of every parameter it holds: the ones outside
    the trunk and its stage's Blocks alone."""
    _, m, v = next(c for c in worker.PIPE_CASES if c[0] == case)
    want, key = seqexpert["pipeline_jax"], f"{mesh}/{case}"
    one = seqexpert["pipeline"][0]
    for rank in range(WORLD):
        got = seqexpert["pipeline"][rank]
        for name in ("out", "dx"):
            np.testing.assert_allclose(got[f"{key}/{name}"], want[f"{key}/{name}"],
                                       err_msg=name, **TOL)
            np.testing.assert_allclose(got[f"{key}/{name}"], one[f"one/{name}"], err_msg=name,
                                       **TOL)
        grads = _rank_grads(got, key)
        stage = seqexpert["pipeline_reports"][rank][key]["stage"]
        held = owned_blocks(MODEL["depth"], 2, v, stage)
        assert seqexpert["pipeline_reports"][rank][key]["blocks"] == sorted(held)
        outer = {k for k in _rank_grads(one, "one") if not k.startswith("blocks.")}
        assert set(grads) == outer | {k for k in _rank_grads(one, "one")
                                      if k.startswith("blocks.") and int(k.split(".")[1]) in held}
        for k, g in grads.items():
            np.testing.assert_allclose(g, want[f"{key}/grad/{k}"], err_msg=f"rank {rank} {k}",
                                       **TOL)
            np.testing.assert_allclose(g, one[f"one/grad/{k}"], err_msg=f"rank {rank} {k}",
                                       **TOL)


@pytest.mark.parametrize("mesh", list(worker.PIPE_MESHES))
def test_stage_mesh_fill_is_the_one_process_draw(seqexpert, mesh):
    """Each rank fills its shards drawing every unit in init_units order,
    the Blocks other stages hold too: gathered whole, the model is the one
    process's draw, in its keys and order."""
    assert all(r[f"{mesh}/draw_equal"] for r in seqexpert["pipeline_reports"])


@pytest.mark.parametrize("name", FITS)
def test_pipelined_trainer_fit_matches_jax(seqexpert, name):
    got = [r["loss"] for r in seqexpert["pipeline_reports"][0][f"fit/{name}"]]
    assert len(got) == worker.FIT["max_epochs"] and all(
        r["batches"] == 1 for r in seqexpert["pipeline_reports"][0][f"fit/{name}"])
    np.testing.assert_allclose(got, seqexpert["pipeline_jax_fit"]["pp_gpipe"], rtol=2e-4)
    assert all([r["loss"] for r in rep[f"fit/{name}"]] == got
               for rep in seqexpert["pipeline_reports"])


def test_pipelined_validation_matches_jax(seqexpert):
    """The GPipe fit's last validation (the schedule under no_grad, the
    sample-weighted means summed over the data ranks) against JAX's after
    its fit (rtol 2e-4: three epochs of training before it)."""
    want = seqexpert["pipeline_jax_validation"]
    for report in seqexpert["pipeline_reports"]:
        got = report["validation"]
        assert got["samples"] == want["samples"] == 8
        assert set(got["means"]) == set(want["means"])  # a mesh sums them in sorted order
        for k, v in want["means"].items():
            np.testing.assert_allclose(got["means"][k], v, rtol=2e-4, atol=1e-6, err_msg=k)


def test_stage_mesh_checkpoint_is_the_whole_model_and_resumes_bit_equal(seqexpert):
    """Rank 0 saved the whole model and moments, gathered over the stages,
    in the unpipelined model's keys and order; a Trainer on the mesh resumes
    them bit for bit, each rank holding its stage's Blocks."""
    for rank, report in enumerate(seqexpert["pipeline_reports"]):
        ck = report["checkpoint"]
        assert ck["saved_equal"] and ck["moments_saved_equal"], rank
        assert ck["resumed_equal"] and ck["resumed_moments_equal"], rank
        stage = 0 if rank < 2 else 1  # stage varies slowest: ranks 0, 1 hold stage 0
        assert ck["own_blocks"] == owned_blocks(MODEL["depth"], 2, 1, stage)
    ck = seqexpert["pipeline_reports"][0]["checkpoint"]
    assert ck["keys"] == ck["one_keys"]


def test_stage_mesh_checkpoint_loads_into_one_process(seqexpert):
    got = seqexpert["pipeline"][0]
    np.testing.assert_allclose(got["ck/one_out"], got["ck/pipelined_out"], **TOL)


def test_microbatches_draw_their_own_masks(seqexpert):
    """Each data rank's batch is two microbatches of the same two samples:
    their outputs differ, the (microbatch, Block) fold's masks."""
    out = seqexpert["pipeline"][0]["dropout/twice"]
    for rank_rows in (out[:4], out[4:]):
        assert np.abs(rank_rows[:2] - rank_rows[2:]).max() > 1e-3


def test_pipelined_remat_changes_no_bit(seqexpert):
    assert all(r["remat_equal"] for r in seqexpert["pipeline_reports"])


def test_outer_parameters_stay_bit_equal_across_stages(seqexpert):
    for r in seqexpert["pipeline_reports"]:
        rep = r["outer_replicas"]
        assert rep["checked"] > 0 and rep["equal"] == rep["checked"], rep
        assert all(np.isfinite(rep["losses"]))


def test_pipelined_step_equals_one_process_sweep(seqexpert):
    """Interleaved at stage 2 x fsdp 2, dropout and drop-path 0.1, against
    the same model at fsdp 2 without a stage axis, where each data rank
    sweeps its microbatches through every Block on one process with the
    same generators and mesh folds: the loss and every gradient."""
    report = seqexpert["pipeline_reports"][0]
    assert report["sweep/split"] and not report["sweep/one/split"]
    np.testing.assert_allclose(report["sweep/loss"], report["sweep/one/loss"], **TOL)
    got = seqexpert["pipeline"][0]
    grads = _rank_grads(got, "sweep")
    assert set(grads) == set(_rank_grads(got, "sweep/one"))
    for k, g in grads.items():
        np.testing.assert_allclose(g, got[f"sweep/one/grad/{k}"], err_msg=k, **TOL)
    assert all(r["sweep/loss"] == report["sweep/loss"] for r in seqexpert["pipeline_reports"])


if __name__ == "__main__":  # the JAX side of the shared launch (jax_side)
    from pathlib import Path

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax_side(Path(sys.argv[1]))
