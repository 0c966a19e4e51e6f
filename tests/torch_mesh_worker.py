"""One rank of tests/test_torch_distributed.py's gloo meshes (torch only, no
JAX: the test process holds the JAX side).

  python tests/torch_mesh_worker.py steps RANK WORLD PORT IN.npz OUT_DIR
      The tiny ResSlimViT of IN.npz's state dict on two meshes (fsdp 2 x
      tensor 2, replica 2 x fsdp 2) at dropout 0: each rank's forward and one
      train step on its slice of the batch, the output gathered and the
      gradients gathered whole into OUT_DIR/<mesh>.npz (rank 0), and whether
      the mesh-built model's draw equals the one-process draw, and whether
      qkv and var_agg's kv hold the rank's heads of each pack. Then two
      steps at dropout and drop-path 0.1 with remat on fsdp 2 x tensor 2:
      whether the parameters replicated across the tensor axis stayed
      bit-equal on both tensor ranks, and K6 stepped aside; last an MoE
      trunk's forward and a train step on replica 2 x fsdp 2. One JSON per rank: OUT_DIR/steps_R.json.

  python tests/torch_mesh_worker.py seqexpert RANK WORLD PORT IN_DIR OUT_DIR
      The seq and expert axes (tests/test_torch_seq.py, test_torch_expert.py):
      seq_flash_attention under gather, Ulysses and ring at seq 2 and 4, its
      output and input gradients gathered whole (and ring at N 768, and
      dropout on inputs whose two halves are equal); then one train step of
      IN_DIR/in.npz's models on its batch: the seq model at seq 2 x fsdp 2
      under each impl, the MoE model at expert 2 x fsdp 2 and expert 2 x
      tensor 2, the gradients gathered whole; then Trainer.fit on IN_DIR's
      configs (seq_{impl}.yaml, moe_ep_fsdp.yaml saving a checkpoint each
      epoch into OUT_DIR/ck, moe_ep_tp.yaml) with its history and the final
      parameters; last two dropout steps at seq 2 x tensor 2 and expert 2 x
      fsdp 2: whether the replicated parameters stayed bit-equal. Rank 0
      writes OUT_DIR/seqexpert.npz and seqexpert.json. Then the stage axis
      (tests/test_torch_pipeline.py): the pipelined model of
      IN_DIR/pp_in.npz's weights under each schedule of PIPE_CASES on
      each mesh of PIPE_MESHES, its output and input gradients gathered
      and every rank's own parameter gradients; the unpipelined model's on
      one process; Trainer.fit on IN_DIR's pp_*.yaml (the GPipe one saving
      checkpoints into OUT_DIR/ppck, then resumed on the mesh and loaded
      into one process); last the dropout cases. Each rank writes
      OUT_DIR/pipeline_R.npz and pipeline_R.json. Last serving on the mesh
      (tests/test_torch_serve_mesh.py, `run_servemesh`): the Evaluator on
      every SERVE_CASES config of IN_DIR/serve_in.npz's weights, MC dropout,
      the stitched field, the evaluate CLI and test_on_many_images; each
      rank writes OUT_DIR/serve_R.json and serve_R.npz. Last the model hub
      (tests/test_torch_hub_mesh.py, `run_hubmesh`): the resnet, unet and
      vit presets trained, checkpointed, fine-tuned and served on the data
      and tensor meshes, while ranks 0 and 1 run configs/forecast.yaml
      through the train CLI in a world of 2 of their own (`forecast`, a
      process each); each rank writes OUT_DIR/hub_R.json and hub_R.npz.

  python tests/torch_mesh_worker.py forecast RANK 2 PORT IN_DIR OUT_DIR
      One rank of that train CLI run, as torchrun starts it.

  python tests/torch_mesh_worker.py cli RANK WORLD PORT CONFIG CKPT_DIR OUT_DIR
      The train CLI (`orbit2_tpu_torch.train.main`) as torchrun would start
      it, one epoch with validation, recording the files each reader was
      given and the batch counts each data module reported; then the model
      gathered whole (rank 0: OUT_DIR/cli_params.npz), and a fresh Trainer on
      the mesh resumed from the checkpoint; last the CLI on the config meshed
      fsdp 8 at a batch of 2, which the scale-down brings to a mesh of the
      first 2 ranks, the others idle. OUT_DIR/cli_R.json.
"""

import copy
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from orbit2_tpu_torch.evaluate import materialize  # noqa: E402
from orbit2_tpu_torch.metrics.metrics import METRICS_REGISTRY  # noqa: E402
from orbit2_tpu_torch.models import ResSlimViT  # noqa: E402
from orbit2_tpu_torch.models.components.blocks import DropPath, Mlp  # noqa: E402
from orbit2_tpu_torch.ops.seq_attention import SEQ_IMPLS, seq_flash_attention  # noqa: E402
from orbit2_tpu_torch.parallel import (  # noqa: E402
    AXIS_TENSOR, data_group, data_rank, data_size, full_tensor, make_mesh, shard_model)
from orbit2_tpu_torch.training.optim import make_optimizer  # noqa: E402
from orbit2_tpu_torch.training.train import make_train_step  # noqa: E402

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
MESHES = {"fsdp2_tensor2": dict(fsdp=2, tensor=2), "replica2_fsdp2": dict(replica=2, fsdp=2)}


def sharded(mesh, state=None, drop=0.0, remat=False, seed=0, fused=False, **model):
    """The tiny model on `mesh`, filled from `state` or drawn from `seed`;
    `fused` asks its Mlps for K6 first."""
    kw = dict(attention_impl="auto", drop_rate=drop, drop_path=drop, remat=remat,
              **dict(TINY, **model))
    with torch.device("meta"):
        skeleton = ResSlimViT(DEFAULT_VARS, **kw)
    for m in skeleton.modules():
        if isinstance(m, Mlp):
            m.use_fused = fused
    model = shard_model(copy.deepcopy(skeleton), mesh)
    model.to_empty(device="cpu")
    if state is None:
        materialize(skeleton, "cpu", generator=torch.Generator().manual_seed(seed), into=model)
    else:
        materialize(skeleton, "cpu", fill=lambda keys: {k: state[k] for k in keys}, into=model)
    return model


def train_step(model):
    opt = make_optimizer("adamw", HP, model.named_parameters())
    return make_train_step(model, METRICS_REGISTRY["bayesian_tv"](aggregate_only=True),
                           VAR_WEIGHTS, opt, DEFAULT_VARS, OUT_VARS)


def gather_batch(t, mesh):
    group = data_group(mesh)
    parts = [torch.empty_like(t) for _ in range(data_size(mesh))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def data_mean(t, mesh):
    t = t.detach().clone()
    dist.all_reduce(t, group=data_group(mesh))
    return t / data_size(mesh)


def run_steps(rank, out_dir, state_path):
    raw = np.load(state_path)
    state = {k: torch.from_numpy(raw[k]) for k in raw.files if k not in ("x", "y")}
    x, y = torch.from_numpy(raw["x"]), torch.from_numpy(raw["y"])
    report = {}
    for name, axes in MESHES.items():
        mesh = make_mesh(device_type="cpu", **axes)
        one = ResSlimViT(DEFAULT_VARS, attention_impl="auto", drop_rate=0.0, drop_path=0.0,
                         generator=torch.Generator().manual_seed(3), **TINY)
        drawn = sharded(mesh, seed=3)
        draw_equal = all(torch.equal(full_tensor(t), one.state_dict()[k])
                         for k, t in drawn.state_dict().items())

        model = sharded(mesh, state)
        if name == "fsdp2_tensor2":  # the rank's heads of each pack, its fsdp columns
            t, f = mesh.get_local_rank(AXIS_TENSOR), mesh.get_local_rank("fsdp")
            params = dict(model.named_parameters())
            report["heads"] = {}
            for key, packs in (("blocks.0.attn.qkv.weight", 3), ("blocks.1.attn.qkv.weight", 3),
                               ("var_agg.kv.weight", 2)):
                w = state[key]
                rows = w.reshape(packs, 2, -1, w.shape[1])[:, t].reshape(-1, w.shape[1])
                report["heads"][key] = torch.equal(params[key].detach().to_local(),
                                                   rows.chunk(2, dim=1)[f])
        xs, ys = (t.chunk(data_size(mesh))[data_rank(mesh)] for t in (x, y))
        with torch.no_grad():
            model.train()
            out = gather_batch(model(xs, DEFAULT_VARS, OUT_VARS), mesh)
        loss = data_mean(train_step(model)(xs, ys, torch.Generator(), None), mesh)
        grads = {k: full_tensor(p.grad).numpy() for k, p in model.named_parameters()
                 if p.grad is not None}
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{name}.npz"), out=out.numpy(), loss=loss.numpy(),
                     **{f"grad/{k}": v for k, v in grads.items()})
        report[name] = {"draw_equal": draw_equal,
                        "coords": dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())),
                        "data_rank": data_rank(mesh)}

    # dropout and drop-path 0.1, remat: the tensor replicas stay bit-equal
    mesh = make_mesh(device_type="cpu", fsdp=2, tensor=2)
    model = sharded(mesh, state, drop=0.1, remat=True, fused=True)
    step = train_step(model)
    xs, ys = (t.chunk(data_size(mesh))[data_rank(mesh)] for t in (x, y))
    gens = (torch.Generator().manual_seed(11), torch.Generator().manual_seed(12))
    losses = [step(xs, ys, *gens).item() for _ in range(2)]
    group = mesh[AXIS_TENSOR].get_group()
    checked = equal = 0
    for _, p in model.named_parameters():
        if AXIS_TENSOR in p.device_mesh.mesh_dim_names:
            continue  # split over the tensor axis: no replica to compare
        mine = p.detach().to_local().contiguous()
        both = [torch.empty_like(mine) for _ in range(2)]
        dist.all_gather(both, mine, group=group)
        checked += 1
        equal += int(torch.equal(both[0], both[1]))
    both = [None, None]
    dist.all_gather_object(both, losses, group=group)
    slices = sorted({m.batch_slice for m in model.modules()
                     if isinstance(m, DropPath) and m.rate > 0})
    report["dropout"] = {"checked": checked, "equal": equal, "losses": losses,
                         "tensor_losses_equal": both[0] == both[1],
                         "drop_path_slices": [list(s) for s in slices],
                         "fused_off": all(not m.use_fused for m in model.modules()
                                          if isinstance(m, Mlp))}

    # an MoE trunk (a MoEMlp in every Block) on the data axes
    mesh = make_mesh(device_type="cpu", replica=2, fsdp=2)
    moe = dict(moe_experts=2, moe_every=1)
    one = ResSlimViT(DEFAULT_VARS, attention_impl="auto", drop_rate=0.0, drop_path=0.0,
                     generator=torch.Generator().manual_seed(5), **TINY, **moe)
    model = sharded(mesh, seed=5, **moe)
    xs, ys = (t.chunk(data_size(mesh))[data_rank(mesh)] for t in (x, y))
    with torch.no_grad():
        want, got = one(x, DEFAULT_VARS, OUT_VARS), gather_batch(model(xs, DEFAULT_VARS, OUT_VARS),
                                                                 mesh)
    before = {k: full_tensor(p.detach()).clone() for k, p in model.named_parameters()}
    loss = data_mean(train_step(model)(xs, ys, torch.Generator(), None), mesh)
    moved = [k for k, p in model.named_parameters()
             if "moe_mlp" in k and not torch.equal(full_tensor(p.detach()), before[k])]
    report["moe"] = {"forward_err": (got - want).abs().max().item(), "loss": loss.item(),
                     "experts_moved": len(moved)}
    with open(os.path.join(out_dir, f"steps_{rank}.json"), "w") as f:
        json.dump(report, f)


# seq_flash_attention's cases: (impl, seq, B, N, H, D)
ATTENTION_CASES = [(impl, s, 2, 512, 4, 32) for s in (2, 4) for impl in SEQ_IMPLS] + [
    ("ring", 2, 2, 768, 2, 32)]
# the models' changes to TINY: the seq model at head dim 64 (the flash path)
# over 16 x 32 fields of 512 tokens (ring's N/s % 128), the MoE model with 4
# experts in each Block
SEQ_MODEL = dict(img_size=(16, 32), embed_dim=128, num_heads=2, patch_size=1)
MOE_MODEL = dict(embed_dim=128, num_heads=2, moe_experts=4, moe_every=1)
# Trainer.fit's run: epochs of one step
FIT = dict(max_epochs=3, max_steps_per_epoch=1)
STEP_MESHES = {f"seq_{impl}": (dict(seq=2, fsdp=2), "seq", dict(seq_shard=True, seq_impl=impl))
               for impl in SEQ_IMPLS}
STEP_MESHES.update({"moe_ep_fsdp": (dict(expert=2, fsdp=2), "moe", {}),
                    "moe_ep_tp": (dict(expert=2, tensor=2), "moe", {})})


def attention_inputs(b, n, h, d, seed, doubled=False):
    """q, k, v [B, N, H, D] fp32 from numpy's generator at `seed`; `doubled`:
    each the concatenation of two equal halves along N."""
    rng = np.random.default_rng(seed)
    half = n // 2 if doubled else n
    out = []
    for _ in range(3):
        a = rng.normal(size=(b, half, h, d)).astype(np.float32)
        out.append(torch.from_numpy(np.concatenate([a, a], axis=1) if doubled else a))
    return out


def gather_seq_dim(t, split):
    parts = [torch.empty_like(t) for _ in range(split.size)]
    dist.all_gather(parts, t.contiguous(), group=split.group)
    return torch.cat(parts, 1)


def run_seqexpert(rank, in_dir, out_dir):
    from orbit2_tpu_torch.config import load_config
    from orbit2_tpu_torch.ops.attention import dot_product_attention
    from orbit2_tpu_torch.parallel import AXIS_SEQ, BATCH_AXES, seq_split
    from orbit2_tpu_torch.parallel.mesh import sharded_coords
    from orbit2_tpu_torch.training.trainer import Trainer

    world = dist.get_world_size()
    arrays, report = {}, {}

    # seq_flash_attention: output and gradients of sum(o^2), gathered whole
    for i, (impl, s, b, n, h, d) in enumerate(ATTENTION_CASES):
        split = seq_split(make_mesh(device_type="cpu", seq=s, replica=world // s), impl)
        q, k, v = (t.chunk(s, 1)[split.rank].clone().requires_grad_()
                   for t in attention_inputs(b, n, h, d, seed=i))
        o = seq_flash_attention(q, k, v, split)
        (o ** 2).sum().backward()
        key = f"attn/{impl}{s}_n{n}"
        for name, t in (("o", o.detach()), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
            arrays[f"{key}/{name}"] = gather_seq_dim(t, split).numpy()
    # dropout on inputs whose halves are equal, through the Attention's call
    # (head dim 64: the flash path) with shard_model's fold of the rank's
    # replica and seq coordinates: the two seq ranks' masks
    for impl in ("gather", "ulysses"):
        mesh = make_mesh(device_type="cpu", seq=2, replica=2)
        split, fold = seq_split(mesh, impl), sharded_coords(mesh, BATCH_AXES + (AXIS_SEQ,))
        q, k, v = (t.chunk(2, 1)[split.rank] for t in attention_inputs(2, 256, 4, 64, seed=20,
                                                                      doubled=True))
        runs = [dot_product_attention(q, k, v, "auto", dropout_rate=rate, fold=fold, seq=split,
                                      generator=torch.Generator().manual_seed(5))
                for rate in (0.0, 0.3, 0.3)]
        for name, o in zip(("clean", "drop", "drop2"), runs):
            arrays[f"dropout/{impl}/{name}"] = gather_seq_dim(o, split).numpy()

    # one train step at dropout 0 on in.npz's batch and weights
    raw = np.load(os.path.join(in_dir, "in.npz"))
    batch = {kind: (torch.from_numpy(raw[f"{kind}_x"]), torch.from_numpy(raw[f"{kind}_y"]))
             for kind in ("seq", "moe")}
    states = {kind: {k.split("/", 1)[1]: torch.from_numpy(raw[k]) for k in raw.files
                     if k.startswith(kind + "/")} for kind in ("seq", "moe", "moetp")}
    for name, (axes, kind, extra) in STEP_MESHES.items():
        mesh = make_mesh(device_type="cpu", **axes)
        model = sharded(mesh, states[kind], **dict(SEQ_MODEL if kind == "seq" else MOE_MODEL,
                                                   **extra))
        xs, ys = (t.chunk(data_size(mesh))[data_rank(mesh)] for t in batch[kind])
        loss = data_mean(train_step(model)(xs, ys, torch.Generator(), None), mesh)
        arrays[f"step/{name}/loss"] = loss.numpy()
        for k, p in model.named_parameters():
            if p.grad is not None:
                arrays[f"step/{name}/grad/{k}"] = full_tensor(p.grad).numpy()

    # Trainer.fit on the configs
    for name in [f"seq_{impl}" for impl in SEQ_IMPLS] + ["moe_ep_fsdp", "moe_ep_tp"]:
        cfg = load_config(os.path.join(in_dir, f"{name}.yaml"))
        ck = os.path.join(out_dir, "ck") if name == "moe_ep_fsdp" else None
        kind = {"moe_ep_fsdp": "moe", "moe_ep_tp": "moetp"}.get(name, "seq")
        trainer = Trainer(cfg, "cpu", state_dict=states[kind], checkpoint_dir=ck)
        report[f"fit/{name}"] = trainer.fit(**FIT)
        for k, t in trainer.model.state_dict().items():
            arrays[f"fit/{name}/param/{k}"] = full_tensor(t).numpy()
        if name == "moe_ep_fsdp":
            for key in ("mu", "nu"):
                for k, t in trainer.optimizer.state_dict()[key].items():
                    arrays[f"fit/{name}/{key}/{k}"] = full_tensor(t).numpy()

    # dropout and drop-path 0.1: the replicas of each parameter stay bit-equal
    for name, axes, kind, extra, axis in (
            ("seq2_tensor2", dict(seq=2, tensor=2), "seq", dict(seq_shard=True), "seq"),
            ("expert2_fsdp2", dict(expert=2, fsdp=2), "moe", {}, "expert")):
        mesh = make_mesh(device_type="cpu", **axes)
        model = sharded(mesh, states[kind], drop=0.1,
                        **dict(SEQ_MODEL if kind == "seq" else MOE_MODEL, **extra))
        step = train_step(model)
        xs, ys = (t.chunk(data_size(mesh))[data_rank(mesh)] for t in batch[kind])
        gens = (torch.Generator().manual_seed(11), torch.Generator().manual_seed(12))
        losses = [step(xs, ys, *gens).item() for _ in range(2)]
        checked = {AXIS_TENSOR: [0, 0], axis: [0, 0]}
        for _, p in model.named_parameters():
            placed = dict(zip(p.device_mesh.mesh_dim_names, p.placements))
            for along in checked:
                if along in placed and not placed[along].is_replicate():
                    continue  # split over this axis: no replica to compare
                group = mesh[along].get_group()
                mine = p.detach().to_local().contiguous()
                both = [torch.empty_like(mine) for _ in range(mesh[along].size())]
                dist.all_gather(both, mine, group=group)
                checked[along][0] += 1
                checked[along][1] += int(all(torch.equal(both[0], t) for t in both))
        report[f"replicas/{name}"] = {"checked": checked, "losses": losses}

    with open(os.path.join(out_dir, f"seqexpert_{rank}.json"), "w") as f:
        json.dump(report, f)
    if rank == 0:
        np.savez(os.path.join(out_dir, "seqexpert.npz"), **arrays)
    run_pipeline(rank, in_dir, out_dir)


# the pipelined model (JAX tests/test_pipeline.py's tiny model) and its cases:
# (name, microbatches, interleave) on each mesh, 2 stages
PIPE_MODEL = dict(img_size=(16, 32), embed_dim=64, depth=4, num_heads=4)
PIPE_CASES = [("gpipe_m2", 2, 1), ("gpipe_m4", 4, 1), ("interleaved_m4", 4, 2)]
PIPE_MESHES = {"stage2_fsdp2": dict(stage=2, fsdp=2), "stage2_tensor2": dict(stage=2, tensor=2)}
# how long the ranks wait for the JAX side's inputs
PIPE_WAIT_S = 400
PIPE_FITS = {"pp_gpipe": {"pipeline": 2, "fsdp": 2, "pipeline_microbatches": 2},
             "pp_interleaved": {"pipeline": 2, "fsdp": 2, "pipeline_microbatches": 4,
                                "pipeline_interleave": 2}}


def run_pipeline(rank, in_dir, out_dir):
    from orbit2_tpu_torch.config import load_config
    from orbit2_tpu_torch.parallel import AXIS_STAGE, in_mesh
    from orbit2_tpu_torch.parallel.sharding import full_named, full_state_dict
    from orbit2_tpu_torch.training.checkpoint import restore_checkpoint
    from orbit2_tpu_torch.training.trainer import Trainer

    path, waited = os.path.join(in_dir, "pp_in.npz"), 0.0
    while not os.path.exists(path):  # written by the JAX side beside the ranks
        if waited > PIPE_WAIT_S:
            raise TimeoutError(f"no {path} after {PIPE_WAIT_S} s")
        time.sleep(0.5)
        waited += 0.5
    raw = np.load(path)
    state = {k[3:]: torch.from_numpy(raw[k]) for k in raw.files if k.startswith("pp/")}
    x, y = torch.from_numpy(raw["pp_x"]), torch.from_numpy(raw["pp_y"])
    arrays, report = {}, {}

    def step(model, xs, ys, mesh):
        """Forward, JAX test_pipeline.py's loss mean((out - y)^2) of the
        rank's slice (FSDP2 averages the data ranks' gradients: the global
        mean's) and its backward: (output and input gradient gathered over
        the data ranks, this rank's parameters' gradients, each whole)."""
        xs = xs.clone().requires_grad_()
        model.train()
        out = model(xs, DEFAULT_VARS, OUT_VARS)
        ((out - ys) ** 2).mean().backward()
        # the rank's loss is its slice's mean: its input gradient is the
        # global mean's times the data ranks
        dx = xs.grad / (1 if mesh is None else data_size(mesh))
        if mesh is not None:
            out, dx = gather_batch(out.detach(), mesh), gather_batch(dx, mesh)
        grads = {k: full_tensor(p.grad).numpy() for k, p in model.named_parameters()
                 if p.grad is not None}
        return out.detach().numpy(), dx.numpy(), grads

    # the unpipelined model on one process, then each schedule on each mesh
    one = ResSlimViT(DEFAULT_VARS, attention_impl="auto", drop_rate=0.0, drop_path=0.0,
                     **dict(TINY, **PIPE_MODEL))
    one.load_state_dict(state)
    out, dx, grads = step(one, x, y, None)
    arrays.update({"one/out": out, "one/dx": dx, **{f"one/grad/{k}": g for k, g in grads.items()}})
    for mesh_name, axes in PIPE_MESHES.items():
        mesh = make_mesh(device_type="cpu", **axes)
        # the fill draws every unit from the one generator, the Blocks held
        # elsewhere too: the whole model is the one-process draw
        drawn = sharded(mesh, seed=3, pipeline_stages=2, pipeline_interleave=2,
                        pipeline_microbatches=4, **PIPE_MODEL)
        one_draw = ResSlimViT(DEFAULT_VARS, attention_impl="auto", drop_rate=0.0, drop_path=0.0,
                              generator=torch.Generator().manual_seed(3),
                              **dict(TINY, **PIPE_MODEL)).state_dict()
        whole = full_state_dict(drawn)
        report[f"{mesh_name}/draw_equal"] = list(whole) == list(one_draw) and all(
            torch.equal(t, one_draw[k]) for k, t in whole.items())
        for case, m, v in PIPE_CASES:
            model = sharded(mesh, state, pipeline_stages=2, pipeline_microbatches=m,
                            pipeline_interleave=v, **PIPE_MODEL)
            xs, ys = (t.chunk(data_size(mesh))[data_rank(mesh)] for t in (x, y))
            out, dx, grads = step(model, xs, ys, mesh)
            key = f"{mesh_name}/{case}"
            arrays.update({f"{key}/out": out, f"{key}/dx": dx,
                           **{f"{key}/grad/{k}": g for k, g in grads.items()}})
            report[key] = {"blocks": [i for i, b in enumerate(model.blocks)
                                      if any(True for _ in b.parameters())],
                           "stage": mesh.get_local_rank(AXIS_STAGE)}

    # Trainer.fit on the configs, the GPipe one saving checkpoints
    for name in PIPE_FITS:  # both from the JAX Trainer's initial parameters
        cfg = load_config(os.path.join(in_dir, f"{name}.yaml"))
        init = state
        ck = os.path.join(out_dir, "ppck") if name == "pp_gpipe" else None
        trainer = Trainer(cfg, "cpu", state_dict=init, checkpoint_dir=ck,
                          run_validation=ck is not None)
        report[f"fit/{name}"] = trainer.fit(**FIT)
        if ck is None:
            continue
        report["validation"] = trainer.last_validation
        params = full_state_dict(trainer.model)
        moments = {k: full_named(trainer.model, trainer.optimizer.state_dict()[k])
                   for k in ("mu", "nu")}
        saved = restore_checkpoint(os.path.join(ck, f"epoch_{FIT['max_epochs'] - 1}"))
        again = Trainer(cfg, "cpu", checkpoint_dir=ck)
        key = next(iter(cfg.data.low_res_dir))
        again._start(again.data_module(key))
        again._phase(again.data_module(key), key)  # the phase's geometry, as fit sets it
        resumed = full_state_dict(again.model)
        report["checkpoint"] = {
            "keys": list(saved["model"]),
            "saved_equal": all(torch.equal(saved["model"][k], t) for k, t in params.items()),
            "moments_saved_equal": all(torch.equal(saved["optimizer"][k][n], t)
                                       for k in moments for n, t in moments[k].items()),
            "resumed_equal": list(resumed) == list(params) and all(
                torch.equal(resumed[k], t) for k, t in params.items()),
            "resumed_moments_equal": all(
                torch.equal(full_named(again.model, again.optimizer.state_dict()[k])[n], t)
                for k in moments for n, t in moments[k].items()),
            "own_blocks": sorted({int(n.split(".")[1]) for n, _ in again.model.named_parameters()
                                  if n.startswith("blocks.")})}
        # the saved model on one process against the pipelined one, eval mode
        mesh = again.mesh
        xs = x.chunk(data_size(mesh))[data_rank(mesh)]
        with torch.no_grad():
            got = gather_batch(again.model.eval()(xs, DEFAULT_VARS, OUT_VARS), mesh)
        if rank == 0:  # the config's model, unpipelined
            single = ResSlimViT(DEFAULT_VARS, attention_impl="auto", drop_rate=0.0,
                                drop_path=0.0, **dict(TINY, **PIPE_MODEL))
            report["checkpoint"]["one_keys"] = list(single.state_dict())
            single.load_state_dict(saved["model"], strict=True)
            with torch.no_grad():
                arrays["ck/one_out"] = single.eval()(x, DEFAULT_VARS, OUT_VARS).numpy()
            arrays["ck/pipelined_out"] = got.numpy()

    # dropout and drop-path 0.1
    mesh = make_mesh(device_type="cpu", stage=2, fsdp=2)
    gens = lambda: (torch.Generator().manual_seed(11), torch.Generator().manual_seed(12))  # noqa
    model = sharded(mesh, state, drop=0.1, pipeline_stages=2, pipeline_microbatches=2,
                    **PIPE_MODEL)
    xs = x[:2].repeat(2, 1, 1, 1)  # microbatches 0 and 1 of equal samples
    with torch.no_grad():
        model.train()
        arrays["dropout/twice"] = gather_batch(model(xs, DEFAULT_VARS, OUT_VARS, *gens()),
                                               mesh).numpy()
    runs = {}
    for remat in (False, True):
        model = sharded(mesh, state, drop=0.1, remat=remat, pipeline_stages=2,
                        pipeline_microbatches=2, pipeline_interleave=1, **PIPE_MODEL)
        train = train_step(model)
        xs, ys = (t.chunk(data_size(mesh))[data_rank(mesh)] for t in (x, y))
        g = gens()
        losses = [train(xs, ys, *g).item() for _ in range(2)]
        runs[remat] = (losses, {k: p.detach().to_local().clone()
                                for k, p in model.named_parameters()})
    report["remat_equal"] = runs[False][0] == runs[True][0] and all(
        torch.equal(t, runs[True][1][k]) for k, t in runs[False][1].items())
    # the parameters outside the trunk, replicated over stage, after two steps
    group = mesh[AXIS_STAGE].get_group()
    checked = equal = 0
    for k, t in runs[True][1].items():
        if k.startswith("blocks."):
            continue
        both = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(both, t.contiguous(), group=group)
        checked += 1
        equal += int(torch.equal(both[0], both[1]))
    report["outer_replicas"] = {"checked": checked, "equal": equal, "losses": runs[True][0]}

    # an interleaved step at stage 2 x fsdp 2 against the same model on fsdp 2
    # alone (ranks 0 and 1; 2 and 3 idle), where each data rank sweeps its
    # microbatches through every Block on one process: the same folds
    kw = dict(drop=0.1, pipeline_stages=2, pipeline_microbatches=4, pipeline_interleave=2,
              **PIPE_MODEL)
    for name, axes in (("sweep", dict(stage=2, fsdp=2)), ("sweep/one", dict(fsdp=2))):
        mesh = make_mesh(device_type="cpu", **axes)
        if not in_mesh(mesh):
            continue
        model = sharded(mesh, state, **kw)
        xs, ys = (t.chunk(data_size(mesh))[data_rank(mesh)] for t in (x, y))
        loss = data_mean(train_step(model)(xs, ys, *gens()), mesh).item()
        grads = full_named(model, {k: p.grad for k, p in model.named_parameters()})
        report[f"{name}/loss"] = loss
        report[f"{name}/split"] = model.stage_split is not None
        if rank == 0:
            arrays.update({f"{name}/grad/{k}": g.numpy() for k, g in grads.items()})

    np.savez(os.path.join(out_dir, f"pipeline_{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"pipeline_{rank}.json"), "w") as f:
        json.dump(report, f)
    run_servemesh(rank, in_dir, out_dir)


# the serving cases (tests/test_torch_serve_mesh.py): name -> (model kind,
# parallelism, dropout), each kind's changes to TINY
SERVE_MODELS = {"dense": {}, "seq": SEQ_MODEL, "moe": MOE_MODEL, "pipe": PIPE_MODEL}
SERVE_CASES = {
    "tensor2_seq2_gather": ("seq", {"tensor_par": 2, "seq_par": 2, "seq_impl": "gather"}, 0.0),
    "tensor2_seq2_ring": ("seq", {"tensor_par": 2, "seq_par": 2, "seq_impl": "ring"}, 0.0),
    "expert2_tensor2": ("moe", {"expert_par": 2, "tensor_par": 2}, 0.0),
    "stage2_tensor2_gpipe": ("pipe", {"pipeline": 2, "tensor_par": 2,
                                      "pipeline_microbatches": 4}, 0.0),
    "stage2_tensor2_interleaved": ("pipe", {"pipeline": 2, "tensor_par": 2,
                                            "pipeline_microbatches": 4,
                                            "pipeline_interleave": 2}, 0.0),
    "fsdp2_tensor2": ("dense", {"fsdp": 2, "tensor_par": 2}, 0.0),
    "replica2_fsdp2": ("dense", {"simple_ddp": 2, "fsdp": 2}, 0.0),
    # meshes of ranks 0 and 1, ranks 2 and 3 idle
    "tensor2": ("dense", {"tensor_par": 2}, 0.1),
    "stage2": ("pipe", {"pipeline": 2, "pipeline_microbatches": 2}, 0.0),
}
# the samples of each round the data ranks gather (files of 3, 2, 2 and 1
# samples: at two data ranks of batch 2 rank 0 reads files 0-1, rank 1 files
# 2-3; at four of batch 1 one file each)
SERVE_ROUND_REALS = {"fsdp2_tensor2": [4, 3, 1], "replica2_fsdp2": [4, 3, 1]}
# how long the ranks wait for the serving cases' JAX side
SERVE_WAIT_S = 400


def serve_world(name):
    """The ranks of case `name`'s mesh."""
    par = SERVE_CASES[name][1]
    return int(np.prod([v for k, v in par.items() if k in (
        "tensor_par", "seq_par", "expert_par", "pipeline", "fsdp", "simple_ddp")]))


def first_batch(dm):
    loader = iter(dm.test_dataloader())
    try:
        return torch.from_numpy(next(loader)[0])
    finally:
        loader.close()


def run_servemesh(rank, in_dir, out_dir):
    """Every SERVE_CASES config served on its mesh (Evaluator.test in fp32
    and w8a8, or the error it raises), the data meshes' gathered rounds
    recorded; the meshes that leave ranks 2 and 3 idle; MC dropout, the
    stitched field and both serving CLIs on tensor 2; test_on_many_images on
    fsdp 2 x tensor 2. Each rank writes OUT_DIR/serve_R.json and
    serve_R.npz."""
    import contextlib
    import io

    from orbit2_tpu_torch import evaluate as evaluate_mod
    from orbit2_tpu_torch.config import load_config
    from orbit2_tpu_torch.parallel import in_mesh
    from orbit2_tpu_torch.utils.inference import test_on_many_images
    from orbit2_tpu_torch.utils.mc_dropout import get_monte_carlo_predictions
    from orbit2_tpu_torch.utils.visualize import model_forward_fn, visualize_at_index

    path, waited = os.path.join(in_dir, "serve_in.npz"), 0.0
    while not os.path.exists(path):  # written by the JAX side beside the ranks
        if waited > SERVE_WAIT_S:
            raise TimeoutError(f"no {path} after {SERVE_WAIT_S} s")
        time.sleep(0.5)
        waited += 0.5
    raw = np.load(path)
    states = {kind: {k.split("/", 1)[1]: torch.from_numpy(raw[k]) for k in raw.files
                     if k.startswith(kind + "/")} for kind in SERVE_MODELS}
    report, arrays = {"idle_meshes": {}}, {}
    # the repaired fault: meshes whose data axes are 1, smaller than the world
    for name, axes in (("stage2", dict(stage=2)), ("tensor2", dict(tensor=2))):
        mesh = make_mesh(device_type="cpu", **axes)
        r = report["idle_meshes"][name] = {"in_mesh": in_mesh(mesh)}
        if r["in_mesh"]:
            r.update(data_size=data_size(mesh), data_rank=data_rank(mesh))

    gathered = []
    gather_rows = evaluate_mod.gather_rows

    def recording(tensors, real, mesh, device):
        out = gather_rows(tensors, real, mesh, device)
        gathered.append(out)
        return out

    evaluate_mod.gather_rows = recording
    for name, (kind, _, _) in SERVE_CASES.items():
        cfg = load_config(os.path.join(in_dir, f"serve_{name}.yaml"))
        ev = evaluate_mod.Evaluator(cfg, "cpu", state_dict=states[kind])
        gathered.clear()
        r = report[name] = {"idle": ev.idle, "means": ev.test()}
        r["samples"] = ev.last_test["samples"] if ev.last_test else 0
        for i, ((yhat, y), real) in enumerate(gathered):
            if rank == 0:
                arrays.update({f"{name}/round/{i}/yhat": yhat.numpy(),
                               f"{name}/round/{i}/y": y.numpy(),
                               f"{name}/round/{i}/real": np.int64(real)})
        try:
            r["w8a8"] = ev.test(quant="w8a8")
        except Exception as e:  # noqa: BLE001 - the error is the result
            r["w8a8_error"] = [type(e).__name__, str(e)]
        if ev.idle:
            continue
        in_vars, out_vars = ev.data_module.get_data_variables()
        if name == "fsdp2_tensor2":
            # MC dropout at rate 0: the deterministic prediction
            x = first_batch(ev.data_module)
            with torch.no_grad():
                det = ev.model.eval()(x, in_vars, out_vars)
            ens = get_monte_carlo_predictions(ev.model, x, in_vars, out_vars, n_samples=2)
            report["mc"] = {"rate0_equals_eval": all(torch.equal(e, det) for e in ens)}
            many = os.path.join(out_dir, f"many_{rank}")
            written = test_on_many_images(model_forward_fn(ev.model, in_vars, out_vars),
                                          ev.data_module, many, mesh=ev.mesh)
            files = sorted(os.listdir(many)) if os.path.isdir(many) else []
            gts = [np.load(os.path.join(many, f)) for f in files if f.startswith("gt_")]
            rows = np.concatenate(gts) if gts else np.zeros((0,))
            report["many"] = {"written": written, "files": len(files),
                              "samples": int(rows.shape[0]),
                              "unique_targets": len({a.tobytes() for a in rows})}
        if name == "tensor2":
            x = first_batch(ev.data_module)
            runs = [get_monte_carlo_predictions(ev.model, x, in_vars, out_vars, n_samples=2,
                                                generator=torch.Generator().manual_seed(3))
                    for _ in range(2)]
            report["mc"]["repeats"] = torch.equal(runs[0], runs[1])
            report["mc"]["members_differ"] = not torch.equal(runs[0][0], runs[0][1])
            dm_vis = evaluate_mod.make_data_module(cfg, ev.data_key, 1, 0, "test")
            field_dir = os.path.join(out_dir, f"field_{rank}")
            res = visualize_at_index(model_forward_fn(ev.model, in_vars, out_vars), dm_vis,
                                     index=1, div=1, overlap=0, mag=TINY["superres_mag"],
                                     out_dir=field_dir)
            arrays[f"field/{rank}"] = res["preds"]
            report["field_files"] = sorted(os.listdir(field_dir)) if os.path.isdir(
                field_dir) else []
    evaluate_mod.gather_rows = gather_rows

    # the serving CLIs on tensor 2 (ranks 2 and 3 idle), weights from an npz
    from orbit2_tpu_torch import visualize as visualize_cli

    args = [os.path.join(in_dir, "serve_tensor2.yaml"), "--device", "cpu", "--torch-npz",
            os.path.join(in_dir, "serve_dense.npz")]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        evaluate_mod.main(args)
    report["cli"] = out.getvalue()
    viz = os.path.join(out_dir, f"viz_{rank}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        visualize_cli.main(args + ["--index", "1", "--out-dir", viz])
    report["viz_cli"] = {"printed": out.getvalue(),
                         "files": sorted(os.listdir(viz)) if os.path.isdir(viz) else []}
    if report["viz_cli"]["files"]:
        arrays["viz_cli"] = np.stack([np.load(os.path.join(viz, f"pred_{v}_1.npy"))
                                      for v in OUT_VARS])
    np.savez(os.path.join(out_dir, f"serve_{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"serve_{rank}.json"), "w") as f:
        json.dump(report, f)
    run_hubmesh(rank, in_dir, out_dir)


# the model hub on a mesh (tests/test_torch_hub_mesh.py): each CNN's small
# widths (both packages' factories patched alike), the hub ViT's config,
# and the cases: name -> (model kind, parallelism)
HUB_WIDTHS = {"resnet": dict(hidden_channels=8, n_blocks=2),
              "unet": dict(hidden_channels=4, ch_mults=(1,), is_attn=(False,),
                           mid_attn=False, n_blocks=1)}
HUB_VIT = dict(patch_size=2, embed_dim=64, depth=2, decoder_depth=2, num_heads=2)
HUB_CASES = {
    "resnet_fsdp2": ("resnet", {"fsdp": 2}),
    "resnet_replica2_fsdp2": ("resnet", {"simple_ddp": 2, "fsdp": 2}),
    "resnet_tensor2": ("resnet", {"tensor_par": 2}),
    "resnet_seq2_fsdp2": ("resnet", {"seq_par": 2, "fsdp": 2}),
    "unet_fsdp2": ("unet", {"fsdp": 2}),
    "unet_replica2_fsdp2": ("unet", {"simple_ddp": 2, "fsdp": 2}),
    "vit_fsdp2": ("vit", {"fsdp": 2}),
    "vit_replica2_fsdp2": ("vit", {"simple_ddp": 2, "fsdp": 2}),
    "vit_tensor2": ("vit", {"tensor_par": 2}),
}
HUB_EPOCHS = 2  # of one step each, each epoch its own batch
HUB_FAULT = "resnet_fsdp2"  # run again with each rank's own BatchNorm statistics
HUB_VALIDATED = "vit_replica2_fsdp2"  # validates after each epoch
HUB_WAIT_S = 400
HUB_FAILED = "hub_jax.failed"  # the hub's JAX side's traceback, where it fails


def hub_widths(loaders, resnet, unet):
    """Patches a package's loaders module so that its resnet and unet
    presets build at HUB_WIDTHS (`resnet` / `unet`: that package's classes;
    JAX's take keywords alone)."""
    loaders.ResNet = lambda *a, **kw: resnet(*a, **{**kw, **HUB_WIDTHS["resnet"]})
    loaders.Unet = lambda *a, **kw: unet(*a, **{**kw, **HUB_WIDTHS["unet"]})


def wait_for(path, limit):
    """`path` once a JAX side beside the ranks has written it; raises at
    `limit` seconds, or at once where the hub's JAX side failed."""
    waited = 0.0
    failed = os.path.join(os.path.dirname(path), HUB_FAILED)
    while not os.path.exists(path):
        if os.path.exists(failed):
            raise RuntimeError(f"the JAX side failed:\n{open(failed).read()[-2000:]}")
        if waited > limit:
            raise TimeoutError(f"no {path} after {limit} s")
        time.sleep(0.5)
        waited += 0.5
    return path


def run_hubmesh(rank, in_dir, out_dir):
    """The model hub's cases (tests/test_torch_hub_mesh.py): Trainer.fit of
    each HUB_CASES config for HUB_EPOCHS epochs of one step, epoch e on
    IN_DIR/hub_in.npz's batch e (each data rank its slice); HUB_FAULT again
    with each rank's own BatchNorm statistics; the fsdp 2 cases' checkpoints
    resumed on the mesh and loaded into one process, fine-tuned from by the
    finetune CLI on the mesh, and served by the evaluate CLI (the ViT's);
    the data ranks' dropout masks at rate 0.1; then test() on each case's
    mesh from JAX's trained weights (IN_DIR/hub_jax.npz), MC dropout and the
    stitched field of the ViT on tensor 2 against one process. Beside it all,
    ranks 0 and 1 start the train CLI on IN_DIR/forecast.yaml in a world of
    2 of its own (`forecast` mode). Each rank writes OUT_DIR/hub_R.json and
    hub_R.npz."""
    import contextlib
    import io

    from orbit2_tpu_torch import evaluate as evaluate_mod
    from orbit2_tpu_torch import finetune
    from orbit2_tpu_torch.config import load_config
    from orbit2_tpu_torch.data.itermodule import IterDataModule
    from orbit2_tpu_torch.models.components.cnn import BatchNorm2d
    from orbit2_tpu_torch.models.resnet import ResNet
    from orbit2_tpu_torch.models.unet import Unet
    from orbit2_tpu_torch.parallel import in_mesh
    from orbit2_tpu_torch.parallel.sharding import full_state_dict
    from orbit2_tpu_torch.training.checkpoint import restore_checkpoint
    from orbit2_tpu_torch.training.trainer import Trainer
    from orbit2_tpu_torch.utils import loaders
    from orbit2_tpu_torch.utils.mc_dropout import get_monte_carlo_predictions
    from orbit2_tpu_torch.utils.visualize import model_forward_fn, visualize_at_index

    raw = np.load(wait_for(os.path.join(in_dir, "hub_in.npz"), HUB_WAIT_S))
    cli = start_forecast_cli(rank, in_dir, out_dir)
    kinds = sorted({kind for kind, _ in HUB_CASES.values()})
    states = {kind: {k.split("/", 1)[1]: torch.from_numpy(raw[k]) for k in raw.files
                     if k.startswith(kind + "/")} for kind in kinds}
    batches = [(raw[f"batch/x{e}"], raw[f"batch/y{e}"]) for e in range(HUB_EPOCHS)]
    hub_widths(loaders, ResNet, Unet)
    t_start = time.perf_counter()

    # the train split: an epoch's loader yields the data rank's slice of
    # that epoch's batch, one step
    train_dataloader, num_batches = IterDataModule.train_dataloader, IterDataModule.num_batches

    def epoch_batch(self):
        e = self.hub_epoch = getattr(self, "hub_epoch", -1) + 1
        n = batches[e][0].shape[0] // self.data_par_size
        yield tuple(a[self.data_par_rank * n:(self.data_par_rank + 1) * n] for a in batches[e])

    IterDataModule.train_dataloader = epoch_batch
    IterDataModule.num_batches = lambda self, split="train": (
        1 if split == "train" else num_batches(self, split))

    report, arrays = {}, {}
    trained = {}

    def fit_case(name, label):
        kind, _ = HUB_CASES[name]
        cfg = load_config(os.path.join(in_dir, f"hub_{name}.yaml"))
        ck = os.path.join(out_dir, f"hubck_{label}") if label == f"{kind}_fsdp2" else None
        trainer = Trainer(cfg, "cpu", state_dict=states[kind], checkpoint_dir=ck,
                          run_validation=label == HUB_VALIDATED)
        history = trainer.fit(max_epochs=HUB_EPOCHS, max_steps_per_epoch=1)
        r = report[label] = {"idle": not in_mesh(trainer.mesh), "history": history}
        if r["idle"]:
            return None
        model = trainer.model
        state = full_state_dict(model)
        for k, b in model.named_buffers():
            arrays[f"{label}/buffer/{k}"] = b.numpy()
        if rank == 0:
            arrays.update({f"{label}/param/{k}": t.numpy() for k, t in state.items()})
        r["validation"] = trainer.last_validation
        r["sync"] = [m.sync is not None for m in model.modules() if isinstance(m, BatchNorm2d)]
        return trainer, state

    for name in HUB_CASES:
        trained[name] = fit_case(name, name)

    # the fault: each rank's own statistics (the sync switched off here)
    shard_model = evaluate_mod.shard_model

    def unsynced(*a, **kw):
        model = shard_model(*a, **kw)
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.sync = None
        return model

    evaluate_mod.shard_model = unsynced
    try:
        fit_case(HUB_FAULT, "fault_per_rank_statistics")
    finally:
        evaluate_mod.shard_model = shard_model

    # the fsdp 2 checkpoints (ranks 0 and 1; 2 and 3 idle): resumed on the
    # mesh bit for bit, loaded into one process, fine-tuned from and served by
    # the CLIs on the mesh. Every rank builds each Trainer: making the
    # mesh's groups is collective
    for kind in kinds:
        name = f"{kind}_fsdp2"
        path = os.path.join(in_dir, f"hub_{name}.yaml")
        ck = os.path.join(out_dir, f"hubck_{name}")
        last = os.path.join(ck, f"epoch_{HUB_EPOCHS - 1}")
        again = Trainer(load_config(path), "cpu", checkpoint_dir=ck)
        if trained[name] is not None:
            trainer, state = trained[name]
            dm = again.data_module(next(iter(again.cfg.data.low_res_dir)))
            epoch = again._start(dm)
            resumed = full_state_dict(again.model)
            saved = restore_checkpoint(last)["model"]
            one = loaders.load_architecture(dm, kind, **evaluate_mod.model_kwargs(again.cfg))
            one.load_state_dict(saved, strict=True)
            report[f"checkpoint/{name}"] = {
                "resumed_epoch": epoch, "saved": sorted(saved),
                "resumed_equal": list(resumed) == list(state) and all(
                    torch.equal(resumed[k], t) for k, t in state.items()),
                "one_process_equal": all(torch.equal(t, state[k])
                                         for k, t in one.state_dict().items())}
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = finetune.main([path, "--arch", kind, "--pretrain", last, "--max-epochs", "1",
                                 "--max-steps-per-epoch", "1", "--checkpoint-dir",
                                 os.path.join(out_dir, f"hubft_{kind}"), "--device", "cpu"])
        report[f"finetune/{kind}"] = {
            "history": res["history"],
            "used": None if res["pretrain"] is None else sorted(res["pretrain"]["used"]),
            "dropped": None if res["pretrain"] is None else res["pretrain"]["dropped"]}
        if kind == "vit":
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                evaluate_mod.main([path, "--device", "cpu", "--checkpoint", last])
            report["evaluate_cli"] = out.getvalue()

    # dropout 0.1 on fsdp 2, both data ranks fed the same sample: their masks
    # differ (the seeds fold the data coordinate), and a seed repeats
    for kind in kinds:
        if trained[f"{kind}_fsdp2"] is None:
            continue
        trainer, _ = trained[f"{kind}_fsdp2"]
        dm = trainer.data_module(next(iter(trainer.cfg.data.low_res_dir)))
        with torch.device("meta"):
            skeleton = loaders.load_architecture(dm, kind, **dict(
                evaluate_mod.model_kwargs(trainer.cfg), generator=None, drop_rate=0.1))
        model = evaluate_mod.build_sharded(skeleton, trainer.mesh, "cpu", "cpu",
                                           torch.Generator().manual_seed(0)).train()
        in_vars, out_vars = dm.get_data_variables()
        x = torch.from_numpy(batches[0][0][:1])
        with torch.no_grad():
            runs = [model(x, in_vars, out_vars, torch.Generator().manual_seed(5))
                    for _ in range(2)]
        both = [torch.empty_like(runs[0]) for _ in range(2)]
        dist.all_gather(both, runs[0].contiguous(), group=data_group(trainer.mesh))
        report[f"dropout/{kind}"] = {"ranks_differ": not torch.equal(both[0], both[1]),
                                     "repeats": torch.equal(runs[0], runs[1])}

    # serving on each case's mesh, from JAX's trained weights (the JAX side
    # writes them while the ranks train): Evaluator.test; for the ViT on
    # tensor 2 (ranks 0 and 1) MC dropout at its rate 0 and the stitched
    # field against one process
    raw = np.load(wait_for(os.path.join(in_dir, "hub_jax.npz"), HUB_WAIT_S))
    for name in HUB_CASES:
        state = {k.split("/", 1)[1]: torch.from_numpy(raw[k]) for k in raw.files
                 if k.startswith(name + "/")}
        cfg = load_config(os.path.join(in_dir, f"hub_{name}.yaml"))
        ev = evaluate_mod.Evaluator(cfg, "cpu", state_dict=state)
        report[name]["test"] = ev.test()
        report[name]["samples"] = ev.last_test["samples"] if ev.last_test else 0
        if name != "vit_tensor2" or ev.idle:
            continue
        dm = ev.data_module
        in_vars, out_vars = dm.get_data_variables()
        x = first_batch(dm)
        with torch.no_grad():
            det = ev.model.eval()(x, in_vars, out_vars)
        ens = get_monte_carlo_predictions(ev.model, x, in_vars, out_vars, n_samples=2)
        report["mc"] = {"rate0_equals_eval": all(torch.equal(e, det) for e in ens)}
        dm_vis = evaluate_mod.make_data_module(cfg, ev.data_key, 1, 0, "test")
        field = visualize_at_index(model_forward_fn(ev.model, in_vars, out_vars), dm_vis,
                                   index=1, div=1, overlap=0, mag=4)["preds"]
        one = loaders.load_architecture(dm_vis, "vit", **evaluate_mod.model_kwargs(cfg))
        one.load_state_dict(state, strict=True)
        want = visualize_at_index(model_forward_fn(one, in_vars, out_vars), dm_vis, index=1,
                                  div=1, overlap=0, mag=4)["preds"]
        report["field_max_diff"] = float(np.abs(np.asarray(field) - np.asarray(want)).max())
    report["seconds"] = time.perf_counter() - t_start
    IterDataModule.train_dataloader, IterDataModule.num_batches = train_dataloader, num_batches
    np.savez(os.path.join(out_dir, f"hub_{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"hub_{rank}.json"), "w") as f:
        json.dump(report, f)
    if cli is not None:
        log = cli.communicate(timeout=HUB_WAIT_S)[0]
        if cli.returncode:
            raise RuntimeError(f"forecast CLI rank {rank} exited {cli.returncode}:\n{log[-4000:]}")


def start_forecast_cli(rank, in_dir, out_dir):
    """On ranks 0 and 1: a process of a world of 2 (`forecast` mode), beside
    this launch's work; None on the others."""
    import socket
    import subprocess

    port = [None]
    if rank == 0:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port[0] = str(sock.getsockname()[1])
    dist.broadcast_object_list(port)
    if rank >= 2:
        return None
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), "forecast", str(rank), "2",
                             port[0], in_dir, out_dir], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def run_forecast_cli(rank, in_dir, out_dir):
    """configs/forecast.yaml on IN_DIR's small forecasting grid
    (IN_DIR/forecast.yaml) through the train CLI as `torchrun
    --nproc-per-node 2` starts it, one step: OUT_DIR/forecast_R.json."""
    from orbit2_tpu_torch.models.components.cnn import BatchNorm2d
    from orbit2_tpu_torch.train import main as train_main

    t0 = time.perf_counter()
    trainer = train_main([os.path.join(in_dir, "forecast.yaml"), "--device", "cpu",
                          "--max-epochs", "1", "--max-steps-per-epoch", "1",
                          "--checkpoint-dir", os.path.join(out_dir, "forecast_ck")])
    norms = [m for m in trainer.model.modules() if isinstance(m, BatchNorm2d)]
    stats = torch.cat([torch.cat((m.running_mean, m.running_var)) for m in norms])
    both = [torch.empty_like(stats) for _ in range(2)]
    dist.all_gather(both, stats)
    par = trainer.cfg.parallelism
    with open(os.path.join(out_dir, f"forecast_{rank}.json"), "w") as f:
        json.dump({"history": trainer.history, "world": dist.get_world_size(),
                   "parallelism": {a: getattr(par, a) for a in (
                       "fsdp", "simple_ddp", "tensor_par", "seq_par", "pipeline", "expert_par")},
                   "preset": trainer.cfg.model.preset, "blocks": len(trainer.model.blocks),
                   "synced": all(m.sync is not None for m in norms),
                   "stats_equal": torch.equal(both[0], both[1]),
                   "stats_moved": bool((stats != torch.cat([torch.cat((
                       torch.zeros_like(m.running_mean), torch.ones_like(m.running_var)))
                       for m in norms])).all()),
                   "seconds": time.perf_counter() - t0}, f)


def run_cli(rank, out_dir, config, ckpt_dir):
    from orbit2_tpu_torch.data import reader as reader_mod
    from orbit2_tpu_torch.data.itermodule import IterDataModule
    from orbit2_tpu_torch.train import main

    files = {"train": set(), "val": set()}
    counts = {"train": [], "val": []}
    sharded_files = reader_mod.NpyReader._sharded_files
    num_batches = IterDataModule.num_batches

    def record_files(self, peek=False):
        got = sharded_files(self, peek=peek)
        if not peek:
            split = os.path.basename(os.path.dirname(got[0][0])) if got else None
            if split in files:
                files[split].update(os.path.basename(a) for a, _ in got)
        return got

    def record_count(self, split="train"):
        n = num_batches(self, split)
        if split in counts:
            counts[split].append(n)
        return n

    reader_mod.NpyReader._sharded_files = record_files
    IterDataModule.num_batches = record_count
    trainer = main([config, "--device", "cpu", "--max-epochs", "1", "--validate",
                    "--checkpoint-dir", ckpt_dir])
    reader_mod.NpyReader._sharded_files = sharded_files
    IterDataModule.num_batches = num_batches
    params = {k: full_tensor(t).numpy() for k, t in trainer.model.state_dict().items()}
    if rank == 0:
        np.savez(os.path.join(out_dir, "cli_params.npz"), **params)
    mesh = trainer.mesh

    # a fresh Trainer on the mesh resumes from the checkpoint rank 0 wrote:
    # the whole tensors re-sharded, parameters and moments bit for bit
    from orbit2_tpu_torch.training.checkpoint import restore_checkpoint
    from orbit2_tpu_torch.training.trainer import Trainer

    again = Trainer(trainer.cfg, "cpu", checkpoint_dir=ckpt_dir)
    resumed = again._start(again.data_module(next(iter(trainer.cfg.data.low_res_dir))))
    saved = restore_checkpoint(os.path.join(ckpt_dir, "epoch_0"))
    restored = all(np.array_equal(full_tensor(t).numpy(), params[k])
                   for k, t in again.model.state_dict().items())
    moments = all(torch.equal(full_tensor(t), saved["optimizer"][key][n])
                  for key in ("mu", "nu")
                  for n, t in again.optimizer.state_dict()[key].items())

    # a mesh smaller than the world: fsdp 8 asked for at world 4 scales to
    # fsdp 4, which the batch of 2 halves to 2 (examples/train.py:28-48);
    # the mesh takes ranks 0 and 1, as JAX's takes the first devices
    import yaml

    from orbit2_tpu_torch.parallel import in_mesh

    with open(config) as f:
        raw = yaml.safe_load(f)
    raw["parallelism"] = {"fsdp": 8, "simple_ddp": 1, "tensor_par": 1}
    raw["trainer"]["batch_size"] = 2
    small = os.path.join(out_dir, f"idle_{rank}.yaml")
    with open(small, "w") as f:
        yaml.safe_dump(raw, f)
    part = main([small, "--device", "cpu", "--max-epochs", "1", "--max-steps-per-epoch", "1",
                 "--checkpoint-dir", os.path.join(out_dir, "ck_idle")])
    idle = {"in_mesh": in_mesh(part.mesh), "mesh_size": part.mesh.size(),
            "fsdp": part.cfg.parallelism.fsdp, "history": part.history}
    with open(os.path.join(out_dir, f"cli_{rank}.json"), "w") as f:
        json.dump({"idle": idle, "history": trainer.history, "validation": trainer.last_validation,
                   "resumed_epoch": resumed, "restored": restored, "moments": moments,
                   "files": {k: sorted(v) for k, v in files.items()}, "counts": counts,
                   "data_rank": data_rank(mesh), "tensor_rank": mesh.get_local_rank(AXIS_TENSOR),
                   "batch_size": trainer.data_module(next(iter(trainer.cfg.data.low_res_dir)))
                   .batch_size}, f)


def main():
    mode, rank, world, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    if mode in ("steps", "seqexpert"):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world)
        if mode == "steps":
            run_steps(rank, sys.argv[6], sys.argv[5])
        else:
            run_seqexpert(rank, sys.argv[5], sys.argv[6])
    else:  # torchrun's variables, for the CLI's init_distributed
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                          MASTER_ADDR="localhost", MASTER_PORT=port)
        if mode == "forecast":
            run_forecast_cli(rank, sys.argv[5], sys.argv[6])
        else:
            run_cli(rank, sys.argv[7], sys.argv[5], sys.argv[6])
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
