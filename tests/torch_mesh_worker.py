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

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from orbit2_tpu_torch.evaluate import materialize  # noqa: E402
from orbit2_tpu_torch.metrics.metrics import METRICS_REGISTRY  # noqa: E402
from orbit2_tpu_torch.models import ResSlimViT  # noqa: E402
from orbit2_tpu_torch.models.components.blocks import DropPath, Mlp  # noqa: E402
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
    kw = dict(attention_impl="auto", drop_rate=drop, drop_path=drop, remat=remat, **TINY, **model)
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
    if mode == "steps":
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world)
        run_steps(rank, sys.argv[6], sys.argv[5])
    else:  # torchrun's variables, for the CLI's init_distributed
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                          MASTER_ADDR="localhost", MASTER_PORT=port)
        run_cli(rank, sys.argv[7], sys.argv[5], sys.argv[6])
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
