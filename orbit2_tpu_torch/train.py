"""Train the downscaling model: the port's counterpart of examples/train.py.

Usage: python -m orbit2_tpu_torch.train configs/interm_117m.yaml \
           [--torch-npz PATH] [--max-epochs N] [--max-steps-per-epoch N] \
           [--checkpoint-dir DIR] [--validate] [--keep-last N] [--async-checkpoints] \
           [--device cuda]
       torchrun --nproc-per-node N -m orbit2_tpu_torch.train CONFIG [...]

The world is the number of processes: torchrun's (one per device, NCCL on
"cuda", gloo on "cpu"), else 1. Where the config's mesh asks for another
number of devices, its `parallelism` is scaled to the world as
examples/train.py:28-48 does (`scale_parallelism`) and logged: tensor_par by
gcd, fsdp first and simple_ddp the rest, seq_par to 1, both data axes halved
until they divide trainer.batch_size; pipeline and expert_par are left as
they are, so a config that needs them then raises JAX's ValueError (mesh
larger than the devices). The world and the parallelism it trains on are
logged; the Trainer trains on that mesh (training/trainer.py; one device at
world 1).

Rank 0 prints one JSON history record per epoch, then the last validation's
means and sample count where --validate asked for them. Trains on TILES
tiles where the config sets `tiling.do_tiling`, with per-Block recomputation
where it sets `trainer.remat`. Saves `epoch_N` under --checkpoint-dir
(default checkpoints/climate, the JAX Trainer's) after each epoch, keeping
the newest --keep-last (0: all), and resumes from `trainer.checkpoint` or the
newest `epoch_N` there, whatever mesh wrote it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math

import torch.distributed as dist

from orbit2_tpu_torch.config import Config, load_config
from orbit2_tpu_torch.parallel.mesh import init_distributed
from orbit2_tpu_torch.training.checkpoint import DEFAULT_CHECKPOINT_DIR, load_state_npz
from orbit2_tpu_torch.training.trainer import Trainer

log = logging.getLogger("orbit2_tpu_torch")


def scale_parallelism(cfg: Config, world: int) -> Config:
    """examples/train.py:28-48's scale-down of the config's mesh to `world`
    devices, in place (and returned); nothing changes where the mesh is
    already `world` devices."""
    par = cfg.parallelism
    if par.world_size == world:
        return cfg
    log.warning("config wants %d devices, found %d — scaling parallelism down",
                par.world_size, world)
    par.tensor_par = math.gcd(par.tensor_par, world)
    rest = world // par.tensor_par
    par.fsdp = math.gcd(par.fsdp, rest)
    par.simple_ddp = rest // par.fsdp
    par.seq_par = 1
    # the data axes split the batch: shrink until they divide it
    while par.simple_ddp > 1 and cfg.trainer.batch_size % par.data_par:
        par.simple_ddp //= 2
    while par.fsdp > 1 and cfg.trainer.batch_size % par.data_par:
        par.fsdp //= 2
    return cfg


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("--torch-npz", default=None,
                   help="initial reference-layout state_dict saved as an npz of numpy arrays")
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--max-steps-per-epoch", type=int, default=None)
    p.add_argument("--checkpoint-dir", default=DEFAULT_CHECKPOINT_DIR)
    p.add_argument("--validate", action="store_true", help="validate after each epoch")
    p.add_argument("--keep-last", type=int, default=0,
                   help="keep the newest N epoch checkpoints (0: all)")
    p.add_argument("--async-checkpoints", action="store_true",
                   help="write checkpoints in a background thread")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    world = init_distributed(args.device)
    cfg = scale_parallelism(load_config(args.config), world)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    log.info("world %d, parallelism %s", world, json.dumps(dataclasses.asdict(cfg.parallelism)))
    state_dict = None
    if args.torch_npz:
        state_dict = load_state_npz(args.torch_npz)
    else:
        log.warning("no --torch-npz: training from weights drawn from trainer.seed")
    trainer = Trainer(cfg, args.device, state_dict=state_dict,
                      checkpoint_dir=args.checkpoint_dir, run_validation=args.validate,
                      keep_last_checkpoints=args.keep_last,
                      async_checkpoints=args.async_checkpoints)
    for record in trainer.fit(args.max_epochs, args.max_steps_per_epoch):
        if lead:
            print(json.dumps(record))
    if trainer.last_validation is not None and lead:
        print(json.dumps({"validation": trainer.last_validation}))
    return trainer


if __name__ == "__main__":
    main()
