"""Train the downscaling model on one device: the port's counterpart of
examples/train.py.

Usage: python -m orbit2_tpu_torch.train configs/interm_117m.yaml \
           [--torch-npz PATH] [--max-epochs N] [--max-steps-per-epoch N] \
           [--checkpoint-dir DIR] [--validate] [--keep-last N] [--async-checkpoints] \
           [--device cuda]

Prints one JSON history record per epoch, then the last validation's means
and sample count where --validate asked for them. Trains on TILES tiles where
the config sets `tiling.do_tiling`, with per-Block recomputation where it
sets `trainer.remat`. Saves `epoch_N` under --checkpoint-dir (default
checkpoints/climate, the JAX Trainer's) after each epoch, keeping the newest
--keep-last (0: all), and resumes from `trainer.checkpoint` or the newest
`epoch_N` there. Device meshes are not ported: a config that asks for one
raises.
"""

from __future__ import annotations

import argparse
import json
import logging

from orbit2_tpu_torch.config import load_config
from orbit2_tpu_torch.training.checkpoint import DEFAULT_CHECKPOINT_DIR, load_state_npz
from orbit2_tpu_torch.training.trainer import Trainer

log = logging.getLogger("orbit2_tpu_torch")


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

    state_dict = None
    if args.torch_npz:
        state_dict = load_state_npz(args.torch_npz)
    else:
        log.warning("no --torch-npz: training from weights drawn from trainer.seed")
    trainer = Trainer(load_config(args.config), args.device, state_dict=state_dict,
                      checkpoint_dir=args.checkpoint_dir, run_validation=args.validate,
                      keep_last_checkpoints=args.keep_last,
                      async_checkpoints=args.async_checkpoints)
    for record in trainer.fit(args.max_epochs, args.max_steps_per_epoch):
        print(json.dumps(record))
    if trainer.last_validation is not None:
        print(json.dumps({"validation": trainer.last_validation}))
    return trainer


if __name__ == "__main__":
    main()
