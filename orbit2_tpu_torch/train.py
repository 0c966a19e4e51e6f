"""Train the downscaling model on one device: the port's counterpart of
examples/train.py.

Usage: python -m orbit2_tpu_torch.train configs/interm_117m.yaml \
           [--torch-npz PATH] [--max-epochs N] [--max-steps-per-epoch N] [--device cuda]

Prints one JSON history record per epoch. Trains on TILES tiles where the
config sets `tiling.do_tiling`, with per-Block recomputation where it sets
`trainer.remat`. Checkpoint save/resume, validation during fit and device
meshes are not ported: a config that asks for one raises.
"""

from __future__ import annotations

import argparse
import json
import logging

from orbit2_tpu_torch.config import load_config
from orbit2_tpu_torch.training.checkpoint import load_state_npz
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
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    state_dict = None
    if args.torch_npz:
        state_dict = load_state_npz(args.torch_npz)
    else:
        log.warning("no --torch-npz: training from weights drawn from trainer.seed")
    trainer = Trainer(load_config(args.config), args.device, state_dict=state_dict)
    for record in trainer.fit(args.max_epochs, args.max_steps_per_epoch):
        print(json.dumps(record))


if __name__ == "__main__":
    main()
