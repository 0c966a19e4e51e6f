"""Fine-tune from pretrained weights: the port's counterpart of
examples/finetune.py (reference examples/era5_daymet_downscaling.py:201-572).
On one device, or, under torchrun (one process a card: the CLI joins the
group its variables describe), on the config's mesh as written, as
examples/finetune.py's Trainer builds it (no scale-down; rank 0 prints).

Usage: python -m orbit2_tpu_torch.finetune configs/interm_1b.yaml \
           [--pretrain PATH] [--arch {res_slimvit,resnet,unet,vit}] \
           [--loss {mse,bayesian_tv,quantile,imagegradient,masked_mse}] \
           [--max-epochs N] [--max-steps-per-epoch N] [--checkpoint-dir DIR] \
           [--device cuda]
       torchrun --nproc-per-node N -m orbit2_tpu_torch.finetune CONFIG [...]

--pretrain takes a port checkpoint directory (epoch_N) or a reference-layout
state_dict saved as an npz (the JAX package's `export_torch_state_dict`
writes one). The pretrained weights are merged into the Trainer's model
with the reference's filter (training/checkpoint.py::load_pretrained_params:
keys the model lacks and keys of another shape are dropped, pos_embed is
resized to the tiles' grid; evaluate.py::weight_fill and materialize fill
the model one unit at a time, drawing from trainer.seed only where keys are
left unfilled), and it fits, saving each
epoch under --checkpoint-dir (default checkpoints/finetune, apart from the
train CLI's checkpoints/climate that the pretrained weights usually come
from); a checkpoint already there resumes instead, as in JAX, so --pretrain
may not lie inside it. Prints one JSON history record per epoch.

--arch resnet | unet | vit fine-tunes the model-hub presets behind a
bilinear upsample to the target grid (utils/loaders.py::PreInterpolated),
imported the same way (each preset one unit; a pretrained conv model's
BatchNorm running statistics carried over, as examples/finetune.py:55-57
carries them). --loss masked_mse takes the data module's validity mask (the
Trainer wires it; TILES tiling refuses it, as in JAX). --loss perceptual
raises NotImplementedError: LPIPS is not ported.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import torch
import torch.distributed as dist

from orbit2_tpu_torch.config import load_config
from orbit2_tpu_torch.evaluate import materialize, model_kwargs, weight_fill
from orbit2_tpu_torch.parallel.mesh import in_mesh, init_distributed
from orbit2_tpu_torch.training.checkpoint import load_state_npz, restore_checkpoint
from orbit2_tpu_torch.training.trainer import Trainer
from orbit2_tpu_torch.utils.loaders import load_architecture

log = logging.getLogger("orbit2_tpu_torch")

# examples/finetune.py's choices
ARCHS = ("res_slimvit", "resnet", "unet", "vit")
LOSSES = ("mse", "bayesian_tv", "perceptual", "quantile", "imagegradient", "masked_mse")
FINETUNE_CHECKPOINT_DIR = os.path.join("checkpoints", "finetune")


def _inside(path: str, directory: str) -> bool:
    path, directory = os.path.realpath(path), os.path.realpath(directory)
    return os.path.commonpath([path, directory]) == directory


def main(argv=None) -> dict:
    """Returns {"history": the fit's records, "pretrain": the import report
    (None without --pretrain)}."""
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("--pretrain", default=None,
                   help="a port checkpoint directory or a reference-layout .npz")
    p.add_argument("--arch", default="res_slimvit", choices=ARCHS)
    p.add_argument("--loss", default="mse", choices=LOSSES)
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--max-steps-per-epoch", type=int, default=None)
    p.add_argument("--checkpoint-dir", default=FINETUNE_CHECKPOINT_DIR)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.loss == "perceptual":
        raise NotImplementedError(
            "--loss perceptual (L1 + LPIPS over VGG16) is not ported: the repo holds no trained "
            "LPIPS weights to hold it against (ROADMAP.md section 1, queue 1 item 7)")

    if args.pretrain and _inside(args.pretrain, args.checkpoint_dir):
        raise ValueError(
            f"--pretrain {args.pretrain} lies in --checkpoint-dir {args.checkpoint_dir}: the fit "
            "would resume from that directory's newest checkpoint over the pretrained weights; "
            "give the fine-tune a directory of its own")
    init_distributed(args.device)  # torchrun's group, where its variables are set
    cfg = load_config(args.config)
    cfg.model.preset = args.arch
    cfg.trainer.train_loss = args.loss
    trainer = Trainer(cfg, args.device, checkpoint_dir=args.checkpoint_dir)
    report = None
    # a rank past the mesh imports nothing: its fit returns at once
    if args.pretrain and (trainer.mesh is None or in_mesh(trainer.mesh)):
        dm = trainer.data_module(next(iter(cfg.data.low_res_dir)))
        if args.pretrain.endswith(".npz"):
            pretrained = load_state_npz(args.pretrain)
        else:
            pretrained = restore_checkpoint(args.pretrain)["model"]
        c = trainer.cfg
        with torch.device("meta"):
            model = load_architecture(dm, c.model.preset, **dict(model_kwargs(c), generator=None))
        fill, drawn, report = weight_fill(c, dm, model, pretrained)
        generator = torch.Generator().manual_seed(c.trainer.seed) if drawn else None
        materialize(model, "cpu", generator=generator, fill=fill)
        log.info("pretrain import: %d used, %d dropped, %d resized", len(report["used"]),
                 len(report["dropped"]), len(report["resized"]))
        trainer.build_model(dm, model.state_dict())
    history = trainer.fit(args.max_epochs, args.max_steps_per_epoch)
    if not dist.is_initialized() or dist.get_rank() == 0:
        for record in history:
            print(json.dumps(record))
    return {"history": history, "pretrain": report}


if __name__ == "__main__":
    main()
