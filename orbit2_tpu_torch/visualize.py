"""Stitched full-field inference on one device or a device mesh (counterpart
of examples/visualize.py): the model's TILES tiles stitched back into one full
test field, denormalized, dumped as npy per output variable, with PSNR/SSIM.

Usage: python -m orbit2_tpu_torch.visualize configs/interm_1b.yaml \
           [--checkpoint DIR | --torch-npz PATH] [--index N] [--out-dir DIR] \
           [--quant {none,w8a8}] [--device cuda]

Two data modules, as in the reference (examples/visualize.py:341-378): the
Evaluator's tiled one gives the model its per-tile geometry, and an untiled
one (div 1, overlap 0) locates the full sample that is stitched. The weights
are found and merged as the evaluate CLI's are (evaluate.py::serving_weights:
--torch-npz, --checkpoint, `trainer.checkpoint`, the newest `epoch_N` under
checkpoints/climate, merged by the Evaluator), else drawn from trainer.seed.

Under torchrun (one process a card) it joins the group torchrun's variables
describe and stitches on the config's mesh as written: every rank of the
mesh runs every tile (the forward is collective) on the whole untiled test
split's sample, and rank 0 writes the files and prints; the ranks past the
mesh are idle.
"""

from __future__ import annotations

import argparse
import json
import logging

import torch.distributed as dist

from orbit2_tpu_torch.config import load_config
from orbit2_tpu_torch.evaluate import Evaluator, make_data_module, serving_weights
from orbit2_tpu_torch.models.components.blocks import QUANT_MODES
from orbit2_tpu_torch.parallel.mesh import init_distributed
from orbit2_tpu_torch.utils.memory import device_memory_stats
from orbit2_tpu_torch.utils.visualize import model_forward_fn, visualize_at_index

log = logging.getLogger("orbit2_tpu_torch")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("--checkpoint", default=None, help="a port checkpoint directory (epoch_N)")
    p.add_argument("--torch-npz", default=None,
                   help="reference-layout state_dict saved as an npz of numpy arrays")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--out-dir", default="visualizations")
    p.add_argument("--data-key", default=None)
    p.add_argument("--quant", default="none", choices=QUANT_MODES,
                   help="w8a8: stitch through the int8 trunk (ops/quant.py)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    init_distributed(args.device)  # torchrun's group, where its variables are set
    cfg = load_config(args.config)
    state_dict = serving_weights(cfg, args.checkpoint, args.torch_npz)
    if state_dict is None:
        log.warning("no checkpoint: visualizing weights drawn from trainer.seed")
    ev = Evaluator(cfg, args.device, state_dict=state_dict, data_key=args.data_key,
                   quant_modes=(args.quant,))
    if ev.idle:
        return None
    div, overlap = cfg.tiling.effective_div, cfg.tiling.effective_overlap
    # the whole split, untiled: on a mesh every rank stitches the same sample
    dm_vis = (ev.data_module if div == 1 and ev.mesh is None
              else make_data_module(cfg, ev.data_key, 1, 0, "test"))
    in_vars, out_vars = ev.data_module.get_data_variables()
    fwd = model_forward_fn(ev.serving_model(args.quant), in_vars, out_vars)
    res = visualize_at_index(fwd, dm_vis, index=args.index, div=div, overlap=overlap,
                             mag=cfg.model.superres_mag, out_dir=args.out_dir)
    for var, m in res["metrics"].items():
        log.info("%s: PSNR=%.2f SSIM=%.4f", var, m["psnr"], m["ssim"])
    log.info("memory: %s", device_memory_stats(ev.device))
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(res["metrics"]))
    return res


if __name__ == "__main__":
    main()
