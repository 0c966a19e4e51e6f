"""Test-split evaluation on one device: the serving path of the port.

Counterpart of `Trainer.test` (orbit2_tpu/training/trainer.py:762-831) and
of examples/evaluate.py: a deterministic ResSlimViT forward on every test
batch, clip, denormalize, then rmse / pearson / mean_bias per output variable,
averaged over samples into the same `test/<metric>:<var>` dict.

Usage: python -m orbit2_tpu_torch.evaluate configs/interm_117m.yaml \
           [--torch-npz PATH] [--max-batches N] [--device cuda]

Device meshes, w8a8 serving, TILES tiling (div > 1) and Orbax checkpoints are
not ported: a config that asks for one raises.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
from typing import Dict, Mapping, Optional

import torch

from orbit2_tpu_torch.config import Config, load_config
from orbit2_tpu_torch.data.itermodule import IterDataModule
from orbit2_tpu_torch.training.checkpoint import load_state_npz
from orbit2_tpu_torch.training.train import evaluate_batch, make_eval_step
from orbit2_tpu_torch.utils.loaders import load_downscaling_module

log = logging.getLogger("orbit2_tpu_torch")


def model_kwargs(c: Config) -> dict:
    """The ResSlimViT arguments of a config, weights drawn from trainer.seed."""
    m = c.model
    return dict(
        default_vars=c.data.default_vars, superres_mag=m.superres_mag, cnn_ratio=m.cnn_ratio,
        patch_size=m.patch_size, embed_dim=m.embed_dim, depth=m.depth,
        decoder_depth=m.decoder_depth, num_heads=m.num_heads, mlp_ratio=m.mlp_ratio,
        drop_path=m.drop_path, drop_rate=m.drop_rate, attention_impl=m.attention_impl,
        gelu_approx=m.gelu_approx, data_type=c.trainer.data_type, moe_experts=m.moe_experts,
        pipeline_stages=c.parallelism.pipeline,
        generator=torch.Generator().manual_seed(c.trainer.seed))


def check_scope(cfg: Config) -> None:
    if cfg.trainer.task != "downscaling":
        raise NotImplementedError(f"task {cfg.trainer.task!r}: only downscaling is ported")
    par = cfg.parallelism
    if par.auto or par.world_size != 1:
        raise NotImplementedError(
            "device meshes are not ported: the evaluator runs on one device — set every "
            "parallelism size to 1 and auto to false")
    if cfg.tiling.effective_div > 1:
        raise NotImplementedError("TILES tiling (div > 1) is not ported: set do_tiling false")


class Evaluator:
    """Builds the data module and model of `config` on `device` (the card
    unless the caller asks for "cpu"); `test()`
    evaluates the test split. `state_dict` (reference layout, e.g. from
    training/checkpoint.py::state_dict_from_jax_params) is loaded strictly;
    without one the weights are drawn from `config.trainer.seed`."""

    def __init__(self, config: Config, device="cuda",
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 data_key: Optional[str] = None):
        self.cfg = c = config.validate()
        check_scope(c)
        self.device = torch.device(device)
        self.data_key = data_key or next(iter(c.data.low_res_dir))
        self.data_module = dm = IterDataModule(
            "downscaling", c.data.low_res_dir[self.data_key],
            c.data.high_res_dir[self.data_key], c.data.dict_in_variables[self.data_key],
            out_vars=c.data.dict_out_variables[self.data_key], subsample=1,
            batch_size=c.trainer.batch_size, buffer_size=c.trainer.buffer_size,
            num_workers=c.trainer.num_workers, drop_last=True, div=1, overlap=0,
            seed=c.trainer.data_seed if c.trainer.data_seed is not None else c.trainer.seed)
        dm.setup("test")
        (self.model, _, _, self.test_losses, _, _,
         self.test_transforms) = load_downscaling_module(dm, c.model.preset, model_kwargs(c))
        in_shape, _ = dm.get_data_dims()
        in_vars, out_vars = dm.get_data_variables()
        self.model.for_phase(spatial_resolution=c.data.spatial_resolution[self.data_key],
                             img_size=tuple(in_shape[-2:]), in_channels=len(in_vars),
                             out_channels=len(out_vars))
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        # serving holds the parameters in the compute dtype: no per-use casts
        self.model.to(self.device, self.model.dtype).eval()

    def test(self, max_batches: Optional[int] = None) -> Dict[str, float]:
        dm = self.data_module
        in_vars, out_vars = dm.get_data_variables()
        step = make_eval_step(self.model, in_vars, out_vars)
        agg: Dict[str, float] = {}
        n = 0
        loader = iter(dm.test_dataloader())
        try:
            for batch in itertools.islice(loader, max_batches):
                x = torch.from_numpy(batch[0]).to(self.device)
                y = torch.from_numpy(batch[1]).to(self.device)
                losses = evaluate_batch(step(x, y), y, "test", self.test_losses,
                                        self.test_transforms, out_vars)
                values = torch.stack(list(losses.values())).tolist()  # one sync per batch
                for k, v in zip(losses, values):
                    agg[k] = agg.get(k, 0.0) + v * x.shape[0]
                n += x.shape[0]
        finally:
            loader.close()
        return {k: v / max(1, n) for k, v in agg.items()}


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("--torch-npz", default=None,
                   help="reference-layout state_dict saved as an npz of numpy arrays")
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--data-key", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    state_dict = None
    if args.torch_npz:
        state_dict = load_state_npz(args.torch_npz)
    else:
        log.warning("no --torch-npz: evaluating weights drawn from trainer.seed")
    ev = Evaluator(cfg, args.device, state_dict=state_dict, data_key=args.data_key)
    means = ev.test(max_batches=args.max_batches)
    print(json.dumps({k: round(float(v), 6) for k, v in means.items()}, indent=2))


if __name__ == "__main__":
    main()
