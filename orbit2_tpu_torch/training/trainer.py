"""Trainer.fit on one device (counterpart of orbit2_tpu/training/trainer.py:
29-65, 188-323, 370-585; the reference's main() loop,
examples/intermediate_downscaling.py:379-832).

The loop is the JAX Trainer's: the curriculum over `data.low_res_dir` keys
(each phase rebinds the same parameters to its geometry with `for_phase`),
the learning rate set once per epoch from the warmup-cosine schedule, batches
cast to bf16 on the host when `data_type: bfloat16` (half the copy bytes),
and losses kept on the device with one readback fence per 32 steps and one at
the end of the epoch. Each epoch appends a history record {epoch, data_key,
loss, batches, seconds, lr, data_wait_s, fence_wait_s, h2d_bytes}.

Randomness: the dropout sites draw their seeds from a CPU generator seeded
with trainer.seed + 17 (the JAX Trainer's dropout key, trainer.py:393), and
DropPath its masks from a second CPU generator seeded with trainer.seed + 18,
the JAX package's separate drop_path stream. Both are host-side, so a step on
the card and the same step on the CPU see the same masks and no draw waits
for the device.

A config with `tiling.do_tiling` trains on its TILES tiles (div x div halo
tiles of each field, the JAX Trainer's train batches), after the JAX
Trainer's tile check (trainer.py:129-186); `trainer.remat` and
`trainer.remat_policy` recompute each Block's activations in the backward
(models/res_slimvit.py::remat_block), which changes no value.

Not ported, and raising NotImplementedError when configured: checkpoint
save/resume (`trainer.checkpoint`, a checkpoint_dir), validation during fit,
device meshes, MoE and pipeline trunks.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Mapping, Optional

import torch

from orbit2_tpu_torch.config import Config
from orbit2_tpu_torch.data.itermodule import IterDataModule
from orbit2_tpu_torch.evaluate import check_scope, check_tiling, make_data_module, model_kwargs
from orbit2_tpu_torch.training.optim import make_lr_scheduler, make_optimizer, set_learning_rate
from orbit2_tpu_torch.training.train import make_train_step
from orbit2_tpu_torch.utils.loaders import load_downscaling_module

log = logging.getLogger("orbit2_tpu_torch")

FENCE_EVERY = 32
DROPOUT_SEED_OFFSET = 17
DROP_PATH_SEED_OFFSET = 18


class Trainer:
    """Builds the data modules, model and optimizer of `config` on `device`
    (the card unless the caller asks for "cpu").
    `state_dict` (reference layout, e.g. from
    training/checkpoint.py::state_dict_from_jax_params) is loaded strictly
    as the initial parameters (the model is then built on the meta device
    and nothing is drawn); without one they are drawn from
    `config.trainer.seed`."""

    def __init__(self, config: Config, device="cuda",
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 checkpoint_dir: Optional[str] = None, run_validation: bool = False):
        self.cfg = c = config.validate()
        check_scope(c)
        if checkpoint_dir is not None or c.trainer.checkpoint:
            raise NotImplementedError("checkpoint save/resume is not ported yet")
        if run_validation:
            raise NotImplementedError("validation during fit is not ported yet")
        if c.model.moe_experts or c.parallelism.pipeline > 1:
            raise NotImplementedError("MoE and pipeline trunks are not ported yet")
        self.device = torch.device(device)
        self.state_dict = state_dict
        self.model = None
        self.optimizer = None
        self.lr_schedule = None
        self.history: list = []
        self._data_modules: Dict[str, IterDataModule] = {}

    def _build_model(self, dm: IterDataModule) -> None:
        c = self.cfg
        kwargs = dict(model_kwargs(c), remat=c.trainer.remat,
                      remat_policy=c.trainer.remat_policy)
        if self.state_dict is None:
            (self.model, self.train_loss, _, _, _, _, _) = load_downscaling_module(
                dm, c.model.preset, kwargs, train_loss=c.trainer.train_loss)
            self.model.to(self.device)
        else:
            with torch.device("meta"):
                (self.model, self.train_loss, _, _, _, _, _) = load_downscaling_module(
                    dm, c.model.preset, dict(kwargs, generator=None),
                    train_loss=c.trainer.train_loss)
            self.model.to_empty(device=self.device)
            self.model.load_state_dict(self.state_dict, strict=True)
        n = sum(p.numel() for p in self.model.parameters())
        log.info("initialized %.2fM params on %s", n / 1e6, self.device)

    def _phase(self, dm: IterDataModule, data_key: str) -> None:
        in_shape, _ = dm.get_data_dims()
        in_vars, out_vars = dm.get_data_variables()
        self.model.for_phase(spatial_resolution=self.cfg.data.spatial_resolution[data_key],
                             img_size=tuple(in_shape[-2:]), in_channels=len(in_vars),
                             out_channels=len(out_vars))

    def _put(self, a, dtype: Optional[torch.dtype]) -> torch.Tensor:
        t = torch.from_numpy(a)
        if dtype is not None:
            t = t.to(dtype)  # on the host, before the copy
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def fit(self, max_epochs: Optional[int] = None,
            max_steps_per_epoch: Optional[int] = None) -> list:
        c = self.cfg
        max_epochs = max_epochs if max_epochs is not None else c.trainer.max_epochs
        interval = c.trainer.interval_epochs
        self.lr_schedule = make_lr_scheduler("linear-warmup-cosine-annealing", {
            "lr": c.model.lr, "warmup_epochs": c.model.warmup_epochs, "max_epochs": max_epochs,
            "warmup_start_lr": c.model.warmup_start_lr, "eta_min": c.model.eta_min})
        dropout_gen = torch.Generator().manual_seed(c.trainer.seed + DROPOUT_SEED_OFFSET)
        drop_path_gen = torch.Generator().manual_seed(c.trainer.seed + DROP_PATH_SEED_OFFSET)
        stage_dtype = torch.bfloat16 if c.trainer.data_type == "bfloat16" else None
        steps = {}

        epoch_start = 0
        while epoch_start < max_epochs:
            for data_key in c.data.low_res_dir:
                dm = self._data_modules.get(data_key)
                if dm is None:
                    dm = make_data_module(c, data_key, c.tiling.effective_div,
                                          c.tiling.effective_overlap)
                    check_tiling(c, dm)
                    self._data_modules[data_key] = dm
                if self.model is None:
                    self._build_model(dm)
                    self.optimizer = make_optimizer("adamw", {
                        "lr": c.model.lr, "weight_decay": c.model.weight_decay,
                        "betas": (c.model.beta_1, c.model.beta_2),
                        "mu_dtype": c.trainer.adam_mu_dtype,
                        "nu_dtype": c.trainer.adam_nu_dtype,
                    }, self.model.parameters())
                self._phase(dm, data_key)
                in_vars, out_vars = dm.get_data_variables()
                if data_key not in steps:
                    steps[data_key] = make_train_step(
                        self.model, self.train_loss, c.data.var_weights, self.optimizer,
                        in_vars, out_vars, grad_accum=c.trainer.grad_accum)
                train_step = steps[data_key]

                epoch_end = min(epoch_start + interval, max_epochs)
                for epoch in range(epoch_start, epoch_end):
                    set_learning_rate(self.optimizer, self.lr_schedule(epoch))
                    self.history.append(self._epoch(
                        epoch, data_key, dm, train_step, dropout_gen, drop_path_gen,
                        stage_dtype, max_steps_per_epoch))
                    log.info("epoch %d %s: %s", epoch, data_key, self.history[-1])
                epoch_start = epoch_end
                if epoch_start >= max_epochs:
                    break
        return self.history

    def _epoch(self, epoch, data_key, dm, train_step, dropout_gen, drop_path_gen, stage_dtype,
               max_steps) -> dict:
        t0 = time.perf_counter()
        # losses stay on the device: a readback every step would make the
        # host wait for each step before it can launch the next
        step_losses = []
        data_wait_s = fence_wait_s = 0.0
        h2d_bytes = 0
        it = iter(dm.train_dataloader())
        try:
            while not max_steps or len(step_losses) < max_steps:
                tw = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    break
                x, y = self._put(batch[0], stage_dtype), self._put(batch[1], stage_dtype)
                data_wait_s += time.perf_counter() - tw
                h2d_bytes += x.nbytes + y.nbytes
                step_losses.append(train_step(x, y, dropout_gen, drop_path_gen))
                if len(step_losses) % FENCE_EVERY == 0:
                    tf = time.perf_counter()
                    step_losses[-1].item()
                    fence_wait_s += time.perf_counter() - tf
        finally:
            it.close()
        tf = time.perf_counter()
        total = torch.stack(step_losses).sum().item() if step_losses else 0.0
        fence_wait_s += time.perf_counter() - tf
        return {"epoch": epoch, "data_key": data_key,
                "loss": total / max(1, len(step_losses)), "batches": len(step_losses),
                "seconds": time.perf_counter() - t0, "lr": self.lr_schedule(epoch),
                "data_wait_s": round(data_wait_s, 4), "fence_wait_s": round(fence_wait_s, 4),
                "h2d_bytes": h2d_bytes}


__all__ = ["Trainer"]
