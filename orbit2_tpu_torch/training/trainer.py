"""Trainer.fit on one device or a device mesh (counterpart of
orbit2_tpu/training/trainer.py: 29-65, 188-323, 370-700, 786-801, 859-872;
the reference's main() loop, examples/intermediate_downscaling.py:379-832).

The loop is the JAX Trainer's: the curriculum over `data.low_res_dir` keys
(each phase rebinds the same parameters to its geometry with `for_phase`),
the learning rate set once per epoch from the warmup-cosine schedule, batches
cast to bf16 on the host when `data_type: bfloat16` (half the copy bytes),
and losses kept on the device with one readback fence per 32 steps and one at
the end of the epoch. Each epoch appends a history record {epoch, data_key,
loss, batches, seconds, lr, data_wait_s, fence_wait_s, h2d_bytes}.

Checkpoints (training/checkpoint.py): with a `checkpoint_dir`, each epoch is
saved after its record as `epoch_{e}` (model, optimizer, epoch; in a
background thread with `async_checkpoints`), and then all but the newest
`keep_last_checkpoints` are pruned (0 keeps all). The first fit resumes from
`trainer.checkpoint`, else from the newest `epoch_N` in `checkpoint_dir`:
model, optimizer and epoch are restored and training goes on at epoch + 1
(an `epoch_N` of the JAX package's Orbax format is skipped with a log line).
A checkpoint found there wins over a `state_dict` passed in, as JAX's
restore overwrites pre-seeded parameters. Without a `checkpoint_dir` nothing
is saved and no directory is searched (`trainer.checkpoint` still resumes):
the JAX Trainer defaults to "checkpoints/climate", the port's CLIs do.

With `run_validation`, each epoch is validated after its save (JAX
Trainer.validate): the eval step over the phase's val split, partial tail
batch included, into sample-weighted means kept as `last_validation` =
{"means", "samples"} and logged.

Randomness: the dropout sites draw their seeds from a CPU generator seeded
with trainer.seed + 17 (the JAX Trainer's dropout key, trainer.py:393), and
DropPath its masks from a second CPU generator seeded with trainer.seed + 18,
the JAX package's separate drop_path stream. Both are host-side, so a step on
the card and the same step on the CPU see the same masks and no draw waits
for the device. Both start afresh at each fit, on a resume too, as JAX's key
does: a resumed run is the JAX Trainer's resumed run, not the uninterrupted
one.

A config with `tiling.do_tiling` trains on its TILES tiles (div x div halo
tiles of each field, the JAX Trainer's train batches), after the JAX
Trainer's tile check (trainer.py:129-186); `trainer.remat` and
`trainer.remat_policy` recompute each Block's activations in the backward
(models/res_slimvit.py::remat_block), which changes no value.

An MoE config (`model.moe_experts` > 0) trains its MoE trunk and adds
`model.moe_aux_weight` x the mean load-balance loss of its MoE Blocks to the
train loss, as the JAX Trainer does (trainer.py:455-461).

`trainer.task` forecasting and continuous-forecasting train the
forecasting presets (rasp-theurey-2020, linear-regression, ...) on the
config's history windows; the model-hub presets (vit, unet, resnet behind a
bilinear upsample) downscale. BatchNorm running statistics are the models'
buffers: train() mode moves them, validation and test run in eval() mode,
and checkpoints carry them. A loss with `set_mask` (masked_mse) takes the
data module's validity mask (`_wire_out_mask`, JAX trainer.py:238-265).

On a device mesh (the config's, whenever a process group runs:
parallel/mesh.py; one process drives one device): the model is built on
the meta device, sharded (parallel/sharding.py::shard_model: tensor
parallelism, the MoE expert stacks over (expert, tensor), the tokens over
seq where `parallelism.seq_par` > 1 (the model built with seq_shard and the
config's seq_impl, JAX trainer.py:44-46, :283-286), then FSDP2 per Block and
at the root over (replica, fsdp)) and each rank's shards are filled unit by
unit (evaluate.py::materialize), with the one-process draws from
trainer.seed or the `state_dict`. The model-hub presets (resnet, unet, vit,
rasp-theurey-2020) take the same path: one unit, the hub ViT's Blocks split
over tensor as the ResSlimViT's, the CNNs replicated over it (every tensor
rank repeats the same work, as under JAX's replicated convs) and over a seq
axis (JAX splits their batch over the data axes alone); their BatchNorms
take the global batch's statistics (models/components/cnn.py), so the
running averages are the same on every rank, and their dropout sites fold
the rank's data coordinates. With grad_accum > 1 a BatchNorm's microbatch
statistics are taken over each data rank's i-th chunk, where JAX takes the
global batch's i-th contiguous chunk: the same samples only at one data
rank. The train step sums the Blocks' gradients
over seq (training/train.py). Each data rank (replica, fsdp) reads its own
file shards in batches of batch_size / its count; the expert, seq and
tensor ranks of one data rank read the same ones. An MoE trunk's aux loss
is the whole routing's on every rank, weighted as on one device. The epoch is
clamped to the least number of batches of any rank (JAX trainer.py:470-490);
the records' loss is the mean over the data ranks. Validation pads a short
rank with zero batches that count no sample (JAX `_synced_batches`,
trainer.py:621-685) and takes each round's metrics over the global batch,
every data rank's prediction and target gathered (evaluate.py::gather_rows,
as Evaluator.test does), as JAX's one-process mesh validates it.
Rank 0 writes the checkpoint, the model and the moments gathered whole, so
a checkpoint resumes on any mesh, or on one device. As JAX's mesh takes the
first devices, the mesh takes the first ranks: where the world is larger
(the scale-down halved the data axes to divide the batch), the ranks past
the mesh are idle and their fit returns at once with no record.

On a mesh with a stage axis (`parallelism.pipeline` S > 1) the trunk is
pipelined (parallel/pipeline.py): each stage rank holds its stage's Blocks
alone (GPipe, or interleaved with `pipeline_interleave`, over
`pipeline_microbatches` microbatches of its local batch), and the fill
still draws every unit in init_units order from the one generator, the
Blocks held elsewhere too, and drops those, so a pipelined run starts from
the one-process parameters. The stage ranks of one data rank read the same
batches; every stage computes the loss, the validation and the records on
the same output. A checkpoint saved there holds the whole model and moments
in the reference layout (the Blocks handed over the stage group), and a
stage rank resumes its own part of one.

A mesh larger than the world raises JAX's ValueError; then
`parallelism.auto` raises NotImplementedError (evaluate.py::check_mesh,
check_scope). A model-hub preset with a stage or expert axis above 1 raises
JAX's ConfigError (config.py), as JAX does.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from orbit2_tpu_torch.config import Config
from orbit2_tpu_torch.data.itermodule import IterDataModule
from orbit2_tpu_torch.evaluate import (
    build_sharded, check_mesh, check_tiling, check_scope, gather_rows, load_module,
    make_data_module, model_kwargs, pad_rows, synced_batches)
from orbit2_tpu_torch.parallel.mesh import (
    all_ranks, comm_device, data_group, data_rank, data_size, in_mesh, mesh_from_config,
    world_size)
from orbit2_tpu_torch.parallel.sharding import (
    full_named, full_state_dict, held_state, load_full_state_dict)
from orbit2_tpu_torch.training.checkpoint import (
    latest_port_checkpoint, prune_checkpoints, restore_checkpoint, save_checkpoint,
    wait_for_async_saves)
from orbit2_tpu_torch.training.optim import make_lr_scheduler, make_optimizer, set_learning_rate
from orbit2_tpu_torch.training.train import evaluate_batch, make_eval_step, make_train_step

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
    `config.trainer.seed`. The module docstring says what `checkpoint_dir`,
    `keep_last_checkpoints`, `async_checkpoints` and `run_validation` do.
    Where a process group runs, the Trainer trains on the config's mesh
    (`mesh`); else `mesh` is None (one device, the model unwrapped)."""

    def __init__(self, config: Config, device="cuda",
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 checkpoint_dir: Optional[str] = None, run_validation: bool = False,
                 keep_last_checkpoints: int = 0, async_checkpoints: bool = False):
        self.cfg = c = config.validate()
        check_mesh(c, world_size())
        check_scope(c)
        self.device = torch.device(device)
        self.mesh = (mesh_from_config(c.parallelism, self.device.type) if dist.is_initialized()
                     else None)
        self.state_dict = state_dict
        self.checkpoint_dir = checkpoint_dir
        self.run_validation = run_validation
        self.keep_last_checkpoints = keep_last_checkpoints
        self.async_checkpoints = async_checkpoints
        self.model = None
        self.optimizer = None
        self.lr_schedule = None
        self.history: list = []
        self.last_validation: Optional[dict] = None
        self._data_modules: Dict[str, IterDataModule] = {}

    def data_module(self, data_key: str) -> IterDataModule:
        """The phase's data module at the config's tiling, every split set
        up, tile-checked; made once per data key."""
        dm = self._data_modules.get(data_key)
        if dm is None:
            c = self.cfg
            ranks = ({} if self.mesh is None else
                     dict(data_par_size=data_size(self.mesh), data_par_rank=data_rank(self.mesh)))
            dm = make_data_module(c, data_key, c.tiling.effective_div, c.tiling.effective_overlap,
                                  **ranks)
            check_tiling(c, dm)
            self._data_modules[data_key] = dm
        return dm

    def build_model(self, dm: IterDataModule, state_dict=None) -> None:
        """The config's model on the device, with its train and val losses:
        drawn from trainer.seed, or, given a `state_dict`, built on the meta
        device (nothing drawn) and filled strictly from it."""
        c = self.cfg
        kwargs = dict(model_kwargs(c), remat=c.trainer.remat,
                      remat_policy=c.trainer.remat_policy)
        if self.mesh is not None:
            self._build_sharded(dm, kwargs, state_dict)
            return
        meta = state_dict is not None
        with torch.device("meta") if meta else contextlib.nullcontext():
            (self.model, self.train_loss, self.val_losses, self.test_losses, _,
             self.val_transforms, _) = load_module(c, dm,
                                                   dict(kwargs, generator=None) if meta else kwargs)
        self._wire_out_mask(dm)
        if meta:
            self.model.to_empty(device=self.device)
            self.model.load_state_dict(state_dict, strict=True)
        else:
            self.model.to(self.device)
        n = sum(p.numel() for p in self.model.parameters())
        log.info("initialized %.2fM params on %s", n / 1e6, self.device)

    def _build_sharded(self, dm: IterDataModule, kwargs: dict, state_dict) -> None:
        """The model on the mesh: built on the meta device, sharded, and each
        rank's shards filled unit by unit from the one-process draws (the
        host generator of trainer.seed, init_units order) or from
        `state_dict` (strictly); no rank holds more than one whole unit."""
        c = self.cfg
        with torch.device("meta"):
            (skeleton, self.train_loss, self.val_losses, self.test_losses, _,
             self.val_transforms, _) = load_module(c, dm, dict(kwargs, generator=None))
        self._wire_out_mask(dm)
        fill, generator = None, kwargs["generator"]
        if state_dict is not None:
            want = set(skeleton.state_dict())  # a stage rank's model holds part of the trunk
            if set(state_dict) != want:
                raise KeyError(f"state dict: missing {sorted(want - set(state_dict))}, "
                               f"unexpected {sorted(set(state_dict) - want)}")
            fill, generator = (lambda keys: {k: state_dict[k] for k in keys}), None
        self.model = build_sharded(skeleton, self.mesh, self.device, "cpu", generator, fill)
        n = sum(p.numel() for p in self.model.parameters())
        log.info("initialized %.2fM params on mesh %s", n / 1e6,
                 dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape)))

    def _wire_out_mask(self, dm: IterDataModule) -> None:
        """Hands the data module's validity mask to every loss that takes one
        (masked_mse's set_mask), as the JAX Trainer does (trainer.py:238-265):
        masked losses are full-grid, so TILES tiling with one raises
        ValueError; a data module without a mask leaves them unmasked."""
        losses = [self.train_loss, *(self.val_losses or []), *(self.test_losses or [])]
        maskable = [l for l in losses if hasattr(l, "set_mask")]
        if not maskable:
            return
        mask = dm.get_out_mask()
        if mask is None:
            log.warning("mask-aware loss requested but the data module derives no validity "
                        "mask — running unmasked")
            for l in maskable:
                l.set_mask(None)
            return
        if self.cfg.tiling.effective_div > 1:
            raise ValueError("masked losses need full-grid targets; disable tiling.do_tiling "
                             "for masked fine-tuning")
        for l in maskable:
            l.set_mask(mask)
        log.info("wired validity mask (%.1f%% valid) into %d losses",
                 100.0 * float(np.asarray(mask).mean()), len(maskable))

    def _start(self, dm: IterDataModule) -> int:
        """Builds the model (unless the caller has) and the optimizer, and
        resumes them and the epoch from `trainer.checkpoint` or the newest
        checkpoint of checkpoint_dir, where there is one. Returns the first
        epoch to train."""
        c = self.cfg
        path = c.trainer.checkpoint or (latest_port_checkpoint(self.checkpoint_dir)
                                        if self.checkpoint_dir is not None else None)
        if path and not os.path.exists(path):
            log.warning("checkpoint %s does not exist: training from the start", path)
            path = None
        # the loads below cast to the model's and the moments' dtypes
        state = restore_checkpoint(path) if path else None
        if self.model is None:
            self.build_model(dm, state["model"] if state else self.state_dict)
        elif state and self.mesh is not None:
            load_full_state_dict(self.model, state["model"])
        elif state:
            self.model.load_state_dict(state["model"], strict=True)
        self.optimizer = make_optimizer("adamw", {
            "lr": c.model.lr, "weight_decay": c.model.weight_decay,
            "betas": (c.model.beta_1, c.model.beta_2),
            "mu_dtype": c.trainer.adam_mu_dtype, "nu_dtype": c.trainer.adam_nu_dtype,
        }, self.model.named_parameters())
        if state is None:
            return 0
        opt = state["optimizer"]
        if self.mesh is not None:  # a stage rank steps its own Blocks' moments
            opt = dict(opt, **{k: held_state(self.model, opt[k]) for k in ("mu", "nu")})
        self.optimizer.load_state_dict(opt)
        epoch = int(state["epoch"]) + 1
        log.info("resumed from %s at epoch %d", path, epoch)
        return epoch

    def _phase(self, dm: IterDataModule, data_key: str) -> None:
        if not hasattr(self.model, "for_phase"):
            return  # a geometry-agnostic model (JAX trainer.py:273-276)
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
        if self.mesh is not None and not in_mesh(self.mesh):
            log.info("rank %d is idle: the mesh takes the first %d ranks of %d", dist.get_rank(),
                     self.mesh.size(), dist.get_world_size())
            return self.history

        epoch_start = 0
        while epoch_start < max_epochs:
            for data_key in c.data.low_res_dir:
                dm = self.data_module(data_key)
                if self.optimizer is None:
                    epoch_start = self._start(dm)
                else:  # a masked loss holds one mask: this phase's
                    self._wire_out_mask(dm)
                self._phase(dm, data_key)
                in_vars, out_vars = dm.get_data_variables()
                if data_key not in steps:
                    steps[data_key] = make_train_step(
                        self.model, self.train_loss, c.data.var_weights, self.optimizer,
                        in_vars, out_vars, grad_accum=c.trainer.grad_accum,
                        moe_aux_weight=c.model.moe_aux_weight)
                train_step = steps[data_key]

                epoch_end = min(epoch_start + interval, max_epochs)
                for epoch in range(epoch_start, epoch_end):
                    set_learning_rate(self.optimizer, self.lr_schedule(epoch))
                    max_steps = max_steps_per_epoch
                    if self.mesh is not None:
                        # every rank takes the same number of steps: the
                        # least any rank's file shards give (before the
                        # epoch's iterator: the count peeks its permutation)
                        least = all_ranks(dm.num_batches("train"), dist.ReduceOp.MIN,
                                          self.mesh, self.device)
                        max_steps = least if not max_steps else min(max_steps, least)
                        if not max_steps:
                            raise ValueError("a data rank has no full train batch this epoch")
                    self.history.append(self._epoch(
                        epoch, data_key, dm, train_step, dropout_gen, drop_path_gen,
                        stage_dtype, max_steps))
                    log.info("epoch %d %s: %s", epoch, data_key, self.history[-1])
                    if self.checkpoint_dir is not None:
                        self._save(epoch)
                    if self.run_validation:
                        self.validate(dm, in_vars, out_vars, epoch)
                epoch_start = epoch_end
                if epoch_start >= max_epochs:
                    break
        wait_for_async_saves()
        if self.mesh is not None:
            dist.barrier(group=self.mesh.mesh_group)
        return self.history

    def _save(self, epoch: int) -> None:
        """Saves epoch_{epoch}, then prunes to the newest keep_last_checkpoints
        (JAX trainer.py:859-872). On a mesh every rank gathers the model and
        the moments whole and rank 0 writes them (JAX trainer.py:786-801)."""
        path = os.path.join(self.checkpoint_dir, f"epoch_{epoch}")
        model, opt = self.model.state_dict(), self.optimizer.state_dict()
        if self.mesh is not None:
            model = full_state_dict(self.model)
            opt = dict(opt, **{k: full_named(self.model, opt[k]) for k in ("mu", "nu")})
            if dist.get_rank() != 0:
                return
        save_checkpoint(path, {"model": model, "optimizer": opt, "epoch": epoch},
                        async_save=self.async_checkpoints)
        if self.keep_last_checkpoints:
            prune_checkpoints(self.checkpoint_dir, self.keep_last_checkpoints,
                              current_epoch=epoch)

    def validate(self, dm: IterDataModule, in_vars, out_vars, epoch: int) -> Dict[str, float]:
        """The val losses over `dm`'s val split, sample-weighted (JAX
        trainer.py:587-619). JAX pads a partial tail batch to the static
        batch size and slices the padding off again; eager PyTorch takes it
        as it is, but on a data mesh, where the ranks gather each round's
        batch, it is padded by its last row and the padding dropped, as
        Evaluator.test does. Sets `last_validation` = {"means", "samples"}."""
        step = make_eval_step(self.model, in_vars, out_vars)
        agg: Dict[str, float] = {}
        n = 0
        rounds = (None if self.mesh is None
                  else all_ranks(dm.num_batches("val"), dist.ReduceOp.MAX, self.mesh, self.device))
        gathered = self.mesh is not None and data_size(self.mesh) > 1
        loader = iter(dm.val_dataloader())
        try:
            for batch, real in synced_batches(loader, dm, rounds):
                if gathered:
                    batch = [pad_rows(a, dm.batch_size) for a in batch[:2]]
                x, y = self._put(batch[0], None), self._put(batch[1], None)
                yhat = step(x, y)
                if gathered:  # the round's global batch, on every data rank
                    (yhat, y), real = gather_rows((yhat, y), real, self.mesh, self.device)
                    if not real:  # every data rank on a padding round
                        continue
                losses = evaluate_batch(yhat, y, "val", self.val_losses, self.val_transforms,
                                        out_vars)
                values = torch.stack(list(losses.values())).tolist()  # one sync per batch
                for k, v in zip(losses, values):
                    agg[k] = agg.get(k, 0.0) + v * real
                n += real
        finally:
            loader.close()
        means = {k: v / max(1, n) for k, v in agg.items()}
        log.info("validation epoch %d: %s", epoch, means)
        self.last_validation = {"means": means, "samples": n}
        return means

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
        total = 0.0
        if step_losses:
            losses = torch.stack(step_losses)
            if self.mesh is not None:  # the mean over the data ranks
                losses = losses.to(comm_device(self.device))
                dist.all_reduce(losses, group=data_group(self.mesh))
                losses = losses / data_size(self.mesh)
            total = losses.sum().item()
        fence_wait_s += time.perf_counter() - tf
        return {"epoch": epoch, "data_key": data_key,
                "loss": total / max(1, len(step_losses)), "batches": len(step_losses),
                "seconds": time.perf_counter() - t0, "lr": self.lr_schedule(epoch),
                "data_wait_s": round(data_wait_s, 4), "fence_wait_s": round(fence_wait_s, 4),
                "h2d_bytes": h2d_bytes}


__all__ = ["Trainer"]
