"""Test-split evaluation on one device or a device mesh: the serving path
of the port.

Counterpart of `Trainer.test` (orbit2_tpu/training/trainer.py:762-831) and
of examples/evaluate.py: a deterministic forward of the config's model on
every test batch, clip, then the task's test metrics per output variable
(downscaling: rmse / pearson / mean_bias, denormalized; forecasting and
continuous-forecasting: lat_rmse / lat_acc, denormalized), averaged over
samples into the same `test/<metric>:<var>` dict. The model is the
config's preset: the ResSlimViT, or a model-hub preset (utils/loaders.py:
vit, unet, resnet, the interpolation baselines; rasp-theurey-2020 and the
forecasting baselines), which keeps its fp32 parameters, computes in its
dtype and serves bf16 or fp32 alone, as in JAX (w8a8 raises JAX's
ValueError). Every preset is built on the meta device and filled unit by
unit (`materialize`; a model-hub preset is one unit).

Usage: python -m orbit2_tpu_torch.evaluate configs/interm_1b.yaml \
           [--checkpoint DIR | --torch-npz PATH] [--max-batches N] \
           [--quant {none,w8a8}] [--device cuda]

The weights, as the JAX drivers find them (examples/evaluate.py:41-63,
examples/visualize.py:52-64): a reference-layout --torch-npz, else a port
checkpoint from --checkpoint, then `trainer.checkpoint`, then the newest
`epoch_N` under checkpoints/climate (an Orbax `epoch_N` of the JAX package is
skipped); the Evaluator merges either into the config's model by
`load_pretrained_params`, so one from another grid has its pos_embed resized
(keys the source lacks are drawn). Without any, the drawn weights are
served. A config with `tiling.do_tiling` serves its TILES tiles (div x div
halo tiles of each field, the JAX Trainer.test's batches; metrics per tile),
after the JAX Trainer's tiling check (trainer.py:167-186). `--quant w8a8`
serves through the int8 trunk (utils/quantize.py), quantized from the fp32
weights; the CLI builds the Evaluator for the one mode it serves
(`quant_modes`), so a bf16 run holds no int8 twin. An MoE config
(`model.moe_experts` > 0) serves bf16 only, as in JAX: w8a8 raises JAX's
ValueError. Orbax checkpoints are not read.

On a device mesh: under torchrun (one process a card: the CLI joins the
group its variables describe, parallel/mesh.py::init_distributed) the
Evaluator serves on the config's mesh as written, as examples/evaluate.py
and examples/visualize.py do (no scale-down; a mesh larger than the world
raises JAX's ValueError, and so does a config mesh above 1 without a
process group). The model is sharded as the Trainer shards it
(parallel/sharding.py: fsdp, replica, tensor, seq, expert and stage; a
model-hub preset over the data axes, its ViT's Blocks over tensor too),
each data rank reads its file shards, and
each round's predictions are gathered over the data ranks, so the metrics
are the global batch's, as JAX's one-process mesh takes them
(`Evaluator.test`). Rank 0 prints; the ranks past the mesh are idle.
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import logging
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from orbit2_tpu_torch.config import Config, load_config
from orbit2_tpu_torch.data.itermodule import IterDataModule
from orbit2_tpu_torch.models.components.blocks import MOE_QUANT_ERROR, QUANT_MODES
from orbit2_tpu_torch.models.res_slimvit import ResSlimViT
from orbit2_tpu_torch.parallel.mesh import (
    all_ranks, comm_device, data_group, data_rank, data_size, in_mesh, init_distributed,
    mesh_from_config, rank_grid, world_size)
from orbit2_tpu_torch.parallel.sharding import load_full_state_dict, shard_model
from orbit2_tpu_torch.training.checkpoint import (
    DEFAULT_CHECKPOINT_DIR, latest_port_checkpoint, load_pretrained_params, load_state_npz,
    restore_checkpoint)
from orbit2_tpu_torch.training.train import evaluate_batch, make_eval_step
from orbit2_tpu_torch.utils.loaders import (
    QUANT_PRESETS, check_quant, load_architecture, load_downscaling_module,
    load_forecasting_module)
from orbit2_tpu_torch.utils.memory import device_memory_stats
from orbit2_tpu_torch.utils.quantize import fill_twin, fp32_sources, quantize_state_dict

log = logging.getLogger("orbit2_tpu_torch")

# JAX's quantize_weight takes each kernel's per-output-channel scale over its
# axis 0, which in a pipelined trunk's stacked Block kernels [depth, K, N] is
# the depth axis, and flax refuses the [K, N] scales it wants as [depth, N]
# (orbit2_tpu/ops/quant.py:36-44, utils/quantize.py:32-52): JAX's
# Trainer.test(quant="w8a8") of a pipelined config raises
PIPELINE_QUANT_ERROR = ("quant='w8a8' of a pipelined trunk (parallelism.pipeline > 1): the JAX "
                        "package cannot quantize its stacked Block kernels (flax "
                        "ScopeParamShapeError); serve it with quant='none'")


def model_kwargs(c: Config) -> dict:
    """The ResSlimViT arguments of a config, weights drawn from trainer.seed."""
    m = c.model
    return dict(
        default_vars=c.data.default_vars, superres_mag=m.superres_mag, cnn_ratio=m.cnn_ratio,
        patch_size=m.patch_size, embed_dim=m.embed_dim, depth=m.depth,
        decoder_depth=m.decoder_depth, num_heads=m.num_heads, mlp_ratio=m.mlp_ratio,
        drop_path=m.drop_path, drop_rate=m.drop_rate, attention_impl=m.attention_impl,
        gelu_approx=m.gelu_approx, data_type=c.trainer.data_type, moe_experts=m.moe_experts,
        moe_every=m.moe_every, moe_capacity_factor=m.moe_capacity_factor, moe_top_k=m.moe_top_k,
        pipeline_stages=c.parallelism.pipeline,
        pipeline_microbatches=c.parallelism.pipeline_microbatches,
        pipeline_interleave=c.parallelism.pipeline_interleave, seq_shard=c.parallelism.seq_par > 1,
        seq_impl=c.parallelism.seq_impl,
        generator=torch.Generator().manual_seed(c.trainer.seed))


def load_module(cfg: Config, data_module: IterDataModule, kwargs: dict):
    """The config's (model, train_loss, val_losses, test_losses,
    train_transform, val_transforms, test_transforms) by its task's factory,
    as the JAX Trainer builds them (trainer.py:188-236)."""
    loader = (load_downscaling_module if cfg.trainer.task == "downscaling"
              else load_forecasting_module)
    return loader(data_module=data_module, architecture=cfg.model.preset, model_kwargs=kwargs,
                  train_loss=cfg.trainer.train_loss)


def check_mesh(cfg: Config, world: int) -> None:
    """JAX make_mesh's refusal of a mesh larger than the devices
    (orbit2_tpu/parallel/mesh.py:53-57), over a world of `world` processes,
    one device each (parallel/mesh.py::rank_grid)."""
    par = cfg.parallelism
    rank_grid(replica=par.simple_ddp, fsdp=par.fsdp, tensor=par.tensor_par, seq=par.seq_par,
              stage=par.pipeline, expert=par.expert_par, world=world)


def check_scope(cfg: Config) -> None:
    """What neither the Trainer nor the Evaluator runs: `parallelism.auto`.
    Both run every preset on one device or on the config's mesh."""
    if cfg.parallelism.auto:
        raise NotImplementedError(
            "parallelism.auto resolves its mesh through the TPU AOT planner, which has no GPU "
            "meaning: give the axis sizes")


def check_tiling(cfg: Config, data_module: IterDataModule) -> None:
    """The JAX Trainer's tiling checks (trainer.py:167-186): TILES tiling is
    for downscaling only, and tile dims must divide by patch_size (the
    reference aborts with an increase-the-overlap instruction)."""
    if cfg.tiling.effective_div <= 1:
        return
    if cfg.trainer.task != "downscaling":
        raise ValueError(
            "TILES tiling is a downscaling-only feature (reference "
            "iterdataset.py:90-177); disable tiling.do_tiling for "
            f"task={cfg.trainer.task}")
    in_shape, _ = data_module.get_data_dims()
    _, h, w = in_shape[1:]
    p = cfg.model.patch_size
    if h % p or w % p:
        raise ValueError(
            f"tile shape ({h}, {w}) is not divisible by patch_size {p}; "
            f"increase tiling.overlap by {h % p or w % p} "
            "(see reference TILES divisibility rule)")


def make_data_module(cfg: Config, data_key: str, div: int, overlap: int,
                     stage: Optional[str] = None, data_par_size: int = 1,
                     data_par_rank: int = 0) -> IterDataModule:
    """The data module of `data_key` at tiling (div, overlap), set up for
    `stage` (None: every split). On a mesh it is data rank `data_par_rank`
    of `data_par_size`'s: it reads that rank's file shards, in batches of
    `trainer.batch_size / data_par_size`, so the data ranks' batches make up
    the global batch (the single-process JAX mesh's meaning of
    batch_size)."""
    c = cfg
    if c.trainer.batch_size % data_par_size:
        raise ValueError(f"trainer.batch_size {c.trainer.batch_size} is not divisible by the "
                         f"{data_par_size} data ranks")
    # config task -> the data module's (JAX Trainer._make_data_module)
    task = {"forecasting": "direct-forecasting"}.get(c.trainer.task, c.trainer.task)
    forecast = {}
    if task != "downscaling":
        d = c.data
        forecast = dict(src=d.src, history=d.history, window=d.window, pred_range=d.pred_range,
                        random_lead_time=d.random_lead_time, max_pred_range=d.max_pred_range,
                        hrs_each_step=d.hrs_each_step)
    dm = IterDataModule(
        task, c.data.low_res_dir[data_key], c.data.high_res_dir[data_key],
        c.data.dict_in_variables[data_key], out_vars=c.data.dict_out_variables[data_key],
        data_par_size=data_par_size, data_par_rank=data_par_rank, subsample=1,
        batch_size=c.trainer.batch_size // data_par_size, buffer_size=c.trainer.buffer_size,
        num_workers=c.trainer.num_workers, drop_last=True, div=div, overlap=overlap,
        seed=c.trainer.data_seed if c.trainer.data_seed is not None else c.trainer.seed,
        **forecast)
    dm.setup(stage)
    return dm


def weight_fill(cfg: Config, data_module: IterDataModule, meta_model: torch.nn.Module,
                state_dict: Mapping[str, torch.Tensor]):
    """How `state_dict` (reference layout, perhaps of another grid; an
    NpzState is read one tensor at a time) fills `meta_model`, a meta-device
    build of the config's model, by load_pretrained_params at the tiles of
    `data_module` (pos_embed resized to the tiles' grid): (fill, drawn,
    the import report). fill(keys) gives the merged tensors of those keys,
    for `materialize`; drawn says whether keys are left unfilled, which are
    then drawn from trainer.seed, as the JAX drivers merge into drawn
    weights."""
    in_shape, _ = data_module.get_data_dims()
    meta = meta_model.state_dict()
    merge = lambda keys: load_pretrained_params(meta, state_dict, cfg.model.patch_size,
                                                img_size=tuple(in_shape[-2:]), keys=keys)
    report = merge(())[1]
    lacking = set(meta) - set(report["used"]) - set(report["resized"])
    log.info("weights: %d used / %d dropped / %d resized / %d drawn", len(report["used"]),
             len(report["dropped"]), len(report["resized"]), len(lacking))
    return (lambda keys: merge(keys)[0]), bool(lacking), report


def materialize(model: torch.nn.Module, device, dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None,
                fill: Optional[Callable[[List[str]], Mapping[str, torch.Tensor]]] = None,
                on_unit: Optional[Callable[[Dict[str, torch.Tensor]], None]] = None,
                into: Optional[torch.nn.Module] = None) -> None:
    """Fills `model`, built on the meta device, on `device` one unit at a
    time (its init_units: for the ResSlimViT a Block or a top-level module,
    and the model itself for its own tensors; a model of one unit, as the
    model hub's, is filled whole): each unit is drawn from `generator`
    where one is given
    (reset_parameters' values, in its order), takes the tensors that
    `fill(its keys)` returns, is handed to `on_unit` as {key: fp32 tensor},
    then cast to `dtype` (None: kept in fp32). At most one unit is on the
    device in fp32, and nothing of the model is on the host unless `device`
    is.

    `into`: the same model sharded over a mesh (parallel/sharding.py::
    shard_model, after to_empty). Each unit's whole tensors are then copied
    into its shards and the unit is released to the meta device, so no rank
    holds more than one whole unit, and the shards hold the one-process
    draws."""
    units = model.init_units()
    with torch.no_grad():
        for name, module, init in units:
            recurse = module is not model or len(units) == 1
            module.to_empty(device=device, recurse=recurse)
            prefix = f"{name}." if name else ""
            own = itertools.chain(module._parameters.items(), module._buffers.items())
            unit = (module.state_dict(prefix=prefix, keep_vars=True) if recurse
                    else {prefix + k: t for k, t in own if t is not None})
            if generator is not None:
                init(generator)
            if fill is not None:
                for key, t in fill(list(unit)).items():
                    unit[key].copy_(t)
            if on_unit is not None:
                on_unit({k: t.detach() for k, t in unit.items()})
            if into is not None:
                load_full_state_dict(into, unit, keys=list(unit))
                module.to_empty(device="meta", recurse=recurse)
                continue
            if dtype is not None:
                module._apply(lambda t: t.to(dtype) if t.is_floating_point() else t,
                              recurse=recurse)


def build_sharded(skeleton: torch.nn.Module, mesh, device, fill_device,
                  generator: Optional[torch.Generator] = None,
                  fill: Optional[Callable[[List[str]], Mapping[str, torch.Tensor]]] = None,
                  on_unit: Optional[Callable[[Dict[str, torch.Tensor]], None]] = None,
                  dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
    """`skeleton`, a model on the meta device, sharded over `mesh` on
    `device` (parallel/sharding.py::shard_model; `dtype`: serving's), each
    rank's shards filled unit by unit by `materialize` on `fill_device`
    (drawn from `generator`, or from `fill`; each unit handed to `on_unit`),
    so no rank holds more than one whole unit. The skeleton stays on the
    meta device."""
    model = shard_model(copy.deepcopy(skeleton), mesh, dtype)
    model.to_empty(device=device)
    materialize(skeleton, fill_device, generator=generator, fill=fill, on_unit=on_unit,
                into=model)
    return model


def synced_batches(loader, dm: IterDataModule, rounds: Optional[int]):
    """(batch, real samples) of `loader`; on a mesh, `rounds` of them (the
    most any rank has): a rank out of batches feeds zero batches that count
    no sample, so every rank runs every collective (JAX trainer.py:621-685)."""
    if rounds is None:
        for batch in loader:
            yield batch, batch[0].shape[0]
        return
    last = None
    for _ in range(rounds):
        batch = next(loader, None)
        if batch is not None:
            last = batch
            yield batch, batch[0].shape[0]
            continue
        if last is not None:
            shapes = [(dm.batch_size,) + tuple(np.shape(a))[1:] for a in last[:2]]
        else:  # this rank saw no batch at all
            shapes = [tuple(d) for d in dm.get_data_dims()]
        yield tuple(np.zeros(sh, np.float32) for sh in shapes), 0
    if next(loader, None) is not None:
        raise RuntimeError(f"the batch count undercounted: the loader yielded more than "
                           f"{rounds} batches")


def pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    """`a` with its last row repeated up to `rows` rows (JAX _eval_one's
    padding of a partial tail batch, trainer.py:719-725)."""
    if a.shape[0] == rows:
        return a
    return np.concatenate([a, np.repeat(a[-1:], rows - a.shape[0], axis=0)])


def gather_rows(tensors: Sequence[torch.Tensor], real: int, mesh, device):
    """Each data rank's first `real` rows of each of `tensors` (of equal
    rows on every rank), over its data group, in data-rank order: the
    round's global batch, its padding dropped, on every data rank; and the
    round's samples."""
    group, size = data_group(mesh), data_size(mesh)
    cdev = comm_device(device)
    reals = [torch.zeros(1, dtype=torch.int64, device=cdev) for _ in range(size)]
    dist.all_gather(reals, torch.tensor([real], dtype=torch.int64, device=cdev), group=group)
    reals = [int(r.item()) for r in reals]
    out = []
    for t in tensors:
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t.contiguous(), group=group)
        out.append(torch.cat([p[:r] for p, r in zip(parts, reals)]))
    return out, sum(reals)


def serving_weights(cfg: Config, checkpoint: Optional[str] = None,
                    torch_npz: Optional[str] = None) -> Optional[Mapping[str, torch.Tensor]]:
    """The serving CLIs' weights (module docstring), as they lie in the
    source, for the Evaluator to merge: `torch_npz`, else the model of
    `checkpoint`, `trainer.checkpoint` or the newest port checkpoint under
    checkpoints/climate. None where there is nothing to load."""
    if torch_npz:
        return load_state_npz(torch_npz)
    source = checkpoint or cfg.trainer.checkpoint or latest_port_checkpoint(DEFAULT_CHECKPOINT_DIR)
    if not source:
        return None
    state = restore_checkpoint(source)
    log.info("checkpoint %s (epoch %s)", source, state.get("epoch"))
    return state["model"]


class Evaluator:
    """Builds the data module (tiled as the config says) and model of
    `config` on `device` (the card unless the caller asks for "cpu");
    `test()` evaluates the test split. The model is built on the meta device
    and filled on `device` one unit at a time (`materialize`: a Block or
    top-level module of the ResSlimViT, a model-hub preset whole), so the
    host never holds the whole model: drawn from
    `config.trainer.seed` (by a generator on `device`: a card's draws differ
    from the host's), or merged from `state_dict` (reference layout, e.g.
    from training/checkpoint.py::state_dict_from_jax_params or
    `serving_weights`, perhaps of another grid; an NpzState is read one
    tensor at a time) by `weight_fill` (pos_embed resized to the tiles'
    grid; drawn only where keys are left unfilled). The ResSlimViT's
    parameters are held in its compute dtype (no per-use casts); a
    model-hub preset keeps fp32 parameters, as it trains, its BatchNorm
    scales fp32 as flax's param_dtype holds them.

    `quant_modes` names the serving modes built at construction ("none" is
    always served; default: both, or "none" alone for an MoE config, whose
    expert FFNs have no int8 path: asking w8a8 of one raises JAX's
    ValueError, at construction or in test()). w8a8 quantizes from the fp32 weights, as
    the JAX Trainer does from its fp32 params: the int8 twin is quantized on
    `device` as each unit is filled, from its fp32 tensors, so at most the
    model and its twin live on the device and no fp32 tensor is kept. Built
    without "w8a8", the Evaluator holds the bf16 model alone, and
    test(quant="w8a8") raises.

    Where a process group runs, the Evaluator serves on the config's mesh
    (`mesh`; else None: one device, the model unwrapped), as the Trainer
    trains on it: the model built on the meta device, sharded
    (parallel/sharding.py::shard_model; the ResSlimViT's parameters in the
    compute dtype)
    and each rank's shards filled unit by unit with the one-device draws or
    the merged `state_dict` (`build_sharded`); the data module is the rank's
    data shard. The int8 twin lies whole on every rank of the mesh (JAX's
    quantized kernels land replicated, trainer.py:833-857), quantized from
    every unit's fp32 tensors as they are filled, and serves the rank's data
    batch. A rank past the mesh is idle: it builds nothing and its test()
    returns {}."""

    def __init__(self, config: Config, device="cuda",
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 data_key: Optional[str] = None, quant_modes: Optional[Sequence[str]] = None):
        self.cfg = c = config.validate()
        check_mesh(c, world_size())
        check_scope(c)
        self.device = torch.device(device)
        self.mesh = (mesh_from_config(c.parallelism, self.device.type) if dist.is_initialized()
                     else None)
        self.idle = self.mesh is not None and not in_mesh(self.mesh)
        self.moe = c.model.moe_experts > 0
        self.pipelined = c.parallelism.pipeline > 1
        if quant_modes is None:
            # the w8a8 path is the ResSlimViT family's (JAX trainer.py:847-850)
            quant_modes = (QUANT_MODES if c.model.preset in QUANT_PRESETS and not self.moe
                           and not self.pipelined else ("none",))
        unknown = set(quant_modes) - set(QUANT_MODES)
        if unknown:
            raise ValueError(f"unknown quant_modes {sorted(unknown)} (none | w8a8)")
        if set(quant_modes) - {"none"}:
            self._check_quant("w8a8")
        self.quant_modes = tuple(quant_modes)
        self.data_key = data_key or next(iter(c.data.low_res_dir))
        self._twins: Dict[str, torch.nn.Module] = {}
        self.last_test: Optional[dict] = None
        if self.idle:
            self.model = self.data_module = None
            log.info("rank %d is idle: the mesh takes the first %d ranks of %d", dist.get_rank(),
                     self.mesh.size(), dist.get_world_size())
            return
        ranks = ({} if self.mesh is None else
                 dict(data_par_size=data_size(self.mesh), data_par_rank=data_rank(self.mesh)))
        self.data_module = dm = make_data_module(
            c, self.data_key, c.tiling.effective_div, c.tiling.effective_overlap, "test", **ranks)
        check_tiling(c, dm)
        with torch.device("meta"):
            (self.model, _, _, self.test_losses, _, _,
             self.test_transforms) = load_module(c, dm, dict(model_kwargs(c), generator=None))
        self._phase(self.model)
        # the ResSlimViT serves its parameters in the compute dtype (no per-use
        # casts); a model-hub preset keeps fp32 ones, as it trains
        dtype = self.model.dtype if isinstance(self.model, ResSlimViT) else None
        fill, drawn = None, True
        if state_dict is not None:
            fill, drawn, _ = weight_fill(c, dm, self.model, state_dict)
        generator = torch.Generator(self.device).manual_seed(c.trainer.seed) if drawn else None

        on_unit = None
        if "w8a8" in self.quant_modes:
            twin = self._architecture("w8a8")
            sources = fp32_sources(twin)
            quantized: Dict[str, torch.Tensor] = {}

            def on_unit(unit):
                # on a mesh the whole twin comes from the units (the model's
                # own tensors are shards); on one device the rest comes from
                # the filled model, cast, so no fp32 copy of it is held
                taken = (unit if self.mesh is not None
                         else {k: t for k, t in unit.items() if k in sources})
                quantized.update(quantize_state_dict(twin, taken, self.device, partial=True))
        if self.mesh is None:
            materialize(self.model, self.device, dtype, generator, fill, on_unit)
        else:
            self.model = build_sharded(self.model, self.mesh, self.device, self.device,
                                       generator, fill, on_unit, dtype)
        self.model.eval()
        if "w8a8" in self.quant_modes:
            if self.mesh is None:
                rest = {k: t for k, t in self.model.state_dict().items() if k not in sources}
                quantized.update(quantize_state_dict(twin, rest, self.device, partial=True))
            self._twins["w8a8"] = fill_twin(twin, quantized, self.device)

    def _check_quant(self, quant: str) -> None:
        """JAX's refusals of w8a8: its ValueErrors where the model has no
        int8 path, and a pipelined trunk, which JAX cannot convert
        (PIPELINE_QUANT_ERROR)."""
        if self.moe:
            raise ValueError(MOE_QUANT_ERROR)
        if self.pipelined:
            raise ValueError(PIPELINE_QUANT_ERROR)
        check_quant(self.cfg.model.preset, quant)

    def _architecture(self, quant: str) -> torch.nn.Module:
        """The config's model under `quant`, on the meta device: nothing drawn."""
        with torch.device("meta"):
            model = load_architecture(self.data_module, self.cfg.model.preset,
                                      **dict(model_kwargs(self.cfg), generator=None, quant=quant))
        return self._phase(model)

    def _phase(self, model):
        in_shape, _ = self.data_module.get_data_dims()
        in_vars, out_vars = self.data_module.get_data_variables()
        if not hasattr(model, "for_phase"):
            return model  # geometry-agnostic (JAX trainer.py:273-276)
        return model.for_phase(
            spatial_resolution=self.cfg.data.spatial_resolution[self.data_key],
            img_size=tuple(in_shape[-2:]), in_channels=len(in_vars), out_channels=len(out_vars))

    def serving_model(self, quant: str = "none") -> torch.nn.Module:
        """The model served under `quant`: the fp model itself, or its int8
        twin ("w8a8"), quantized at construction."""
        if quant == "none":
            return self.model
        if quant not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {quant!r} (none | w8a8)")
        self._check_quant(quant)
        if quant not in self._twins:
            raise ValueError(f"quant={quant!r} was not asked for: this Evaluator was built with "
                             f"quant_modes={self.quant_modes}; pass quant_modes=(..., {quant!r})")
        return self._twins[quant]

    def test(self, max_batches: Optional[int] = None, quant: str = "none") -> Dict[str, float]:
        """Metrics over the test split (at most `max_batches` batches a
        rank), each batch's weighted by its samples, into means; sets
        `last_test` = {"means", "samples"}. quant="w8a8" serves the int8
        twin (JAX Trainer.test(quant=...)); the fp model is untouched, so
        later calls serve in fp again. A partial tail batch is padded to the
        batch size by its last row and the padding dropped before the
        metrics (JAX _eval_one).

        On a mesh, JAX's semantics (trainer.py:621-749): every rank runs as
        many rounds as the data rank with the most batches (a rank out of
        batches feeds zero batches that count no sample), and each round's
        metrics are taken over the global batch: every data rank's
        prediction and target gathered over the data group, the padding
        rows dropped. Every rank returns the same means; an idle rank
        returns {}."""
        if self.idle:
            log.info("rank %d is idle: no test()", dist.get_rank())
            return {}
        dm = self.data_module
        in_vars, out_vars = dm.get_data_variables()
        step = make_eval_step(self.serving_model(quant), in_vars, out_vars)
        rounds = None
        if self.mesh is not None:
            mine = dm.num_batches("test")
            rounds = all_ranks(mine if max_batches is None else min(mine, max_batches),
                               dist.ReduceOp.MAX, self.mesh, self.device)
        gathered = self.mesh is not None and data_size(self.mesh) > 1
        agg: Dict[str, float] = {}
        n = 0
        loader = iter(dm.test_dataloader())
        try:
            for batch, real in synced_batches(itertools.islice(loader, max_batches), dm, rounds):
                x, y = (torch.from_numpy(pad_rows(a, dm.batch_size)).to(self.device)
                        for a in batch[:2])
                yhat = step(x, y)
                if gathered:
                    (yhat, y), real = gather_rows((yhat, y), real, self.mesh, self.device)
                    if not real:  # every data rank on a padding round
                        continue
                else:
                    yhat, y = yhat[:real], y[:real]
                losses = evaluate_batch(yhat, y, "test", self.test_losses,
                                        self.test_transforms, out_vars)
                values = torch.stack(list(losses.values())).tolist()  # one sync per batch
                for k, v in zip(losses, values):
                    agg[k] = agg.get(k, 0.0) + v * real
                n += real
        finally:
            loader.close()
        means = {k: v / max(1, n) for k, v in agg.items()}
        self.last_test = {"means": means, "samples": n}
        return means


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("--checkpoint", default=None, help="a port checkpoint directory (epoch_N)")
    p.add_argument("--torch-npz", default=None,
                   help="reference-layout state_dict saved as an npz of numpy arrays")
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--data-key", default=None)
    p.add_argument("--quant", default="none", choices=QUANT_MODES,
                   help="w8a8: serve through the int8 trunk (ops/quant.py)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    init_distributed(args.device)  # torchrun's group, where its variables are set
    cfg = load_config(args.config)
    state_dict = serving_weights(cfg, args.checkpoint, args.torch_npz)
    if state_dict is None:
        log.warning("no checkpoint: evaluating weights drawn from trainer.seed")
    ev = Evaluator(cfg, args.device, state_dict=state_dict, data_key=args.data_key,
                   quant_modes=(args.quant,))
    means = ev.test(max_batches=args.max_batches, quant=args.quant)
    if ev.idle:
        return ev
    log.info("memory: %s", device_memory_stats(ev.device))
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps({k: round(float(v), 6) for k, v in means.items()}, indent=2))
    return ev


if __name__ == "__main__":
    main()
