"""Public API factory functions (counterpart of orbit2_tpu/utils/loaders.py;
reference src/climate_learn/utils/loaders.py:31-480): the same names, the
same task / architecture / loss strings, the same 7-tuple from
`load_model_module`.

  * `load_model_module` -> (model, train_loss, val_losses, test_losses,
    train_transform, val_transforms, test_transforms); the per-task
    partials `load_forecasting_module`, `load_climatebench_module` and
    `load_downscaling_module` carry JAX's losses and transforms
    (loaders.py:122-153).
  * `load_architecture` builds every preset of JAX loaders.py:189-326 with
    its refusals: forecasting climatology | persistence |
    linear-regression | rasp-theurey-2020; downscaling
    bilinear-interpolation | nearest-interpolation | vit | unet | resnet
    (each behind PreInterpolated, a bilinear upsample to the target grid)
    | res_slimvit. The models take fp32 parameters and compute in
    `data_type`; `generator` draws their weights (None: torch's default
    generator, or nothing under the meta device).
  * `load_optimizer` / `load_lr_scheduler` / `load_loss` /
    `load_transform` / `get_climatology`.

The port's `load_architecture` takes (data_module, architecture, ...,
task="downscaling"), the order its callers have used; JAX's takes the task
first.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch
from torch import nn

import orbit2_tpu_torch.metrics  # noqa: F401  (populate registry)
import orbit2_tpu_torch.transforms  # noqa: F401
from orbit2_tpu_torch.metrics.metrics import MetricsMetaInfo
from orbit2_tpu_torch.models.baselines import (
    Climatology, Interpolation, LinearRegression, Persistence)
from orbit2_tpu_torch.models.res_slimvit import ResSlimViT
from orbit2_tpu_torch.models.resnet import ResNet
from orbit2_tpu_torch.models.unet import Unet
from orbit2_tpu_torch.models.vit import VisionTransformer
from orbit2_tpu_torch.registry import METRICS_REGISTRY, TRANSFORMS_REGISTRY
from orbit2_tpu_torch.training.optim import make_lr_scheduler, make_optimizer

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the presets with a w8a8 serving path (JAX Trainer._quantize_for_serving
# asks the phase model for a `quant` field: the ResSlimViT family's)
QUANT_PRESETS = ("res_slimvit",)


def check_quant(architecture: str, quant: str) -> None:
    """JAX's ValueError for a `quant` other than "none" on a preset with no
    quantized serving path (JAX trainer.py:847-850)."""
    if quant != "none" and architecture not in QUANT_PRESETS:
        raise ValueError(f"preset {architecture!r} has no quantized serving path "
                         "(w8a8 is wired for the ViT family)")


def load_model_module(data_module=None, task: str = "downscaling",
                      architecture: Optional[str] = None, model=None,
                      model_kwargs: Optional[Dict[str, Any]] = None,
                      train_loss: Optional[Union[str, Callable]] = None,
                      val_loss: Optional[Iterable[Union[str, Callable]]] = None,
                      test_loss: Optional[Iterable[Union[str, Callable]]] = None,
                      train_target_transform: Optional[Union[str, Callable]] = None,
                      val_target_transform: Optional[Iterable] = None,
                      test_target_transform: Optional[Iterable] = None):
    """Returns (model, train_loss, val_losses, test_losses, train_transform,
    val_transforms, test_transforms): JAX loaders.py:39-90 (reference
    loaders.py:31-222); losses by name are built against the split's
    climatology, the train loss aggregate only."""
    lat, lon = data_module.get_lat_lon()
    if lat is None and lon is None:
        raise RuntimeError("Data module has not been set up yet.")
    if architecture is None and model is None:
        raise RuntimeError("Please specify 'architecture' or 'model'")
    if architecture and model is None:
        model = load_architecture(data_module, architecture, task=task, **(model_kwargs or {}))
    elif isinstance(model, str):
        raise RuntimeError(f"{model} is not an implemented model.")

    in_vars, out_vars = data_module.get_data_variables()

    def metainfo(split):
        return MetricsMetaInfo(in_vars, out_vars, lat, lon, get_climatology(data_module, split))

    if isinstance(train_loss, str):
        train_loss = load_loss(None, model, train_loss, True, metainfo("train"))
    elif not callable(train_loss):
        raise TypeError("'train_loss' must be str or Callable")
    return (model, train_loss, _load_losses(model, val_loss, metainfo, "val"),
            _load_losses(model, test_loss, metainfo, "test"),
            _load_one_transform(train_target_transform, data_module),
            _load_transforms(val_target_transform, data_module),
            _load_transforms(test_target_transform, data_module))


def _load_losses(model, losses, metainfo_fn, split):
    if not isinstance(losses, Iterable):
        raise TypeError(f"'{split}_loss' must be an iterable")
    out = []
    for item in losses:
        if isinstance(item, str):
            out.append(load_loss(None, model, item, False, metainfo_fn(split)))
        elif callable(item):
            out.append(item)
        else:
            raise TypeError(f"each '{split}_loss' must be str or Callable")
    return out


def _load_one_transform(t, data_module):
    if isinstance(t, str):
        return load_transform(t, data_module)
    if t is None or callable(t):
        return t
    raise TypeError("transform must be str, callable, or None")


def _load_transforms(transforms, data_module):
    if transforms is None:
        return None
    if not isinstance(transforms, Iterable):
        raise TypeError("target transforms must be an iterable or None")
    return [_load_one_transform(t, data_module) for t in transforms]


def _identity(x):
    return x


load_forecasting_module = partial(
    load_model_module, task="forecasting", train_loss="lat_mse",
    val_loss=["lat_rmse", "lat_acc", "lat_mse"], test_loss=["lat_rmse", "lat_acc"],
    train_target_transform=None, val_target_transform=["denormalize", "denormalize", None],
    test_target_transform=["denormalize", "denormalize"])

load_climatebench_module = partial(
    load_model_module, task="forecasting", train_loss="mse", val_loss=["mse"],
    test_loss=["lat_nrmses", "lat_nrmseg", "lat_nrmse"], train_target_transform=None,
    val_target_transform=[_identity], test_target_transform=[_identity] * 3)

load_downscaling_module = partial(
    load_model_module, task="downscaling", train_loss="mse",
    val_loss=["rmse", "pearson", "mean_bias", "mse"], test_loss=["rmse", "pearson", "mean_bias"],
    train_target_transform=None,
    val_target_transform=["denormalize", "denormalize", "denormalize", None],
    test_target_transform=["denormalize", "denormalize", "denormalize"])


class PreInterpolated(nn.Module):
    """nn.Sequential(Interpolation, backbone) equivalent (reference
    loaders.py:383-385; JAX loaders.py:156-186): upsample the input to the
    target grid, then run a same-resolution backbone, whose parameters are
    this module's under `backbone.`. It forwards the trainers' calling
    convention to the backbone. `for_phase` returns it unchanged: its
    backbones are geometry-agnostic or sized at construction, as in JAX."""

    def __init__(self, interpolation: Interpolation, backbone: nn.Module):
        super().__init__()
        self.interpolation = interpolation
        self.backbone = backbone

    def for_phase(self, spatial_resolution=None, img_size=None, in_channels=None,
                  out_channels=None) -> "PreInterpolated":
        return self

    def init_units(self):
        """The backbone's units under `backbone.` (the interpolation holds no
        tensor)."""
        return [(f"backbone.{name}".rstrip("."), module, init)
                for name, module, init in self.backbone.init_units()]

    def forward(self, x, *args, **kwargs):
        return self.backbone(self.interpolation(x), *args, **kwargs)


def load_architecture(data_module, architecture: str, default_vars=None, superres_mag=4,
                      cnn_ratio=4, patch_size=2, embed_dim=256, depth=6, decoder_depth=1,
                      num_heads=4, mlp_ratio=4, drop_path=0.1, drop_rate=0.1,
                      attention_impl="auto", gelu_approx="exact", data_type="float32",
                      remat=False, remat_policy="full", moe_experts=0, moe_every=2,
                      moe_capacity_factor=1.25, moe_top_k=1, pipeline_stages=1,
                      pipeline_microbatches=0, pipeline_interleave=1, seq_shard=False,
                      seq_impl="gather", quant="none",
                      generator: Optional[torch.Generator] = None, task: str = "downscaling",
                      **_ignored):
    """The preset `architecture` of `task` for `data_module`'s shapes (JAX
    loaders.py:189-326). Refusals as JAX's: NotImplementedError for an
    unknown preset or task, RuntimeError for persistence without its output
    variables among the inputs and for interpolation whose output variables
    are not the inputs. `quant` other than "none" is taken by the
    res_slimvit preset alone."""
    in_vars, out_vars = data_module.get_data_variables()
    in_shape, out_shape = data_module.get_data_dims()
    dtype = DTYPES[data_type]

    def not_implemented():
        return NotImplementedError(
            f"{architecture} is not an implemented architecture for the {task} task.")

    check_quant(architecture, quant)
    if task in ("forecasting", "continuous-forecasting"):
        history, in_channels, in_height, in_width = in_shape[1:]
        out_channels, out_height, out_width = out_shape[1:]
        if architecture.lower() == "climatology":
            return Climatology(get_climatology(data_module, "train"))
        if architecture == "persistence":
            if not set(out_vars).issubset(in_vars):
                raise RuntimeError("Persistence requires the output variables to be a subset"
                                   " of the input variables.")
            return Persistence([in_vars.index(o) for o in out_vars])
        if architecture.lower() == "linear-regression":
            return LinearRegression(history * in_channels * in_height * in_width,
                                    out_channels * out_height * out_width,
                                    (out_channels, out_height, out_width), generator=generator)
        if architecture.lower() == "rasp-theurey-2020":
            return ResNet(in_channels, out_channels, history=history, hidden_channels=128,
                          activation="leaky", norm=True, dropout=0.1, n_blocks=19, dtype=dtype,
                          generator=generator)
        raise not_implemented()

    if task == "downscaling":
        in_channels, in_height, in_width = in_shape[1:]
        out_channels, out_height, out_width = out_shape[1:]
        upsample = lambda: Interpolation(out_height / in_height, "bilinear")  # noqa: E731
        if architecture.lower() in ("bilinear-interpolation", "nearest-interpolation"):
            if set(out_vars) != set(in_vars):
                raise RuntimeError("Interpolation requires the output variables to match the"
                                   " input variables.")
            return Interpolation(out_height / in_height, architecture.split("-")[0])
        if architecture == "vit":
            return PreInterpolated(upsample(), VisionTransformer(
                (out_height, out_width), in_channels, out_channels, history=1,
                patch_size=patch_size, learn_pos_emb=True, embed_dim=embed_dim, depth=depth,
                decoder_depth=decoder_depth, num_heads=num_heads, mlp_ratio=mlp_ratio,
                drop_path=drop_path, drop_rate=drop_rate, attention_impl=attention_impl,
                gelu_approx=gelu_approx, dtype=dtype, generator=generator))
        if architecture in ("unet", "resnet"):
            # the reference's fine-tune driver offers these presets and its
            # load_architecture rejects them; JAX builds them interpolation-
            # first, with their BatchNorm running statistics trained as state
            cls = Unet if architecture == "unet" else ResNet
            return PreInterpolated(upsample(), cls(in_channels, out_channels, history=1,
                                                   dropout=drop_rate, dtype=dtype,
                                                   generator=generator))
        if architecture == "res_slimvit":
            return ResSlimViT(
                default_vars=tuple(default_vars), img_size=(in_height, in_width),
                in_channels=in_channels, out_channels=out_channels, superres_mag=superres_mag,
                patch_size=patch_size, cnn_ratio=cnn_ratio,
                learn_pos_emb=True,  # the reference hardcodes this (loaders.py:366)
                embed_dim=embed_dim, depth=depth, decoder_depth=decoder_depth,
                num_heads=num_heads, mlp_ratio=mlp_ratio, drop_path=drop_path,
                drop_rate=drop_rate, attention_impl=attention_impl, gelu_approx=gelu_approx,
                remat=remat, remat_policy=remat_policy, moe_experts=moe_experts,
                moe_every=moe_every, moe_capacity_factor=moe_capacity_factor,
                moe_top_k=moe_top_k, pipeline_stages=pipeline_stages,
                pipeline_microbatches=pipeline_microbatches,
                pipeline_interleave=pipeline_interleave, seq_shard=seq_shard,
                seq_impl=seq_impl, quant=quant, dtype=dtype, generator=generator)
        raise not_implemented()
    raise not_implemented()


def load_optimizer(net: nn.Module, optim: str = "adamw",
                   optim_kwargs: Optional[Dict[str, Any]] = None):
    """reference loaders.py:390-406: the optimizer over net's parameters."""
    return make_optimizer(optim.lower(), optim_kwargs or {}, net.named_parameters())


def load_lr_scheduler(sched: str, optimizer=None, sched_kwargs: Optional[Dict[str, Any]] = None):
    """reference loaders.py:409-433 -> epoch -> lr."""
    kwargs = dict(sched_kwargs or {})
    kwargs.setdefault("lr", kwargs.get("base_lr", kwargs.get("lr", 1.0)))
    return make_lr_scheduler(sched, kwargs)


def load_loss(device, model, loss_name, aggregate_only, metainfo):
    """reference loaders.py:436-450."""
    loss_cls = METRICS_REGISTRY.get(loss_name, None)
    if loss_cls is None:
        raise NotImplementedError(f"{loss_name} is not an implemented loss.")
    return loss_cls(aggregate_only=aggregate_only, metainfo=metainfo)


def load_transform(transform_name, data_module):
    """reference loaders.py:453-462."""
    transform_cls = TRANSFORMS_REGISTRY.get(transform_name, None)
    if transform_cls is None:
        raise NotImplementedError(f"{transform_name} is not an implemented transform.")
    return transform_cls(data_module)


def get_climatology(data_module, split):
    clim = data_module.get_climatology(split=split)
    if clim is None:
        raise RuntimeError("Climatology has not yet been set.")
    if isinstance(clim, dict):
        clim = np.stack(tuple(clim.values()))
    return clim
