"""Model-module factory (counterpart of orbit2_tpu/utils/loaders.py,
res_slimvit preset only).

`load_downscaling_module` returns the JAX factory's 7-tuple (model,
train_loss, val_losses, test_losses, train_transform, val_transforms,
test_transforms) with the same losses and transforms
(orbit2_tpu/utils/loaders.py:45-90, 144-153): the train loss by name
(aggregate only), val rmse / pearson / mean_bias / mse and test rmse /
pearson / mean_bias, denormalized except the val mse.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

import orbit2_tpu_torch.metrics  # noqa: F401  (populate registry)
import orbit2_tpu_torch.transforms  # noqa: F401
from orbit2_tpu_torch.metrics.metrics import MetricsMetaInfo
from orbit2_tpu_torch.models.res_slimvit import ResSlimViT
from orbit2_tpu_torch.registry import METRICS_REGISTRY, TRANSFORMS_REGISTRY

VAL_LOSSES = ("rmse", "pearson", "mean_bias", "mse")
TEST_LOSSES = ("rmse", "pearson", "mean_bias")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def load_architecture(data_module, architecture: str, default_vars=None, superres_mag=4,
                      cnn_ratio=4, patch_size=2, embed_dim=256, depth=6, decoder_depth=1,
                      num_heads=4, mlp_ratio=4, drop_path=0.1, drop_rate=0.1,
                      attention_impl="auto", gelu_approx="exact", data_type="float32",
                      remat=False, remat_policy="full", moe_experts=0, moe_every=2,
                      moe_capacity_factor=1.25, moe_top_k=1, pipeline_stages=1, quant="none", generator: Optional[torch.Generator] = None, **_ignored):
    """The downscaling ResSlimViT with fp32 parameters computing in `data_type`."""
    if architecture != "res_slimvit":
        raise NotImplementedError(
            f"{architecture!r} is not ported yet: only the res_slimvit preset")
    in_shape, out_shape = data_module.get_data_dims()
    in_channels, in_height, in_width = in_shape[1:]
    return ResSlimViT(
        default_vars=tuple(default_vars), img_size=(in_height, in_width),
        in_channels=in_channels, out_channels=out_shape[1], superres_mag=superres_mag,
        patch_size=patch_size, cnn_ratio=cnn_ratio,
        learn_pos_emb=True,  # the reference hardcodes this (loaders.py:366)
        embed_dim=embed_dim, depth=depth, decoder_depth=decoder_depth,
        num_heads=num_heads, mlp_ratio=mlp_ratio, drop_path=drop_path, drop_rate=drop_rate,
        attention_impl=attention_impl, gelu_approx=gelu_approx, remat=remat,
        remat_policy=remat_policy, moe_experts=moe_experts, moe_every=moe_every,
        moe_capacity_factor=moe_capacity_factor, moe_top_k=moe_top_k,
        pipeline_stages=pipeline_stages,
        quant=quant, dtype=DTYPES[data_type], generator=generator)


def load_downscaling_module(data_module, architecture: str = "res_slimvit",
                            model_kwargs: Optional[Dict[str, Any]] = None,
                            train_loss: str = "mse"):
    """Returns (model, train_loss, val_losses, test_losses, train_transform,
    val_transforms, test_transforms)."""
    lat, lon = data_module.get_lat_lon()
    in_vars, out_vars = data_module.get_data_variables()
    model = load_architecture(data_module, architecture, **(model_kwargs or {}))

    def metric(name, split, aggregate_only=False):
        if name not in METRICS_REGISTRY:
            raise NotImplementedError(f"{name} is not an implemented loss.")
        clim = data_module.get_climatology(split=split)
        return METRICS_REGISTRY[name](aggregate_only=aggregate_only,
                                      metainfo=MetricsMetaInfo(in_vars, out_vars, lat, lon, clim))

    denorm = TRANSFORMS_REGISTRY["denormalize"](data_module)
    return (model, metric(train_loss, "train", aggregate_only=True),
            [metric(n, "val") for n in VAL_LOSSES], [metric(n, "test") for n in TEST_LOSSES],
            None, [denorm, denorm, denorm, None], [denorm] * len(TEST_LOSSES))
