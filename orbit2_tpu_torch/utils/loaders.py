"""Model-module factory for the serving path (counterpart of
orbit2_tpu/utils/loaders.py, res_slimvit preset only).

`load_downscaling_module` returns the serving subset of the JAX factory's
7-tuple — (model, test_losses, test_transforms) with the same test metrics
(rmse, pearson, mean_bias) and denormalize transforms
(orbit2_tpu/utils/loaders.py:144-153). The train and val slots come with
training.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

import orbit2_tpu_torch.metrics  # noqa: F401  (populate registry)
import orbit2_tpu_torch.transforms  # noqa: F401
from orbit2_tpu_torch.metrics.metrics import MetricsMetaInfo
from orbit2_tpu_torch.models.res_slimvit import ResSlimViT
from orbit2_tpu_torch.registry import METRICS_REGISTRY, TRANSFORMS_REGISTRY

TEST_LOSSES = ("rmse", "pearson", "mean_bias")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def load_architecture(data_module, architecture: str, default_vars=None, superres_mag=4,
                      cnn_ratio=4, patch_size=2, embed_dim=256, depth=6, decoder_depth=1,
                      num_heads=4, mlp_ratio=4, drop_path=0.1, attention_impl="auto",
                      gelu_approx="exact", data_type="float32", moe_experts=0,
                      pipeline_stages=1,
                      generator: Optional[torch.Generator] = None, **_training_only):
    """The downscaling ResSlimViT, its parameters in `data_type`. Knobs that
    only matter to training (dropout rate, remat, ...) are ignored: only the
    deterministic forward is ported."""
    if architecture != "res_slimvit":
        raise NotImplementedError(
            f"{architecture!r} is not ported yet: only the res_slimvit preset serves")
    in_shape, out_shape = data_module.get_data_dims()
    in_channels, in_height, in_width = in_shape[1:]
    model = ResSlimViT(
        default_vars=tuple(default_vars), img_size=(in_height, in_width),
        in_channels=in_channels, out_channels=out_shape[1], superres_mag=superres_mag,
        patch_size=patch_size, cnn_ratio=cnn_ratio,
        learn_pos_emb=True,  # the reference hardcodes this (loaders.py:366)
        embed_dim=embed_dim, depth=depth, decoder_depth=decoder_depth,
        num_heads=num_heads, mlp_ratio=mlp_ratio, drop_path=drop_path,
        attention_impl=attention_impl, gelu_approx=gelu_approx,
        moe_experts=moe_experts, pipeline_stages=pipeline_stages, generator=generator)
    return model.to(_DTYPES[data_type])


def load_downscaling_module(data_module, architecture: str = "res_slimvit",
                            model_kwargs: Optional[Dict[str, Any]] = None):
    """Returns (model, test_losses, test_transforms)."""
    lat, lon = data_module.get_lat_lon()
    in_vars, out_vars = data_module.get_data_variables()
    model = load_architecture(data_module, architecture, **(model_kwargs or {}))
    clim = data_module.get_climatology(split="test")
    metainfo = MetricsMetaInfo(in_vars, out_vars, lat, lon, clim)
    test_losses = [METRICS_REGISTRY[name](aggregate_only=False, metainfo=metainfo)
                   for name in TEST_LOSSES]
    denorm = TRANSFORMS_REGISTRY["denormalize"](data_module)
    return model, test_losses, [denorm] * len(TEST_LOSSES)
