"""Non-learned and simple baselines, in PyTorch (counterpart of
orbit2_tpu/models/baselines.py; reference models/hub/{climatology.py,
persistence.py, linear_regression.py, interpolation.py}).

Each takes the trainers' calling convention, model(x, in_variables,
out_variables, dropout_gen, drop_path_gen, return_aux=False), and ignores
what it does not use. Each has `init_units`, by which
evaluate.py::materialize fills a build on the meta device: one unit, or none
where it holds no tensor.

Interpolation is jax.image.resize's: "bilinear" is half-pixel with the
weights renormalised at the borders, which for an upsample is
F.interpolate(align_corners=False, antialias=False); "nearest" is half-pixel
nearest, torch's "nearest-exact" (torch's "nearest" agrees with it only at
integer scales). The output grid is int(H * scale) x int(W * scale).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from orbit2_tpu_torch.models.components.cnn import init_dense_
from orbit2_tpu_torch.models.components.blocks import Linear
from orbit2_tpu_torch.registry import register_model


def _out(y, return_aux):
    return (y, []) if return_aux else y


@register_model("climatology")
class Climatology(nn.Module):
    """Repeats the climatology (C, H, W) for every sample (reference
    climatology.py:8-20)."""

    def __init__(self, clim):
        super().__init__()
        self._clim = np.asarray(clim, dtype=np.float32)  # what a meta-device build fills in
        self.register_buffer("clim", torch.as_tensor(self._clim))

    def init_units(self):
        return [("", self, lambda generator: self.clim.copy_(torch.as_tensor(self._clim)))]

    def forward(self, x, *args, return_aux: bool = False, **kwargs):
        return _out(self.clim[None].expand((x.shape[0],) + tuple(self.clim.shape)), return_aux)


@register_model("persistence")
class Persistence(nn.Module):
    """The last input state of the output channels (reference
    persistence.py:11-28)."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        self.channels = list(channels)

    def init_units(self):
        return []

    def forward(self, x, *args, return_aux: bool = False, **kwargs):
        if x.ndim == 5:  # [B, T, C, H, W] -> the last history step
            x = x[:, -1]
        return _out(x[:, self.channels], return_aux)


@register_model("linear-regression")
class LinearRegression(nn.Module):
    """A linear map of the flattened input (reference
    linear_regression.py:8-24): [B, ...] flattened in its given (NCHW)
    order, as the JAX model flattens it."""

    def __init__(self, in_features: int, out_features: int, out_shape: Tuple[int, int, int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_shape = tuple(out_shape)
        self.linear = Linear(in_features, out_features)
        with torch.no_grad():
            init_dense_(self.linear, generator)

    def init_units(self):
        return [("", self, lambda generator: init_dense_(self.linear, generator))]

    def forward(self, x, *args, return_aux: bool = False, **kwargs):
        b = x.shape[0]
        return _out(self.linear(x.reshape(b, -1)).reshape((b,) + self.out_shape), return_aux)


class Interpolation(nn.Module):
    """jax.image.resize to int(H * scale) x int(W * scale) (reference
    interpolation.py:9-18; module docstring)."""

    MODES = {"bilinear": "bilinear", "nearest": "nearest-exact"}

    def __init__(self, scale_factor: float, mode: str = "bilinear"):
        super().__init__()
        if mode not in self.MODES:
            raise KeyError(mode)
        self.scale_factor = scale_factor
        self.mode = mode

    def init_units(self):
        return []

    def forward(self, x, *args, return_aux: bool = False, **kwargs):
        h, w = x.shape[-2:]
        size = (int(h * self.scale_factor), int(w * self.scale_factor))
        kwargs = dict(align_corners=False, antialias=False) if self.mode == "bilinear" else {}
        return _out(F.interpolate(x, size=size, mode=self.MODES[self.mode], **kwargs), return_aux)


__all__ = ["Climatology", "Interpolation", "LinearRegression", "Persistence"]
