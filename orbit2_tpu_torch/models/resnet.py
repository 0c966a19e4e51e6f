"""Periodic-conv ResNet, the Rasp & Theurey 2020 forecasting baseline, in
PyTorch (counterpart of orbit2_tpu/models/resnet.py; reference
models/hub/resnet.py:10-71).

Parameters carry the reference keys (image_proj.conv, blocks.{i}.conv1.conv,
blocks.{i}.norm1, ..., norm, final.conv). They are fp32; the forward computes
in `dtype` (x is cast on entry, every layer casts its weights at use), with
BatchNorm's statistics in fp32 (models/components/cnn.py). A [B, T, C, H, W]
input is folded to [B, T*C, H, W], as the JAX model does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from orbit2_tpu_torch.models.components.blocks import Generator
from orbit2_tpu_torch.models.components.cnn import (
    BatchNorm2d, PeriodicConv2D, ResidualBlock, activation_fn)
from orbit2_tpu_torch.registry import register_model


@register_model("resnet")
class ResNet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, history: int = 1,
                 hidden_channels: int = 128, activation: str = "leaky", norm: bool = True,
                 dropout: float = 0.1, n_blocks: int = 2, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.out_channels = out_channels
        self.act = activation_fn(activation)
        self.image_proj = PeriodicConv2D(in_channels * history, hidden_channels, 7, padding=3)
        # every residual block normalizes, whatever `norm` says (JAX resnet.py:35)
        self.blocks = nn.ModuleList(
            ResidualBlock(hidden_channels, hidden_channels, activation, norm=True, dropout=dropout)
            for _ in range(n_blocks))
        self.norm = BatchNorm2d(hidden_channels) if norm else None
        self.final = PeriodicConv2D(hidden_channels, out_channels, 7, padding=3)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initializers (lecun_normal kernels, zero biases, unit
        scales), drawn from `generator` in module order."""
        self.image_proj.reset_parameters(generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        if self.norm is not None:
            self.norm.reset_parameters()
        self.final.reset_parameters(generator)

    def init_units(self):
        """One unit, the whole model, drawn as reset_parameters draws: a
        model built on the meta device is filled by evaluate.py::materialize
        (on a mesh, into its shards) with the one-process draws."""
        return [("", self, self.reset_parameters)]

    def forward(self, x, in_variables=None, out_variables=None, dropout_gen: Generator = None,
                drop_path_gen: Generator = None, return_aux: bool = False):
        """x: [B, C, H, W] or [B, T, C, H, W]; returns [B, out, H, W] in the
        compute dtype (and, with return_aux, an empty list of aux losses).
        The variable lists are taken for the trainers' calling convention
        and not used; the dropout sites draw from `dropout_gen` in train()."""
        if x.ndim == 5:
            x = x.flatten(1, 2)
        x = self.image_proj(x.to(self.dtype))
        for blk in self.blocks:
            x = blk(x, dropout_gen)
        if self.norm is not None:
            x = self.norm(x)
        y = self.final(self.act(x))
        return (y, []) if return_aux else y
