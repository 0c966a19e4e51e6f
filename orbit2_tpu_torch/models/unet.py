"""Classic U-Net with periodic convs and optional attention, in PyTorch
(counterpart of orbit2_tpu/models/unet.py; reference
models/hub/unet.py:20-161).

Parameters carry the reference keys: image_proj.conv; `down`, the encoder's
DownBlocks with a Downsample after each resolution but the last; middle;
`up`, the decoder's UpBlocks with an Upsample after each resolution but the
last; norm; final.conv. Mixed precision and the [B, T, C, H, W] fold as in
models/resnet.py.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from orbit2_tpu_torch.models.components.blocks import Generator
from orbit2_tpu_torch.models.components.cnn import (
    BatchNorm2d, DownBlock, Downsample, MiddleBlock, PeriodicConv2D, UpBlock, Upsample,
    activation_fn)
from orbit2_tpu_torch.registry import register_model


@register_model("unet")
class Unet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, history: int = 1,
                 hidden_channels: int = 64, activation: str = "leaky", norm: bool = True,
                 dropout: float = 0.1, ch_mults: Sequence[int] = (1, 2, 2, 4),
                 is_attn: Sequence[bool] = (False, False, False, False), mid_attn: bool = False,
                 n_blocks: int = 2, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.out_channels = out_channels
        self.act = activation_fn(activation)
        blk = dict(activation=activation, norm=norm, dropout=dropout)
        self.image_proj = PeriodicConv2D(in_channels * history, hidden_channels, 7, padding=3)

        # the encoder (reference unet.py:57-84); skips: each stored output's channels
        n_res = len(ch_mults)
        down, skips = [], [hidden_channels]
        ch = hidden_channels
        for i in range(n_res):
            out_ch = ch * ch_mults[i]
            for _ in range(n_blocks):
                down.append(DownBlock(ch, out_ch, is_attn[i], **blk))
                ch = out_ch
                skips.append(ch)
            if i < n_res - 1:
                down.append(Downsample(ch))
                skips.append(ch)
        self.down = nn.ModuleList(down)
        self.middle = MiddleBlock(ch, mid_attn, **blk)

        # the decoder (reference unet.py:95-131): n_blocks at the same width,
        # one channel-reducing block, an upsample between resolutions
        up = []
        for i in reversed(range(n_res)):
            for _ in range(n_blocks):
                up.append(UpBlock(ch + skips.pop(), ch, is_attn[i], **blk))
            out_ch = ch // ch_mults[i]
            up.append(UpBlock(ch + skips.pop(), out_ch, is_attn[i], **blk))
            ch = out_ch
            if i > 0:
                up.append(Upsample(ch))
        self.up = nn.ModuleList(up)
        self.norm = BatchNorm2d(ch) if norm else None
        self.final = PeriodicConv2D(ch, out_channels, 7, padding=3)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initializers, drawn from `generator` in module order."""
        self.image_proj.reset_parameters(generator)
        for m in (*self.down, self.middle, *self.up):
            m.reset_parameters(generator)
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
        """As models/resnet.py::ResNet.forward."""
        if x.ndim == 5:
            x = x.flatten(1, 2)
        x = self.image_proj(x.to(self.dtype))
        skips = [x]
        for m in self.down:
            x = m(x, dropout_gen)
            skips.append(x)
        x = self.middle(x, dropout_gen)
        for m in self.up:
            if isinstance(m, Upsample):
                x = m(x)
            else:
                x = m(torch.cat((x, skips.pop()), dim=1), dropout_gen)
        if self.norm is not None:
            x = self.norm(x)
        y = self.final(self.act(x))
        return (y, []) if return_aux else y
