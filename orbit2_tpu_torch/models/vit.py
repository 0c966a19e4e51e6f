"""Plain VisionTransformer, in PyTorch (counterpart of
orbit2_tpu/models/vit.py; reference models/hub/vit.py:12-125).

One patch embedding over all channels, the port's Blocks (flash attention,
K1-K3, and the fused dropout, K5, at their sites), LayerNorm, an erf-GELU
head of `decoder_depth` layers and the unpatchify `nhwpqc->nchpwq`. For
downscaling it runs behind a bilinear upsample to the target grid
(utils/loaders.py::PreInterpolated), so its tokens are the target grid's.

Parameters carry the reference keys: patch_embed.proj (a Conv2d(C, D, p, p)
weight, applied as one product over the (C, p, p)-ordered patch features),
pos_embed (learned, or fixed at the 2-D sin-cos table), blocks.{i}.*, norm,
head.{2i} (Linear layers between GELUs). Drawn as the JAX module draws:
trunc_normal(0.02) for every dense kernel, zero biases, unit LayerNorm
scales. fp32 parameters, computing in `dtype`. On a mesh pos_drop folds the
rank's data coordinates into its seed (`pos_fold`), as the Blocks' sites
fold theirs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from orbit2_tpu_torch.models.components.blocks import (
    Block, Conv2d, Generator, LayerNorm, Linear, init_linear_, trunc_normal_)
from orbit2_tpu_torch.ops.dropout import dropout
from orbit2_tpu_torch.ops.pos_embed import get_2d_sincos_pos_embed
from orbit2_tpu_torch.registry import register_model


class _PatchEmbed(nn.Module):
    """Holds the patch projection under the reference key patch_embed.proj."""

    def __init__(self, in_channels: int, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = Conv2d(in_channels, embed_dim, patch_size, patch_size)


@register_model("vit")
class VisionTransformer(nn.Module):
    # on a mesh: the data coordinates folded into pos_drop's seed
    # (parallel/sharding.py::shard_model)
    pos_fold: tuple = ()

    def __init__(self, img_size: Tuple[int, int], in_channels: int, out_channels: int,
                 history: int = 1, patch_size: int = 16, drop_path: float = 0.1,
                 drop_rate: float = 0.1, learn_pos_emb: bool = False, embed_dim: int = 1024,
                 depth: int = 24, decoder_depth: int = 8, num_heads: int = 16,
                 mlp_ratio: float = 4.0, attention_impl: str = "xla", gelu_approx: str = "exact",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if gelu_approx not in ("exact", "tanh"):
            raise ValueError(f"unknown gelu_approx {gelu_approx!r}")
        self.img_size = tuple(img_size)
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.out_channels = out_channels
        self.drop_rate = drop_rate
        self.dtype = dtype
        D = embed_dim
        self.patch_embed = _PatchEmbed(in_channels * history, patch_size, D)
        self.pos_embed = nn.Parameter(torch.as_tensor(self._sincos())[None],
                                      requires_grad=learn_pos_emb)
        dpr = np.linspace(0, drop_path, depth)
        self.blocks = nn.ModuleList(
            Block(D, num_heads, mlp_ratio, qkv_bias=True, proj_drop=drop_rate,
                  attn_drop=drop_rate, drop_path=float(dpr[i]), attention_impl=attention_impl,
                  gelu_tanh=gelu_approx == "tanh")
            for i in range(depth))
        self.norm = LayerNorm(D, eps=1e-5)
        head = []
        for _ in range(decoder_depth):
            head += [Linear(D, D), nn.GELU()]
        head.append(Linear(D, out_channels * patch_size ** 2))
        self.head = nn.Sequential(*head)
        self.reset_parameters(generator)

    def _sincos(self) -> np.ndarray:
        p = self.patch_size
        pe = get_2d_sincos_pos_embed(self.embed_dim, self.img_size[0] // p, self.img_size[1] // p)
        return np.asarray(pe, np.float32)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX module's initializers, drawn from `generator` in module order."""
        trunc_normal_(self.patch_embed.proj.weight, generator)
        nn.init.zeros_(self.patch_embed.proj.bias)
        self.pos_embed.copy_(torch.as_tensor(self._sincos())[None])
        for blk in self.blocks:
            blk.reset_parameters(generator)
        self.norm.reset_parameters()
        for m in self.head:
            if isinstance(m, nn.Linear):
                init_linear_(m, generator)

    def init_units(self):
        """One unit, the whole model, drawn as reset_parameters draws
        (models/resnet.py::ResNet.init_units)."""
        return [("", self, self.reset_parameters)]

    def forward(self, x, in_variables=None, out_variables=None, dropout_gen: Generator = None,
                drop_path_gen: Generator = None, return_aux: bool = False):
        """x: [B, C, H, W] or [B, T, C, H, W] at img_size; returns [B, out, H, W]
        in the compute dtype (with return_aux, and an empty list of aux
        losses). In train() mode the dropout sites draw from `dropout_gen`
        and DropPath from `drop_path_gen`."""
        if x.ndim == 5:
            x = x.flatten(1, 2)
        x = x.to(self.dtype)
        B, C, H, W = x.shape
        p, D = self.patch_size, self.embed_dim
        h, w = H // p, W // p
        patches = x.reshape(B, C, h, p, w, p).permute(0, 2, 4, 1, 3, 5).reshape(B, h * w, C * p * p)
        proj = self.patch_embed.proj
        tokens = torch.nn.functional.linear(patches, proj.weight.reshape(D, -1).to(x.dtype),
                                            proj.bias.to(x.dtype))
        tokens = tokens + self.pos_embed.to(x.dtype)
        tokens = dropout(tokens, self.drop_rate, self.training, dropout_gen,
                         self.pos_fold)  # pos_drop
        for blk in self.blocks:
            tokens = blk(tokens, dropout_gen, drop_path_gen)
        y = self.head(self.norm(tokens))
        c = self.out_channels
        y = torch.einsum("nhwpqc->nchpwq", y.reshape(B, h, w, p, p, c))
        y = y.reshape(B, c, h * p, w * p)
        return (y, []) if return_aux else y
