"""CNN building blocks with periodic (longitude-wrap) padding, in PyTorch.

Counterpart of orbit2_tpu/models/components/cnn.py (reference
models/hub/components/cnn_blocks.py:5-295). Modules work on NCHW tensors and
carry the reference's parameter names (conv1.conv, norm1, shortcut,
projection/output, res1/res2, conv), so
training/checkpoint.py::state_dict_from_jax_params maps the JAX trees onto
them; the JAX package works on NHWC inside and takes NCHW at its models'
boundary, which is where these modules stand.

Convolutions are cuDNN's (F.conv2d / F.conv_transpose2d, as XLA computes
them outside any Pallas kernel), with the weights cast to the activations'
dtype at use (the compute dtype; parameters stay fp32 masters). Dropout is
the fused dropout kernel (ops/dropout.py, K5), drawing its seed from the
`dropout` generator.

The JAX modules' numerics, where torch's differ:
  * BatchNorm: flax's. Statistics in fp32 whatever the compute dtype, the
    variance as E[x^2] - E[x]^2 clipped at 0, the running averages updated
    with the BIASED batch variance (ra = 0.9 ra + 0.1 stat; torch's
    BatchNorm2d updates running_var with the unbiased one), the output
    (x - mean) * (rsqrt(var + eps) * scale) + bias in fp32, cast once.
  * Transposed convolution: flax's ConvTranspose does not flip its kernel
    and torch's does, so a flax kernel k [K, K, I, O] is this module's
    weight[i, o, kh, kw] = k[K-1-kh, K-1-kw, i, o] (the import does it);
    Upsample's torch padding 1 is flax's explicit (2, 2).
  * Initialisers: flax's lecun_normal (variance 1 / fan_in, truncated at two
    std) for every conv and dense kernel, zero biases; fan_in of a
    transposed kernel is K * K * its input channels, as flax counts it.
  * AttentionBlock softmaxes over the queries (the reference quirk, JAX
    cnn.py:131): it is no flash attention and stays plain torch ops.

On a device mesh (parallel/sharding.py::shard_model) each data rank holds
its slice of the global batch, and JAX's BatchNorm, inside one jitted step,
takes its statistics over the whole global batch: a BatchNorm2d given
`sync` = (the data ranks' process group, their count) averages the ranks'
batch moments E[x], E[x^2] (equal slices) by an all-reduce whose backward
sums the gradients over the ranks too (parallel/tensor.py::all_reduce_sum),
so the running averages move by the global batch's moments, bit-equal on
every rank, and the gradients FSDP2 averages are the global loss's. Its
ResidualBlocks' dropout seeds fold the rank's data coordinates (`fold`), so
two data ranks draw different masks; ranks that share a data coordinate
(tensor, seq) draw the same. The convolutions are replicated over the
tensor axis (JAX's rules split none of them): every tensor rank repeats the
same work on the same batch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from orbit2_tpu_torch.models.components.blocks import Conv2d, Generator, Linear
from orbit2_tpu_torch.ops.dropout import dropout
from orbit2_tpu_torch.parallel.tensor import all_reduce_sum

# the truncated normal at two std has std 0.8796... of the untruncated one
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, generator: Optional[torch.Generator],
                  fan_in: Optional[int] = None) -> None:
    """flax's default kernel init: variance 1/fan_in, truncated at two std.
    fan_in defaults to t[0].numel() (a Linear's in features, a conv's
    in x kh x kw)."""
    fan_in = t[0].numel() if fan_in is None else fan_in
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def init_dense_(m: nn.Module, generator: Optional[torch.Generator]) -> None:
    """lecun_normal kernel, zero bias: a flax Dense or Conv at its defaults."""
    fan_in = None
    if isinstance(m, nn.ConvTranspose2d):
        fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
    lecun_normal_(m.weight, generator, fan_in)
    if m.bias is not None:
        nn.init.zeros_(m.bias)


def periodic_pad(x: torch.Tensor, pad_width: int) -> torch.Tensor:
    """Wrap-pad longitude (W), zero-pad latitude (H) of an NCHW tensor
    (reference cnn_blocks.py:5-25)."""
    if pad_width == 0:
        return x
    x = torch.cat((x[..., -pad_width:], x, x[..., :pad_width]), dim=-1)
    return F.pad(x, (0, 0, pad_width, pad_width))


def activation_fn(name: str):
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    if name == "relu":
        return F.relu
    if name == "silu":
        return F.silu
    if name == "leaky":
        return lambda x: F.leaky_relu(x, negative_slope=0.3)
    raise NotImplementedError(f"Activation {name} not implemented")


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d computing in its input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


class PeriodicConv2D(nn.Module):
    """Periodic pad, then a VALID conv (reference cnn_blocks.py:28-39)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.padding = padding
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride)

    def reset_parameters(self, generator=None):
        init_dense_(self.conv, generator)

    def forward(self, x):
        return self.conv(periodic_pad(x, self.padding))


class PeriodicConvTranspose2D(nn.Module):
    """Periodic pad, then a VALID transposed conv (reference
    cnn_blocks.py:42-54; unused on the reference's active path, kept for
    component parity)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.padding = padding
        self.conv = ConvTranspose2d(in_channels, out_channels, kernel_size, stride)

    def reset_parameters(self, generator=None):
        init_dense_(self.conv, generator)

    def forward(self, x):
        return self.conv(periodic_pad(x, self.padding))


class BatchNorm2d(nn.BatchNorm2d):
    """flax nn.BatchNorm(momentum=0.9, epsilon=1e-5) over NCHW channels, under
    torch BatchNorm2d's parameter and buffer names (module docstring). In
    train() mode it normalizes by the batch statistics and moves the
    running averages; in eval() mode it normalizes by the running averages.
    `sync` (set on a mesh): the data ranks' (process group, count), whose
    moments are averaged (module docstring)."""

    sync: Optional[Tuple[object, int]] = None

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def _apply(self, fn, recurse=True):
        # the running averages stay fp32 through a cast of the model, as
        # flax's batch_stats do under a bf16 dtype
        stats = {k: self._buffers[k] for k in ("running_mean", "running_var")}
        super()._apply(fn, recurse)
        for k, old in stats.items():
            new = self._buffers[k]
            if new is not None and new.dtype != old.dtype:
                self._buffers[k] = new.to(old.dtype)
        return self

    def forward(self, x):
        x32 = x.float()
        if self.training:
            mean, sq = x32.mean(dim=(0, 2, 3)), (x32 * x32).mean(dim=(0, 2, 3))
            if self.sync is not None:  # the global batch's: the data ranks' slices averaged
                group, ranks = self.sync
                mean, sq = (all_reduce_sum(torch.stack((mean, sq)), group) / ranks).unbind(0)
            var = torch.clamp(sq - mean * mean, min=0.0)
            with torch.no_grad():
                decay = 1.0 - self.momentum
                self.running_mean.mul_(decay).add_(mean.detach() * self.momentum)
                self.running_var.mul_(decay).add_(var.detach() * self.momentum)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x32 - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + self.bias.float().view(1, -1, 1, 1)
        return y.to(x.dtype)


class ResidualBlock(nn.Module):
    """conv -> act -> norm -> drop, twice, plus the (1x1-projected) shortcut
    (reference cnn_blocks.py:56-106). Both dropout sites fold `fold` (on a
    mesh: the rank's data coordinates) into their seeds."""

    fold: tuple = ()

    def __init__(self, in_channels: int, out_channels: int, activation: str = "leaky",
                 norm: bool = False, dropout: float = 0.1):
        super().__init__()
        self.act = activation_fn(activation)
        self.conv1 = PeriodicConv2D(in_channels, out_channels, 3, padding=1)
        self.conv2 = PeriodicConv2D(out_channels, out_channels, 3, padding=1)
        self.shortcut = Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None
        self.norm1 = BatchNorm2d(out_channels) if norm else None
        self.norm2 = BatchNorm2d(out_channels) if norm else None
        self.drop = dropout

    def reset_parameters(self, generator=None):
        self.conv1.reset_parameters(generator)
        for m in (self.norm1, self.norm2):
            if m is not None:
                m.reset_parameters()
        self.conv2.reset_parameters(generator)
        if self.shortcut is not None:
            init_dense_(self.shortcut, generator)

    def forward(self, x, generator: Generator = None):
        h = self.act(self.conv1(x))
        if self.norm1 is not None:
            h = self.norm1(h)
        h = dropout(h, self.drop, self.training, generator, self.fold)
        h = self.act(self.conv2(h))
        if self.norm2 is not None:
            h = self.norm2(h)
        h = dropout(h, self.drop, self.training, generator, self.fold)
        return h + (x if self.shortcut is None else self.shortcut(x))


class AttentionBlock(nn.Module):
    """Spatial self-attention over the flattened H*W positions (reference
    cnn_blocks.py:109-164), softmaxed over the queries as the reference
    does."""

    def __init__(self, n_channels: int, n_heads: int = 1, d_k: Optional[int] = None):
        super().__init__()
        self.n_heads = n_heads
        self.d_k = d_k or n_channels
        self.projection = Linear(n_channels, n_heads * self.d_k * 3)
        self.output = Linear(n_heads * self.d_k, n_channels)

    def reset_parameters(self, generator=None):
        init_dense_(self.projection, generator)
        init_dense_(self.output, generator)

    def forward(self, x, generator: Generator = None):
        B, C, H, W = x.shape
        seq = x.flatten(2).transpose(1, 2)  # [B, H*W, C]
        qkv = self.projection(seq).view(B, H * W, self.n_heads, 3 * self.d_k)
        q, k, v = qkv.chunk(3, dim=-1)
        attn = torch.einsum("bihd,bjhd->bijh", q, k) * self.d_k ** -0.5
        attn = attn.softmax(dim=1)  # the reference quirk: over the queries i
        res = torch.einsum("bijh,bjhd->bihd", attn, v).reshape(B, H * W, self.n_heads * self.d_k)
        res = self.output(res) + seq
        return res.transpose(1, 2).reshape(B, C, H, W)


class DownBlock(nn.Module):
    """reference cnn_blocks.py:167-198."""

    def __init__(self, in_channels: int, out_channels: int, has_attn: bool = False,
                 activation: str = "leaky", norm: bool = False, dropout: float = 0.1):
        super().__init__()
        self.res = ResidualBlock(in_channels, out_channels, activation, norm, dropout)
        self.attn = AttentionBlock(out_channels) if has_attn else None

    def reset_parameters(self, generator=None):
        self.res.reset_parameters(generator)
        if self.attn is not None:
            self.attn.reset_parameters(generator)

    def forward(self, x, generator: Generator = None):
        x = self.res(x, generator)
        return x if self.attn is None else self.attn(x)


class UpBlock(DownBlock):
    """reference cnn_blocks.py:201-234: a DownBlock whose input is the
    concatenation of the up path and its skip."""


class MiddleBlock(nn.Module):
    """reference cnn_blocks.py:237-273."""

    def __init__(self, n_channels: int, has_attn: bool = False, activation: str = "leaky",
                 norm: bool = False, dropout: float = 0.1):
        super().__init__()
        self.res1 = ResidualBlock(n_channels, n_channels, activation, norm, dropout)
        self.attn = AttentionBlock(n_channels) if has_attn else None
        self.res2 = ResidualBlock(n_channels, n_channels, activation, norm, dropout)

    def reset_parameters(self, generator=None):
        self.res1.reset_parameters(generator)
        if self.attn is not None:
            self.attn.reset_parameters(generator)
        self.res2.reset_parameters(generator)

    def forward(self, x, generator: Generator = None):
        x = self.res1(x, generator)
        if self.attn is not None:
            x = self.attn(x)
        return self.res2(x, generator)


class Upsample(nn.Module):
    """2x transposed-conv upsample (reference cnn_blocks.py:276-284): torch
    ConvTranspose2d(k 4, s 2, p 1), flax's explicit padding (2, 2)."""

    def __init__(self, n_channels: int):
        super().__init__()
        self.conv = ConvTranspose2d(n_channels, n_channels, 4, 2, 1)

    def reset_parameters(self, generator=None):
        init_dense_(self.conv, generator)

    def forward(self, x, generator: Generator = None):
        return self.conv(x)


class Downsample(nn.Module):
    """2x strided-conv downsample (reference cnn_blocks.py:287-295)."""

    def __init__(self, n_channels: int):
        super().__init__()
        self.conv = Conv2d(n_channels, n_channels, 3, 2, 1)

    def reset_parameters(self, generator=None):
        init_dense_(self.conv, generator)

    def forward(self, x, generator: Generator = None):
        return self.conv(x)


__all__ = ["AttentionBlock", "BatchNorm2d", "ConvTranspose2d", "DownBlock", "Downsample",
           "MiddleBlock", "PeriodicConv2D", "PeriodicConvTranspose2D", "ResidualBlock", "UpBlock",
           "Upsample", "activation_fn", "init_dense_", "lecun_normal_", "periodic_pad"]
