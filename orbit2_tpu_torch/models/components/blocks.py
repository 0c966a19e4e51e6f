"""Transformer building blocks (counterpart of orbit2_tpu/models/components/blocks.py).

Parameter names and shapes follow the reference PyTorch modules
(models/hub/components/{attention.py, mlp.py, vit_blocks.py}), so the
reference state-dict keys load directly.

Mixed precision as in the JAX package: parameters keep their own dtype (fp32
masters when training) and every module casts its weights to the dtype of
the activations it is given, the compute dtype, at use (flax's
dtype/param_dtype split). When the parameters already are in that dtype the
casts are no-ops.

Randomness is explicit: in train() mode the dropout sites draw their seeds
from a `dropout` generator and DropPath its masks from a separate
`drop_path` generator (the JAX package's two rng streams, train.py:98).
Without a drop_path generator DropPath is inert, as in the JAX package
(blocks.py:39-49); dropout in training without a generator raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from orbit2_tpu_torch.ops.attention import dot_product_attention
from orbit2_tpu_torch.ops.dropout import dropout
from orbit2_tpu_torch.ops.fused_mlp import fused_mlp

Generator = Optional[torch.Generator]


def trunc_normal_(t: torch.Tensor, generator: Optional[torch.Generator], std: float = 0.02):
    """flax truncated_normal(stddev=std, lower=-2, upper=2): cut at two std."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def init_linear_(m: nn.Linear, generator: Optional[torch.Generator]) -> None:
    trunc_normal_(m.weight, generator)
    if m.bias is not None:
        nn.init.zeros_(m.bias)


def _cast(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype."""

    def forward(self, x):
        return F.linear(x, _cast(self.weight, x.dtype), _cast(self.bias, x.dtype))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm computing in its input's dtype."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, _cast(self.weight, x.dtype),
                            _cast(self.bias, x.dtype), self.eps)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in its input's dtype."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class DropPath(nn.Module):
    """Stochastic depth (timm DropPath, reference vit_blocks.py:61): in
    training each sample's branch is kept with probability 1 - rate and then
    scaled by 1/keep. The [B] keep mask is drawn on the host from the
    drop_path generator and copied to the device without a sync."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Generator = None):
        if not self.training or generator is None or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape[0], generator=generator) < keep
        if x.is_cuda:
            mask = mask.pin_memory()
        mask = mask.to(x.device, non_blocking=True).view((-1,) + (1,) * (x.dim() - 1))
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class LayerScale(nn.Module):
    """Reference vit_blocks.py:9-21."""

    def __init__(self, dim: int, init_values: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class Mlp(nn.Module):
    """fc1 -> GELU (erf, or tanh when gelu_tanh) -> drop -> fc2 -> drop
    (reference mlp.py:22-73); both dropouts are the fused kernel.

    `use_fused` (JAX blocks.py:151, :174-183) sends an eval-mode, erf-GELU
    forward through ops/fused_mlp.py (the K6 kernels, which save no hidden
    for the backward), on the weights cast to x's dtype; where that declines
    on shape the plain chain runs. The parameters stay fc1/fc2 either way, so
    weights load the same. Off by default, as in the JAX package, whose
    measurements on a TPU found the fused kernel slower at model level
    (blocks.py:128-137; a TPU finding, not one about this port)."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, drop: float = 0.0, use_bias: bool = True,
                 gelu_tanh: bool = False, use_fused: bool = False):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, bias=use_bias)
        self.fc2 = Linear(hidden_features, out_features or in_features, bias=use_bias)
        self.drop = drop
        self.approximate = "tanh" if gelu_tanh else "none"
        self.use_fused = use_fused

    def reset_parameters(self, generator=None):
        init_linear_(self.fc1, generator)
        init_linear_(self.fc2, generator)

    def forward(self, x, generator: Generator = None):
        if self.use_fused and not self.training and self.approximate == "none":
            out = fused_mlp(x, _cast(self.fc1.weight, x.dtype), _cast(self.fc1.bias, x.dtype),
                            _cast(self.fc2.weight, x.dtype), _cast(self.fc2.bias, x.dtype))
            if out is not None:
                return out
        h = F.gelu(self.fc1(x), approximate=self.approximate)
        h = dropout(h, self.drop, self.training, generator)
        return dropout(self.fc2(h), self.drop, self.training, generator)


class Attention(nn.Module):
    """Self attention with a selectable kernel (reference attention.py:12-87):
    probability dropout `attn_drop` inside the attention op, `proj_drop` on
    the projection."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 qk_norm: bool = False, proj_bias: bool = True, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, attention_impl: str = "xla"):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.q_norm = LayerNorm(self.head_dim, eps=1e-5) if qk_norm else None
        self.k_norm = LayerNorm(self.head_dim, eps=1e-5) if qk_norm else None
        self.proj = Linear(dim, dim, bias=proj_bias)
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.attention_impl = attention_impl

    def reset_parameters(self, generator=None):
        init_linear_(self.qkv, generator)
        init_linear_(self.proj, generator)

    def forward(self, x, generator: Generator = None):
        B, N, C = x.shape
        # q, k, v stay strided views of the packed projection: the kernels
        # read them through their strides, no copy
        q, k, v = self.qkv(x).reshape(B, N, 3, self.num_heads, self.head_dim).unbind(2)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        rate = self.attn_drop if self.training else 0.0
        x = dot_product_attention(q, k, v, impl=self.attention_impl, dropout_rate=rate,
                                  generator=generator)
        return dropout(self.proj(x.reshape(B, N, C)), self.proj_drop, self.training, generator)


class VariableMappingAttention(nn.Module):
    """Cross attention collapsing V variable token streams to one aggregated
    stream (reference attention.py:98-183), in the JAX package's algebraically
    reduced form with the reference's parameter shapes (q: D x C, kv: 2D x C):

      * scores: k_v . q_h == x_v . (W_k[h] q_h), one [C, H] matrix `u`
      * values: sum_v attn_vh (W_v x_v)_h == W_v[h] (sum_v attn_vh x_v)

    The model builds it without dropout (attn_drop = proj_drop = 0 in the
    JAX package), so it has none.
    """

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 proj_bias: bool = True):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.q = Linear(dim, dim, bias=qkv_bias)
        self.kv = Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim, bias=proj_bias)

    def reset_parameters(self, generator=None):
        for m in (self.q, self.kv, self.proj):
            init_linear_(m, generator)

    def forward(self, var_query, x):
        """var_query: [1, 1, C] (learned, position-independent); x: [B', V, C]
        where B' = B*L. Returns [B', 1, C]."""
        Bp, _, C = x.shape
        H, D = self.num_heads, self.dim
        hd = D // H
        scale = hd ** -0.5
        kv_w = self.kv.weight.to(x.dtype)
        kv_b = _cast(self.kv.bias, x.dtype)

        q_heads = self.q(var_query[0, 0].to(x.dtype)).reshape(H, hd)
        w_k = kv_w[:D].reshape(H, hd, C)
        w_v = kv_w[D:].reshape(H, hd, C)
        u = torch.einsum("hdc,hd->ch", w_k, q_heads)
        scores = torch.einsum("bvc,ch->bvh", x, u) * scale
        if kv_b is not None:
            kb = kv_b[:D].reshape(H, hd)
            scores = scores + torch.einsum("hd,hd->h", kb, q_heads) * scale
        attn = torch.softmax(scores.float(), dim=1).to(x.dtype)

        y = torch.einsum("bvh,bvc->bhc", attn, x)
        vals = torch.einsum("bhc,hdc->bhd", y, w_v)
        if kv_b is not None:
            vals = vals + kv_b[D:].reshape(1, H, hd)
        return self.proj(vals.reshape(Bp, 1, D))


class Block(nn.Module):
    """Pre-LN transformer block (reference vit_blocks.py:25-81):
    x = x + DropPath(LS(Attn(LN(x)))); x = x + DropPath(LS(Mlp(LN(x))))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_norm: bool = False, proj_bias: bool = True,
                 proj_drop: float = 0.0, attn_drop: float = 0.0,
                 init_values: Optional[float] = None, drop_path: float = 0.0,
                 attention_impl: str = "xla", gelu_tanh: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_norm, proj_bias, attn_drop,
                              proj_drop, attention_impl)
        self.ls1 = LayerScale(dim, init_values) if init_values else nn.Identity()
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=proj_drop, use_bias=proj_bias,
                       gelu_tanh=gelu_tanh)
        self.ls2 = LayerScale(dim, init_values) if init_values else nn.Identity()
        self.drop_path2 = DropPath(drop_path)

    def reset_parameters(self, generator=None):
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, x, dropout_gen: Generator = None, drop_path_gen: Generator = None):
        x = x + self.drop_path1(self.ls1(self.attn(self.norm1(x), dropout_gen)), drop_path_gen)
        return x + self.drop_path2(self.ls2(self.mlp(self.norm2(x), dropout_gen)), drop_path_gen)
