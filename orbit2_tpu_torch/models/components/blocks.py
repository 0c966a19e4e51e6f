"""Transformer building blocks (counterpart of orbit2_tpu/models/components/blocks.py).

Parameter names and shapes follow the reference PyTorch modules
(models/hub/components/{attention.py, mlp.py, vit_blocks.py}), so the
reference state-dict keys load directly. This slice serves: dropout, DropPath
and attention dropout are eval-mode identities, and a forward in train() mode
raises until the training kernels are ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from orbit2_tpu_torch.ops.attention import dot_product_attention


def trunc_normal_(t: torch.Tensor, generator: Optional[torch.Generator], std: float = 0.02):
    """flax truncated_normal(stddev=std, lower=-2, upper=2): cut at two std."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def init_linear_(m: nn.Linear, generator: Optional[torch.Generator]) -> None:
    trunc_normal_(m.weight, generator)
    if m.bias is not None:
        nn.init.zeros_(m.bias)


def require_eval(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__}: only the deterministic (eval) forward is ported; "
            "dropout and drop-path come with the training kernels — call .eval()")


class DropPath(nn.Module):
    """Stochastic depth (timm DropPath, reference vit_blocks.py:61): identity in eval."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        require_eval(self)
        return x


class LayerScale(nn.Module):
    """Reference vit_blocks.py:9-21."""

    def __init__(self, dim: int, init_values: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x):
        return x * self.gamma


class Mlp(nn.Module):
    """fc1 -> GELU (erf, or tanh when gelu_tanh) -> fc2 (reference mlp.py:22-73)."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, use_bias: bool = True,
                 gelu_tanh: bool = False):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features, bias=use_bias)
        self.fc2 = nn.Linear(hidden_features, out_features or in_features, bias=use_bias)
        self.approximate = "tanh" if gelu_tanh else "none"

    def reset_parameters(self, generator=None):
        init_linear_(self.fc1, generator)
        init_linear_(self.fc2, generator)

    def forward(self, x):
        require_eval(self)
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class Attention(nn.Module):
    """Self attention with a selectable kernel (reference attention.py:12-87)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 qk_norm: bool = False, proj_bias: bool = True, attention_impl: str = "xla"):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.q_norm = nn.LayerNorm(self.head_dim, eps=1e-5) if qk_norm else None
        self.k_norm = nn.LayerNorm(self.head_dim, eps=1e-5) if qk_norm else None
        self.proj = nn.Linear(dim, dim, bias=proj_bias)
        self.attention_impl = attention_impl

    def reset_parameters(self, generator=None):
        init_linear_(self.qkv, generator)
        init_linear_(self.proj, generator)

    def forward(self, x):
        require_eval(self)
        B, N, C = x.shape
        # q, k, v stay strided views of the packed projection: the kernel
        # reads them through their strides, no copy
        q, k, v = self.qkv(x).reshape(B, N, 3, self.num_heads, self.head_dim).unbind(2)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        x = dot_product_attention(q, k, v, impl=self.attention_impl)
        return self.proj(x.reshape(B, N, C))


class VariableMappingAttention(nn.Module):
    """Cross attention collapsing V variable token streams to one aggregated
    stream (reference attention.py:98-183), in the JAX package's algebraically
    reduced form with the reference's parameter shapes (q: D x C, kv: 2D x C):

      * scores: k_v . q_h == x_v . (W_k[h] q_h), one [C, H] matrix `u`
      * values: sum_v attn_vh (W_v x_v)_h == W_v[h] (sum_v attn_vh x_v)
    """

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 proj_bias: bool = True):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim, bias=proj_bias)

    def reset_parameters(self, generator=None):
        for m in (self.q, self.kv, self.proj):
            init_linear_(m, generator)

    def forward(self, var_query, x):
        """var_query: [1, 1, C] (learned, position-independent); x: [B', V, C]
        where B' = B*L. Returns [B', 1, C]."""
        require_eval(self)
        Bp, _, C = x.shape
        H, D = self.num_heads, self.dim
        hd = D // H
        scale = hd ** -0.5

        q_heads = self.q(var_query[0, 0]).reshape(H, hd)
        w_k = self.kv.weight[:D].reshape(H, hd, C)
        w_v = self.kv.weight[D:].reshape(H, hd, C)
        u = torch.einsum("hdc,hd->ch", w_k, q_heads)
        scores = torch.einsum("bvc,ch->bvh", x, u) * scale
        if self.kv.bias is not None:
            kb = self.kv.bias[:D].reshape(H, hd)
            scores = scores + torch.einsum("hd,hd->h", kb, q_heads) * scale
        attn = torch.softmax(scores.float(), dim=1).to(x.dtype)

        y = torch.einsum("bvh,bvc->bhc", attn, x)
        vals = torch.einsum("bhc,hdc->bhd", y, w_v)
        if self.kv.bias is not None:
            vals = vals + self.kv.bias[D:].reshape(1, H, hd)
        return self.proj(vals.reshape(Bp, 1, D))


class Block(nn.Module):
    """Pre-LN transformer block (reference vit_blocks.py:25-81):
    x = x + DropPath(LS(Attn(LN(x)))); x = x + DropPath(LS(Mlp(LN(x))))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_norm: bool = False, proj_bias: bool = True,
                 init_values: Optional[float] = None, drop_path: float = 0.0,
                 attention_impl: str = "xla", gelu_tanh: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_norm, proj_bias, attention_impl)
        self.ls1 = LayerScale(dim, init_values) if init_values else nn.Identity()
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), use_bias=proj_bias, gelu_tanh=gelu_tanh)
        self.ls2 = LayerScale(dim, init_values) if init_values else nn.Identity()
        self.drop_path2 = DropPath(drop_path)

    def reset_parameters(self, generator=None):
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, x):
        x = x + self.drop_path1(self.ls1(self.attn(self.norm1(x))))
        return x + self.drop_path2(self.ls2(self.mlp(self.norm2(x))))
