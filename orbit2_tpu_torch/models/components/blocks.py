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

w8a8 serving (`quant="w8a8"`, JAX blocks.py:96-122, :147-168, :210-248):
`Mlp` and `Attention` hold `QLinear`s at qkv, proj, fc1 and fc2, whose int8
products run through ops/quant.py; attention itself stays on the flash
kernel. Serving only: in training mode they raise ValueError. An MoE Block
(models/components/moe.py) has no int8 path and refuses w8a8 with JAX's
ValueError.

On a device mesh (parallel/sharding.py::shard_model) qkv, fc1 and var_agg's
q/kv are column-split Linears and proj, fc2 and var_agg's proj row-split
ones (`Linear.tensor_split`): a Block then holds num_heads / tensor heads
and mlp / tensor hidden columns, and its dropout sites fold the rank's mesh
coordinates into their seeds (`*_fold`: the data coordinate where the
activation is replicated across the tensor axis, so every tensor rank draws
the same mask, and the tensor coordinate too where the activation is split
over it: the attention probabilities and the Mlp hidden). Where the trunk's
tokens are split over a seq axis, every Block site folds the seq coordinate
in as well, and the attention runs over all ranks' keys
(`Attention.seq_split`, ops/seq_attention.py). DropPath then takes the
rank's slice of the global batch's mask (`batch_slice`), the same on every
expert, seq and tensor rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from orbit2_tpu_torch.models.components.moe import MoEMlp
from orbit2_tpu_torch.ops.attention import dot_product_attention
from orbit2_tpu_torch.ops.dropout import dropout
from orbit2_tpu_torch.ops.fused_mlp import fused_mlp
from orbit2_tpu_torch.ops.quant import w8a8_matmul
from orbit2_tpu_torch.parallel.tensor import SeqSplit, TensorSplit, local, reduce_from_tensor

Generator = Optional[torch.Generator]


def trunc_normal_(t: torch.Tensor, generator: Optional[torch.Generator], std: float = 0.02):
    """flax truncated_normal(stddev=std, lower=-2, upper=2): cut at two std."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def init_linear_(m: nn.Module, generator: Optional[torch.Generator]) -> None:
    if isinstance(m, QLinear):
        return  # serving buffers, filled from trained weights (utils/quantize.py)
    trunc_normal_(m.weight, generator)
    if m.bias is not None:
        nn.init.zeros_(m.bias)


def _cast(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype. Under tensor parallelism
    (`tensor_split`, set by parallel/sharding.py) it computes on its weight's
    local shard: a column split on the replicated input (a packed
    projection's replicated bias cut to the rank's heads), a row split as a
    partial product summed over the tensor group before its bias is added."""

    tensor_split: Optional[TensorSplit] = None

    def forward(self, x):
        w, b, split = local(self.weight), self.bias, self.tensor_split
        if split is None or split.size == 1:
            return F.linear(x, _cast(w, x.dtype), _cast(local(b), x.dtype))
        if split.mode == "row":
            y = reduce_from_tensor(F.linear(x, _cast(w, x.dtype)), split.group)
            return y if b is None else y + b.to(x.dtype)
        x = split.copy_in(x)
        if b is not None:
            b = split.heads_of(b) if split.packs > 1 else local(b)
        return F.linear(x, _cast(w, x.dtype), _cast(b, x.dtype))


class QLinear(nn.Module):
    """w8a8 serving twin of a Linear (JAX QDense, blocks.py:96-122): buffers
    weight_q (int8 [out, in]), weight_scale (fp32 [out]) and bias (fp32
    [out]), initialised as QDense's (zeros, ones, zeros), under the module
    path of the Linear it replaces, so
    utils/quantize.py maps a trained state dict onto it key for key. The
    scale and the bias stay fp32 through a cast of the model's dtype
    (`_apply`): the rescale adds the bias in fp32 before its one cast to the
    input's dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight_q", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features) if bias else None)

    def _apply(self, fn, recurse=True):
        for name, t in self._buffers.items():
            if t is not None:
                moved = fn(t)
                # a dtype cast keeps only its move: int8 and fp32 stay as they are
                self._buffers[name] = moved if moved.dtype == t.dtype else t.to(moved.device)
        return self

    def forward(self, x):
        return w8a8_matmul(x, self.weight_q, self.weight_scale, self.bias)


QUANT_MODES = ("none", "w8a8")
# JAX blocks.py:388-397's refusal, wherever w8a8 is asked of an MoE model
MOE_QUANT_ERROR = ("quant != 'none' is not supported for MoE blocks (moe_experts > 0): the "
                   "expert FFN has no quantized path; serve the model with quant='none'")


def _linear_class(quant: str):
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r} (none | w8a8)")
    return QLinear if quant == "w8a8" else Linear


def _serving_only(training: bool) -> None:
    if training:
        raise ValueError("w8a8 quantization is serving-only: the rounded int8 path is "
                         "piecewise-constant and carries zero gradient")


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

    # on a mesh: (data rank, data size), the slice of the global batch's
    # mask this rank's local batch takes
    batch_slice: Optional[tuple] = None

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Generator = None):
        if not self.training or generator is None or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        n = x.shape[0]
        if self.batch_slice is None:
            mask = torch.rand(n, generator=generator) < keep
        else:
            rank, size = self.batch_slice
            mask = (torch.rand(n * size, generator=generator) < keep)[rank * n:(rank + 1) * n]
        if x.is_cuda:
            mask = mask.pin_memory()
        mask = mask.to(x.device, non_blocking=True).view((-1,) + (1,) * (x.dim() - 1))
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class LayerScale(nn.Module):
    """Reference vit_blocks.py:9-21."""

    def __init__(self, dim: int, init_values: float = 1e-5):
        super().__init__()
        self.init_values = float(init_values)
        self.gamma = nn.Parameter(torch.full((dim,), self.init_values))

    def reset_parameters(self):
        nn.init.constant_(self.gamma, self.init_values)

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
    (blocks.py:128-137; a TPU finding, not one about this port).

    quant="w8a8": fc1 and fc2 are QLinears, and the forward is fc1 -> GELU ->
    fc2 without dropout or the fused kernel (JAX blocks.py:157-168).

    On a mesh of more than one device K6 steps aside, as JAX's does
    (ops/fused_mlp.py:479-483): shard_model turns `use_fused` off."""

    hidden_fold: tuple = ()
    out_fold: tuple = ()

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, drop: float = 0.0, use_bias: bool = True,
                 gelu_tanh: bool = False, use_fused: bool = False, quant: str = "none"):
        super().__init__()
        lin = _linear_class(quant)
        self.fc1 = lin(in_features, hidden_features, bias=use_bias)
        self.fc2 = lin(hidden_features, out_features or in_features, bias=use_bias)
        self.drop = drop
        self.approximate = "tanh" if gelu_tanh else "none"
        self.use_fused = use_fused
        self.quant = quant

    def reset_parameters(self, generator=None):
        init_linear_(self.fc1, generator)
        init_linear_(self.fc2, generator)

    def forward(self, x, generator: Generator = None):
        if self.quant == "w8a8":
            _serving_only(self.training)
            return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))
        if self.use_fused and not self.training and self.approximate == "none":
            out = fused_mlp(x, _cast(self.fc1.weight, x.dtype), _cast(self.fc1.bias, x.dtype),
                            _cast(self.fc2.weight, x.dtype), _cast(self.fc2.bias, x.dtype))
            if out is not None:
                return out
        h = F.gelu(self.fc1(x), approximate=self.approximate)
        h = dropout(h, self.drop, self.training, generator, self.hidden_fold)
        return dropout(self.fc2(h), self.drop, self.training, generator, self.out_fold)


class Attention(nn.Module):
    """Self attention with a selectable kernel (reference attention.py:12-87):
    probability dropout `attn_drop` inside the attention op, `proj_drop` on
    the projection. quant="w8a8" makes qkv and proj QLinears (JAX
    blocks.py:210-248); the attention op is the same. Under tensor
    parallelism qkv yields the rank's heads (num_heads / tensor of them);
    under a seq split (`seq_split`) x is the rank's token slice."""

    attn_fold: tuple = ()
    proj_fold: tuple = ()
    seq_split: Optional[SeqSplit] = None

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 qk_norm: bool = False, proj_bias: bool = True, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, attention_impl: str = "xla", quant: str = "none"):
        super().__init__()
        lin = _linear_class(quant)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = lin(dim, dim * 3, bias=qkv_bias)
        self.q_norm = LayerNorm(self.head_dim, eps=1e-5) if qk_norm else None
        self.k_norm = LayerNorm(self.head_dim, eps=1e-5) if qk_norm else None
        self.proj = lin(dim, dim, bias=proj_bias)
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.attention_impl = attention_impl
        self.quant = quant

    def reset_parameters(self, generator=None):
        init_linear_(self.qkv, generator)
        init_linear_(self.proj, generator)

    def forward(self, x, generator: Generator = None):
        if self.quant == "w8a8":
            _serving_only(self.training)
        B, N, _ = x.shape
        # q, k, v stay strided views of the packed projection: the kernels
        # read them through their strides, no copy
        q, k, v = self.qkv(x).reshape(B, N, 3, -1, self.head_dim).unbind(2)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        rate = self.attn_drop if self.training else 0.0
        x = dot_product_attention(q, k, v, impl=self.attention_impl, dropout_rate=rate,
                                  generator=generator, fold=self.attn_fold, seq=self.seq_split)
        return dropout(self.proj(x.reshape(B, N, -1)), self.proj_drop, self.training, generator,
                       self.proj_fold)


class VariableMappingAttention(nn.Module):
    """Cross attention collapsing V variable token streams to one aggregated
    stream (reference attention.py:98-183), in the JAX package's algebraically
    reduced form with the reference's parameter shapes (q: D x C, kv: 2D x C):

      * scores: k_v . q_h == x_v . (W_k[h] q_h), one [C, H] matrix `u`
      * values: sum_v attn_vh (W_v x_v)_h == W_v[h] (sum_v attn_vh x_v)

    The model builds it without dropout (attn_drop = proj_drop = 0 in the
    JAX package), so it has none. Under tensor parallelism q and kv hold the
    rank's heads (kv: of k and of v) and proj sums the heads' partial
    products over the tensor group.
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
        hd = self.dim // self.num_heads
        scale = hd ** -0.5
        split = self.kv.tensor_split
        kv_w, kv_b = local(self.kv.weight), self.kv.bias
        if split is not None and split.size > 1:
            x = split.copy_in(x)
            kv_b = None if kv_b is None else split.heads_of(kv_b)
        kv_w, kv_b = kv_w.to(x.dtype), _cast(local(kv_b), x.dtype)
        D = kv_w.shape[0] // 2  # the rank's heads x hd
        H = D // hd

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
    x = x + DropPath(LS(Attn(LN(x)))); x = x + DropPath(LS(Mlp(LN(x)))).

    moe_experts > 0 holds a MoEMlp (models/components/moe.py) as `moe_mlp`
    in place of `mlp` (JAX blocks.py:343-419); such a Block returns (x, aux),
    its load-balance loss beside its output, so the loss is an output of the
    Block's call and a recomputation under remat counts it once."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_norm: bool = False, proj_bias: bool = True,
                 proj_drop: float = 0.0, attn_drop: float = 0.0,
                 init_values: Optional[float] = None, drop_path: float = 0.0,
                 attention_impl: str = "xla", gelu_tanh: bool = False, quant: str = "none",
                 moe_experts: int = 0, moe_capacity_factor: float = 1.25, moe_top_k: int = 1):
        super().__init__()
        if moe_experts > 0 and quant != "none":
            raise ValueError(MOE_QUANT_ERROR)  # the expert FFNs have no int8 path
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_norm, proj_bias, attn_drop,
                              proj_drop, attention_impl, quant)
        self.ls1 = LayerScale(dim, init_values) if init_values else nn.Identity()
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.moe = moe_experts > 0
        if self.moe:
            self.moe_mlp = MoEMlp(dim, int(dim * mlp_ratio), moe_experts, moe_capacity_factor,
                                  moe_top_k, drop=proj_drop, gelu_tanh=gelu_tanh)
        else:
            self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=proj_drop, use_bias=proj_bias,
                           gelu_tanh=gelu_tanh, quant=quant)
        self.ls2 = LayerScale(dim, init_values) if init_values else nn.Identity()
        self.drop_path2 = DropPath(drop_path)

    def reset_parameters(self, generator=None):
        """Every parameter of the Block: the norms and layer scales to their
        constants, the Linears drawn from `generator` (attention, then the
        Mlp or the MoE's router and experts)."""
        for m in (self.norm1, self.norm2, self.ls1, self.ls2):
            if not isinstance(m, nn.Identity):
                m.reset_parameters()
        self.attn.reset_parameters(generator)
        (self.moe_mlp if self.moe else self.mlp).reset_parameters(generator)

    def forward(self, x, dropout_gen: Generator = None, drop_path_gen: Generator = None):
        x = x + self.drop_path1(self.ls1(self.attn(self.norm1(x), dropout_gen)), drop_path_gen)
        if not self.moe:
            return x + self.drop_path2(self.ls2(self.mlp(self.norm2(x), dropout_gen)),
                                       drop_path_gen)
        y, aux = self.moe_mlp(self.norm2(x), dropout_gen)
        return x + self.drop_path2(self.ls2(y), drop_path_gen), aux
