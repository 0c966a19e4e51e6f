"""Res_Slim_ViT — the ORBIT-2 residual Slim Vision Transformer, in PyTorch.

Counterpart of orbit2_tpu/models/res_slimvit.py (reference
src/climate_learn/models/hub/res_slimvit.py:20-338). Parameters carry the
reference state-dict keys (token_embeds.{i}.proj, var_agg.q/kv/proj,
blocks.{b}.attn.qkv, head.{2i}, path2.0/path2.3, conv_out, ...), the map
orbit2_tpu/training/checkpoint.py:353-424 writes, so weights move across with
training/checkpoint.py::state_dict_from_jax_params and load strictly.

The math follows the JAX package: one gathered einsum for the per-variable
patch embedding, the reduced variable-aggregation attention, the on-the-fly
pos-embed resize, the CNN residual path with the crop-to-match add, and the
reference's exact unpatchify permutation. Only the deterministic forward is
ported, so the dropout rates of the JAX module have no counterpart yet;
mixture-of-experts, pipeline and sequence sharding raise.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from orbit2_tpu_torch.models.components.blocks import (
    Block,
    VariableMappingAttention,
    init_linear_,
    require_eval,
    trunc_normal_,
)
from orbit2_tpu_torch.ops.pos_embed import (
    get_2d_sincos_pos_embed,
    interpolate_pos_embed_on_the_fly,
)
from orbit2_tpu_torch.registry import register_model

# static surface channels appended to the residual path input
# (reference find_var_index, res_slimvit.py:302-310)
RESIDUAL_STATIC_VARS = ("land_sea_mask", "orography", "lattitude", "landcover")


def find_var_index(in_variables: Sequence[str], out_variables: Sequence[str]):
    idx = [in_variables.index(v) for v in out_variables]
    idx += [in_variables.index(v) for v in RESIDUAL_STATIC_VARS]
    return idx


class _TokenEmbed(nn.Module):
    """Holds one variable's Conv2d(1, D, p, p) patch projection under the
    reference key `token_embeds.{i}.proj`; the forward gathers all of them
    into one einsum instead of calling them one by one."""

    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(1, embed_dim, patch_size, patch_size)


def _lecun_normal_(t: torch.Tensor, generator) -> None:
    """flax's default conv init: variance 1/fan_in, truncated at two std."""
    fan_in = t[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


@register_model("res_slimvit")
class ResSlimViT(nn.Module):
    def __init__(self, default_vars: Sequence[str], img_size: Tuple[int, int],
                 in_channels: int, out_channels: int, superres_mag: int = 4,
                 cnn_ratio: int = 4, patch_size: int = 2, drop_path: float = 0.1,
                 learn_pos_emb: bool = False, embed_dim: int = 1024, depth: int = 24,
                 decoder_depth: int = 8, num_heads: int = 16, mlp_ratio: float = 4.0,
                 spatial_resolution: float = 0.0, attention_impl: str = "xla",
                 gelu_approx: str = "exact", quant: str = "none", moe_experts: int = 0,
                 pipeline_stages: int = 1, seq_shard: bool = False,
                 base_img_size: Optional[Tuple[int, int]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if quant != "none":
            raise NotImplementedError(f"quant={quant!r}: w8a8 serving is not ported yet")
        if moe_experts:
            raise NotImplementedError("moe_experts > 0: the MoE trunk is not ported yet")
        if pipeline_stages > 1 or seq_shard:
            raise NotImplementedError(
                "pipeline_stages > 1 / seq_shard: the parallel trunks are not ported yet")
        if gelu_approx not in ("exact", "tanh"):
            raise ValueError(f"unknown gelu_approx {gelu_approx!r}")
        self.default_vars = tuple(default_vars)
        self.img_size = tuple(img_size)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.superres_mag = superres_mag
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.spatial_resolution = spatial_resolution
        self.base_img_size = tuple(base_img_size or img_size)
        D, p, mag = embed_dim, patch_size, superres_mag

        self.token_embeds = nn.ModuleList(
            _TokenEmbed(p, D) for _ in self.default_vars)
        self.var_embed = nn.Parameter(torch.zeros(1, len(self.default_vars), D))
        self.var_query = nn.Parameter(torch.zeros(1, 1, D))
        self.var_agg = VariableMappingAttention(D, num_heads, qkv_bias=False)
        base = self.base_img_size
        pe = get_2d_sincos_pos_embed(D, base[0] // p, base[1] // p)
        self.pos_embed = nn.Parameter(torch.as_tensor(pe, dtype=torch.float32)[None],
                                      requires_grad=learn_pos_emb)
        self.spatial_embed = nn.Linear(1, D)
        dpr = torch.linspace(0, drop_path, depth).tolist()
        self.blocks = nn.ModuleList(
            Block(D, num_heads, mlp_ratio, qkv_bias=True, drop_path=dpr[i],
                  attention_impl=attention_impl, gelu_tanh=gelu_approx == "tanh")
            for i in range(depth))
        self.norm = nn.LayerNorm(D, eps=1e-5)
        head = []
        for _ in range(decoder_depth):
            head += [nn.Linear(D, D), nn.GELU()]
        head.append(nn.Linear(D, out_channels * (mag * p) ** 2))
        self.head = nn.Sequential(*head)
        self.conv_out = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        n_sel = out_channels + len(RESIDUAL_STATIC_VARS)
        self.path2 = nn.Sequential(
            nn.Conv2d(n_sel, cnn_ratio * mag * mag, 3, padding=1), nn.GELU(),
            nn.PixelShuffle(mag), nn.Conv2d(cnn_ratio, out_channels, 3, padding=1))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX package's initializers, drawn from `generator`."""
        for te in self.token_embeds:
            trunc_normal_(te.proj.weight, generator)
            nn.init.zeros_(te.proj.bias)
        nn.init.zeros_(self.var_embed)
        nn.init.zeros_(self.var_query)
        self.var_agg.reset_parameters(generator)
        init_linear_(self.spatial_embed, generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        for m in self.head:
            if isinstance(m, nn.Linear):
                init_linear_(m, generator)
        for conv in (self.conv_out, self.path2[0], self.path2[3]):
            _lecun_normal_(conv.weight, generator)
            nn.init.zeros_(conv.bias)

    def for_phase(self, spatial_resolution: float, img_size: Tuple[int, int],
                  in_channels: int, out_channels: int) -> "ResSlimViT":
        """data_config equivalent (reference res_slimvit.py:148-164): same
        params, new geometry. Mutates in place, as the reference does."""
        if out_channels != self.out_channels:
            raise ValueError("decoder head is sized at construction; out_channels cannot change")
        self.spatial_resolution = spatial_resolution
        self.img_size = tuple(img_size)
        self.in_channels = in_channels
        return self

    def forward(self, x, in_variables: Sequence[str], out_variables: Sequence[str]):
        """x: [B, C_in, H, W] (or [B, T, C, H, W], flattened like reference
        :313-314); returns [B, C_out, H*mag, W*mag]."""
        require_eval(self)
        if x.ndim == 5:
            x = x.flatten(1, 2)
        in_variables, out_variables = tuple(in_variables), tuple(out_variables)
        if len(out_variables) != self.out_channels:
            raise ValueError(f"{len(out_variables)} out variables for a "
                             f"{self.out_channels}-channel head")
        path2 = self.path2(x[:, find_var_index(in_variables, out_variables)])
        y = self.head(self._forward_encoder(x, in_variables))
        y = self.conv_out(self._unpatchify(y, x.shape[2], x.shape[3]))
        # crop-to-match add (reference :333-336)
        return y + path2[:, :, : y.shape[2], : y.shape[3]]

    def _forward_encoder(self, x, in_variables):
        B, V, H, W = x.shape
        p, D = self.patch_size, self.embed_dim
        h, w = H // p, W // p
        var_ids = [self.default_vars.index(v) for v in in_variables]

        # token embedding: every variable's conv patch projection as one einsum
        patches = x.reshape(B, V, h, p, w, p).permute(0, 1, 2, 4, 3, 5).reshape(B, V, h * w, p * p)
        kern = torch.stack([self.token_embeds[i].proj.weight.reshape(D, p * p) for i in var_ids])
        bias = torch.stack([self.token_embeds[i].proj.bias for i in var_ids])
        tokens = torch.einsum("bvlp,vdp->blvd", patches, kern) + bias
        tokens = tokens + self.var_embed[0, var_ids]

        # variable aggregation over the (B*L, V) layout (reference :205-230)
        L = h * w
        tokens = self.var_agg(self.var_query, tokens.reshape(B * L, V, D)).reshape(B, L, D)

        tokens = tokens + interpolate_pos_embed_on_the_fly(self.pos_embed, p, (H, W))
        res = torch.tensor([[self.spatial_resolution]], dtype=x.dtype, device=x.device)
        tokens = tokens + self.spatial_embed(res)
        for blk in self.blocks:
            tokens = blk(tokens)
        return self.norm(tokens)

    def _unpatchify(self, y, H, W):
        """[B, L, out*(mag*p)^2] -> [B, out, H*mag, W*mag], the reference's
        permutation (:167-179): the head output is re-chunked as an
        (H*mag/p, W*mag/p) grid of p x p patches."""
        p, mag, c = self.patch_size, self.superres_mag, self.out_channels
        h, w = H * mag // p, W * mag // p
        y = y.reshape(y.shape[0], h, w, p, p, c)
        y = torch.einsum("nhwpqc->nchpwq", y)
        return y.reshape(y.shape[0], c, h * p, w * p)


