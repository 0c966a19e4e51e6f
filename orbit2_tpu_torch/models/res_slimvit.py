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
reference's exact unpatchify permutation.

Training as in the JAX module: `drop_rate` drives pos_drop (after the
spatial embedding) and each block's attention-probability, projection and
Mlp dropout, `drop_path` the per-depth stochastic-depth rates
linspace(0, drop_path, depth). The parameters are created in fp32 (the JAX
module's param_dtype; masters when training) and the forward computes in
`dtype`: x is cast to it on entry and every layer casts its weights to it
at use, a no-op once the parameters are in `dtype` (as for serving).

The pipelined trunk (`pipeline_stages` S > 1, JAX res_slimvit.py:100-116,
:338-407): the Blocks stay in the reference layout (`blocks.{i}`, so a
pipelined model's state dict is the unpipelined one's); on a mesh with a
stage axis (parallel/sharding.py::shard_model sets `stage_split` and keeps
on each stage only the Blocks it holds) the trunk runs the GPipe (V = 1) or
interleaved (`pipeline_interleave` V > 1) schedule of
parallel/pipeline.py over `pipeline_microbatches` M (0: S) microbatches,
and without one the same microbatches through every Block in turn (JAX's
sequential fallback). The depth must divide by S*V, and seq_shard and MoE
Blocks raise JAX's errors. Dropout there folds the microbatch and the
global Block into each Block's seeds (kernel_prng.fold_seed of one draw a
forward from each generator, in place of JAX's tick): a (microbatch, Block)
pair draws the same masks whatever S and V are, DropPath's per-sample masks
too, and a recomputation under remat draws them again.

Sequence parallelism (`seq_shard`, JAX res_slimvit.py:147-162, :317,
:333-335): on a mesh with a seq axis (parallel/sharding.py::shard_model
sets `seq_split`) the tokens are split over it where JAX pins them, after
pos_drop and before Block 0, and gathered again before the final norm and
the head. The split's backward all-gathers the slices' gradients and the
gather's takes the rank's slice, so the embedding, variable aggregation,
norm and head run on the whole tokens on every seq rank, their gradients
whole there, and only the Blocks see the rank's slice (their gradients are
summed over seq after the backward, parallel/sharding.py::reduce_seq_grads).
`seq_impl` is the Blocks' sequence attention (ops/seq_attention.py). Without
a seq axis seq_shard changes nothing, as JAX's constraint does nothing off a
mesh.

Mixture of experts (JAX res_slimvit.py:117-125, :319-330): with
`moe_experts` > 0, every Block i with (i + 1) % moe_every == 0 holds a MoEMlp
(models/components/moe.py) in place of its Mlp, under the keys
`blocks.{i}.moe_mlp.{router_kernel,wi,bi,wo,bo}`. Such a Block returns its
load-balance loss beside its output; `forward(..., return_aux=True)` returns
(prediction, [the losses of the MoE Blocks, in order]), which the train step
weights (training/train.py). The losses are outputs of the Block calls, so
a recomputation under remat counts each once.

`remat` recomputes each Block's activations in the backward (JAX
res_slimvit.py:312-316, `nn.remat(Block)`): `remat_policy="full"` keeps only
the Block's input, "dots" also the outputs of its matrix products (JAX
`checkpoint_dots`); the variable aggregation, embedding and head are not
recomputed, as in JAX. The flash and dropout kernels are no products, so
both policies run them again. The recomputation draws the dropout seeds and
DropPath masks of the first run again (remat_block), so remat changes no
value: outputs, gradients and the generators' states equal those without it.

`quant="w8a8"` builds every trunk Block's qkv, proj, fc1 and fc2 as a QLinear
(JAX res_slimvit.py:327), for serving only; utils/quantize.py::w8a8_twin
fills such a model from a trained one's state dict.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    checkpoint, create_selective_checkpoint_contexts, noop_context_fn)

from orbit2_tpu_torch.models.components.blocks import (
    Block,
    Conv2d,
    Generator,
    LayerNorm,
    Linear,
    VariableMappingAttention,
    init_linear_,
    trunc_normal_,
)
from orbit2_tpu_torch.ops.dropout import dropout
from orbit2_tpu_torch.ops.kernel_prng import draw_seed, fold_seed
from orbit2_tpu_torch.ops.pos_embed import (
    get_2d_sincos_pos_embed,
    interpolate_pos_embed_on_the_fly,
)
from orbit2_tpu_torch.ops.seq_attention import SEQ_IMPLS
from orbit2_tpu_torch.parallel.pipeline import (
    StageSplit, check_schedule, pipeline_blocks, sequential_blocks)
from orbit2_tpu_torch.parallel.tensor import SeqSplit, gather_tokens, split_tokens
from orbit2_tpu_torch.registry import register_model

# JAX config.py:328-335's refusal, wherever MoE Blocks meet a pipelined trunk
MOE_PIPELINE_ERROR = ("model.moe_experts inside a pipelined trunk is future work (the "
                      "stacked-block pipeline shares one Block template; MoE blocks alternate "
                      "with dense ones)")

# static surface channels appended to the residual path input
# (reference find_var_index, res_slimvit.py:302-310)
RESIDUAL_STATIC_VARS = ("land_sea_mask", "orography", "lattitude", "landcover")


REMAT_POLICIES = ("full", "dots")
# the ops F.linear and einsum lower to, whose outputs "dots" keeps
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.baddbmm.default]


def remat_block(block, x, dropout_gen: Generator, drop_path_gen: Generator, policy: str):
    """block(x, dropout_gen, drop_path_gen) (x, or an MoE Block's (x, aux))
    under non-reentrant activation checkpointing: the backward recomputes
    what `policy` did not keep. The
    Block draws its dropout seeds and DropPath masks from the two host
    generators as it runs, and checkpointing restores only the global RNGs;
    so the states of both generators are taken when the Block first runs,
    and the recomputation draws from fresh generators at those states. It
    gets the first run's masks, and the caller's generators move once, as
    without remat."""
    gens = (dropout_gen, drop_path_gen)
    states = [None if g is None else (g.device, g.get_state()) for g in gens]
    first = True

    def run(x):
        nonlocal first
        if first:
            first = False
            return block(x, *gens)
        replay = [None if st is None else torch.Generator(st[0]).set_state(st[1])
                  for st in states]
        return block(x, *replay)

    context_fn = (functools.partial(create_selective_checkpoint_contexts, _DOTS)
                  if policy == "dots" else noop_context_fn)
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False,
                      context_fn=context_fn)


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
        self.proj = Conv2d(1, embed_dim, patch_size, patch_size)


def _lecun_normal_(t: torch.Tensor, generator) -> None:
    """flax's default conv init: variance 1/fan_in, truncated at two std."""
    fan_in = t[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


@register_model("res_slimvit")
class ResSlimViT(nn.Module):
    # on a mesh: the data coordinates folded into pos_drop's seed, the seq
    # axis the trunk's tokens are split over and the stage axis it is
    # pipelined over
    pos_fold: tuple = ()
    seq_split: Optional[SeqSplit] = None
    stage_split: Optional[StageSplit] = None

    def __init__(self, default_vars: Sequence[str], img_size: Tuple[int, int],
                 in_channels: int, out_channels: int, superres_mag: int = 4,
                 cnn_ratio: int = 4, patch_size: int = 2, drop_path: float = 0.1,
                 drop_rate: float = 0.1,
                 learn_pos_emb: bool = False, embed_dim: int = 1024, depth: int = 24,
                 decoder_depth: int = 8, num_heads: int = 16, mlp_ratio: float = 4.0,
                 spatial_resolution: float = 0.0, attention_impl: str = "xla",
                 gelu_approx: str = "exact", quant: str = "none", moe_experts: int = 0,
                 moe_every: int = 2, moe_capacity_factor: float = 1.25, moe_top_k: int = 1,
                 pipeline_stages: int = 1, pipeline_microbatches: int = 0,
                 pipeline_interleave: int = 1, seq_shard: bool = False, seq_impl: str = "gather",
                 remat: bool = False, remat_policy: str = "full",
                 base_img_size: Optional[Tuple[int, int]] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pipeline_stages > 1:
            S, V = pipeline_stages, pipeline_interleave
            if depth % (S * V):
                raise ValueError(f"depth {depth} not divisible by pipeline_stages x "
                                 f"interleave {S}x{V}")
            if seq_shard:
                raise ValueError("pipeline_stages > 1 is incompatible with seq_shard (v1 "
                                 "scope; see parallel/pipeline.py)")
            if moe_experts > 0:
                raise ValueError(MOE_PIPELINE_ERROR)
            check_schedule(depth, S, pipeline_microbatches or S, V)
        elif pipeline_interleave > 1:
            raise ValueError("pipeline_interleave > 1 needs pipeline_stages > 1")
        if seq_impl not in SEQ_IMPLS:
            raise ValueError(f"unknown seq_impl {seq_impl!r} ({' | '.join(SEQ_IMPLS)})")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r} (full | dots)")
        if gelu_approx not in ("exact", "tanh"):
            raise ValueError(f"unknown gelu_approx {gelu_approx!r}")
        self.default_vars = tuple(default_vars)
        self.img_size = tuple(img_size)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.superres_mag = superres_mag
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.drop_rate = drop_rate
        self.remat, self.remat_policy = remat, remat_policy
        self.seq_shard, self.seq_impl = seq_shard, seq_impl
        self.pipeline_stages = pipeline_stages
        self.pipeline_microbatches = pipeline_microbatches or pipeline_stages
        self.pipeline_interleave = pipeline_interleave
        self.dtype = dtype
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
        self.spatial_embed = Linear(1, D)
        # float64 rates, as numpy gives them to the JAX module
        dpr = np.linspace(0, drop_path, depth)
        # MoE in every moe_every-th Block (the 2nd, 4th, ...: Switch's
        # every other layer)
        self.blocks = nn.ModuleList(
            Block(D, num_heads, mlp_ratio, qkv_bias=True, proj_drop=drop_rate,
                  attn_drop=drop_rate, drop_path=float(dpr[i]), attention_impl=attention_impl,
                  gelu_tanh=gelu_approx == "tanh", quant=quant,
                  moe_experts=moe_experts if moe_experts > 0 and (i + 1) % moe_every == 0 else 0,
                  moe_capacity_factor=moe_capacity_factor, moe_top_k=moe_top_k)
            for i in range(depth))
        self.norm = LayerNorm(D, eps=1e-5)
        head = []
        for _ in range(decoder_depth):
            head += [Linear(D, D), nn.GELU()]
        head.append(Linear(D, out_channels * (mag * p) ** 2))
        self.head = nn.Sequential(*head)
        self.conv_out = Conv2d(out_channels, out_channels, 3, padding=1)
        n_sel = out_channels + len(RESIDUAL_STATIC_VARS)
        self.path2 = nn.Sequential(
            Conv2d(n_sel, cnn_ratio * mag * mag, 3, padding=1), nn.GELU(),
            nn.PixelShuffle(mag), Conv2d(cnn_ratio, out_channels, 3, padding=1))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX package's initializers, drawn from `generator`."""
        for _, _, init in self.init_units():
            init(generator)

    def init_units(self):
        """reset_parameters in units, in its order: [(name, module, init)],
        one a top-level module or a Block, and "" the model's own tensors
        (var_embed, var_query, pos_embed) without its children. init(generator)
        sets every parameter of its unit, so a unit built on the meta device is
        whole after to_empty and init (evaluate.py::materialize), and drawing
        the units in turn from one generator gives reset_parameters' values."""
        p = self.patch_size

        def own(generator):
            nn.init.zeros_(self.var_embed)
            nn.init.zeros_(self.var_query)
            base = self.base_img_size
            pe = get_2d_sincos_pos_embed(self.embed_dim, base[0] // p, base[1] // p)
            self.pos_embed.copy_(torch.as_tensor(pe, dtype=torch.float32)[None])

        def token_embed(te):
            def init(generator):
                trunc_normal_(te.proj.weight, generator)
                nn.init.zeros_(te.proj.bias)
            return init

        def head(generator):
            for m in self.head:
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)

        def convs(*modules):
            def init(generator):
                for conv in modules:
                    _lecun_normal_(conv.weight, generator)
                    nn.init.zeros_(conv.bias)
            return init

        return [
            *((f"token_embeds.{i}", te, token_embed(te)) for i, te in enumerate(self.token_embeds)),
            ("", self, own),
            ("var_agg", self.var_agg, self.var_agg.reset_parameters),
            ("spatial_embed", self.spatial_embed, lambda g: init_linear_(self.spatial_embed, g)),
            *((f"blocks.{i}", blk, blk.reset_parameters) for i, blk in enumerate(self.blocks)),
            ("norm", self.norm, lambda g: self.norm.reset_parameters()),
            ("head", self.head, head),
            ("conv_out", self.conv_out, convs(self.conv_out)),
            ("path2", self.path2, convs(self.path2[0], self.path2[3])),
        ]

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

    def forward(self, x, in_variables: Sequence[str], out_variables: Sequence[str],
                dropout_gen: Generator = None, drop_path_gen: Generator = None,
                return_aux: bool = False):
        """x: [B, C_in, H, W] (or [B, T, C, H, W], flattened like reference
        :313-314); returns [B, C_out, H*mag, W*mag] in the compute dtype. In
        train() mode the dropout sites draw from `dropout_gen` and DropPath
        from `drop_path_gen` (inert without it). return_aux=True returns
        (that, the MoE Blocks' load-balance losses: a list of 0-dim fp32
        tensors, empty without MoE Blocks)."""
        if x.ndim == 5:
            x = x.flatten(1, 2)
        x = x.to(self.dtype)
        in_variables, out_variables = tuple(in_variables), tuple(out_variables)
        if len(out_variables) != self.out_channels:
            raise ValueError(f"{len(out_variables)} out variables for a "
                             f"{self.out_channels}-channel head")
        path2 = self.path2(x[:, find_var_index(in_variables, out_variables)])
        tokens, aux = self._forward_encoder(x, in_variables, dropout_gen, drop_path_gen)
        y = self.conv_out(self._unpatchify(self.head(tokens), x.shape[2], x.shape[3]))
        # crop-to-match add (reference :333-336)
        y = y + path2[:, :, : y.shape[2], : y.shape[3]]
        return (y, aux) if return_aux else y

    def _forward_encoder(self, x, in_variables, dropout_gen, drop_path_gen):
        B, V, H, W = x.shape
        p, D = self.patch_size, self.embed_dim
        h, w = H // p, W // p
        var_ids = [self.default_vars.index(v) for v in in_variables]

        # token embedding: every variable's conv patch projection as one einsum
        patches = x.reshape(B, V, h, p, w, p).permute(0, 1, 2, 4, 3, 5).reshape(B, V, h * w, p * p)
        kern = torch.stack([self.token_embeds[i].proj.weight.reshape(D, p * p)
                            for i in var_ids]).to(x.dtype)
        bias = torch.stack([self.token_embeds[i].proj.bias for i in var_ids]).to(x.dtype)
        tokens = torch.einsum("bvlp,vdp->blvd", patches, kern) + bias
        tokens = tokens + self.var_embed[0, var_ids].to(x.dtype)

        # variable aggregation over the (B*L, V) layout (reference :205-230)
        L = h * w
        tokens = self.var_agg(self.var_query, tokens.reshape(B * L, V, D)).reshape(B, L, D)

        tokens = tokens + interpolate_pos_embed_on_the_fly(self.pos_embed.to(x.dtype), p, (H, W))
        res = torch.tensor([[self.spatial_resolution]], dtype=x.dtype, device=x.device)
        tokens = tokens + self.spatial_embed(res)
        tokens = dropout(tokens, self.drop_rate, self.training, dropout_gen,
                         self.pos_fold)  # pos_drop
        if self.pipeline_stages > 1:
            return self.norm(self._pipelined_trunk(tokens, dropout_gen, drop_path_gen)), []
        seq = self.seq_split
        if seq is not None:
            tokens = split_tokens(tokens, seq)
        remat = self.remat and torch.is_grad_enabled()
        aux = []
        for blk in self.blocks:
            if remat:
                tokens = remat_block(blk, tokens, dropout_gen, drop_path_gen, self.remat_policy)
            else:
                tokens = blk(tokens, dropout_gen, drop_path_gen)
            if blk.moe:
                tokens, loss = tokens
                aux.append(loss)
        if seq is not None:
            tokens = gather_tokens(tokens, seq)
        return self.norm(tokens), aux

    def _pipelined_trunk(self, tokens, dropout_gen, drop_path_gen):
        """The Blocks over the stage axis (stage_split) or, without one, in
        turn on one process, microbatch by microbatch; Block g on microbatch
        m draws from generators seeded with the (m, g) fold of one draw from
        each of the caller's (module docstring)."""
        remat = self.remat and torch.is_grad_enabled()
        seeds = [draw_seed(g) if self.training and g is not None else None
                 for g in (dropout_gen, drop_path_gen)]

        def run_block(g, m, x):
            gens = [None if seed is None else
                    torch.Generator().manual_seed(fold_seed(seed, (m, g))) for seed in seeds]
            if remat:
                return remat_block(self.blocks[g], x, *gens, self.remat_policy)
            return self.blocks[g](x, *gens)

        if self.stage_split is not None:
            return pipeline_blocks(self.blocks, tokens, self.stage_split, run_block)
        return sequential_blocks(self.blocks, tokens, self.pipeline_microbatches, run_block)

    def _unpatchify(self, y, H, W):
        """[B, L, out*(mag*p)^2] -> [B, out, H*mag, W*mag], the reference's
        permutation (:167-179): the head output is re-chunked as an
        (H*mag/p, W*mag/p) grid of p x p patches."""
        p, mag, c = self.patch_size, self.superres_mag, self.out_channels
        h, w = H * mag // p, W * mag // p
        y = y.reshape(y.shape[0], h, w, p, p, c)
        y = torch.einsum("nhwpqc->nchpwq", y)
        return y.reshape(y.shape[0], c, h * p, w * p)


