"""Parameter sharding rules and the sharded model: HSDP x tensor x expert x
seq parallelism (counterpart of orbit2_tpu/parallel/sharding.py).

The rule table is JAX's, whole (`_RULES`, `_fit`, `jax_spec_for`): a
parameter path gets a PartitionSpec over the mesh axes, first match wins,
and an axis is dropped where its dim does not divide. `spec_for` gives that
placement for the port's parameter names and shapes (the names
training/checkpoint.py::state_dict_from_jax_params writes), as one axis or
None per torch dim: a Linear's weight is the transpose of JAX's kernel, a
conv's OIHW of its HWIO, a token embedding's [D, 1, p, p] weight one
variable of JAX's stacked [V, p*p, D].

`shard_model` applies the table with torch's tools:
  * tensor parallelism over the tensor axis (`tensor_plan`, `split_linear`):
    the column splits, where JAX puts `tensor` on the output dim (qkv, fc1,
    var_agg's q and kv), and the row splits, where it puts it on the input
    dim (attention's proj, fc2, var_agg's proj). The weights become
    DTensors; the products run on their local shards through the Megatron
    collectives of parallel/tensor.py.
    A packed projection is split by heads inside each of its packs (a
    `_StridedShard` of dim 0): rank t holds heads t*H/tp.. of q, of k and of
    v. Its bias stays replicated and is cut to the rank's heads at use,
    since FSDP2 cannot describe a dim-0 shard of a strided dim-0 shard;
  * an MoE layer's expert stacks (wi, bi, wo, bo) become DTensors over the
    (expert, tensor) dims: the rank's experts of dim 0, and of those the
    tensor rank's hidden columns (wi, bi) or rows (wo), as the dense Mlp's
    fc1 and fc2 are split; its ExpertSplit (parallel/tensor.py) tells it
    which experts are its own and which group sums their outputs
    (models/components/moe.py);
  * the seq axis: the model's tokens are split over it (its SeqSplit on the
    model and every Attention: models/res_slimvit.py, ops/seq_attention.py).
    The parameters stay whole on every seq rank; the Blocks' gradients,
    partial sums over the rank's tokens, are summed over it after the
    backward (`reduce_seq_grads`, called by training/train.py's step);
  * the stage axis (parallel/pipeline.py): the model's `stage_split` is
    set, and each stage rank keeps only the Blocks its stage holds
    ((v*S + s)*dc + j, JAX's P("stage") on the stacked Blocks); the others
    become pipeline.Elsewhere stand-ins, never materialised, and the tensor
    plan and FSDP2 take the held Blocks alone. Everything outside the trunk
    is replicated over stage (its gradients come out equal on every stage,
    parallel/pipeline.py says why);
  * then `fully_shard` (FSDP2) on each Block, and on the root last, over
    the (replica, fsdp) mesh: HSDP when both are above 1. FSDP2 shards the
    dim the table names for `fsdp` (shard_placement_fn), dim 0 where it
    names none, and dim 1 of a packed weight whose input dim the table
    could not shard (never the dim its heads are split on). Sharding what
    the table replicates changes memory, not values.
A remat Block (models/res_slimvit.py::remat_block) recomputes inside its
FSDP2 unit: the pre-backward all-gather serves the recomputation.

The model hub (models/resnet.py, unet.py, vit.py, behind
utils/loaders.py::PreInterpolated for downscaling, their names under
`backbone.` as JAX's under `backbone/`) is sharded by the same table: the
hub ViT's Blocks are split over tensor and its patch embedding and head
take JAX's fsdp placement; no rule names a conv, so a CNN is replicated
over tensor and each tensor rank repeats the same work. FSDP2 keeps the
BatchNorm running averages whole on every rank (it shards parameters, not
buffers); shard_model hands each BatchNorm the data ranks' group, over
which it takes the global batch's statistics (models/components/cnn.py).

The dropout sites fold the rank's coordinates into their seeds: the data
coordinates (replica, fsdp) everywhere, the seq coordinate where the
trunk's tokens are split over it (every Block site), and the tensor
coordinate where the activation is split over it (the attention
probabilities, the Mlp hidden), so activations replicated across the
tensor, expert or seq axis get one mask on every such rank (pos_drop
before the split, the MoE output after its sum; the model hub's
ResidualBlock sites and the hub ViT's pos_drop fold the data coordinates
alone). Folds are taken only over axes above 1, so a one-device mesh draws
the one-process masks. DropPath
takes the rank's slice of the global batch's mask, the same on every
expert, seq and tensor rank. K6 (Mlp.use_fused) steps aside on a mesh of
more than one device, as JAX's does.

`full_tensor` / `shard_like` / `load_full_state_dict` move whole tensors in
and out of the shards (checkpoints, the unit-by-unit fill of
evaluate.py::materialize); on a stage mesh `full_state_dict` and
`full_named` also hand each Block from the stage that holds it to the
others, so a checkpoint holds the whole model in the reference layout, and
`load_full_state_dict` / `held_state` pass over the Blocks held elsewhere.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.placement_types import _StridedShard

from orbit2_tpu_torch.parallel.mesh import (
    AXES, AXIS_EXPERT, AXIS_FSDP, AXIS_SEQ, AXIS_STAGE, AXIS_TENSOR, BATCH_AXES, MOE_AXES,
    data_rank, data_size, seq_split, sharded_coords, stage_split)
from orbit2_tpu_torch.parallel.pipeline import Elsewhere, block_stage
from orbit2_tpu_torch.parallel.tensor import ExpertSplit, TensorSplit, local

Spec = Tuple[Any, ...]

# (path regex, spec): JAX's table, orbit2_tpu/parallel/sharding.py:33-63
_RULES: List[Tuple[str, Spec]] = [
    # MoE expert stacks: experts over `expert`, the per-expert fc1/fc2 keep
    # the dense Mlp's column/row tensor split behind the leading E dim; the
    # fp32 router kernel [D, E] falls through to ()
    (r"moe_mlp/wi$", (AXIS_EXPERT, AXIS_FSDP, AXIS_TENSOR)),
    (r"moe_mlp/bi$", (AXIS_EXPERT, AXIS_TENSOR)),
    (r"moe_mlp/wo$", (AXIS_EXPERT, AXIS_TENSOR, AXIS_FSDP)),
    (r"moe_mlp/bo$", (AXIS_EXPERT, None)),
    # tensor-parallel column splits (output dim on tensor)
    (r"(attn/qkv|mlp/fc1)/kernel$", (AXIS_FSDP, AXIS_TENSOR)),
    (r"(attn/qkv|mlp/fc1)/bias$", (AXIS_TENSOR,)),
    (r"var_agg/(q_kernel|kv_kernel)$", (AXIS_FSDP, AXIS_TENSOR)),
    (r"var_agg/(q_bias|kv_bias)$", (AXIS_TENSOR,)),
    # tensor-parallel row splits (input dim on tensor)
    (r"(attn/proj|mlp/fc2|var_agg/proj)/kernel$", (AXIS_TENSOR, AXIS_FSDP)),
    # decoder head and misc dense layers: fsdp-shard the input dim
    (r"head_\d+/kernel$", (AXIS_FSDP, None)),
    (r"head_out/kernel$", (AXIS_FSDP, None)),
    # per-variable token embedding stack [V, p*p, D]: shard the embed dim
    (r"token_embed_kernel$", (None, None, AXIS_FSDP)),
    # learnable pos embed [1, L, D]: shard over tokens
    (r"pos_embed$", (None, AXIS_FSDP, None)),
    (r"patch_embed/kernel$", (AXIS_FSDP, None)),
]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a DeviceMesh, or the mapping itself (absent axes 1)."""
    if isinstance(mesh, DeviceMesh):
        return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}
    return {a: int(mesh.get(a, 1)) for a in AXES}


def _fit(spec: Spec, shape: Sequence[int], sizes: Mapping[str, int]) -> Spec:
    """Drops spec axes whose dim is not divisible by the axis size."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, entries):
        if axis is None:
            out.append(None)
            continue
        names = axis if isinstance(axis, tuple) else (axis,)
        size = int(np.prod([sizes.get(a, 1) for a in names]))
        out.append(axis if size > 0 and dim % size == 0 else None)
    return tuple(out)


def jax_spec_for(path: str, shape: Sequence[int], mesh) -> Spec:
    """JAX spec_for on a JAX parameter path ('/'-joined), as a tuple (the
    entries of its PartitionSpec, trailing Nones kept to the shape's
    rank by _fit)."""
    sizes = axis_sizes(mesh)
    shape = tuple(shape)
    if "blocks_stacked_iv/" in path:
        inner = jax_spec_for(path.split("blocks_stacked_iv/", 1)[1], shape[3:], sizes)
        return _fit((None, AXIS_STAGE, None, *inner), shape, sizes)
    if "blocks_stacked/" in path:
        inner = jax_spec_for(path.split("blocks_stacked/", 1)[1], shape[1:], sizes)
        return _fit((AXIS_STAGE, *inner), shape, sizes)
    for pattern, spec in _RULES:
        if re.search(pattern, path):
            return _fit(spec, shape, sizes)
    return _fit((), shape, sizes)


# the port's parameter names -> (JAX path, kind); kind says how the torch
# dims map onto JAX's (training/checkpoint.py::state_dict_from_jax_params)
_NAMES: List[Tuple[str, str, str]] = [
    (r"^blocks\.(\d+)\.(attn\.qkv|attn\.proj|mlp\.fc1|mlp\.fc2)\.weight$", "blocks_{0}/{1}/kernel",
     "linear"),
    (r"^blocks\.(\d+)\.(attn\.qkv|attn\.proj|mlp\.fc1|mlp\.fc2)\.bias$", "blocks_{0}/{1}/bias",
     "same"),
    (r"^blocks\.(\d+)\.(norm1|norm2)\.weight$", "blocks_{0}/{1}/scale", "same"),
    (r"^blocks\.(\d+)\.(norm1|norm2)\.bias$", "blocks_{0}/{1}/bias", "same"),
    (r"^blocks\.(\d+)\.moe_mlp\.(\w+)$", "blocks_{0}/moe_mlp/{1}", "same"),
    (r"^var_agg\.(q|kv)\.weight$", "var_agg/{0}_kernel", "linear"),
    (r"^var_agg\.(q|kv)\.bias$", "var_agg/{0}_bias", "same"),
    (r"^var_agg\.proj\.weight$", "var_agg/proj/kernel", "linear"),
    (r"^var_agg\.proj\.bias$", "var_agg/proj/bias", "same"),
    (r"^token_embeds\.\d+\.proj\.weight$", "token_embed_kernel", "token"),
    (r"^token_embeds\.\d+\.proj\.bias$", "token_embed_bias", "token_bias"),
    (r"^spatial_embed\.weight$", "spatial_embed/kernel", "linear"),
    (r"^spatial_embed\.bias$", "spatial_embed/bias", "same"),
    (r"^head\.(\d+)\.weight$", "head_{0}/kernel", "head"),
    (r"^head\.(\d+)\.bias$", "head_{0}/bias", "head"),
    (r"^norm\.weight$", "norm/scale", "same"),
    (r"^norm\.bias$", "norm/bias", "same"),
    (r"^conv_out\.(weight|bias)$", "conv_out/{0}", "conv"),
    (r"^path2\.0\.(weight|bias)$", "path2_conv1/{0}", "conv"),
    (r"^path2\.3\.(weight|bias)$", "path2_conv2/{0}", "conv"),
    # the model hub's ViT: one patch projection over all channels
    (r"^patch_embed\.proj\.weight$", "patch_embed/kernel", "patch"),
    (r"^patch_embed\.proj\.bias$", "patch_embed/bias", "same"),
]


def jax_name(name: str) -> Tuple[str, str]:
    """(JAX path, kind) of a port parameter name; an unknown name maps
    '.' -> '/' as it is. A model-hub preset behind PreInterpolated keeps
    its backbone's names under `backbone.`, as JAX's under `backbone/`."""
    if name.startswith("backbone."):
        path, kind = jax_name(name[len("backbone."):])
        return "backbone/" + path, kind
    for pattern, fmt, kind in _NAMES:
        m = re.match(pattern, name)
        if m:
            groups = list(m.groups())
            if kind == "head":  # head.{2i} -> head_{i} (head_out's rule is head_i's)
                groups[0] = str(int(groups[0]) // 2)
            if kind == "conv":
                groups[0] = "kernel" if groups[0] == "weight" else "bias"
            return fmt.format(*(g.replace(".", "/") for g in groups)), kind
    return name.replace(".", "/"), "same"


def spec_for(name: str, shape: Sequence[int], mesh) -> Spec:
    """JAX's placement of the port parameter `name` of torch shape `shape`:
    one mesh axis (or None) per torch dim."""
    path, kind = jax_name(name)
    shape = tuple(shape)
    if kind in ("linear", "head") and len(shape) == 2:
        return tuple(reversed(jax_spec_for(path, shape[::-1], mesh)))
    if kind == "conv" and len(shape) == 4:  # OIHW <- HWIO
        s = jax_spec_for(path, (shape[2], shape[3], shape[1], shape[0]), mesh)
        return (s[3], s[2], s[0], s[1])
    if kind == "token":  # [D, 1, p, p] <- one variable's [p*p, D] of [V, p*p, D]
        s = jax_spec_for(path, (1, int(np.prod(shape[1:])), shape[0]), mesh)
        return (s[2],) + (None,) * (len(shape) - 1)
    if kind == "token_bias":  # [D] <- one variable's row of [V, D]
        return jax_spec_for(path, (1,) + shape, mesh)[1:]
    if kind == "patch" and len(shape) == 4:  # [D, C, p, p] <- [C p p, D]
        s = jax_spec_for(path, (int(np.prod(shape[1:])), shape[0]), mesh)
        # JAX's split of the (C, p, p) input dim, taken on C where it divides
        return (s[1],) + _fit(s[:1], shape[1:2], axis_sizes(mesh)) + (None, None)
    return jax_spec_for(path, shape, mesh)


# -- tensor parallelism ------------------------------------------------------


def _distribute(module: nn.Module, name: str, mesh: DeviceMesh, placements) -> None:
    t = getattr(module, name)
    if t is None:
        return
    module.register_parameter(name, nn.Parameter(
        distribute_tensor(t.data, mesh, placements, src_data_rank=None),
        requires_grad=t.requires_grad))


def split_linear(module: nn.Module, mode: str, packs: int, tmesh: DeviceMesh) -> None:
    """Splits a Linear over the tensor axis `tmesh`: mode "col" its weight's
    output rows (by heads inside each of `packs` packed projections; the
    bias split with them where there is one pack, else replicated and cut at
    use, TensorSplit.heads_of), mode "row" its input columns (the bias stays
    replicated and is added after the sum)."""
    # the model modules import parallel/tensor.py: imported here, not above
    from orbit2_tpu_torch.models.components.blocks import Linear

    if not isinstance(module, Linear):
        raise TypeError(f"a tensor split takes a Linear, got {type(module).__name__}")
    tp = tmesh.size()
    if mode == "col":
        rows = Shard(0) if packs == 1 or tp == 1 else _StridedShard(0, split_factor=packs)
        _distribute(module, "weight", tmesh, [rows])
        if packs == 1:
            _distribute(module, "bias", tmesh, [Shard(0)])
    else:
        _distribute(module, "weight", tmesh, [Shard(1)])
    module.tensor_split = TensorSplit(mode, tmesh.get_group(), tp, tmesh.get_local_rank(), packs)


def trunk(model: nn.Module) -> List[Tuple[str, nn.Module]]:
    """(name, Block) of every transformer Block the model holds: the
    ResSlimViT's trunk (those its stage holds), the hub ViT's; none in a
    CNN."""
    from orbit2_tpu_torch.models.components.blocks import Block

    return [(name, m) for name, m in model.named_modules() if isinstance(m, Block)]


def tensor_plan(model: nn.Module) -> Dict[str, Tuple[str, int]]:
    """The tensor splits of a model, (mode, packs) by Linear name, by JAX's
    paths: every Block's attention and dense Mlp, and the ResSlimViT's
    variable aggregation. Nothing of a CNN: JAX's rules split no conv."""
    plan = {}
    if hasattr(model, "var_agg"):
        plan.update({"var_agg.q": ("col", 1), "var_agg.kv": ("col", 2),
                     "var_agg.proj": ("row", 1)})
    for name, blk in trunk(model):
        plan[f"{name}.attn.qkv"] = ("col", 3)
        plan[f"{name}.attn.proj"] = ("row", 1)
        if not blk.moe:
            plan[f"{name}.mlp.fc1"] = ("col", 1)
            plan[f"{name}.mlp.fc2"] = ("row", 1)
    return plan


def check_shardable(model: nn.Module, mesh: DeviceMesh) -> None:
    """What shard_model does not take: a stage axis above 1 other than the
    model's pipeline_stages (1 for the model hub; a pipelined model on a
    mesh without one sweeps its microbatches on each rank, JAX's fallback),
    heads or hidden columns the tensor axis does not divide, an expert axis
    over a trunk without MoE Blocks or experts it does not divide, and a seq
    axis under a ResSlimViT not built with seq_shard (its tokens would stay
    whole). A model-hub preset, which has no seq_shard (JAX's
    _phase_model sets it only where the model has one), repeats its work
    over the seq axis, as on JAX's mesh its batch is split over the data
    axes alone."""
    sizes = axis_sizes(mesh)
    stages = getattr(model, "pipeline_stages", 1)
    if sizes[AXIS_STAGE] > 1 and sizes[AXIS_STAGE] != stages:
        raise ValueError(f"pipeline_stages={stages} but the mesh's stage axis is "
                         f"{sizes[AXIS_STAGE]}: build the mesh with stage={stages}")
    if sizes[AXIS_SEQ] > 1 and not getattr(model, "seq_shard", True):
        raise ValueError(f"a seq axis of {sizes[AXIS_SEQ]} needs the model built with "
                         "seq_shard=True")
    tp, ep = sizes[AXIS_TENSOR], sizes[AXIS_EXPERT]
    blocks = [blk for _, blk in trunk(model)]
    if ep > 1 and not any(blk.moe for blk in blocks):
        raise ValueError(f"an expert axis of {ep} needs MoE Blocks (model.moe_experts > 0)")
    for blk in blocks:
        heads = blk.attn.num_heads
        if blk.moe:
            experts, hidden = blk.moe_mlp.num_experts, blk.moe_mlp.wi.shape[2]
            if experts % ep:
                raise ValueError(f"expert_par {ep} must divide the {experts} experts")
        else:
            hidden = blk.mlp.fc1.out_features
        if heads % tp or hidden % tp:
            raise ValueError(f"tensor_par {tp} must divide the {heads} heads and the {hidden} "
                             "Mlp columns")
    if hasattr(model, "var_agg") and model.var_agg.num_heads % tp:
        raise ValueError(f"tensor_par {tp} must divide var_agg's {model.var_agg.num_heads} heads")


# an expert stack's tensor split: the dense Mlp's, behind the leading E dim
_EXPERT_TENSOR_DIM = {"wi": 2, "bi": 1, "wo": 1, "bo": None}


def split_experts(model: nn.Module, mesh: DeviceMesh) -> None:
    """Splits every MoE layer's expert stacks over the (expert, tensor) dims
    of `mesh` (module docstring) and hands the layer its ExpertSplit; no-op
    where both axes are 1."""
    from orbit2_tpu_torch.models.components.moe import MoEMlp

    sizes = axis_sizes(mesh)
    ep, tp = sizes[AXIS_EXPERT], sizes[AXIS_TENSOR]
    if ep * tp == 1:
        return
    emesh = mesh[MOE_AXES]
    for m in model.modules():
        if not isinstance(m, MoEMlp):
            continue
        for name, dim in _EXPERT_TENSOR_DIM.items():
            _distribute(m, name, emesh,
                        [Shard(0), Replicate() if dim is None or tp == 1 else Shard(dim)])
        count = m.num_experts // ep
        tgroup = mesh[AXIS_TENSOR].get_group()
        m.expert_split = ExpertSplit(
            mesh.moe_group if ep > 1 else tgroup, mesh.get_local_rank(AXIS_EXPERT) * count,
            count, tgroup, tp, mesh.get_local_rank(AXIS_TENSOR))


# the bytes of gradients reduce_seq_grads sums in one all-reduce
SEQ_GRAD_BUCKET = 256 << 20


def reduce_seq_grads(model: nn.Module) -> None:
    """Sums the Blocks' gradients over the seq axis the model's tokens are
    split over (each rank's are the part its tokens give), in buckets of at
    most SEQ_GRAD_BUCKET bytes; no-op without one. The embedding, variable
    aggregation, final norm and head run on the tokens whole on every seq
    rank, so theirs are whole already and are not summed."""
    split = getattr(model, "seq_split", None)
    if split is None or split.size == 1:
        return
    buckets, size = [[]], 0
    for p in model.blocks.parameters():
        if p.grad is None:
            continue
        g = local(p.grad)
        if buckets[-1] and (size + g.nbytes > SEQ_GRAD_BUCKET or g.dtype != buckets[-1][0].dtype):
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += g.nbytes
    for bucket in buckets:
        if not bucket:
            continue
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=split.group)
        parts = flat.split([g.numel() for g in bucket])
        torch._foreach_copy_(bucket, [t.view_as(g) for t, g in zip(parts, bucket)])


def _fsdp_dim(name: str, p: torch.Tensor, mesh: DeviceMesh) -> int:
    spec = spec_for(name, p.shape, mesh)
    if AXIS_FSDP in spec:
        return spec.index(AXIS_FSDP)
    if (isinstance(p, DTensor) and p.ndim > 1
            and any(isinstance(q, (Shard, _StridedShard)) and q.dim == 0 for q in p.placements)):
        return 1  # a column-split weight: never the dim its rows are split on
    return 0


def shard_model(model: nn.Module, mesh: DeviceMesh, dtype: Optional[torch.dtype] = None):
    """Shards a model over `mesh` in place (module docstring) and returns
    it: its parameters become DTensors, each rank holding its
    shards. Built on the meta device, it stays there (then to_empty and a
    fill: evaluate.py::materialize). `dtype` (serving): the floating
    tensors are cast to it first, as the one-device Evaluator holds them;
    those the cast leaves as they are (an MoE router, kept fp32) stay out of
    FSDP2, which gathers one dtype a unit, whole on every rank (no gradient
    reaches them in serving)."""
    from torch.distributed.fsdp import fully_shard

    from orbit2_tpu_torch.models.components.blocks import Attention, DropPath, Mlp
    from orbit2_tpu_torch.models.components.cnn import BatchNorm2d, ResidualBlock
    from orbit2_tpu_torch.models.components.moe import MoEMlp

    check_shardable(model, mesh)
    ignored = set()
    if dtype is not None:
        model._apply(lambda t: t.to(dtype) if t.is_floating_point() else t)
        ignored = {p for p in model.parameters() if p.is_floating_point() and p.dtype != dtype}
    sizes = axis_sizes(mesh)
    if sizes[AXIS_STAGE] > 1:
        split = model.stage_split = stage_split(mesh, model.pipeline_microbatches,
                                                model.pipeline_interleave)
        depth = len(model.blocks)
        for g in range(depth):
            stage = block_stage(g, depth, split.size, split.interleave)
            if stage != split.rank:
                model.blocks[g] = Elsewhere(stage)
    tmesh = mesh[AXIS_TENSOR]
    for name, (mode, packs) in tensor_plan(model).items():
        split_linear(model.get_submodule(name), mode, packs, tmesh)
    split_experts(model, mesh)

    data = sharded_coords(mesh, BATCH_AXES)
    # the Blocks' tokens are split over seq where the model is built for it
    # (a model-hub preset repeats its work over seq: check_shardable)
    seq = sharded_coords(mesh, (AXIS_SEQ,)) if getattr(model, "seq_shard", False) else ()
    tokens = data + seq
    heads = tokens + sharded_coords(mesh, (AXIS_TENSOR,))
    many = int(np.prod(list(sizes.values()))) > 1
    split = model.seq_split = seq_split(mesh, model.seq_impl) if seq else None
    for m in model.modules():
        if hasattr(m, "pos_fold"):  # the ResSlimViT's and the hub ViT's pos_drop
            m.pos_fold = data
        if isinstance(m, Attention):
            m.attn_fold, m.proj_fold = heads, tokens
            m.seq_split = split
        elif isinstance(m, Mlp):
            m.hidden_fold, m.out_fold = heads, tokens
            if many:
                m.use_fused = False
        elif isinstance(m, MoEMlp):
            m.out_fold = data  # summed over expert x tensor: the same y on each
        elif isinstance(m, DropPath) and data_size(mesh) > 1:
            m.batch_slice = (data_rank(mesh), data_size(mesh))
        elif isinstance(m, ResidualBlock):
            m.fold = data
        elif isinstance(m, BatchNorm2d) and data_size(mesh) > 1:
            m.sync = (mesh.data_group, data_size(mesh))

    names = {id(p): n for n, p in model.named_parameters()}
    dp = mesh[BATCH_AXES]

    def placement(p):
        return Shard(_fsdp_dim(names[id(p)], p, mesh))

    # every unit, the root too, reshards after its forward: a root left
    # unsharded after a no-grad forward would hand its whole parameters, not
    # the shards, to named_parameters() (an optimizer built then steps them).
    # The units: each transformer Block, then the root (a CNN's whole)
    for _, blk in trunk(model):
        fully_shard(blk, mesh=dp, shard_placement_fn=placement, reshard_after_forward=True,
                    ignored_params=ignored or None)
    fully_shard(model, mesh=dp, shard_placement_fn=placement, reshard_after_forward=True,
                ignored_params=ignored or None)
    return model


# -- whole tensors in and out of the shards ----------------------------------


def _chunk_sizes(n: int, parts: int) -> List[int]:
    """torch.chunk's piece sizes of n over `parts` ranks (0 past the last
    piece), as FSDP2 and DTensor cut a dim."""
    c = -(-n // parts)
    return [min(c, max(0, n - i * c)) for i in range(parts)]


def _splits(t: DTensor):
    """(the tensor axis's placement or None, [(mesh dim, dim) of the other
    axes' shards: the data axes' and the expert axis's]), mesh dims of one
    rank left out (their piece is the whole). On the port's meshes FSDP2
    shards the tensor axis's local tensor: whatever DTensor calls its
    placement (Shard, or a _StridedShard where it shares the tensor split's
    dim), each data rank holds its torch.chunk piece of that local tensor
    along `dim`."""
    mesh = t.device_mesh
    names = mesh.mesh_dim_names
    tp, data = None, []
    for i, p in enumerate(t.placements):
        if not isinstance(p, (Shard, _StridedShard)) or mesh.size(i) == 1:
            continue
        if names[i] == AXIS_TENSOR:
            tp = p
        else:
            data.append((i, p.dim))
    return tp, data


def _tensor_part(full: torch.Tensor, p, size: int, rank: int) -> torch.Tensor:
    """The tensor rank's part of `full` under placement p: its torch.chunk
    piece along p.dim, or, for a _StridedShard of split_factor packs, its
    piece of each pack."""
    if isinstance(p, _StridedShard):
        packs = int(p.split_factor)
        d = p.dim
        view = full.unflatten(d, (packs, size, full.shape[d] // (packs * size)))
        return view.select(d + 1, rank).flatten(d, d + 1)
    sizes = _chunk_sizes(full.shape[p.dim], size)
    return full.narrow(p.dim, sum(sizes[:rank]), sizes[rank])


def _gather(x: torch.Tensor, dim: int, n: int, group, size: int) -> torch.Tensor:
    """The pieces of a dim of length n that the `size` ranks of `group` hold
    (torch.chunk's cut), concatenated: padded to one length for the
    all-gather, cut back after."""
    sizes = _chunk_sizes(n, size)
    pad = list(x.shape)
    pad[dim] = max(sizes)
    buf = x.new_zeros(pad)
    buf.narrow(dim, 0, x.shape[dim]).copy_(x)
    parts = [torch.empty_like(buf) for _ in range(size)]
    dist.all_gather(parts, buf.contiguous(), group=group)
    return torch.cat([q.narrow(dim, 0, k) for q, k in zip(parts, sizes)], dim)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor of the port's meshes (a collective:
    every rank calls it in the same order), else t. Gathered with plain
    all-gathers, the data axes' pieces first, then the tensor axis's (the
    reverse of shard_model's order), so no DTensor redistribution plan is
    needed: torch 2.11's cannot order a _StridedShard beside a Shard."""
    if not isinstance(t, DTensor):
        return t
    mesh, x = t.device_mesh, t.to_local()
    tp, data = _splits(t)
    tp_dim = mesh.mesh_dim_names.index(AXIS_TENSOR) if tp is not None else None
    whole = torch.empty(t.shape, device="meta")
    local = (whole if tp is None else
             _tensor_part(whole, tp, mesh.size(tp_dim), mesh.get_local_rank(tp_dim)))
    for i, dim in data:
        x = _gather(x, dim, local.shape[dim], mesh.get_group(i), mesh.size(i))
    if tp is None or mesh.size(tp_dim) == 1:
        return x
    size = mesh.size(tp_dim)
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group(tp_dim))
    if isinstance(tp, _StridedShard):
        packs, d = int(tp.split_factor), tp.dim
        stacked = torch.stack([q.unflatten(d, (packs, -1)) for q in parts], d + 1)
        return stacked.flatten(d, d + 2)
    return torch.cat(parts, tp.dim)


def shard_like(full: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """This rank's part of `full` as `t` holds it (`full` itself where t is
    no DTensor), on t's device; no communication. The tensor axis's part
    first, then the data axes' pieces of it (shard_model's order)."""
    full = full.to(t.device)
    if not isinstance(t, DTensor):
        return full
    mesh = t.device_mesh
    tp, data = _splits(t)
    if tp is not None:
        i = mesh.mesh_dim_names.index(AXIS_TENSOR)
        full = _tensor_part(full, tp, mesh.size(i), mesh.get_local_rank(i))
    for i, dim in data:
        sizes = _chunk_sizes(full.shape[dim], mesh.size(i))
        r = mesh.get_local_rank(i)
        full = full.narrow(dim, sum(sizes[:r]), sizes[r])
    return full


def held_elsewhere(model: nn.Module, key: str) -> bool:
    """Whether `key` (a state-dict or parameter name) belongs to a Block
    another stage holds (shard_model on a stage mesh)."""
    m = re.match(r"^blocks\.(\d+)\.", key)
    blocks = getattr(model, "blocks", ())
    return bool(m) and int(m.group(1)) < len(blocks) and isinstance(blocks[int(m.group(1))],
                                                                     Elsewhere)


def held_state(model: nn.Module, state: Mapping[str, Any]) -> Dict[str, Any]:
    """`state` (whole tensors by name) without the Blocks other stages hold:
    what this rank loads of a checkpoint's model or moments."""
    return {k: v for k, v in state.items() if not held_elsewhere(model, k)}


@torch.no_grad()
def load_full_state_dict(model: nn.Module, state: Mapping[str, torch.Tensor],
                         keys: Optional[Sequence[str]] = None) -> None:
    """Copies the whole tensors of `state` into `model`'s shards, strictly:
    every parameter and buffer (or every one of `keys`) must be there. The
    tensors of Blocks other stages hold are passed over."""
    mine = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    whole = keys is None
    keys = list(mine) if whole else [k for k in keys if not held_elsewhere(model, k)]
    missing = [k for k in keys if k not in state]
    extra = ([k for k in state if k not in mine and not held_elsewhere(model, k)] if whole
             else [k for k in keys if k not in mine])
    if missing or extra:
        raise KeyError(f"state dict: missing {missing}, unexpected {extra}")
    for k in keys:
        t = mine[k]
        got = state[k]
        if tuple(got.shape) != tuple(t.shape):
            raise ValueError(f"{k}: shape {tuple(got.shape)}, the model's {tuple(t.shape)}")
        tl = t.to_local() if isinstance(t, DTensor) else t
        tl.copy_(shard_like(got.to(t.dtype), t))


def full_named(model: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{name: whole tensor on the host} of `tensors` (named as the model's
    state: its state dict, or optimizer moments by parameter name), gathered
    on every rank (a collective, one tensor at a time, so the device never
    holds more than one whole tensor besides the shards). On a stage mesh
    each Block's tensors are then handed from the stage that holds it to
    every other, over the stage group, Block by Block in order, and take
    their places in the order of the unsharded model's."""
    out = {k: full_tensor(t.detach()).cpu() for k, t in tensors.items()}
    split = getattr(model, "stage_split", None)
    if split is None or split.size == 1:
        return out
    comm = torch.device("cpu") if dist.get_backend(split.group) == "gloo" else next(
        p.device for p in model.parameters())
    blocks = []
    for g, blk in enumerate(model.blocks):
        owner = blk.stage if isinstance(blk, Elsewhere) else split.rank
        src = dist.get_global_rank(split.group, owner)
        prefix = f"blocks.{g}."
        names = [[(k, tuple(t.shape), t.dtype) for k, t in out.items() if k.startswith(prefix)]]
        dist.broadcast_object_list(names, src=src, group=split.group)
        for k, shape, dtype in names[0]:
            t = (out[k] if owner == split.rank else torch.empty(shape, dtype=dtype)).to(comm)
            dist.broadcast(t, src=src, group=split.group)
            blocks.append((k, t.cpu()))
    ordered, placed = {}, False
    for k, t in out.items():
        if not k.startswith("blocks."):
            ordered[k] = t
        elif not placed:
            ordered.update(blocks)
            placed = True
    if not placed:
        ordered.update(blocks)
    return ordered


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: whole tensor on the host} of the model's parameters and
    buffers, the Blocks other stages hold included (full_named)."""
    return full_named(model, model.state_dict())


__all__ = ["axis_sizes", "check_shardable", "full_named", "full_state_dict", "full_tensor",
           "held_elsewhere", "held_state", "jax_name", "jax_spec_for", "load_full_state_dict",
           "reduce_seq_grads", "shard_like", "shard_model", "spec_for", "split_experts",
           "split_linear", "tensor_plan", "trunk"]
