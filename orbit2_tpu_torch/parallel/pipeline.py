"""Pipeline parallelism over the mesh's stage axis (counterpart of
orbit2_tpu/parallel/pipeline.py): the trunk's Blocks split over S stages,
microbatches handed from stage to stage by a GPipe (V = 1) or interleaved
(V > 1) schedule.

The schedule is JAX's (pipeline_blocks, :163-321), tick by tick: the batch
is cut into M microbatches, and at tick t = 0 .. V*M + S - 2 stage s runs
admission q = t - s, round v = q // M of microbatch m = q % M, through its
chunk v: the global Blocks (v*S + s)*dc + j, j < dc = depth / (S*V)
(`owned_blocks`, JAX's C-order [V, S, dc] layout). Stage 0 admits a fresh
microbatch while q < M, then the wrap it banked from stage S-1 (V > 1,
which needs M >= S: a wrap is back before its re-admission); the last stage
writes microbatch m's output when it finishes round V-1. After each tick
every stage hands its result to the next (parallel/tensor.py::stage_shift,
S-1 -> 0 too when V > 1). `admission`, `banked` and `written` are that
bookkeeping as pure functions of (t, s, S, M, V).

How the port keeps JAX's one SPMD program on S processes, each with its
own autograd graph:
  * every stage selects its input with a tensor mask (`torch.where(first,
    feed, previous)`, JAX :287) and writes the output slots with one
    (`torch.where(last, y, slot)`, JAX :296-302), so every hop's result is
    in every stage's graph and its backward hop runs on every stage, in the
    same order (the reverse of the ticks). A Python `feed if stage == 0`
    would drop a hop from stage 0's graph, and its partner would wait
    forever;
  * a stage in the fill or drain bubble (no admission) hands its input on
    unchanged instead of running its chunk on it: the value is discarded
    either way (JAX computes it), so the bubble costs hops, not Blocks;
  * the trunk's input enters through copy_to_tensor over the stage group
    (forward identity, backward sum: only stage 0 reads the tokens, so the
    sum gives every stage the embedding's gradient) and its output leaves
    through reduce_from_tensor (forward sum of the last stage's slots and
    the others' zeros, JAX's psum(out * [stage == S-1]) at :313; backward
    identity): every stage then computes the same norm, head and loss, and
    the parameters outside the trunk, replicated over stage, get the same
    gradients with no further sum.

`sequential_blocks` is the same math on one process (JAX's
apply_stacked_sequential fallback): microbatch by microbatch, Block by
Block, with the same (microbatch, Block) arguments. The port keeps the
model in the reference layout (`blocks.{i}`, one ModuleList); the stacked
layouts exist only on the JAX side, and `stack_block_params`,
`unstack_block_params`, `to_interleaved` and `from_interleaved` are the
port's numpy copies of JAX's converters, for JAX parameter trees and
state dicts.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from orbit2_tpu_torch.parallel.tensor import copy_to_tensor, reduce_from_tensor, stage_shift

STACKED_KEY = "blocks_stacked"
STACKED_IV_KEY = "blocks_stacked_iv"


@dataclass(frozen=True)
class StageSplit:
    """The stage axis a ResSlimViT's trunk is pipelined over: its process
    group, size S, this rank's stage, the microbatches M a batch is cut into
    and the interleave V (chunks a stage holds)."""

    group: object
    size: int
    rank: int
    microbatches: int
    interleave: int = 1

    @property
    def ticks(self) -> int:
        return self.interleave * self.microbatches + self.size - 1


def check_schedule(depth: int, stages: int, microbatches: int, interleave: int = 1) -> None:
    """JAX's refusals of a schedule (pipeline.py:211-220)."""
    S, M, V = stages, microbatches, interleave
    if S < 1 or V < 1 or depth % (S * V):
        raise ValueError(f"depth {depth} not divisible by stages*interleave {S}*{V}")
    if V > 1 and M < S:
        raise ValueError(f"interleave {V} > 1 needs microbatches ({M}) >= stages ({S}) "
                         "so wrapped activations arrive before re-admission")


# -- the tick bookkeeping (JAX pipeline.py:257-302) ----------------------------


def admission(t: int, s: int, stages: int, microbatches: int,
              interleave: int = 1) -> Optional[Tuple[int, int]]:
    """(round v, microbatch m) that stage s runs at tick t, None in the fill
    or drain bubble."""
    q = t - s
    if not 0 <= q < interleave * microbatches:
        return None
    return q // microbatches, q % microbatches


def banked(t: int, s: int, stages: int, microbatches: int, interleave: int = 1) -> Optional[int]:
    """The microbatch whose wrap stage 0 banks at tick t (stage S-1's result
    of the tick before, a round short of the last), else None."""
    q_in = t - stages
    if s != 0 or interleave == 1 or not 0 <= q_in < (interleave - 1) * microbatches:
        return None
    return q_in % microbatches


def written(t: int, s: int, stages: int, microbatches: int, interleave: int = 1) -> Optional[int]:
    """The microbatch whose output the last stage writes at tick t, else
    None; every stage takes the slot (stages other than the last write it
    masked)."""
    w = t - (stages - 1) - (interleave - 1) * microbatches
    return w if 0 <= w < microbatches else None


def chunk_blocks(depth: int, stages: int, interleave: int, s: int, v: int) -> List[int]:
    """The global Blocks of stage s's chunk v, in order."""
    dc = depth // (stages * interleave)
    return [(v * stages + s) * dc + j for j in range(dc)]


def owned_blocks(depth: int, stages: int, interleave: int, s: int) -> List[int]:
    """The global Blocks (v*S + s)*dc + j that stage s holds, by chunk."""
    return [g for v in range(interleave) for g in chunk_blocks(depth, stages, interleave, s, v)]


def block_stage(g: int, depth: int, stages: int, interleave: int = 1) -> int:
    """The stage that holds global Block g."""
    return (g // (depth // (stages * interleave))) % stages


def stage_masks(split: StageSplit, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(this rank is the first stage, this rank is the last stage) as 0-dim
    bool tensors: the masks the schedule selects with."""
    return (torch.tensor(split.rank == 0, device=device),
            torch.tensor(split.rank == split.size - 1, device=device))


RunBlock = Callable[[int, int, torch.Tensor], torch.Tensor]


def pipeline_blocks(blocks: nn.ModuleList, tokens: torch.Tensor, split: StageSplit,
                    run_block: RunBlock) -> torch.Tensor:
    """The trunk over `split`'s stages (module docstring): tokens [B, L, D],
    whole on every stage, in; the Blocks' output, whole on every stage, out.
    run_block(g, m, x) runs global Block g on microbatch m's activations x;
    it is called for this stage's Blocks alone. B must divide by M."""
    S, s, M, V = split.size, split.rank, split.microbatches, split.interleave
    depth = len(blocks)
    check_schedule(depth, S, M, V)
    if tokens.shape[0] % M:
        raise ValueError(f"batch {tokens.shape[0]} not divisible by microbatches {M} "
                         "(set parallelism.pipeline_microbatches to a divisor)")
    xs = copy_to_tensor(tokens, split.group).chunk(M)
    first, last = stage_masks(split, tokens.device)
    zeros = torch.zeros_like(xs[0])
    previous, outs, waiting = zeros, [zeros] * M, [zeros] * M
    for t in range(split.ticks):
        m_in = banked(t, s, S, M, V)
        if m_in is not None:
            waiting[m_in] = previous
        work = admission(t, s, S, M, V)
        if work is None:  # JAX's clipped fresh microbatch
            feed = xs[min(max(t - s, 0), M - 1)]
        else:
            feed = xs[work[1]] if work[0] == 0 else waiting[work[1]]
        x = torch.where(first, feed, previous)
        if work is not None:
            v, m = work
            for g in chunk_blocks(depth, S, V, s, v):
                x = run_block(g, m, x)
        w = written(t, s, S, M, V)
        if w is not None:
            outs[w] = torch.where(last, x, outs[w])
        if t < split.ticks - 1:  # the last tick's hop would reach no one
            previous = stage_shift(x, split)
    return reduce_from_tensor(torch.cat(outs), split.group)


def sequential_blocks(blocks: nn.ModuleList, tokens: torch.Tensor, microbatches: int,
                      run_block: RunBlock) -> torch.Tensor:
    """pipeline_blocks' math on one process: each microbatch through every
    Block in order, run_block(g, m, x) as the schedule calls it."""
    if tokens.shape[0] % microbatches:
        raise ValueError(f"batch {tokens.shape[0]} not divisible by microbatches "
                         f"{microbatches} (set parallelism.pipeline_microbatches to a divisor)")
    outs = []
    for m, x in enumerate(tokens.chunk(microbatches)):
        for g in range(len(blocks)):
            x = run_block(g, m, x)
        outs.append(x)
    return torch.cat(outs)


class Elsewhere(nn.Module):
    """Stands, in a stage rank's model, for a Block another stage holds
    (parallel/sharding.py::shard_model): no parameters; `stage` holds it."""

    def __init__(self, stage: int):
        super().__init__()
        self.stage = stage

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"this Block is held by stage {self.stage}")


# -- the JAX side's stacked layouts, on numpy trees ----------------------------


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_stack(trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    return np.stack([np.asarray(t) for t in trees])


def _first_leaf(tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return np.asarray(tree)


_BLOCK_RE = re.compile(r"^blocks_(\d+)$")


def to_interleaved(stacked, stages: int, interleave: int):
    """[depth, ...] stacked tree -> [V, S, dc, ...] (JAX pipeline.py:75-84)."""
    depth = _first_leaf(stacked).shape[0]
    S, V = int(stages), int(interleave)
    if depth % (S * V):
        raise ValueError(f"depth {depth} not divisible by stages*interleave {S}*{V}")
    dc = depth // (S * V)
    return _tree_map(lambda a: np.asarray(a).reshape(V, S, dc, *np.shape(a)[1:]), stacked)


def from_interleaved(iv):
    """[V, S, dc, ...] tree -> [depth, ...] (JAX pipeline.py:87-91)."""
    return _tree_map(lambda a: np.asarray(a).reshape(-1, *np.shape(a)[3:]), iv)


def stack_block_params(params: Mapping, key: str = STACKED_KEY) -> Dict:
    """blocks_0 .. blocks_{n-1} subtrees -> one stacked subtree under `key`
    (JAX pipeline.py:94-110); the input is not changed."""
    idx = sorted(int(m.group(1)) for k in params if (m := _BLOCK_RE.match(k)))
    if not idx:
        raise ValueError("no blocks_<i> subtrees to stack")
    if idx != list(range(len(idx))):
        raise ValueError(f"non-contiguous block indices: {idx}")
    out = {k: v for k, v in params.items() if not _BLOCK_RE.match(k)}
    out[key] = _tree_stack([params[f"blocks_{i}"] for i in idx])
    return out


def unstack_block_params(params: Mapping, key: str = STACKED_KEY) -> Dict:
    """The stacked subtree under `key` -> blocks_{i} subtrees (JAX
    pipeline.py:113-122); a [V, S, dc, ...] one under STACKED_IV_KEY is
    flattened first."""
    if key not in params:
        raise ValueError(f"no '{key}' subtree to unstack")
    stacked = params[key]
    if key == STACKED_IV_KEY:
        stacked = from_interleaved(stacked)
    depth = _first_leaf(stacked).shape[0]
    out = {k: v for k, v in params.items() if k != key}
    for i in range(depth):
        out[f"blocks_{i}"] = _tree_map(lambda a, i=i: np.asarray(a)[i], stacked)
    return out


def unstack_any(params: Mapping) -> Mapping:
    """`params` with whichever stacked subtree it holds unstacked into
    blocks_{i} subtrees; as it is without one."""
    for key in (STACKED_IV_KEY, STACKED_KEY):
        if key in params:
            return unstack_block_params(params, key)
    return params


__all__ = ["Elsewhere", "STACKED_IV_KEY", "STACKED_KEY", "StageSplit", "admission", "banked",
           "block_stage", "check_schedule", "chunk_blocks", "from_interleaved", "owned_blocks",
           "pipeline_blocks", "sequential_blocks", "stack_block_params", "stage_masks",
           "to_interleaved", "unstack_any", "unstack_block_params", "written"]
