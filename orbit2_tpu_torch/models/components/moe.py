"""Switch / GShard mixture-of-experts MLP (counterpart of
orbit2_tpu/models/components/moe.py:72-173).

The JAX module's einsum formulation with a static capacity, step for step:

  * router: fp32 logits ``x.float() @ router_kernel`` -> softmax -> top-k
    experts per token (k = 1 Switch, k = 2 GShard-style, the gates then
    renormalised over the chosen k). The router's kernel stays fp32
    through every cast of the module's dtype (`_apply`), so a bf16 serving
    model routes in fp32, as JAX's does;
  * capacity: each expert takes at most ``C = min(L, max(1, ceil(L / E *
    capacity_factor * k)))`` tokens of each batch row, by a cumulative
    position; a token over capacity gets no expert output (a Block adds the
    MoE output residually, so it keeps its residual stream);
  * dispatch / combine: one-hot einsums over [B, L, E, C], the expert FFN
    over [E, B, C, ...] as batched products (library products, as the JAX
    package's are XLA einsums: it has no Pallas kernel here);
  * dropout on the output y alone, at `drop` (the Block's proj_drop),
    through ops/dropout.py (the fused kernel on the card); the expert hidden
    has none, as in JAX;
  * the Switch load-balance loss ``E * sum_e f_e p_e`` (f_e: the share of
    tokens whose first choice is e, p_e: the mean router probability; 1 at
    perfect balance) is returned beside y, for the train step to weight.

Parameters carry the JAX names and layouts: router_kernel [D, E], wi
[E, D, H], bi [E, H], wo [E, H, D], bo [E, D]; a state dict maps across
without transposes.

Expert parallelism (JAX moe.py:50-70, :149-161; `expert_split`, set by
parallel/sharding.py::shard_model): the stacks are DTensors over the
(expert, tensor) dims, so the rank holds E / expert of the experts, and of
those the tensor rank's hidden columns of wi/bi and rows of wo, as the
dense Mlp's fc1 and fc2 are split. The router, capacity and queue positions
are computed over all E experts on every rank from the same tokens, so the
routing is JAX's bit for bit; the dispatch and FFN einsums run for the
rank's experts only, and their combine is summed over the expert x tensor
ranks (Megatron's g). Its backward:
  * the MoE input's gradient through the dispatch is the rank's experts'
    part, summed over the group (Megatron's f on the dispatched x);
  * the gates' gradient through the combine likewise (f on the gates), so
    the router's gradient is whole on every rank; its load-balance part is
    computed whole on every rank and counted once;
  * the output bias, held whole on every tensor rank, is added by the
    tensor rank 0 alone and its gradient summed over the tensor group.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from orbit2_tpu_torch.ops.dropout import dropout
from orbit2_tpu_torch.parallel.tensor import ExpertSplit, copy_to_tensor, local, reduce_from_tensor


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of `idx` over n classes; an index outside [0, n) gives a
    zero row, as jax.nn.one_hot does (F.one_hot raises there)."""
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)).float()


class MoEMlp(nn.Module):
    """Drop-in MoE replacement for the Block's Mlp: forward(x [B, L, D],
    generator) -> (y [B, L, D] in x's dtype, aux: the 0-dim fp32
    load-balance loss)."""

    def __init__(self, dim: int, hidden_features: int, num_experts: int,
                 capacity_factor: float = 1.25, top_k: int = 1, drop: float = 0.0,
                 gelu_tanh: bool = False):
        super().__init__()
        if top_k not in (1, 2):
            raise ValueError(f"moe top_k must be 1 or 2, got {top_k}")
        if top_k > num_experts:
            raise ValueError(f"moe top_k ({top_k}) must be <= num_experts ({num_experts})")
        E, D, H = num_experts, dim, hidden_features
        self.num_experts, self.capacity_factor, self.top_k = E, capacity_factor, top_k
        self.drop = drop
        self.approximate = "tanh" if gelu_tanh else "none"
        self.router_kernel = nn.Parameter(torch.empty(D, E, dtype=torch.float32))
        self.wi = nn.Parameter(torch.empty(E, D, H))
        self.bi = nn.Parameter(torch.empty(E, H))
        self.wo = nn.Parameter(torch.empty(E, H, D))
        self.bo = nn.Parameter(torch.empty(E, D))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """JAX's initializers: truncated_normal(stddev 0.02, +-2) for the
        router and both expert kernels, zero biases."""
        for w in (self.router_kernel, self.wi, self.wo):
            nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04, generator=generator)
        nn.init.zeros_(self.bi)
        nn.init.zeros_(self.bo)

    def _apply(self, fn, recurse=True):
        # a cast of the module's dtype leaves the router fp32 (JAX creates it
        # fp32 whatever the param dtype); moves and to_empty apply as usual
        router = self.router_kernel

        def keep_router(t):
            out = fn(t)
            if (t is router or t is router.grad) and out.dtype != t.dtype:
                out = t.to(out.device)
            return out

        return super()._apply(keep_router, recurse)

    def capacity(self, tokens: int) -> int:
        """C, the JAX module's float expression (moe.py:102-103)."""
        c = max(1, math.ceil(tokens / self.num_experts * self.capacity_factor * self.top_k))
        return min(c, tokens)

    def router_probs(self, x: torch.Tensor) -> torch.Tensor:
        """The router's fp32 probabilities [B, L, E]; their argmax over E is
        each token's first choice."""
        return torch.softmax(x.float() @ self.router_kernel, dim=-1)

    # on a mesh: the data coordinates folded into the output dropout's seed,
    # and the split over the expert and tensor axes
    out_fold: tuple = ()
    expert_split: Optional[ExpertSplit] = None

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        B, L, _ = x.shape
        E, K = self.num_experts, self.top_k
        C = self.capacity(L)
        probs = self.router_probs(x)  # [B, L, E]

        # top-k assignment with per-round position bookkeeping
        gates, onehots = [], []
        remaining = probs
        for _ in range(K):
            oh = _one_hot(remaining.argmax(dim=-1), E)  # the first maximum, as jnp.argmax
            # no pick where every remaining probability is 0 (fp32 underflow),
            # so a round never places a token on expert 0 again
            oh = oh * (remaining.amax(dim=-1, keepdim=True) > 0.0).float()
            gates.append((probs * oh).sum(dim=-1))  # [B, L]
            onehots.append(oh)
            remaining = remaining * (1.0 - oh)
        # the Switch load balance, f_e from the first round's choices; taken
        # before the expert FFN, so that a recomputation under remat that
        # needs nothing after the combine stops before the output's dropout
        aux = E * (onehots[0].mean(dim=(0, 1)) * probs.mean(dim=(0, 1))).sum()
        if K > 1:
            denom = sum(gates)
            gates = [g / denom.clamp_min(1e-9) for g in gates]
        split = self.expert_split
        if split is not None:  # the combine's gradient is the rank's experts' part
            gates = [copy_to_tensor(g, split.group) for g in gates]
        combine = torch.zeros(B, L, E, C, dtype=torch.float32, device=x.device)
        counts = torch.zeros(B, E, dtype=torch.int64, device=x.device)
        for oh, gate in zip(onehots, gates):
            ohi = oh.long()
            # each token's place in its expert's queue this round, after the
            # tokens placed in earlier rounds
            pos = counts[:, None, :] + ohi.cumsum(dim=1) - ohi  # [B, L, E]
            counts = counts + ohi.sum(dim=1)
            keep = (pos < C).float() * oh
            slot = _one_hot((pos * ohi).sum(dim=-1), C)  # [B, L, C]
            combine = combine + gate[..., None, None] * keep[..., None] * slot[:, :, None, :]
        cd = x.dtype
        wi, bi, wo, bo = (local(t).to(cd) for t in (self.wi, self.bi, self.wo, self.bo))
        if split is not None:  # the rank's experts
            combine = combine[:, :, split.first:split.first + split.count]
            x = copy_to_tensor(x, split.group)
            if split.tensor_size > 1:
                bo = copy_to_tensor(bo, split.tensor_group) * float(split.tensor_rank == 0)
        dispatch = (combine > 0.0).to(cd)

        # the expert FFN over [E, B, C, *]
        xin = torch.einsum("blec,bld->ebcd", dispatch, x)
        h = torch.einsum("ebcd,edh->ebch", xin, wi) + bi[:, None, None, :]
        h = F.gelu(h, approximate=self.approximate)
        out = torch.einsum("ebch,ehd->ebcd", h, wo) + bo[:, None, None, :]
        y = torch.einsum("blec,ebcd->bld", combine.to(cd), out)
        if split is not None:
            y = reduce_from_tensor(y, split.group)
        return dropout(y, self.drop, self.training, generator, self.out_fold), aux


__all__ = ["MoEMlp"]
