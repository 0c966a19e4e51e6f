"""The training control plane's steps (counterpart of
orbit2_tpu/training/train.py): clip_replace_constant, the crop-to-match, the
train step, the eval step and the per-batch metric dict."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from orbit2_tpu_torch.data.processing.era5_constants import CONSTANTS
from orbit2_tpu_torch.parallel.sharding import reduce_seq_grads
from orbit2_tpu_torch.parallel.tensor import local


def clip_replace_constant(y, yhat, out_variables: Sequence[str]):
    """Clamp precipitation predictions at 0 and replace constant channels
    with ground truth (reference intermediate_downscaling.py:267-278).
    Out of place, so gradients flow through the kept channels."""
    chans = []
    for i, var in enumerate(out_variables):
        c = yhat[:, i]
        if var in CONSTANTS:
            c = y[:, i].to(yhat.dtype)
        elif var == "total_precipitation_24hr":
            c = c.clamp(min=0.0)
        chans.append(c)
    return torch.stack(chans, dim=1)


def _crop_to_match(yhat, y):
    return y[:, :, : yhat.shape[2], : yhat.shape[3]]


def make_train_step(model, train_loss_metric, var_weights: Optional[Dict[str, float]],
                    optimizer, in_variables: Sequence[str], out_variables: Sequence[str],
                    grad_accum: int = 1, moe_aux_weight: float = 0.01):
    """Returns step(x, y, dropout_gen, drop_path_gen) -> loss (a 0-dim device
    tensor): train-mode forward, clip, the train loss, backward and one
    optimizer update (reference intermediate_downscaling.py:281-306, 715-742;
    JAX train.py:52-194). The dropout sites and DropPath draw from their own
    generators, the JAX package's two rng streams.

    grad_accum > 1 splits the batch into that many microbatches and averages
    their gradients and losses before the one update. The gradients stay in
    each parameter's .grad until the next step.

    A model with MoE Blocks adds moe_aux_weight x the mean of their
    load-balance losses to each microbatch's loss, the returned loss
    included (JAX train.py:86-127).

    On a mesh (parallel/sharding.py) x and y are the rank's local batch and
    the loss is its mean; FSDP2 averages the gradients over the data ranks,
    so the update is the global batch's (JAX train.py:131-141). Where the
    trunk's tokens are split over a seq axis, the Blocks' gradients are then
    summed over it (parallel/sharding.py::reduce_seq_grads). The caller
    averages the losses over the data ranks for its records."""
    in_variables, out_variables = tuple(in_variables), tuple(out_variables)
    params = [p for p in model.parameters() if p.requires_grad]

    def loss_of(xb, yb, dropout_gen, drop_path_gen):
        yhat, aux = model(xb, in_variables, out_variables, dropout_gen, drop_path_gen,
                          return_aux=True)
        yhat = clip_replace_constant(yb, yhat.float(), out_variables)
        losses = train_loss_metric(yhat, _crop_to_match(yhat, yb),
                                   var_names=list(out_variables), var_weights=var_weights)
        loss = losses if losses.ndim == 0 else losses[-1]
        if aux:  # mean over the MoE layers, 1 at perfect balance
            loss = loss + float(moe_aux_weight) * sum(aux) / len(aux)
        return loss

    def step(x, y, dropout_gen: torch.Generator, drop_path_gen: Optional[torch.Generator]):
        if x.shape[0] % grad_accum:
            raise ValueError(f"batch {x.shape[0]} not divisible by grad_accum {grad_accum}")
        model.train()
        for p in params:
            p.grad = None
        loss = None
        for xb, yb in zip(x.chunk(grad_accum), y.chunk(grad_accum)):
            l = loss_of(xb, yb, dropout_gen, drop_path_gen)
            l.backward()
            loss = l.detach() if loss is None else loss + l.detach()
        reduce_seq_grads(model)
        if grad_accum > 1:
            loss = loss / grad_accum
            torch._foreach_div_([local(p.grad) for p in params], float(grad_accum))
        optimizer.step()
        return loss

    return step


def make_eval_step(model, in_variables, out_variables):
    """Forward + clip (reference evaluate_func, intermediate_downscaling.py:
    329-364): step(x, y) -> fp32 yhat, the model in eval mode (the model
    casts x to its compute dtype)."""
    in_variables, out_variables = tuple(in_variables), tuple(out_variables)

    @torch.no_grad()
    def step(x, y):
        model.eval()
        yhat = model(x, in_variables, out_variables).float()
        return clip_replace_constant(y, yhat, out_variables)

    return step


def evaluate_batch(yhat, y, stage: str, loss_metrics, target_transforms,
                   out_variables) -> Dict[str, torch.Tensor]:
    """Per-loss transform + metric dict (reference evaluate_func :344-364)."""
    loss_dict = {}
    for i, lf in enumerate(loss_metrics):
        yhat_, y_ = yhat, y
        if target_transforms is not None and target_transforms[i] is not None:
            yhat_ = target_transforms[i](yhat)
            y_ = target_transforms[i](y)
        y_ = _crop_to_match(yhat_, y_)
        losses = lf(yhat_, y_)
        name = getattr(lf, "name", f"loss_{i}")
        if losses.ndim == 0:
            loss_dict[f"{stage}/{name}:aggregate"] = losses
        else:
            for var_name, loss in zip(out_variables, losses):
                loss_dict[f"{stage}/{name}:{var_name}"] = loss
            loss_dict[f"{stage}/{name}:aggregate"] = losses[-1]
    return loss_dict
