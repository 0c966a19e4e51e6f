"""Eval pieces of the training control plane (counterpart of the serving half
of orbit2_tpu/training/train.py): clip_replace_constant, the crop-to-match,
the eval step and the per-batch metric dict. The train step comes with the
training kernels."""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from orbit2_tpu_torch.data.processing.era5_constants import CONSTANTS


def clip_replace_constant(y, yhat, out_variables: Sequence[str]):
    """Clamp precipitation predictions at 0 and replace constant channels
    with ground truth (reference intermediate_downscaling.py:267-278)."""
    out_variables = list(out_variables)
    yhat = yhat.clone()
    if "total_precipitation_24hr" in out_variables:
        i = out_variables.index("total_precipitation_24hr")
        yhat[:, i] = yhat[:, i].clamp(min=0.0)
    for i, var in enumerate(out_variables):
        if var in CONSTANTS:
            yhat[:, i] = y[:, i]
    return yhat


def _crop_to_match(yhat, y):
    return y[:, :, : yhat.shape[2], : yhat.shape[3]]


def make_eval_step(model, in_variables, out_variables):
    """Forward + clip (reference evaluate_func, intermediate_downscaling.py:
    329-364): step(x, y) -> fp32 yhat. x is cast to the model's dtype."""
    in_variables, out_variables = tuple(in_variables), tuple(out_variables)
    dtype = next(model.parameters()).dtype

    @torch.no_grad()
    def step(x, y):
        yhat = model(x.to(dtype), in_variables, out_variables).float()
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
