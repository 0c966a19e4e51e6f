"""Losses and metrics in PyTorch, counterparts of
orbit2_tpu/metrics/functional.py (reference metrics/functional.py, file:line
cited per function): the train losses mse, bayesian_tv, image_gradient and
lat_weighted_quantile, and the metrics mae, rmse, acc, pearson, mean_bias,
nrmses and nrmseg. Inputs are [B, C, H, W]; each non-aggregate call returns
concat([per_channel (C,), aggregate (1,)]) like the reference."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def channel_weights(var_names: Optional[Sequence[str]], var_weights: Optional[Dict[str, float]],
                    num_channels: int) -> Optional[np.ndarray]:
    """Per-channel weight vector (reference functional.py:188-196): 1 unless
    `var_weights` names the channel's variable."""
    if var_names is None:
        return None
    if len(var_names) != num_channels:
        raise ValueError("Number of variable names must match channel dimension")
    return np.asarray([float((var_weights or {}).get(v, 1.0)) for v in var_names], np.float32)


def _apply_weights(error, var_names, var_weights, lat_weights):
    if lat_weights is not None:
        error = error * lat_weights
    w = channel_weights(var_names, var_weights, error.shape[1])
    if w is not None:
        error = error * torch.as_tensor(w, dtype=error.dtype, device=error.device).view(1, -1, 1, 1)
    return error


def _per_channel_and_agg(error, aggregate_only: bool):
    loss = error.mean()
    if aggregate_only:
        return loss
    return torch.cat([error.mean(dim=(0, 2, 3)), loss[None]])


def mse(pred, target, var_names=None, var_weights=None, aggregate_only: bool = False,
        lat_weights=None):
    """Weighted MSE (reference functional.py:173-202)."""
    error = _apply_weights(torch.square(pred - target), var_names, var_weights, lat_weights)
    return _per_channel_and_agg(error, aggregate_only)


def bayesian_tv(pred, target, var_names=None, var_weights=None, aggregate_only: bool = False,
                lat_weights=None, prior_weight: float = 0.02, diag_weight: float = 0.7):
    """MSE + directional total-variation prior, ORBIT-2's default train loss
    (reference functional.py:117-167): vertical and horizontal differences
    weighted 1, the two diagonals `diag_weight`, all scaled by `prior_weight`
    and zero-padded back to [H, W] (bottom row; right column; bottom + right;
    bottom + left)."""
    mse_error = torch.square(pred - target)
    dif1 = F.pad(torch.abs(pred[:, :, 1:, :] - pred[:, :, :-1, :]), (0, 0, 0, 1))
    dif2 = F.pad(torch.abs(pred[:, :, :, 1:] - pred[:, :, :, :-1]), (0, 1, 0, 0))
    dif3 = F.pad(torch.abs(pred[:, :, 1:, 1:] - pred[:, :, :-1, :-1]), (0, 1, 0, 1))
    dif4 = F.pad(torch.abs(pred[:, :, 1:, :-1] - pred[:, :, :-1, 1:]), (1, 0, 0, 1))
    prior_error = prior_weight * (dif1 + dif2 + diag_weight * dif3 + diag_weight * dif4)
    error = _apply_weights(mse_error + prior_error, var_names, var_weights, lat_weights)
    return _per_channel_and_agg(error, aggregate_only)


def rmse(pred, target, aggregate_only: bool = False, lat_weights=None, mask=None):
    """Per-sample spatial RMSE averaged over batch (reference functional.py:235-255)."""
    error = torch.square(pred - target)
    if lat_weights is not None:
        error = error * lat_weights
    if mask is not None:
        error = error * mask
        masked_frac = mask.mean(dim=(1, 2, 3), keepdim=True) + 1e-9
        error = error / masked_frac
    per_channel = torch.sqrt(error.mean(dim=(2, 3))).mean(dim=0)
    loss = per_channel.mean()
    if aggregate_only:
        return loss
    return torch.cat([per_channel, loss[None]])


def pearson(pred, target, aggregate_only: bool = False):
    """Cosine similarity of centered per-channel flats (reference
    functional.py:293-308)."""
    c = pred.shape[1]
    pf = pred.movedim(1, 0).reshape(c, -1)
    tf = target.movedim(1, 0).reshape(c, -1)
    pf = pf - pf.mean(dim=1, keepdim=True)
    tf = tf - tf.mean(dim=1, keepdim=True)
    per_channel = (pf * tf).sum(1) / torch.clamp(
        torch.linalg.vector_norm(pf, dim=1) * torch.linalg.vector_norm(tf, dim=1), min=1e-8)
    coeff = per_channel.mean()
    if aggregate_only:
        return coeff
    return torch.cat([per_channel, coeff[None]])


def mean_bias(pred, target, aggregate_only: bool = False):
    """target.mean - pred.mean per channel (reference functional.py:311-324)."""
    per_channel = target.mean(dim=(0, 2, 3)) - pred.mean(dim=(0, 2, 3))
    result = per_channel.mean()
    if aggregate_only:
        return result
    return torch.cat([per_channel, result[None]])


def image_gradient_fn(pred, target):
    """Mean |grad target - grad pred| by forward differences, the last row
    and column zero (torchmetrics.image_gradients, reference
    functional.py:96-114)."""
    def grads(img):
        dy = F.pad(img[:, :, 1:, :] - img[:, :, :-1, :], (0, 0, 0, 1))
        dx = F.pad(img[:, :, :, 1:] - img[:, :, :, :-1], (0, 1, 0, 0))
        return dy, dx

    dy, dx = grads(target)
    hat_dy, hat_dx = grads(pred)
    return torch.mean(torch.abs(dx - hat_dx) + torch.abs(dy - hat_dy))


def image_gradient(pred, target, var_names=None, var_weights=None, aggregate_only: bool = False,
                   lat_weights=None):
    """MSE + 0.1 x the gradient-difference loss (reference
    functional.py:59-94): a scalar whatever aggregate_only says; the channel
    weights multiply the squared error and, through their mean, the
    gradient term (JAX functional.py:118-145)."""
    error_1 = torch.square(pred - target)
    grad_err = image_gradient_fn(pred, target)
    w = channel_weights(var_names, var_weights, pred.shape[1])
    if w is not None:
        wt = torch.as_tensor(w, dtype=pred.dtype, device=pred.device).view(1, -1, 1, 1)
        error_1 = error_1 * wt
        grad_err = grad_err * wt.mean()
    return error_1.mean() + 0.1 * grad_err


def lat_weighted_quantile(pred, target, aggregate_only: bool = False, lat_weights=None):
    """The +-1/2/3 sigma quantile (pinball) loss (reference
    functional.py:35-56): a scalar."""
    q = torch.tensor([1 - 0.9987, 1 - 0.9772, 1 - 0.8413, 0.5000, 0.8413, 0.9772, 0.9987],
                     dtype=pred.dtype, device=pred.device)
    error = pred - target
    if lat_weights is not None:
        error = error * lat_weights
    error = error[..., None]
    return torch.abs(torch.maximum((q - 1) * error, q * error)).mean()


def mae(pred, target, aggregate_only: bool = False, lat_weights=None):
    """Reference functional.py:218-232."""
    error = torch.abs(pred - target)
    if lat_weights is not None:
        error = error * lat_weights
    return _per_channel_and_agg(error, aggregate_only)


def acc(pred, target, climatology, aggregate_only: bool = False, lat_weights=None, mask=None):
    """Anomaly correlation coefficient against the climatology (reference
    functional.py:258-290); the reference overwrites its masked sums with the
    unmasked ones, so the mask changes nothing, as in JAX."""
    pred = pred - climatology
    target = target - climatology
    lw = lat_weights if lat_weights is not None else 1.0
    pred_prime = pred - pred.mean(dim=(0, 2, 3), keepdim=True)
    target_prime = target - target.mean(dim=(0, 2, 3), keepdim=True)
    numer = (lw * pred_prime * target_prime).sum(dim=(0, 2, 3))
    denom1 = (lw * torch.square(pred_prime)).sum(dim=(0, 2, 3))
    denom2 = (lw * torch.square(target_prime)).sum(dim=(0, 2, 3))
    per_channel = numer / torch.sqrt(denom1 * denom2)
    result = per_channel.mean()
    if aggregate_only:
        return result
    return torch.cat([per_channel, result[None]])


def nrmses(pred, target, clim, aggregate_only: bool = False, lat_weights=None):
    """Spatial NRMSE, normalized by the climatology (reference
    functional.py:389-404)."""
    y_norm = clim.squeeze()
    error = torch.square(pred.mean(dim=0) - target.mean(dim=0))  # (C, H, W)
    if lat_weights is not None:
        error = error * lat_weights.squeeze(0)
    per_channel = torch.sqrt(error.mean(dim=(-2, -1))) / y_norm
    loss = per_channel.mean()
    if aggregate_only:
        return loss
    return torch.cat([per_channel, loss[None]])


def nrmseg(pred, target, clim, aggregate_only: bool = False, lat_weights=None):
    """Global NRMSE (reference functional.py:407-425)."""
    y_norm = clim.squeeze()
    if lat_weights is not None:
        pred = pred * lat_weights
        target = target * lat_weights
    error = torch.square(pred.mean(dim=(-2, -1)) - target.mean(dim=(-2, -1)))
    per_channel = torch.sqrt(error.mean(dim=0)) / y_norm
    loss = per_channel.mean()
    if aggregate_only:
        return loss
    return torch.cat([per_channel, loss[None]])
