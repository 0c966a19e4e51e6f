"""Test metrics in PyTorch: rmse, pearson and mean_bias, counterparts of
orbit2_tpu/metrics/functional.py:181-243 (reference functional.py:235-324).
Inputs are [B, C, H, W]; each non-aggregate call returns
concat([per_channel (C,), aggregate (1,)]) like the reference."""

from __future__ import annotations

import torch


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
