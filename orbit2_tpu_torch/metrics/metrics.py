"""Metric classes registered in METRICS_REGISTRY, counterparts of
orbit2_tpu/metrics/metrics.py (reference src/climate_learn/metrics/
metrics.py:23-517): mse, bayesian_tv, imagegradient, quantile, mae,
lat_mse, lat_mae, rmse, lat_rmse, acc, lat_acc, pearson, mean_bias,
lat_nrmses, lat_nrmseg, lat_nrmse and masked_mse, each as the JAX class
computes it. `perceptual` (L1 + LPIPS over VGG16) is not ported: the repo
holds no trained LPIPS weights to hold it against.

The latitude weights cos(lat) / mean(cos(lat)) ([1, 1, H, 1]) and the
climatology ([1, C, H, W]) are made on the host once and copied to a
prediction's device at its first call there."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from orbit2_tpu_torch.metrics import functional as F
from orbit2_tpu_torch.registry import METRICS_REGISTRY, register_metric as register


@dataclass
class MetricsMetaInfo:
    """Reference metrics/utils.py:13-19."""

    in_vars: List[str]
    out_vars: List[str]
    lat: Any
    lon: Any
    climatology: Any


class Metric:
    """Parent class for all metrics (reference metrics.py:23-52)."""

    def __init__(self, aggregate_only: bool = False, metainfo: Optional[MetricsMetaInfo] = None):
        self.aggregate_only = aggregate_only
        self.metainfo = metainfo

    def __call__(self, pred, target, **kwargs):
        raise NotImplementedError


@register("mse")
class MSE(Metric):
    def __call__(self, pred, target, var_names=None, var_weights=None):
        return F.mse(pred, target, var_names, var_weights, self.aggregate_only)


@register("bayesian_tv")
class BayesianTV(Metric):
    """ORBIT-2 default train loss (reference metrics.py:204, functional.py:117-167)."""

    def __call__(self, pred, target, var_names=None, var_weights=None):
        return F.bayesian_tv(pred, target, var_names, var_weights, self.aggregate_only)


class _DeviceCopies:
    """A host tensor and its copies on the devices it was asked for."""

    def __init__(self, t: torch.Tensor):
        self.copies: Dict[torch.device, torch.Tensor] = {t.device: t}

    def on(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self.copies:
            self.copies[device] = next(iter(self.copies.values())).to(device)
        return self.copies[device]


class LatitudeWeightedMetric(Metric):
    """cos(lat)/mean(cos(lat)) weights, [1, 1, H, 1] (reference metrics.py:55-75)."""

    def __init__(self, aggregate_only: bool = False, metainfo: Optional[MetricsMetaInfo] = None):
        super().__init__(aggregate_only, metainfo)
        w = np.cos(np.deg2rad(np.asarray(self.metainfo.lat, np.float64)))
        w = (w / w.mean()).astype(np.float32)
        self._lat_weights = _DeviceCopies(torch.from_numpy(w).reshape(1, 1, -1, 1))

    def lat_weights(self, like: torch.Tensor) -> torch.Tensor:
        return self._lat_weights.on(like.device)


class ClimatologyBasedMetric(Metric):
    """Reference metrics.py:78-97."""

    def __init__(self, aggregate_only: bool = False, metainfo: Optional[MetricsMetaInfo] = None):
        super().__init__(aggregate_only, metainfo)
        self._attach_climatology()

    def _attach_climatology(self):
        """Shared by the latitude-weighted climatology metrics, whose MRO
        routes __init__ through LatitudeWeightedMetric instead."""
        # from_numpy: a host tensor even under a device context (the meta builds)
        clim = torch.from_numpy(np.array(self.metainfo.climatology, np.float32))[None]
        self._climatology = _DeviceCopies(clim)

    def climatology(self, like: torch.Tensor) -> torch.Tensor:
        return self._climatology.on(like.device)


@register("imagegradient")
class ImageGradient(Metric):
    def __call__(self, pred, target, var_names=None, var_weights=None):
        return F.image_gradient(pred, target, var_names, var_weights, self.aggregate_only)


@register("quantile")
class Quantile(Metric):
    def __call__(self, pred, target, var_names=None, var_weights=None):
        return F.lat_weighted_quantile(pred, target, self.aggregate_only)


@register("mae")
class MAE(Metric):
    def __call__(self, pred, target, **_):
        return F.mae(pred, target, self.aggregate_only)


@register("lat_mse")
class LatWeightedMSE(LatitudeWeightedMetric):
    def __call__(self, pred, target, var_names=None, var_weights=None):
        return F.mse(pred, target, var_names, var_weights, self.aggregate_only,
                     lat_weights=self.lat_weights(pred))


@register("lat_mae")
class LatWeightedMAE(LatitudeWeightedMetric):
    def __call__(self, pred, target, **_):
        return F.mae(pred, target, self.aggregate_only, lat_weights=self.lat_weights(pred))


@register("rmse")
class RMSE(Metric):
    def __call__(self, pred, target, mask=None, **_):
        return F.rmse(pred, target, self.aggregate_only, mask=mask)


@register("lat_rmse")
class LatWeightedRMSE(LatitudeWeightedMetric):
    def __call__(self, pred, target, mask=None, **_):
        return F.rmse(pred, target, self.aggregate_only, lat_weights=self.lat_weights(pred),
                      mask=mask)


@register("acc")
class ACC(ClimatologyBasedMetric):
    def __call__(self, pred, target, mask=None, **_):
        return F.acc(pred, target, self.climatology(pred), self.aggregate_only, mask=mask)


@register("lat_acc")
class LatWeightedACC(LatitudeWeightedMetric, ClimatologyBasedMetric):
    def __init__(self, aggregate_only: bool = False, metainfo=None):
        LatitudeWeightedMetric.__init__(self, aggregate_only, metainfo)
        self._attach_climatology()

    def __call__(self, pred, target, mask=None, **_):
        return F.acc(pred, target, self.climatology(pred), self.aggregate_only,
                     lat_weights=self.lat_weights(pred), mask=mask)


@register("pearson")
class Pearson(Metric):
    def __call__(self, pred, target, **_):
        return F.pearson(pred, target, self.aggregate_only)


@register("mean_bias")
class MeanBias(Metric):
    def __call__(self, pred, target, **_):
        return F.mean_bias(pred, target, self.aggregate_only)


@register("lat_nrmses")
class LatNRMSEs(LatitudeWeightedMetric, ClimatologyBasedMetric):
    def __init__(self, aggregate_only: bool = False, metainfo=None):
        LatitudeWeightedMetric.__init__(self, aggregate_only, metainfo)
        self._attach_climatology()

    def __call__(self, pred, target, **_):
        return F.nrmses(pred, target, self.climatology(pred), self.aggregate_only,
                        self.lat_weights(pred))


@register("lat_nrmseg")
class LatNRMSEg(LatitudeWeightedMetric, ClimatologyBasedMetric):
    def __init__(self, aggregate_only: bool = False, metainfo=None):
        LatitudeWeightedMetric.__init__(self, aggregate_only, metainfo)
        self._attach_climatology()

    def __call__(self, pred, target, **_):
        return F.nrmseg(pred, target, self.climatology(pred), self.aggregate_only,
                        self.lat_weights(pred))


@register("lat_nrmse")
class LatNRMSE(Metric):
    """nrmses + 5 x nrmseg, the ClimateBench composite."""

    def __init__(self, aggregate_only: bool = False, metainfo=None):
        super().__init__(aggregate_only, metainfo)
        self._s = LatNRMSEs(aggregate_only, metainfo)
        self._g = LatNRMSEg(aggregate_only, metainfo)

    def __call__(self, pred, target, **_):
        return self._s(pred, target) + 5 * self._g(pred, target)


@register("masked_mse")
class MaskedMSE(Metric):
    """Validity-masked MSE for nodata regions (JAX metrics.py:221-256). The
    mask comes from the data module's get_out_mask() through `set_mask`,
    or per call; a full-grid [H, W] mask is cropped to the top-left of a
    smaller target, as the steps crop the target to the prediction."""

    mask = None

    def set_mask(self, mask):
        self.mask = None if mask is None else _DeviceCopies(
            torch.from_numpy(np.array(mask, np.float32)))
        return self

    def __call__(self, pred, target, var_names=None, var_weights=None, mask=None):
        error = torch.square(pred - target)
        if mask is not None:
            m = torch.as_tensor(mask, dtype=torch.float32, device=pred.device)
        else:
            m = None if self.mask is None else self.mask.on(pred.device)
        if m is not None:
            m = m[..., : error.shape[-2], : error.shape[-1]]
            m = m.expand(error.shape).to(error.dtype)
            error = error * m / (m.mean() + 1e-9)
        w = F.channel_weights(var_names, var_weights, error.shape[1])
        if w is not None:
            error = error * torch.as_tensor(w, dtype=error.dtype, device=error.device).view(1, -1, 1, 1)
        loss = error.mean()
        if self.aggregate_only:
            return loss
        return torch.cat([error.mean(dim=(0, 2, 3)), loss[None]])


__all__ = ["METRICS_REGISTRY", "MetricsMetaInfo", "Metric", "MSE", "BayesianTV", "ImageGradient",
           "Quantile", "MAE", "LatWeightedMSE", "LatWeightedMAE", "RMSE", "LatWeightedRMSE",
           "ACC", "LatWeightedACC", "Pearson", "MeanBias", "LatNRMSEs", "LatNRMSEg", "LatNRMSE",
           "MaskedMSE"]
