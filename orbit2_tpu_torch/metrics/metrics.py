"""Metric classes registered in METRICS_REGISTRY: the test metrics of the
serving path, counterparts of orbit2_tpu/metrics/metrics.py (reference
src/climate_learn/metrics/metrics.py). The rest of the loss zoo comes with
training."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

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


@register("rmse")
class RMSE(Metric):
    def __call__(self, pred, target, mask=None, **_):
        return F.rmse(pred, target, self.aggregate_only, mask=mask)


@register("pearson")
class Pearson(Metric):
    def __call__(self, pred, target, **_):
        return F.pearson(pred, target, self.aggregate_only)


@register("mean_bias")
class MeanBias(Metric):
    def __call__(self, pred, target, **_):
        return F.mean_bias(pred, target, self.aggregate_only)


__all__ = ["METRICS_REGISTRY", "MetricsMetaInfo", "Metric", "RMSE", "Pearson", "MeanBias"]
