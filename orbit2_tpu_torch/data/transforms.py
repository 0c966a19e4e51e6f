"""Per-variable data-space normalizers (numpy, host-side).

`Normalize` mirrors torchvision.transforms.Normalize as used per variable
(reference data/itermodule.py:210); `LogTransform` mirrors the precipitation
transform bit-for-bit (reference data/precipmodule.py:14-42): m -> mm,
suppress <= 0.25 mm/day to 0, then log1p.
"""

from __future__ import annotations

import numpy as np


class Normalize:
    def __init__(self, mean, std):
        self.mean = float(np.asarray(mean).reshape(-1)[0])
        self.std = float(np.asarray(std).reshape(-1)[0])

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean) / self.std

    def __repr__(self):
        return f"Normalize(mean={self.mean}, std={self.std})"


class LogTransform:
    """Reference data/precipmodule.py:4-45."""

    def __init__(self, m2mm: bool = True, log1p: bool = True, thres_mm_per_day: float = 0.25):
        self.m2mm = m2mm
        self.log1p = log1p
        self.thres_mm_per_day = thres_mm_per_day  # 0.1 inch/day
        self.epsilon = np.finfo(np.float64).eps

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32)
        if self.m2mm:
            x = x * 1000.0
            x = np.where(x <= self.thres_mm_per_day, 0.0, x)
        else:
            x = np.where(x <= self.thres_mm_per_day / 1000.0, 0.0, x)
        if self.log1p:
            return np.log1p(x)
        return np.log(x + self.epsilon)

    def inverse(self, y: np.ndarray) -> np.ndarray:
        """expm1 (and mm -> m if m2mm) — used by visualization/eval."""
        x = np.expm1(y) if self.log1p else np.exp(y)
        return x / 1000.0 if self.m2mm else x

    def __repr__(self):
        return f"LogTransform(M2mm={self.m2mm}, Log(x+1)={self.log1p})"
