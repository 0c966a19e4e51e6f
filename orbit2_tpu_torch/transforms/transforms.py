"""Target transforms (counterpart of orbit2_tpu/transforms/transforms.py).

`Denormalize` inverts the per-variable Normalize; precipitation variables get
identity (mean 0 / std 1) because they are log-transformed in data space
instead (reference transforms/denormalize.py:23-31).
"""

from __future__ import annotations

import numpy as np
import torch

from orbit2_tpu_torch.data.processing.era5_constants import PRECIP_VARIABLES
from orbit2_tpu_torch.registry import register_transform as register


@register("denormalize")
class Denormalize:
    def __init__(self, data_module):
        norm = data_module.get_out_transforms()
        if norm is None:
            raise RuntimeError("norm was 'None', did you setup the data module?")
        mean = [norm[k].mean if k not in PRECIP_VARIABLES else 0.0 for k in norm]
        std = [norm[k].std if k not in PRECIP_VARIABLES else 1.0 for k in norm]
        self.mean = torch.from_numpy(np.asarray(mean, np.float32)).reshape(1, -1, 1, 1)
        self.std = torch.from_numpy(np.asarray(std, np.float32)).reshape(1, -1, 1, 1)

    def __call__(self, x):
        return x * self.std.to(x.device) + self.mean.to(x.device)
