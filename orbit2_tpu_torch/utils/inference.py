"""Batch inference dumps (counterpart of orbit2_tpu/utils/inference.py;
reference utils/inference.py:9-151 `test_on_many_images`): save input /
ground truth / prediction npy arrays per test batch for offline analysis."""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch


def test_on_many_images(
    forward_fn: Callable[[np.ndarray], np.ndarray],
    data_module,
    out_dir: str,
    max_batches: Optional[int] = None,
    denormalize=None,
):
    """forward_fn maps a numpy batch to its numpy prediction
    (utils/visualize.py::model_forward_fn); `denormalize` (e.g. the port's
    Denormalize) takes torch tensors. Returns the number of batches written."""
    os.makedirs(out_dir, exist_ok=True)
    loader = data_module.test_dataloader()
    n = 0
    for batch_idx, batch in enumerate(loader):
        if max_batches is not None and batch_idx >= max_batches:
            break
        x, y = batch[0], batch[1]
        yhat = np.asarray(forward_fn(x))
        if denormalize is not None:
            yhat = denormalize(torch.from_numpy(yhat)).numpy()
            y = denormalize(torch.from_numpy(y)).numpy()
        np.save(os.path.join(out_dir, f"input_{batch_idx}.npy"), x)
        np.save(os.path.join(out_dir, f"gt_{batch_idx}.npy"), y)
        np.save(os.path.join(out_dir, f"pred_{batch_idx}.npy"), yhat)
        n += 1
    return n
