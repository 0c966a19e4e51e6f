"""Batch inference dumps (counterpart of orbit2_tpu/utils/inference.py;
reference utils/inference.py:9-151 `test_on_many_images`): save input /
ground truth / prediction npy arrays per test batch for offline analysis."""

from __future__ import annotations

import itertools
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist


def test_on_many_images(
    forward_fn: Callable[[np.ndarray], np.ndarray],
    data_module,
    out_dir: str,
    max_batches: Optional[int] = None,
    denormalize=None,
    mesh=None,
):
    """forward_fn maps a numpy batch to its numpy prediction
    (utils/visualize.py::model_forward_fn); `denormalize` (e.g. the port's
    Denormalize) takes torch tensors. Returns the number of batches written.

    On a device mesh (`mesh`: the Evaluator's, with its rank's data shard
    as `data_module`), every rank runs every round's forward, which is
    collective, in as many rounds as the data rank with the most batches
    (evaluate.py::synced_batches; a partial tail padded, as test() pads it);
    each round's inputs, targets and predictions are gathered over the data
    ranks, their padding dropped, and rank 0 writes them."""
    from orbit2_tpu_torch.evaluate import gather_rows, pad_rows, synced_batches
    from orbit2_tpu_torch.parallel.mesh import all_ranks, comm_device

    rounds = None
    if mesh is not None:
        mine = data_module.num_batches("test")
        rounds = all_ranks(mine if max_batches is None else min(mine, max_batches),
                           dist.ReduceOp.MAX, mesh, None)
    writes = mesh is None or dist.get_rank() == 0
    if writes:
        os.makedirs(out_dir, exist_ok=True)
    loader = iter(data_module.test_dataloader())
    n = 0
    try:
        batches = synced_batches(itertools.islice(loader, max_batches), data_module, rounds)
        for batch_idx, (batch, real) in enumerate(batches):
            x, y = batch[0], batch[1]
            if mesh is None:
                yhat = np.asarray(forward_fn(x))
            else:
                rows = data_module.batch_size
                x, y = pad_rows(x, rows), pad_rows(y, rows)
                yhat = np.asarray(forward_fn(x))
                (x, y, yhat), real = gather_rows(
                    [torch.from_numpy(a).to(comm_device()) for a in (x, y, yhat)], real, mesh,
                    None)
                x, y, yhat = (t.cpu().numpy() for t in (x, y, yhat))
                if not real:
                    continue
            if denormalize is not None:
                yhat = denormalize(torch.from_numpy(yhat)).numpy()
                y = denormalize(torch.from_numpy(y)).numpy()
            if writes:
                np.save(os.path.join(out_dir, f"input_{batch_idx}.npy"), x)
                np.save(os.path.join(out_dir, f"gt_{batch_idx}.npy"), y)
                np.save(os.path.join(out_dir, f"pred_{batch_idx}.npy"), yhat)
            n += 1
    finally:
        loader.close()
    return n
