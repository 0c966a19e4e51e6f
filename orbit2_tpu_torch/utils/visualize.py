"""Tile-stitched inference and visualization (counterpart of
orbit2_tpu/utils/visualize.py; reference examples/visualize.py +
src/climate_learn/utils/visualize.py).

`stitched_inference` is the core: run the model tile by tile over a full
field with the TILES halo slices, crop each tile's halo, and stitch the crops
back into the full high-resolution grid, the index math of reference
visualize.py:125-311 (edge tiles whose halo was borrowed inward included).
`visualize_at_index` adds denormalize, npy (and, where matplotlib imports,
PNG) dumps and PSNR/SSIM; `visualize_mean_bias` and `rank_histogram` are the
analysis extras. Everything here is numpy on the host; `model_forward_fn`
wraps a port model as the numpy forward the functions take.

On a device mesh (a model sharded by parallel/sharding.py::shard_model, as
the Evaluator serves it there) the forward is collective: every rank of the
mesh runs every tile, each on the whole tile, and every rank gets the same
field; rank 0 alone writes the files.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from orbit2_tpu_torch.data.reader import halo_lrtb, tile_slices
from orbit2_tpu_torch.transforms.transforms import Denormalize
from orbit2_tpu_torch.utils.image_metrics import psnr, ssim


def model_forward_fn(model: torch.nn.Module, in_variables: Sequence[str],
                     out_variables: Sequence[str]) -> Callable[[np.ndarray], np.ndarray]:
    """A numpy forward of `model` on its device, in eval mode: x [B, C, h, w]
    -> fp32 [B, C_out, h*mag, w*mag]. On a mesh every rank calls it with
    the same x (module docstring)."""
    device = next(model.parameters()).device
    in_variables, out_variables = tuple(in_variables), tuple(out_variables)

    @torch.no_grad()
    def forward(x: np.ndarray) -> np.ndarray:
        model.eval()
        xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)
        return model(xt, in_variables, out_variables).float().cpu().numpy()

    return forward


def _denormalize(denorm: Denormalize, field: np.ndarray) -> np.ndarray:
    return denorm(torch.from_numpy(np.ascontiguousarray(field))[None])[0].numpy()


def stitched_inference(
    forward_fn: Callable[[np.ndarray], np.ndarray],
    x_full: np.ndarray,
    div: int,
    overlap: int,
    mag: int,
) -> np.ndarray:
    """x_full: [C, H, W] (normalized, untiled). forward_fn maps a [1, C, h, w]
    tile to [1, C_out, h*mag, w*mag]. Returns [C_out, H*mag, W*mag]."""
    _, yinp, xinp = x_full.shape
    yout, xout = yinp * mag, xinp * mag
    left, right, top, bottom = halo_lrtb(overlap)

    out = None
    for t in tile_slices(div, overlap, yinp, xinp, yout, xout):
        tile = x_full[:, t.yi[0]:t.yi[1], t.xi[0]:t.xi[1]]
        pred = np.asarray(forward_fn(tile[None]))[0]  # [C_out, h*mag, w*mag]
        if out is None:
            out = np.zeros((pred.shape[0], yout, xout), dtype=pred.dtype)
        # crop the halo back off (output pixels)
        ct = 0 if t.vindex == 0 else top * mag
        cb = pred.shape[1] - (0 if t.vindex == div - 1 else bottom * mag)
        cl = 0 if t.hindex == 0 else left * mag
        cr = pred.shape[2] - (0 if t.hindex == div - 1 else right * mag)
        core = pred[:, ct:cb, cl:cr]
        out[:, t.yo[0] + ct : t.yo[0] + cb, t.xo[0] + cl : t.xo[0] + cr] = core
    return out


def dataset_flips(data_module) -> bool:
    """Dataset-derived display orientation. The reference flips
    ERA5/PRISM/DAYMET fields north-up inside its stitch loop, gated on the
    src NAME (reference visualize.py:263,285,303); the data-derived
    equivalent of that gate is the storage order itself — those layouts
    store latitude ascending (south row first), so flip exactly when
    lat[0] < lat[-1]."""
    try:
        lat, _ = data_module.get_lat_lon()
    except Exception:
        return False
    lat = np.asarray(lat)
    return lat.size >= 2 and float(lat[0]) < float(lat[-1])


def _nth_test_sample(data_module, index: int):
    """Locate sample `index` in the (untiled) test pipeline
    (reference visualize.py:113-123)."""
    count = 0
    for x, y, in_vars, out_vars in data_module.data_test:
        if count == index:
            xs = np.stack([np.asarray(x[k]) for k in in_vars])
            ys = np.stack([np.asarray(y[k]) for k in out_vars])
            return xs, ys, list(in_vars), list(out_vars)
        count += 1
    raise IndexError(f"test split has only {count} samples")


def visualize_at_index(
    forward_fn,
    data_module,
    index: int = 0,
    div: int = 1,
    overlap: int = 0,
    mag: int = 4,
    out_dir: Optional[str] = None,
    flip: Optional[bool] = None,
    variable: Optional[str] = None,
):
    """Stitched prediction for one test sample + per-variable PSNR/SSIM.

    Returns dict with preds/groundtruth/inputs (denormalized) and metrics.
    Saves npy (and PNG where matplotlib imports) per output variable when
    out_dir is given (reference visualize.py:318-355). flip=None (default)
    derives the north-up orientation from the data module's latitude order
    (`dataset_flips`), matching the reference's in-loop src-gated flips;
    pass an explicit bool to override."""
    if flip is None:
        flip = dataset_flips(data_module)
    x, y, in_vars, out_vars = _nth_test_sample(data_module, index)
    preds = stitched_inference(forward_fn, x, div, overlap, mag)

    denorm = Denormalize(data_module)
    preds_d = _denormalize(denorm, preds)
    y_d = _denormalize(denorm, y)

    if flip:
        preds_d, y_d = preds_d[:, ::-1], y_d[:, ::-1]

    metrics = {}
    for i, var in enumerate(out_vars):
        if variable is not None and var != variable:
            continue
        metrics[var] = {
            "psnr": psnr(preds_d[i], y_d[i]),
            "ssim": ssim(preds_d[i], y_d[i]),
        }

    if out_dir and _writes():
        os.makedirs(out_dir, exist_ok=True)
        for i, var in enumerate(out_vars):
            np.save(os.path.join(out_dir, f"pred_{var}_{index}.npy"), preds_d[i])
            np.save(os.path.join(out_dir, f"gt_{var}_{index}.npy"), y_d[i])
            _save_png(preds_d[i], y_d[i], var,
                      os.path.join(out_dir, f"vis_{var}_{index}.png"))

    return {"preds": preds_d, "groundtruth": y_d, "inputs": x,
            "out_variables": out_vars, "metrics": metrics}


def _writes() -> bool:
    """Whether this process writes the files: rank 0 of a process group, or
    the process itself without one."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _save_png(pred, gt, var, path):  # pragma: no cover - plotting
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    vmin, vmax = np.percentile(gt, [1, 99])
    axes[0].imshow(gt, vmin=vmin, vmax=vmax)
    axes[0].set_title(f"{var} ground truth")
    axes[1].imshow(pred, vmin=vmin, vmax=vmax)
    axes[1].set_title("prediction")
    im = axes[2].imshow(pred - gt, cmap="RdBu_r")
    axes[2].set_title("bias")
    fig.colorbar(im, ax=axes[2])
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def visualize_mean_bias(forward_fn, data_module, div=1, overlap=0, mag=4,
                        max_samples: int = 16, out_dir: Optional[str] = None):
    """Mean (truth - pred) over test samples (reference utils/visualize.py:516)."""
    denorm = Denormalize(data_module)
    acc, n, out_vars = None, 0, None
    for x, y, in_vars, ovars in data_module.data_test:
        if n >= max_samples:
            break
        xs = np.stack([np.asarray(x[k]) for k in in_vars])
        ys = np.stack([np.asarray(y[k]) for k in ovars])
        preds = _denormalize(denorm, stitched_inference(forward_fn, xs, div, overlap, mag))
        bias = _denormalize(denorm, ys) - preds
        acc = bias if acc is None else acc + bias
        n += 1
        out_vars = list(ovars)
    mean_bias = acc / max(1, n)
    if out_dir and _writes():
        os.makedirs(out_dir, exist_ok=True)
        for i, var in enumerate(out_vars):
            np.save(os.path.join(out_dir, f"mean_bias_{var}.npy"), mean_bias[i])
    return mean_bias, out_vars


def rank_histogram(ensemble: np.ndarray, obs: np.ndarray, bins: Optional[int] = None):
    """Ensemble calibration rank histogram (reference utils/visualize.py:561):
    rank of the observation within the sorted ensemble at each pixel.
    ensemble: [N_ens, ...], obs: [...]. Returns (counts[N_ens+1],)."""
    n_ens = ensemble.shape[0]
    rank = np.sum(ensemble < obs[None], axis=0)  # 0..n_ens
    counts = np.bincount(rank.ravel(), minlength=n_ens + 1)
    return counts
