"""2D sin-cos position embeddings + on-the-fly bicubic resize.

Counterpart of orbit2_tpu/ops/pos_embed.py (reference
models/hub/components/pos_embed.py:20-138): the embedding is built for a base
grid at construction and resized to the current token grid every forward,
with the same explicit bicubic weight matrices as the JAX package, which
reproduce F.interpolate(mode="bicubic", align_corners=False).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    pos = pos.reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(
    embed_dim: int, grid_size_h: int, grid_size_w: int, cls_token: bool = False
) -> np.ndarray:
    """[gh*gw, D] (reference pos_embed.py:20-46; w varies fastest)."""
    grid_h = np.arange(grid_size_h, dtype=np.float64)
    grid_w = np.arange(grid_size_w, dtype=np.float64)
    grid = np.meshgrid(grid_w, grid_h)  # w goes first
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_size_h, grid_size_w])
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    pos_embed = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        pos_embed = np.concatenate([np.zeros([1, embed_dim]), pos_embed], axis=0)
    return pos_embed


def torch_bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out, in] interpolation matrix reproducing
    F.interpolate(mode='bicubic', align_corners=False): Keys cubic kernel
    a=-0.75, half-pixel sampling, edge-replicated taps."""
    a = -0.75
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for j in range(out_size):
        src = (j + 0.5) * scale - 0.5
        i0 = int(np.floor(src))
        t = src - i0
        weights = [
            ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a,
            ((a + 2) * t - (a + 3)) * t * t + 1,
            ((a + 2) * (1 - t) - (a + 3)) * (1 - t) ** 2 + 1,
            ((a * (2 - t) - 5 * a) * (2 - t) + 8 * a) * (2 - t) - 4 * a,
        ]
        for tap, wt in zip(range(i0 - 1, i0 + 3), weights):
            w[j, min(max(tap, 0), in_size - 1)] += wt
    return w.astype(np.float32)


def interpolate_pos_embed_on_the_fly(
    pos_embed: torch.Tensor, patch_size: int, new_size: Tuple[int, int]
) -> torch.Tensor:
    """Resize [1, L, D] -> [1, L', D] for the current image size; identity when
    the token grid is unchanged. Keeps the reference's W:H = 2:1 assumption for
    recovering the base grid (reference pos_embed.py:103-138)."""
    embedding_size = pos_embed.shape[-1]
    orig_num_patches = pos_embed.shape[-2]
    w_h_ratio = 2
    orig_h = int((orig_num_patches // w_h_ratio) ** 0.5)
    orig_w = w_h_ratio * orig_h
    new_h, new_w = new_size[0] // patch_size, new_size[1] // patch_size
    if orig_h == new_h and orig_w == new_w:
        return pos_embed
    grid = pos_embed.reshape(orig_h, orig_w, embedding_size)
    like = dict(dtype=pos_embed.dtype, device=pos_embed.device)
    wh = torch.as_tensor(torch_bicubic_weights(orig_h, new_h), **like)
    ww = torch.as_tensor(torch_bicubic_weights(orig_w, new_w), **like)
    resized = torch.einsum("Hh,hwd->Hwd", wh, grid)
    resized = torch.einsum("Ww,hwd->hWd", ww, resized)
    return resized.reshape(1, new_h * new_w, embedding_size)


def interpolate_pos_embed_checkpoint(pos_embed, patch_size: int, new_size: Tuple[int, int]):
    """Checkpoint-import-time resize (JAX orbit2_tpu/ops/pos_embed.py:94-99,
    reference pos_embed.py:75-101): a numpy [1, L, D] comes back as numpy, a
    tensor as a tensor of its dtype and device."""
    if isinstance(pos_embed, np.ndarray):
        return interpolate_pos_embed_on_the_fly(
            torch.from_numpy(pos_embed), patch_size, new_size).numpy()
    return interpolate_pos_embed_on_the_fly(pos_embed, patch_size, new_size)
