"""Fused dropout: the CUDA kernel, its wrapper and its plain version.

Counterpart of orbit2_tpu/ops/dropout.py. `dropout(x, rate, training,
generator)` replaces nn.Dropout on the model's hot paths (pos_drop, the Mlp
hidden and output, the attention projection). The mask is made inside the
kernel (csrc/fused_dropout.cu) from a 64-bit seed drawn on the host, and the
backward regenerates it from the same seed: nothing but the seed is saved.

x is viewed as [rows, cols] with cols its last dim; the bits are those of
csrc/kernel_prng.cuh at (seed, stream 0, row, col), one Philox call per 8
columns, and the product is taken in fp32 and rounded once to x's dtype. On
a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from orbit2_tpu_torch.ops._nvcc import NvccKernel, NvccLibrary
from orbit2_tpu_torch.ops.kernel_prng import draw_seed, fold_seed, keep_mult, keep_threshold

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class FusedDropoutKernel(NvccKernel):
    """csrc/fused_dropout.cu: x * mask/keep from the seed's bits."""

    def __init__(self):
        super().__init__(NvccLibrary("fused_dropout.cu"), "orbit2_fused_dropout",
                         [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                          ctypes.c_int64, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_float,
                          ctypes.c_int])

    def __call__(self, x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
        if not x.is_cuda:
            raise ValueError("fused_dropout: x must be a CUDA tensor")
        if x.dtype not in _DTYPE_CODES:
            raise TypeError(f"fused_dropout takes bfloat16 or float32, got {x.dtype}")
        if x.dim() == 0:
            raise ValueError("fused_dropout needs at least one dim")
        x = x.contiguous()
        out = torch.empty_like(x)
        cols = x.shape[-1]
        rows = x.numel() // cols if cols else 0
        # the vector kernel: whole Philox calls of 8 columns, 16-byte vectors
        vec = cols % 8 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
        self.launch(x.device, _DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(), rows, cols,
                    seed & 0xFFFFFFFFFFFFFFFF, keep_threshold(rate), 1.0 / (1.0 - rate),
                    int(vec))
        return out


FUSED_DROPOUT = FusedDropoutKernel()


def dropout_reference(x: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    """Plain version: x * mult in fp32, rounded once to x's dtype; `mult` is
    the fp32 [rows, cols] multiplier of x's [rows, cols] view."""
    return (x.float() * mult.view(x.shape)).to(x.dtype)


def apply_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """The mask of `seed` on x: the kernel for a CUDA tensor, the plain
    version for a CPU one."""
    if x.device.type == "cpu":
        cols = x.shape[-1]
        return dropout_reference(x, keep_mult(seed, x.numel() // max(cols, 1), cols, rate))
    if x.device.type == "cuda":
        return FUSED_DROPOUT(x, seed, rate)
    raise ValueError(f"fused dropout needs a cpu or cuda tensor, got {x.device}")


class FusedDropout(torch.autograd.Function):
    """x * mask/keep; the backward reapplies the mask of the saved seed."""

    @staticmethod
    def forward(ctx, x, seed: int, rate: float):
        ctx.seed, ctx.rate = seed, rate
        return apply_dropout(x, seed, rate)

    @staticmethod
    def backward(ctx, grad):
        return apply_dropout(grad, ctx.seed, ctx.rate), None, None


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator], fold=()) -> torch.Tensor:
    """nn.Dropout on the hot paths. Identity, drawing no seed, when not
    training or at rate 0; otherwise the seed comes from `generator` (a CPU
    generator, so drawing it does not wait for the device), with the mesh
    coordinates `fold` folded in (kernel_prng.fold_seed)."""
    if not training or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a generator")
    return FusedDropout.apply(x, fold_seed(draw_seed(generator), fold), float(rate))


__all__ = ["FUSED_DROPOUT", "FusedDropout", "apply_dropout", "dropout", "dropout_reference"]
