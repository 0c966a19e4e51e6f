"""Fused MLP: the CUDA kernels, their wrappers and their plain versions.

Counterpart of orbit2_tpu/ops/fused_mlp.py. `fused_mlp(x, w1, b1, w2, b2)`
computes drop2(drop1(gelu_erf(x W1^T + b1)) W2^T + b2) over x [..., D] with
the weights in the port's Linear layout (w1 [F, D], w2 [D2, F]), without
storing the [T, F] hidden activation: csrc/fused_mlp.cu holds the forward
(K6a), dx (K6b) and dW (K6c) kernels. `FusedMlp` is the autograd.Function; it
saves x, w1, b1, w2 and the two dropout seeds, and its backward recomputes
the hidden.

The two seeds come from the generator in the unfused Mlp's order (the hidden
mask's first, then the output mask's). The mask of hidden element (t, f) is
ops/kernel_prng.py's at (seed1, stream 0, row t, col f) and of output
element (t, n) at (seed2, 0, t, n), the bits ops/dropout.py draws for the
unfused chain, so with the same seeds both paths drop the same elements.

`fused_mlp` returns None exactly where the JAX function declines on shape
(tokens % 8, D, F or D2 % 128, a missing bias; fused_mlp.py:500-510). The
JAX function also declines shapes over its 16 MB VMEM budget; this port runs
every shape its shape rules accept. On CPU tensors the wrappers compute the
plain versions; on CUDA tensors they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from orbit2_tpu_torch.ops._nvcc import NvccKernel, NvccLibrary
from orbit2_tpu_torch.ops.kernel_prng import draw_seed, keep_mult, keep_threshold

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
LIBRARY = NvccLibrary("fused_mlp.cu")  # all three kernels
_DIMS = [ctypes.c_int64] * 4
_DROPOUT_ARGS = [ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_float]
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _dropout_args(rate: float, seed1: int, seed2: int):
    if rate <= 0.0:
        return 0, 0, 0, 0, 0.0
    mask = 0xFFFFFFFFFFFFFFFF
    return 1, seed1 & mask, seed2 & mask, keep_threshold(rate), 1.0 / (1.0 - rate)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (the kernels load 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_cuda(x, w1, b1, w2, other) -> Tuple[int, int, int, int]:
    """(tokens, D, F, D2) of a kernel call, raising on what the kernels do not take."""
    ts = (x, w1, b1, w2, other)
    if not all(t.is_cuda for t in ts) or len({t.device for t in ts}) != 1:
        raise ValueError("fused mlp: every tensor must be on one CUDA device")
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in ts):
        raise TypeError(f"fused mlp takes bfloat16 or float32 tensors of one dtype, got "
                        f"{[t.dtype for t in ts]}")
    if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2 or b1.dim() != 1:
        raise ValueError(f"bad ranks x {tuple(x.shape)} w1 {tuple(w1.shape)} w2 {tuple(w2.shape)}")
    tokens, d = x.shape
    f, d2 = w1.shape[0], w2.shape[0]
    if w1.shape[1] != d or w2.shape[1] != f or b1.shape[0] != f:
        raise ValueError(f"x {tuple(x.shape)}, w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)} and "
                         f"w2 {tuple(w2.shape)} disagree")
    if tokens < 8 or tokens % 8 or d % 128 or f % 128 or d2 % 128:
        raise ValueError(f"fused mlp needs tokens % 8 == 0 and D, F, D2 % 128 == 0, got "
                         f"{(tokens, d, f, d2)}")
    return tokens, d, f, d2


class FusedMlpForwardKernel(NvccKernel):
    """csrc/fused_mlp.cu, forward (K6a): the dropped output of x."""

    def __init__(self):
        super().__init__(LIBRARY, "orbit2_fused_mlp_fwd",
                         [ctypes.c_int] + [ctypes.c_void_p] * 6 + _DIMS + _DROPOUT_ARGS)

    def __call__(self, x, w1, b1, w2, b2, rate: float, seed1: int, seed2: int) -> torch.Tensor:
        x, w1, b1, w2, b2 = (_aligned(t) for t in (x, w1, b1, w2, b2))
        tokens, d, f, d2 = _check_cuda(x, w1, b1, w2, b2)
        if tuple(b2.shape) != (d2,):
            raise ValueError(f"b2 {tuple(b2.shape)} is not [{d2}]")
        out = torch.empty((tokens, d2), dtype=x.dtype, device=x.device)
        self.launch(x.device, _DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), b2.data_ptr(), out.data_ptr(), tokens, d, f, d2,
                    *_dropout_args(rate, seed1, seed2))
        return out


class FusedMlpDxKernel(NvccKernel):
    """csrc/fused_mlp.cu, dx (K6b)."""

    def __init__(self):
        super().__init__(LIBRARY, "orbit2_fused_mlp_dx",
                         [ctypes.c_int] + [ctypes.c_void_p] * 6 + _DIMS + _DROPOUT_ARGS)

    def __call__(self, x, w1, b1, w2, do, rate: float, seed1: int, seed2: int) -> torch.Tensor:
        x, w1, b1, w2, do = (_aligned(t) for t in (x, w1, b1, w2, do))
        tokens, d, f, d2 = _check_cuda(x, w1, b1, w2, do)
        dx = torch.empty((tokens, d), dtype=x.dtype, device=x.device)
        self.launch(x.device, _DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), do.data_ptr(), dx.data_ptr(), tokens, d, f, d2,
                    *_dropout_args(rate, seed1, seed2))
        return dx


class FusedMlpDwKernel(NvccKernel):
    """csrc/fused_mlp.cu, dW (K6c): (dw1, db1, dw2, db2) in fp32."""

    def __init__(self):
        super().__init__(LIBRARY, "orbit2_fused_mlp_dw",
                         [ctypes.c_int] + [ctypes.c_void_p] * 9 + _DIMS + _DROPOUT_ARGS)

    def __call__(self, x, w1, b1, w2, do, rate: float, seed1: int, seed2: int):
        x, w1, b1, w2, do = (_aligned(t) for t in (x, w1, b1, w2, do))
        tokens, d, f, d2 = _check_cuda(x, w1, b1, w2, do)
        kw = dict(dtype=torch.float32, device=x.device)
        dw1, db1 = torch.empty((f, d), **kw), torch.empty((f,), **kw)
        dw2, db2 = torch.empty((d2, f), **kw), torch.empty((d2,), **kw)
        self.launch(x.device, _DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), do.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
                    db2.data_ptr(), tokens, d, f, d2, *_dropout_args(rate, seed1, seed2))
        return dw1, db1, dw2, db2


FUSED_MLP_FWD = FusedMlpForwardKernel()
FUSED_MLP_DX = FusedMlpDxKernel()
FUSED_MLP_DW = FusedMlpDwKernel()


# ---- plain versions -------------------------------------------------------------

def mlp_masks(rate: float, seed1: int, seed2: int, tokens: int, f: int, d2: int,
              device=None) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The fp32 multipliers (m1 [tokens, F], m2 [tokens, D2]) of two seeds, or
    (None, None) at rate 0."""
    if rate <= 0.0:
        return None, None
    return (keep_mult(seed1, tokens, f, rate, device=device),
            keep_mult(seed2, tokens, d2, rate, device=device))


def _gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """d/dh gelu_erf(h) = Phi(h) + h phi(h), fp32."""
    return 0.5 * (1.0 + torch.erf(h * math.sqrt(0.5))) + h * torch.exp(-0.5 * h * h) * _INV_SQRT_2PI


def fused_mlp_reference(x, w1, b1, w2, b2, m1: Optional[torch.Tensor] = None,
                        m2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain forward with the kernel's rounding points: fp32 products, the
    hidden rounded to x's dtype before the second product, + b2 and the
    output mask in fp32, one rounding. m1 [T, F] / m2 [T, D2] are fp32
    multipliers of the flattened tokens."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1]).float()
    h = F.gelu(xf @ w1.float().t() + b1.float())
    if m1 is not None:
        h = h * m1
    out = h.to(x.dtype).float() @ w2.float().t() + b2.float()
    if m2 is not None:
        out = out * m2
    return out.to(x.dtype).reshape(*shape[:-1], w2.shape[0])


def fused_mlp_bwd_reference(x, w1, b1, w2, do, m1: Optional[torch.Tensor] = None,
                            m2: Optional[torch.Tensor] = None):
    """Plain backward of the kernels, (dx in x's dtype; dw1, db1, dw2, db2 in
    fp32) for x [T, D] and do [T, D2]: do2 = do * m2 rounded to the dtype,
    dh = do2 W2 * m1, dpre = dh * gelu'(h_pre) with h_pre recomputed;
    dx = dpre_r W1, dW2 = do2^T h_r, dW1 = dpre_r^T x (r: rounded to the
    dtype), db1 = sum dpre, db2 = sum do * m2 (fp32)."""
    rnd = lambda t: t.to(x.dtype).float()
    xf = x.float()
    h_pre = xf @ w1.float().t() + b1.float()
    h = F.gelu(h_pre)
    do2 = do.float()
    if m1 is not None:
        h = h * m1
    if m2 is not None:
        do2 = do2 * m2
    db2 = do2.sum(0)
    do2 = rnd(do2)
    dw2 = do2.t() @ rnd(h)
    dh = do2 @ w2.float()
    if m1 is not None:
        dh = dh * m1
    dpre = dh * _gelu_grad(h_pre)
    db1 = dpre.sum(0)
    dpre = rnd(dpre)
    return (dpre @ w1.float()).to(x.dtype), dpre.t() @ xf, db1, dw2, db2


# ---- wrappers -------------------------------------------------------------------

def _device_type(*tensors) -> str:
    devices = {t.device.type for t in tensors}
    if devices in ({"cpu"}, {"cuda"}):
        return devices.pop()
    raise ValueError(f"fused mlp needs all tensors on one of cpu or cuda, got {devices}")


def fused_mlp_fwd(x, w1, b1, w2, b2, rate: float = 0.0, seed1: int = 0, seed2: int = 0):
    """[T, D2] of x [T, D]: the kernel for CUDA tensors, the plain version for CPU ones."""
    if _device_type(x, w1, b1, w2, b2) == "cpu":
        masks = mlp_masks(rate, seed1, seed2, x.shape[0], w1.shape[0], w2.shape[0])
        return fused_mlp_reference(x, w1, b1, w2, b2, *masks)
    return FUSED_MLP_FWD(x, w1, b1, w2, b2, rate, seed1, seed2)


def fused_mlp_bwd(x, w1, b1, w2, do, rate: float = 0.0, seed1: int = 0, seed2: int = 0):
    """(dx, dw1, db1, dw2, db2): the dx and dW kernels for CUDA tensors, the
    plain backward for CPU ones."""
    if _device_type(x, w1, b1, w2, do) == "cpu":
        masks = mlp_masks(rate, seed1, seed2, x.shape[0], w1.shape[0], w2.shape[0])
        return fused_mlp_bwd_reference(x, w1, b1, w2, do, *masks)
    return (FUSED_MLP_DX(x, w1, b1, w2, do, rate, seed1, seed2),
            *FUSED_MLP_DW(x, w1, b1, w2, do, rate, seed1, seed2))


class FusedMlp(torch.autograd.Function):
    """drop2(drop1(gelu(x W1^T + b1)) W2^T + b2) over x [T, D]; saves x, w1,
    b1, w2 and the seeds, and recomputes the hidden in the backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, rate: float, seed1: int, seed2: int):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.args = (rate, seed1, seed2)
        ctx.b2_dtype = b2.dtype
        return fused_mlp_fwd(x, w1, b1, w2, b2, rate, seed1, seed2)

    @staticmethod
    def backward(ctx, do):
        x, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = fused_mlp_bwd(x, w1, b1, w2, do.contiguous(), *ctx.args)
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(ctx.b2_dtype),
                None, None, None)


def fused_mlp(x, w1, b1, w2, b2, drop_rate: float = 0.0,
              generator: Optional[torch.Generator] = None) -> Optional[torch.Tensor]:
    """drop(gelu(x w1^T + b1) w2^T + b2) with the hidden never stored.
    x [..., D]; w1 [F, D]; b1 [F]; w2 [D2, F]; b2 [D2]. Returns None where the
    JAX function declines on shape (a missing bias, tokens % 8, D, F or
    D2 % 128); with drop_rate > 0 the two seeds are drawn from `generator`
    (the hidden mask's first), which must then be given."""
    if b1 is None or b2 is None:
        return None
    if drop_rate > 0.0 and generator is None:
        raise ValueError("dropout needs a generator")
    shape = x.shape
    d = shape[-1]
    tokens = math.prod(shape[:-1])
    f, d2 = w1.shape[0], w2.shape[0]
    if tokens % 8 or d % 128 or f % 128 or d2 % 128:
        return None
    seeds = (draw_seed(generator), draw_seed(generator)) if drop_rate > 0.0 else (0, 0)
    out = FusedMlp.apply(x.reshape(tokens, d), w1, b1.to(w1.dtype), w2, b2.to(w2.dtype),
                         float(drop_rate), *seeds)
    return out.reshape(*shape[:-1], d2)


__all__ = ["FUSED_MLP_FWD", "FUSED_MLP_DX", "FUSED_MLP_DW", "FusedMlp", "fused_mlp",
           "fused_mlp_fwd", "fused_mlp_bwd", "fused_mlp_reference", "fused_mlp_bwd_reference",
           "mlp_masks"]
