"""w8a8 int8 matmul for serving (counterpart of orbit2_tpu/ops/quant.py).

The standard dynamic w8a8 scheme of the JAX package:
  * weights: per-output-channel symmetric int8, quantized once
    (utils/quantize.py);
  * activations: per-row (per-token) symmetric int8, quantized at each call;
  * the product accumulates in int32, then an fp32 rescale by (row scale x
    channel scale), the bias in fp32, and one cast to the output dtype.

The JAX package's product is an XLA int8 `dot_general`, not a Pallas kernel;
here it is the library's int8 product, `torch._int_mm` (on the CPU too), as
`F.linear` is nn.Dense's. The quantization and the rescale are plain torch
ops. No gradients: round() is piecewise constant, so the path is
serving-only (the modules raise in training mode).

Weights keep the port's Linear layout [out, in]: `quantize_weight(w)` equals
the JAX `quantize_weight(w.T)`, transposed, bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

WEIGHT_FLOOR = 1e-8
ACTIVATION_FLOOR = 1e-6
QMAX = 127.0
# torch._int_mm on CUDA takes more than 16 rows and K, N that are multiples of 8
MIN_ROWS = 17
ALIGN = 8


def _over_qmax(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127 as a true division on every device: CUDA turns a division
    by a Python scalar into a product with its rounded reciprocal, which
    differs from the quotient in the last bit."""
    return amax / amax.new_full((), QMAX)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization of a [out, in] weight:
    (wq int8 [out, in], scale fp32 [out]) with w ~= wq * scale[:, None]."""
    wf = w.float()
    scale = _over_qmax(wf.abs().amax(dim=1).clamp_min(WEIGHT_FLOOR))
    wq = torch.round(wf / scale[:, None]).clamp_(-QMAX, QMAX).to(torch.int8)
    return wq, scale


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of x [..., K]: (xq int8, scale fp32
    [..., 1]); round() is half to even, as jnp.round."""
    xf = x.float()
    scale = _over_qmax(xf.abs().amax(dim=-1, keepdim=True).clamp_min(ACTIVATION_FLOOR))
    return torch.round(xf / scale).clamp_(-QMAX, QMAX).to(torch.int8), scale


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq [M, K] int8 times wq [N, K] int8 transposed: the int32 [M, N]
    accumulators (exact: 127^2 K < 2^31 for K < 133,000). Fewer than
    MIN_ROWS rows are padded with zero rows, which are independent; a K or N
    off the multiple of 8 raises, there is no float fallback."""
    m, k = xq.shape
    n = wq.shape[0]
    if k % ALIGN or n % ALIGN:
        raise ValueError(f"int8 product [{m}, {k}] x [{k}, {n}]: K and N must be multiples "
                         f"of {ALIGN}")
    if m < MIN_ROWS:
        padded = xq.new_zeros(MIN_ROWS, k)
        padded[:m] = xq
        return torch._int_mm(padded, wq.t())[:m]
    return torch._int_mm(xq, wq.t())


def rescale(acc: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
            bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """acc * x_scale * w_scale (+ bias) in fp32, in that order, then one cast."""
    out = acc.float() * x_scale * w_scale
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def w8a8_matmul(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [..., K] times dequant(wq [N, K]) transposed, with dynamic per-row
    activation quantization: int32 accumulators, then the fp32 rescale and
    one cast to out_dtype (default x.dtype). Leading dims are flattened to
    rows."""
    xq, x_scale = quantize_rows(x.reshape(-1, x.shape[-1]))
    out = rescale(int8_matmul(xq, wq), x_scale, w_scale, bias, out_dtype or x.dtype)
    return out.reshape(*x.shape[:-1], wq.shape[0])
