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
import torch.nn.functional as F

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


def pad_operands(xq: torch.Tensor, wq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """xq [M, K] and wq [N, K] padded with zeros to what torch._int_mm takes
    on CUDA: at least MIN_ROWS rows, K and N multiples of ALIGN. Zero rows
    are independent and zero columns of K add nothing, so the first [M, N]
    accumulators of the padded product are the product's, exactly."""
    m, k = xq.shape
    n = wq.shape[0]
    k_pad, m_pad, n_pad = -k % ALIGN, max(0, MIN_ROWS - m), -n % ALIGN
    if k_pad or m_pad:
        xq = F.pad(xq, (0, k_pad, 0, m_pad))
    if k_pad or n_pad:
        wq = F.pad(wq, (0, k_pad, 0, n_pad))
    return xq, wq


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq [M, K] int8 times wq [N, K] int8 transposed: the int32 [M, N]
    accumulators (exact: 127^2 K < 2^31 for K < 133,000), of any M, K and N.
    On CUDA the operands go in padded (pad_operands) and the product comes
    back sliced; the CPU's torch._int_mm takes them as they are."""
    m, n = xq.shape[0], wq.shape[0]
    if xq.device.type == "cpu":
        return torch._int_mm(xq, wq.t())
    xp, wp = pad_operands(xq, wq)
    return torch._int_mm(xp, wp.t())[:m, :n]


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
