"""Flash attention: the CUDA kernels, their wrappers and their plain versions.

Counterpart of orbit2_tpu/ops/flash_attention.py. Public layout is the JAX
package's: q [B, N_q, H, D], k/v [B, N_k, H, D]. The forward returns
(o [B, N_q, H, D] in q's dtype, lse fp32 [B*H, N_q]) where lse is the base-2
logsumexp of the scaled scores, the residual the backward kernels and ring
attention consume. Attention-probability dropout comes after the softmax
normalizer (l and lse sum the undropped p): its {0, 1/keep} multiplier for
score (query i, key j) of flat batch*head bh is the Philox mask of
ops/kernel_prng.py at (seed, stream bh, row i, col j), regenerated by the
backward kernels rather than stored.

`FlashAttention` is the autograd.Function: its forward saves q, k, v, o, lse
and the seed; its backward computes delta = rowsum(o * do) in plain torch (as
the JAX wrapper does) and runs the dq and dk/dv kernels. On CPU tensors every
wrapper computes its plain version; on CUDA tensors it launches its kernel
(csrc/flash_attn_fwd.cu, csrc/flash_attn_bwd.cu) or raises. There is no
fallback from a failed build or launch to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from orbit2_tpu_torch.ops._nvcc import NvccKernel, NvccLibrary
from orbit2_tpu_torch.ops.kernel_prng import keep_mult, keep_threshold

LOG2E = 1.4426950408889634
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_Y = 65535  # the kernels' grid takes B*H in its y dim


def flash_supported(q, k, v) -> bool:
    """Whether the kernels take these shapes and dtypes (the dispatcher's
    static check, as the JAX package's flash_supported): a head dim in
    HEAD_DIMS, bf16 or fp32 of one dtype, B*H within the grid's y dim."""
    return (q.shape[-1] in HEAD_DIMS and q.dtype in _DTYPE_CODES
            and k.dtype == v.dtype == q.dtype and q.shape[0] * q.shape[2] <= MAX_GRID_Y)


_DROPOUT_ARGS = [ctypes.c_int, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_float]


def _dropout_args(rate: float, seed: int):
    if rate <= 0.0:
        return 0, 0, 0, 0.0
    return 1, seed & 0xFFFFFFFFFFFFFFFF, keep_threshold(rate), 1.0 / (1.0 - rate)


def _strides(*tensors):
    return (ctypes.c_int64 * (3 * len(tensors)))(*(s for t in tensors for s in t.stride()[:3]))


def tma_layout(t: torch.Tensor) -> Tuple[Tuple[int, ...], Tuple[int, ...], bool]:
    """How the bf16 forward's TMA map sees a [B, N, H, D] operand: (its dims
    innermost first (D, H, N, B), the byte strides of H, N and B, whether the
    kernel needs a contiguous copy of it). TMA takes a 16-byte-aligned base,
    a contiguous last dim and byte strides that are positive multiples of 16.
    A dim of size 1 is never stepped, so its stride is replaced by one that
    a contiguous tensor could have."""
    b, n, h, d = t.shape
    sb, sn, sh, sd = t.stride()
    size = t.element_size()
    strides = []
    step = d * size  # the last stride taken, times its dim: a contiguous layout's
    for dim, stride in ((h, sh), (n, sn), (b, sb)):
        byte = stride * size if dim > 1 else step
        strides.append(byte)
        step = byte * dim
    needs_copy = (sd != 1 or t.data_ptr() % 16 != 0
                  or any(s <= 0 or s % 16 for s in strides))
    return (d, h, n, b), tuple(strides), needs_copy


def tma_operands(*tensors):
    """The bf16 tensors as the kernel reads them by TMA, each as it is or as a
    fresh contiguous copy (a new allocation is aligned) where tma_layout asks
    for one, followed by their element strides {b, n, h} for the C entry."""
    out, strides = [], []
    for t in tensors:
        _, byte_strides, needs_copy = tma_layout(t)
        if needs_copy:
            t = t.clone(memory_format=torch.contiguous_format)
            byte_strides = tma_layout(t)[1]
        out.append(t)
        strides.extend(s // t.element_size() for s in reversed(byte_strides))
    return (*out, (ctypes.c_int64 * len(strides))(*strides))


def kernel_operands(*tensors):
    """The operands as the flash kernels read them, followed by their element
    strides {b, n, h}: the bf16 kernels read by TMA, so a bf16 operand that
    breaks TMA's alignment rule (a view off 16-byte alignment, a strided `do`
    from autograd) goes in as a contiguous copy (tma_operands); fp32 ones go
    in as they are, read through their strides."""
    if tensors[0].dtype == torch.bfloat16:
        return tma_operands(*tensors)
    return (*tensors, _strides(*tensors))


class FlashForwardKernel(NvccKernel):
    """csrc/flash_attn_fwd.cu: (o, lse) of q, k, v."""

    def __init__(self):
        super().__init__(NvccLibrary("flash_attn_fwd.cu"), "orbit2_flash_attn_fwd",
                         [ctypes.c_int, ctypes.c_int64] + [ctypes.c_void_p] * 5
                         + [ctypes.c_int64] * 4 + [ctypes.c_void_p, ctypes.c_double]
                         + _DROPOUT_ARGS)

    def __call__(self, q, k, v, sm_scale: float, dropout_rate: float = 0.0, seed: int = 0):
        _check_cuda_inputs(q, k, v)
        q, k, v, strides = kernel_operands(q, k, v)
        b, n_q, h, d = q.shape
        o = torch.empty((b, n_q, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b * h, n_q), dtype=torch.float32, device=q.device)
        self.launch(q.device, _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, n_q, k.shape[1],
                    strides, float(sm_scale), *_dropout_args(dropout_rate, seed))
        return o, lse


BWD_LIBRARY = NvccLibrary("flash_attn_bwd.cu")  # both backward kernels
# The bf16 backward's tiles by head dim (csrc/flash_bwd_hopper.cuh at D 64
# and 128, the mma.sync kernels of csrc/flash_attn_bwd.cu at 256): the dq
# kernel's (query rows of a block, keys of a stage) and the dk/dv kernel's
# (keys of a block, query rows of a stage).
BWD_TILES = {64: {"dq": (128, 128), "dkv": (128, 64)},
             128: {"dq": (128, 64), "dkv": (128, 64)},
             256: {"dq": (64, 64), "dkv": (64, 64)}}


def tile_edge_lengths(d: int) -> Tuple[int, ...]:
    """Sequence lengths at the bf16 backward's tile edges for head dim d: 1,
    each tile size of BWD_TILES[d] less one, itself and plus one, and one
    past three of the largest tile."""
    sizes = {n for pair in BWD_TILES[d].values() for n in pair}
    lengths = {1, 3 * max(sizes) + 1}
    for n in sizes:
        lengths.update((n - 1, n, n + 1))
    return tuple(sorted(lengths))
_BWD_ARGS_HEAD = [ctypes.c_int, ctypes.c_int64] + [ctypes.c_void_p] * 6
_BWD_ARGS_TAIL = [ctypes.c_int64] * 4 + [ctypes.c_void_p, ctypes.c_double] + _DROPOUT_ARGS


class FlashBackwardDqKernel(NvccKernel):
    """csrc/flash_attn_bwd.cu, dq kernel (bf16 at D 64 and 128:
    csrc/flash_bwd_hopper.cuh)."""

    def __init__(self):
        super().__init__(BWD_LIBRARY, "orbit2_flash_attn_bwd_dq",
                         _BWD_ARGS_HEAD + [ctypes.c_void_p] + _BWD_ARGS_TAIL)

    def __call__(self, q, k, v, do, lse, delta, sm_scale, dropout_rate, seed):
        q, k, v, do, strides = kernel_operands(q, k, v, do)
        b, n_q, h, d = q.shape
        dq = torch.empty((b, n_q, h, d), dtype=q.dtype, device=q.device)
        self.launch(q.device, _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), b, h, n_q, k.shape[1], strides, float(sm_scale),
                    *_dropout_args(dropout_rate, seed))
        return dq


class FlashBackwardDkvKernel(NvccKernel):
    """csrc/flash_attn_bwd.cu, dk/dv kernel (bf16 at D 64 and 128:
    csrc/flash_bwd_hopper.cuh)."""

    def __init__(self):
        super().__init__(BWD_LIBRARY, "orbit2_flash_attn_bwd_dkv",
                         _BWD_ARGS_HEAD + [ctypes.c_void_p] * 2 + _BWD_ARGS_TAIL)

    def __call__(self, q, k, v, do, lse, delta, sm_scale, dropout_rate, seed):
        q, k, v, do, strides = kernel_operands(q, k, v, do)
        b, n_q, h, d = q.shape
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        self.launch(q.device, _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), b, h, n_q, k.shape[1], strides,
                    float(sm_scale), *_dropout_args(dropout_rate, seed))
        return dk, dv


FLASH_FWD = FlashForwardKernel()
FLASH_BWD_DQ = FlashBackwardDqKernel()
FLASH_BWD_DKV = FlashBackwardDkvKernel()


def _check_cuda_inputs(q, k, v, do=None) -> None:
    ts = (q, k, v) if do is None else (q, k, v, do)
    if not all(t.is_cuda for t in ts):
        raise ValueError("flash attention: q, k, v (and do) must all be CUDA tensors")
    if len({t.device for t in ts}) != 1:
        raise ValueError("flash attention: q, k, v (and do) are on different devices")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(
            f"flash attention takes bfloat16 or float32 tensors of one dtype, got "
            f"{[t.dtype for t in ts]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    b, n_q, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree on B, H or D")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} is not shaped like q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention supports head dims {HEAD_DIMS}, got {d}")
    if n_q < 1 or k.shape[1] < 1:
        raise ValueError("flash attention needs N_q >= 1 and N_k >= 1")
    if b * h > MAX_GRID_Y:
        raise ValueError(f"B*H = {b * h} exceeds the grid's {MAX_GRID_Y} limit")
    for name, t in zip(("q", "k", "v", "do"), ts):
        if t.stride(-1) != 1:
            raise ValueError(f"flash attention: {name} must be contiguous in its last dim")


# ---- plain versions -------------------------------------------------------------

def attention_mult(q, k, dropout_rate: float, seed: int) -> Optional[torch.Tensor]:
    """The dropout multiplier [B*H, N_q, N_k] (fp32) of q/k's shapes, or None."""
    if dropout_rate <= 0.0:
        return None
    b, n_q, h, _ = q.shape
    return keep_mult(seed, n_q, k.shape[1], dropout_rate, streams=b * h, device=q.device)


def _scores(q, k, scale):
    """Base-2 scaled scores [B, H, N_q, N_k] in fp32."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (scale * LOG2E)


def flash_attention_reference(q, k, v, sm_scale: Optional[float] = None,
                              mult: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward in fp32 math: (o in q.dtype, base-2 lse fp32 [B*H, N_q]).
    `mult` ([B*H, N_q, N_k] fp32) is the dropout multiplier applied to the
    normalized probabilities."""
    b, n_q, h, d = q.shape
    scale = d ** -0.5 if sm_scale is None else sm_scale
    s = _scores(q, k, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p / l
    if mult is not None:
        p = p * mult.view(b, h, n_q, -1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    lse = (m + torch.log2(l)).reshape(b * h, n_q)
    return o.to(q.dtype), lse


def flash_attention_bwd_reference(q, k, v, o, lse, do, sm_scale: float,
                                  mult: Optional[torch.Tensor] = None):
    """Plain backward in fp32 math from the saved (o, lse), the computation of
    the dq and dk/dv kernels: p = exp2(s - lse), dp = do v^T (times the
    dropout multiplier), ds = p (dp - delta) scale with delta = rowsum(o do)."""
    b, n_q, h, d = q.shape
    delta = attention_delta(o, do).view(b, h, n_q, 1)
    p = torch.exp2(_scores(q, k, sm_scale) - lse.view(b, h, n_q, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    pm = p
    if mult is not None:
        mult = mult.view(b, h, n_q, -1)
        pm, dp = p * mult, dp * mult
    ds = p * (dp - delta) * sm_scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", pm, do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(o, do) -> torch.Tensor:
    """rowsum(o * do) in fp32 as [B*H, N_q] (flash_attention.py:383)."""
    b, n_q, h, _ = o.shape
    # contiguous: at B = 1 the reshape alone would be a strided view
    return (o.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous().view(b * h, n_q)


# ---- wrappers -------------------------------------------------------------------

def _device_type(*tensors) -> str:
    devices = {t.device.type for t in tensors}
    if devices in ({"cpu"}, {"cuda"}):
        return devices.pop()
    raise ValueError(f"flash attention needs all tensors on one of cpu or cuda, got {devices}")


def flash_attention_fwd(q, k, v, sm_scale: Optional[float] = None, dropout_rate: float = 0.0,
                        seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): the CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    if _device_type(q, k, v) == "cpu":
        return flash_attention_reference(q, k, v, scale, attention_mult(q, k, dropout_rate, seed))
    return FLASH_FWD(q, k, v, scale, dropout_rate, seed)


def flash_attention_bwd(q, k, v, o, lse, do, sm_scale: float, dropout_rate: float = 0.0,
                        seed: int = 0, delta: Optional[torch.Tensor] = None):
    """(dq, dk, dv): the dq and dk/dv kernels for CUDA tensors, the plain
    backward for CPU ones. `delta`: attention_delta(o, do) where the caller
    has it (ring attention's steps share one)."""
    if _device_type(q, k, v, o, lse, do) == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, sm_scale,
                                             attention_mult(q, k, dropout_rate, seed))
    _check_cuda_inputs(q, k, v, do)
    want = (q.shape[0] * q.shape[2], q.shape[1])
    if lse.dtype != torch.float32 or tuple(lse.shape) != want or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 {want}, got {lse.dtype} {tuple(lse.shape)}")
    if delta is None:
        delta = attention_delta(o, do)
    dq = FLASH_BWD_DQ(q, k, v, do, lse, delta, sm_scale, dropout_rate, seed)
    dk, dv = FLASH_BWD_DKV(q, k, v, do, lse, delta, sm_scale, dropout_rate, seed)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """o = dropout(softmax(q k^T scale)) v with the flash kernels both ways."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float, dropout_rate: float, seed: int):
        o, lse = flash_attention_fwd(q, k, v, sm_scale, dropout_rate, seed)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (sm_scale, dropout_rate, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, sm_scale: Optional[float] = None, dropout_rate: float = 0.0,
                    seed: int = 0):
    """q/k/v: [B, N, H, D] -> o [B, N_q, H, D] (the JAX package's public
    signature, with the dropout seed in place of its PRNG key)."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    return FlashAttention.apply(q, k, v, float(scale), float(dropout_rate), int(seed))


def attention_flops(b: int, n_q: int, n_k: int, h: int, d: int) -> int:
    """Flops of the two products of one forward (the JAX CostEstimate's count)."""
    return 4 * b * h * n_q * n_k * d


__all__ = ["FLASH_FWD", "FLASH_BWD_DQ", "FLASH_BWD_DKV", "FlashAttention", "flash_attention",
           "flash_attention_fwd", "flash_attention_bwd", "flash_attention_reference",
           "flash_attention_bwd_reference", "attention_delta", "attention_mult",
           "attention_flops", "flash_supported", "kernel_operands", "tile_edge_lengths",
           "tma_layout", "tma_operands", "BWD_TILES", "LOG2E", "HEAD_DIMS", "MAX_GRID_Y"]
