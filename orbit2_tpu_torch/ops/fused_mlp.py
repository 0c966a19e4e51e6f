"""Fused MLP: the CUDA kernels, their wrappers and their plain versions.

Counterpart of orbit2_tpu/ops/fused_mlp.py. `fused_mlp(x, w1, b1, w2, b2)`
computes drop2(drop1(gelu_erf(x W1^T + b1)) W2^T + b2) over x [..., D] with
the weights in the port's Linear layout (w1 [F, D], w2 [D2, F]):
csrc/fused_mlp.cu holds the forward (K6a), dx (K6b) and dW (K6c) entries.
`FusedMlp` is the autograd.Function; it saves x, w1, b1, w2 and the two
dropout seeds, never the hidden activation.

The bf16 kernels (csrc/fused_mlp_hopper.cuh) run in stages over bf16
workspaces that live only for the call. The forward: F1 writes h_r =
bf16(gelu(x W1^T + b1) m1) once into a [T, F] workspace, F2 computes
bf16((h_r W2^T + b2) m2); `mlp_fwd_plan` gives their tiles and workspace,
and `fused_mlp_fwd_staged` is their plain version. The TPU kernel keeps the
hidden in VMEM; the unfused chain stores the same [T, F] tensor. The
backward: stage H computes h_pre = x W1^T and dh = do2 W2 once into a
workspace (h_r and dpre_r, [T, F] each, and per-128-token-tile partial sums
of db1 and db2), then dx = dpre_r W1, dW1 = dpre_r^T x and dW2 = do2^T h_r.
`mlp_bwd_plan` gives its tile plan and workspace, and
`fused_mlp_bwd_staged` is its plain version, stage by stage. That workspace
is what the unfused chain's autograd keeps for the same backward (GELU's
and fc2's inputs, [T, F] each). At dropout > 0, do2 = bf16(do m2) comes from
the fused dropout (ops/dropout.py), which draws the same bits. The fp32
kernels recompute the hidden per output tile and store no [T, F] tensor
(the parity dtype).

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
from orbit2_tpu_torch.ops.dropout import FUSED_DROPOUT
from orbit2_tpu_torch.ops.kernel_prng import draw_seed, keep_mult, keep_threshold

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
LIBRARY = NvccLibrary("fused_mlp.cu")  # all three kernels
_DIMS = [ctypes.c_int64] * 4
_DROPOUT_ARGS = [ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_float]
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
# tokens of a stage-H tile, and of a partial sum of db1 and db2
# (csrc/fused_mlp_hopper.cuh kBlockRows)
TOKEN_TILE = 128
# the hidden columns of a stage-H tile and the output tile edge of dx and dW
BLOCK_COLS = 128
# tokens of a partial sum of db2 (csrc/fused_mlp_hopper.cuh kSumRows)
BIAS2_ROWS = 64


def _tile_cols(n: int) -> int:
    """Output columns of a product tile: 256 where the width allows, else 128."""
    return 256 if n % 256 == 0 else 128


def mlp_fwd_plan(tokens: int, d: int, f: int, d2: int) -> dict:
    """The bf16 forward's tile plan and workspace (csrc/fused_mlp_hopper.cuh):
    F1's tiles (token tiles x F / BN) and F2's (token tiles x D2 / BN), tiles
    of 128 tokens x BN columns with BN 256 where the output width allows it,
    else 128; the workspace (h_r, bf16 [T, F]) and its bytes."""
    tiles = -(-tokens // TOKEN_TILE)
    bn1, bn2 = _tile_cols(f), _tile_cols(d2)
    return {"token_tiles": tiles,
            "hidden_tiles": tiles * (f // bn1),
            "out_tiles": tiles * (d2 // bn2),
            "tile_cols": {"hidden": bn1, "out": bn2},
            "workspace": {"h": (tokens, f)},
            "workspace_bytes": 2 * tokens * f}


def mlp_bwd_plan(tokens: int, d: int, f: int, d2: int) -> dict:
    """The bf16 backward's tile plan and workspace (csrc/fused_mlp_hopper.cuh):
    the tiles of stage H (hidden-column tiles x token tiles of 128 x 128),
    dx (token tiles x D / BN) and dW (the dW1 then the dW2 tiles of 128 x
    BN), with BN 256 where the output widths allow it, else 128; the
    workspace shapes (dpre_r and h_r bf16 [T, F]; the fp32 partial sums of
    db1, one row a token tile, and of db2, one row a BIAS2_ROWS slice) and
    its bytes."""
    tiles = -(-tokens // TOKEN_TILE)
    slices = -(-tokens // BIAS2_ROWS)
    dx_bn = _tile_cols(d)
    dw_bn = 256 if d % 256 == 0 and f % 256 == 0 else 128
    return {"token_tiles": tiles,
            "hidden_tiles": (f // BLOCK_COLS, tiles),
            "dx_tiles": tiles * (d // dx_bn),
            "dw_tiles": (f // TOKEN_TILE) * (d // dw_bn) + (d2 // TOKEN_TILE) * (f // dw_bn),
            "tile_cols": {"dx": dx_bn, "dw": dw_bn},
            "workspace": {"dpre": (tokens, f), "h": (tokens, f), "db1_part": (tiles, f),
                          "db2_part": (slices, d2)},
            "workspace_bytes": 2 * 2 * tokens * f + 4 * (tiles * f + slices * d2)}


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
    """csrc/fused_mlp.cu, forward (K6a): the dropped output of x. bf16: F1
    into a workspace h_r (mlp_fwd_plan), then F2, on the Hopper kernels; with
    keep_h it also returns h_r."""

    def __init__(self):
        super().__init__(LIBRARY, "orbit2_fused_mlp_fwd",
                         [ctypes.c_int] + [ctypes.c_void_p] * 7 + _DIMS + _DROPOUT_ARGS)

    def __call__(self, x, w1, b1, w2, b2, rate: float, seed1: int, seed2: int,
                 keep_h: bool = False):
        x, w1, b1, w2, b2 = (_aligned(t) for t in (x, w1, b1, w2, b2))
        tokens, d, f, d2 = _check_cuda(x, w1, b1, w2, b2)
        if tuple(b2.shape) != (d2,):
            raise ValueError(f"b2 {tuple(b2.shape)} is not [{d2}]")
        out = torch.empty((tokens, d2), dtype=x.dtype, device=x.device)
        h = None  # the bf16 workspace h_r (mlp_fwd_plan); the fp32 kernel needs none
        if x.dtype == torch.bfloat16:
            h = torch.empty((tokens, f), dtype=x.dtype, device=x.device)
        self.launch(x.device, _DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), b2.data_ptr(), out.data_ptr(), 0 if h is None else h.data_ptr(),
                    tokens, d, f, d2, *_dropout_args(rate, seed1, seed2))
        return (out, h) if keep_h else out


def _masked_do(do, rate: float, seed2: int):
    """do2 of the bf16 backward's products: bf16(do m2) by the fused dropout
    (K5), do itself at rate 0 or in fp32 (whose kernels mask do as they load
    it)."""
    if rate > 0.0 and do.dtype == torch.bfloat16:
        return FUSED_DROPOUT(do, seed2, rate)
    return do


class FusedMlpDxKernel(NvccKernel):
    """csrc/fused_mlp.cu, dx (K6b). bf16: stage H (unless the caller hands
    over `dpre`, stage H's dpre_r) and dx = dpre_r W1 on the Hopper kernels."""

    def __init__(self):
        super().__init__(LIBRARY, "orbit2_fused_mlp_dx",
                         [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] + _DIMS
                         + _DROPOUT_ARGS)

    def __call__(self, x, w1, b1, w2, do, rate: float, seed1: int, seed2: int,
                 do2: Optional[torch.Tensor] = None,
                 dpre: Optional[torch.Tensor] = None) -> torch.Tensor:
        x, w1, b1, w2, do = (_aligned(t) for t in (x, w1, b1, w2, do))
        tokens, d, f, d2 = _check_cuda(x, w1, b1, w2, do)
        do2 = _aligned(_masked_do(do, rate, seed2) if do2 is None else do2)
        have = dpre is not None
        if have and (dpre.shape != (tokens, f) or dpre.dtype != torch.bfloat16
                     or dpre.device != x.device or not dpre.is_contiguous()):
            raise ValueError(f"dpre must be a contiguous bf16 [{tokens}, {f}] on {x.device}")
        if not have and x.dtype == torch.bfloat16:
            dpre = torch.empty((tokens, f), dtype=torch.bfloat16, device=x.device)
        dx = torch.empty((tokens, d), dtype=x.dtype, device=x.device)
        self.launch(x.device, _DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), do.data_ptr(), do2.data_ptr(), dx.data_ptr(),
                    0 if dpre is None else dpre.data_ptr(), int(have), tokens, d, f, d2,
                    *_dropout_args(rate, seed1, seed2))
        return dx


class FusedMlpDwKernel(NvccKernel):
    """csrc/fused_mlp.cu, dW (K6c): (dw1, db1, dw2, db2) in fp32. bf16: stage H
    into a workspace (mlp_bwd_plan), then dW1 and dW2 on the Hopper kernels;
    with keep_dpre it also returns stage H's dpre_r, for FUSED_MLP_DX, and
    with keep_h stage H's h_r after it."""

    def __init__(self):
        super().__init__(LIBRARY, "orbit2_fused_mlp_dw",
                         [ctypes.c_int] + [ctypes.c_void_p] * 14 + _DIMS + _DROPOUT_ARGS)

    def __call__(self, x, w1, b1, w2, do, rate: float, seed1: int, seed2: int,
                 do2: Optional[torch.Tensor] = None, keep_dpre: bool = False,
                 keep_h: bool = False):
        x, w1, b1, w2, do = (_aligned(t) for t in (x, w1, b1, w2, do))
        tokens, d, f, d2 = _check_cuda(x, w1, b1, w2, do)
        do2 = _aligned(_masked_do(do, rate, seed2) if do2 is None else do2)
        kw = dict(dtype=torch.float32, device=x.device)
        dw1, db1 = torch.empty((f, d), **kw), torch.empty((f,), **kw)
        dw2, db2 = torch.empty((d2, f), **kw), torch.empty((d2,), **kw)
        ws = {}
        if x.dtype == torch.bfloat16:
            for name, shape in mlp_bwd_plan(tokens, d, f, d2)["workspace"].items():
                dtype = torch.float32 if name.endswith("_part") else torch.bfloat16
                ws[name] = torch.empty(shape, dtype=dtype, device=x.device)
        ptr = lambda name: ws[name].data_ptr() if ws else 0
        self.launch(x.device, _DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), do.data_ptr(), do2.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
                    dw2.data_ptr(), db2.data_ptr(), ptr("dpre"), ptr("h"), ptr("db1_part"),
                    ptr("db2_part"), tokens, d, f, d2, *_dropout_args(rate, seed1, seed2))
        kept = [ws.get(name) for name, keep in (("dpre", keep_dpre), ("h", keep_h)) if keep]
        return (dw1, db1, dw2, db2, *kept)


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


def _grow_rows(t: torch.Tensor, extra: int, fill: float) -> torch.Tensor:
    """t [n, C] with `extra` rows of `fill` appended."""
    return torch.cat([t, t.new_full((extra, t.shape[1]), fill)]) if extra else t


def fused_mlp_fwd_staged(x, w1, b1, w2, b2, m1: Optional[torch.Tensor] = None,
                         m2: Optional[torch.Tensor] = None, pad: bool = True):
    """The bf16 forward's stages in plain torch, for x [T, D]: F1, h_r =
    gelu(x W1^T + b1) m1 rounded to x's dtype [T', F], then F2, out =
    (h_r W2^T + b2) m2 in fp32 rounded once, of which the first T rows are
    returned with h_r: (out [T, D2], h_r). With `pad`, x first gets zero
    rows up to a multiple of TOKEN_TILE, as TMA fills them (T' rows; the
    masks get rows of ones), else T' = T."""
    tokens = x.shape[0]
    extra = (-tokens) % TOKEN_TILE if pad else 0
    h = F.gelu(_grow_rows(x.float(), extra, 0.0) @ w1.float().t() + b1.float())
    if m1 is not None:
        h = h * _grow_rows(m1, extra, 1.0)
    h = h.to(x.dtype)
    out = h.float() @ w2.float().t() + b2.float()
    if m2 is not None:
        out = out * _grow_rows(m2, extra, 1.0)
    return out.to(x.dtype)[:tokens], h


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


def _tile_sums(v: torch.Tensor) -> torch.Tensor:
    """Column sums of v [T, C] over each TOKEN_TILE rows: [ceil(T / 128), C]."""
    return torch.stack([chunk.sum(0) for chunk in v.split(TOKEN_TILE)])


def _sum_in_order(parts: torch.Tensor) -> torch.Tensor:
    """parts [n, C] summed over n in order, as the dW kernel sums them."""
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


def hidden_bwd_reference(x, w1, b1, w2, do, m1: Optional[torch.Tensor] = None,
                         m2: Optional[torch.Tensor] = None, pad: bool = True):
    """Plain version of stage H (csrc/fused_mlp_hopper.cuh): (dpre_r, h_r in
    x's dtype [T', F]; db1_part [n, F] fp32, the column sums of dpre over
    each token tile; do2 [T', D2] in x's dtype). With `pad`, x and do first
    get zero rows up to a multiple of TOKEN_TILE, as TMA fills them (T' rows;
    the masks get rows of ones), else T' = T."""
    rnd = lambda t: t.to(x.dtype)
    tokens = x.shape[0]
    extra = (-tokens) % TOKEN_TILE if pad else 0
    grow = lambda t, fill: _grow_rows(t, extra, fill)
    xf, dof = grow(x.float(), 0.0), grow(do.float(), 0.0)
    h_pre = xf @ w1.float().t() + b1.float()
    h = F.gelu(h_pre)
    do2 = rnd(dof if m2 is None else dof * grow(m2, 1.0))
    dh = do2.float() @ w2.float()
    if m1 is not None:
        m1 = grow(m1, 1.0)
        h = h * m1
        dh = dh * m1
    dpre = dh * _gelu_grad(h_pre)
    return rnd(dpre), rnd(h), _tile_sums(dpre), do2


def fused_mlp_bwd_staged(x, w1, b1, w2, do, m1: Optional[torch.Tensor] = None,
                         m2: Optional[torch.Tensor] = None, pad: bool = True):
    """The bf16 backward's stages in plain torch: stage H
    (hidden_bwd_reference), then dx = dpre_r W1, dW1 = dpre_r^T x, dW2 =
    do2^T h_r, db1 from stage H's partials in order and db2 = sum_t do m2
    (fp32). The same five outputs as fused_mlp_bwd_reference."""
    tokens = x.shape[0]
    dpre, h, db1_part, do2 = hidden_bwd_reference(x, w1, b1, w2, do, m1, m2, pad)
    xf = torch.cat([x.float(), x.new_zeros(dpre.shape[0] - tokens, x.shape[1]).float()])
    dpre = dpre.float()
    dx = (dpre @ w1.float()).to(x.dtype)[:tokens]
    db2 = (do.float() if m2 is None else do.float() * m2).sum(0)
    return (dx, dpre.t() @ xf, _sum_in_order(db1_part), do2.float().t() @ h.float(), db2)


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
    """(dx, dw1, db1, dw2, db2): the dx and dW kernels for CUDA tensors (in
    bf16 stage H runs once, in the dW call, and dx takes its dpre_r), the
    plain backward for CPU ones."""
    if _device_type(x, w1, b1, w2, do) == "cpu":
        masks = mlp_masks(rate, seed1, seed2, x.shape[0], w1.shape[0], w2.shape[0])
        return fused_mlp_bwd_reference(x, w1, b1, w2, do, *masks)
    # bf16: stage H once (in the dW call), its dpre_r handed on to dx
    do2 = _masked_do(_aligned(do), rate, seed2)
    dw1, db1, dw2, db2, dpre = FUSED_MLP_DW(x, w1, b1, w2, do, rate, seed1, seed2, do2=do2,
                                            keep_dpre=True)
    dx = FUSED_MLP_DX(x, w1, b1, w2, do, rate, seed1, seed2, do2=do2, dpre=dpre)
    return dx, dw1, db1, dw2, db2


class FusedMlp(torch.autograd.Function):
    """drop2(drop1(gelu(x W1^T + b1)) W2^T + b2) over x [T, D]; saves x, w1,
    b1, w2 and the seeds, and recomputes the hidden in the backward (the bf16
    forward's h_r workspace lives only for its call)."""

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
    """drop(gelu(x w1^T + b1) w2^T + b2), the hidden never saved for the
    backward. x [..., D]; w1 [F, D]; b1 [F]; w2 [D2, F]; b2 [D2]. Returns
    None where the JAX function declines on shape (a missing bias, tokens %
    8, D, F or D2 % 128); with drop_rate > 0 the two seeds are drawn from
    `generator` (the hidden mask's first), which must then be given."""
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


__all__ = ["FUSED_MLP_FWD", "FUSED_MLP_DX", "FUSED_MLP_DW", "FusedMlp", "TOKEN_TILE",
           "fused_mlp", "fused_mlp_fwd", "fused_mlp_bwd", "fused_mlp_bwd_reference",
           "fused_mlp_bwd_staged", "fused_mlp_fwd_staged", "fused_mlp_reference",
           "hidden_bwd_reference", "mlp_bwd_plan", "mlp_fwd_plan", "mlp_masks"]
