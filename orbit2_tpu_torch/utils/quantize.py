"""Convert a trained fp model to its w8a8 serving twin (counterpart of
orbit2_tpu/utils/quantize.py).

    with torch.device("meta"):                     # the architecture, nothing drawn
        twin = ResSlimViT(..., quant="w8a8")
    twin.for_phase(...)                            # as the trained model's
    qmodel = w8a8_twin(twin, model.state_dict())   # or a reference-layout state dict
    with torch.no_grad():
        y = qmodel(x, in_vars, out_vars)

`quantize_state_dict` finds which tensors quantize from the twin's own state
dict: a QLinear's `<path>.weight_q` and `<path>.weight_scale` take the trained
`<path>.weight` through ops/quant.py::quantize_weight; every other tensor is
carried over unchanged. A missing key or a shape that differs raises
ValueError. Quantize from the fp32 weights (the JAX package quantizes its fp32
params): the scales of a bf16 copy differ. `fp32_sources` names the tensors
that must come from them: each QLinear's weight and its bias, which QLinear
keeps in fp32.
"""

from __future__ import annotations

from typing import Dict, Mapping, Set

import torch

from orbit2_tpu_torch.models.components.blocks import MOE_QUANT_ERROR, QLinear
from orbit2_tpu_torch.models.components.moe import MoEMlp
from orbit2_tpu_torch.ops.quant import quantize_weight


def _source(state_dict: Mapping[str, torch.Tensor], key: str, shape) -> torch.Tensor:
    if key not in state_dict:
        raise ValueError(f"{key}: missing in the trained state dict")
    src = state_dict[key]
    if tuple(src.shape) != tuple(shape):
        raise ValueError(f"{key}: shape {tuple(src.shape)} != expected {tuple(shape)}")
    return src


def quantize_state_dict(qmodel: torch.nn.Module, state_dict: Mapping[str, torch.Tensor],
                        device=None, partial: bool = False) -> Dict[str, torch.Tensor]:
    """`state_dict` (fp, reference layout) mapped onto `qmodel`'s w8a8
    layout, every tensor a copy on `device` (default: where it lies); the
    quantization runs there. partial=True maps only the keys whose source
    `state_dict` holds, so a twin can be filled piece by piece (the pieces
    together give the whole mapping, tensor for tensor). An MoE model or
    state dict raises JAX's ValueError: its experts have no int8 path, and
    would be left unquantized."""
    if (any(isinstance(m, MoEMlp) for m in qmodel.modules())
            or any(".moe_mlp." in key for key in state_dict)):
        raise ValueError(MOE_QUANT_ERROR)
    out: Dict[str, torch.Tensor] = {}
    for key, want in qmodel.state_dict().items():
        path, _, name = key.rpartition(".")
        if name == "weight_scale":
            continue  # made with its weight_q
        source = f"{path}.weight" if name == "weight_q" else key
        if partial and source not in state_dict:
            continue
        if name == "weight_q":
            w = _source(state_dict, source, want.shape)
            out[key], out[f"{path}.weight_scale"] = quantize_weight(w.to(device=device))
        else:
            out[key] = _source(state_dict, key, want.shape).to(device=device, copy=True)
    return out


def fp32_sources(qmodel: torch.nn.Module) -> Set[str]:
    """The keys of the trained state dict that `qmodel`'s QLinears take:
    each one's `<path>.weight` and, where it has one, `<path>.bias`."""
    return {f"{path}.{name}" for path, mod in qmodel.named_modules()
            if isinstance(mod, QLinear) for name in ("weight", "bias")
            if name == "weight" or mod.bias is not None}


def fill_twin(twin: torch.nn.Module, quantized: Mapping[str, torch.Tensor],
              device=None) -> torch.nn.Module:
    """`twin`, a quant="w8a8" model built on the meta device, holding
    `quantized` (quantize_state_dict's mapping, whole) on `device`,
    computing in its dtype, in eval mode."""
    twin.load_state_dict(quantized, strict=True, assign=True)
    return twin.to(device, twin.dtype).eval()


def w8a8_twin(twin: torch.nn.Module, state_dict: Mapping[str, torch.Tensor],
              device=None) -> torch.nn.Module:
    """`twin`, a quant="w8a8" model of the trained model's architecture and
    phase (built on the meta device, so nothing is drawn), holding
    quantize_state_dict(twin, state_dict) on `device` (default: where the
    state dict lies), computing in its dtype, in eval mode."""
    return fill_twin(twin, quantize_state_dict(twin, state_dict, device), device)
