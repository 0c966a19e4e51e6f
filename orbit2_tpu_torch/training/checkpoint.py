"""Weights across the two packages.

`state_dict_from_jax_params` is the numpy-only counterpart of
orbit2_tpu/training/checkpoint.py::export_torch_state_dict: it maps the JAX
ResSlimViT param tree (numpy or array-likes, no JAX needed) onto the
reference state-dict layout that orbit2_tpu_torch's ResSlimViT carries, ready
for `load_state_dict(strict=True)`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def state_dict_from_jax_params(params_np: Dict[str, Any],
                               patch_size: int) -> Dict[str, torch.Tensor]:
    p = _to_numpy(params_np)
    sd: Dict[str, np.ndarray] = {}

    def put_linear(key_dst: str, sub: dict):
        sd[f"{key_dst}.weight"] = sub["kernel"].T
        if "bias" in sub:
            sd[f"{key_dst}.bias"] = sub["bias"]

    def put_conv(key_dst: str, sub: dict):
        sd[f"{key_dst}.weight"] = sub["kernel"].transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if "bias" in sub:
            sd[f"{key_dst}.bias"] = sub["bias"]

    def put_ln(key_dst: str, sub: dict):
        sd[f"{key_dst}.weight"] = sub["scale"]
        sd[f"{key_dst}.bias"] = sub["bias"]

    # stacked [V, p*p, D] -> per-variable Conv2d(1, D, p, p) weights
    tok_w, tok_b = p["token_embed_kernel"], p["token_embed_bias"]
    d = tok_w.shape[-1]
    for i in range(tok_w.shape[0]):
        sd[f"token_embeds.{i}.proj.weight"] = tok_w[i].T.reshape(d, 1, patch_size, patch_size)
        sd[f"token_embeds.{i}.proj.bias"] = tok_b[i]

    sd["var_embed"] = p["var_embed"]
    sd["var_query"] = p["var_query"]
    sd["pos_embed"] = p["pos_embed"]
    put_linear("spatial_embed", p["spatial_embed"])

    va = p["var_agg"]
    sd["var_agg.q.weight"] = va["q_kernel"].T
    if "q_bias" in va:
        sd["var_agg.q.bias"] = va["q_bias"]
    sd["var_agg.kv.weight"] = va["kv_kernel"].T
    if "kv_bias" in va:
        sd["var_agg.kv.bias"] = va["kv_bias"]
    put_linear("var_agg.proj", va["proj"])

    b = 0
    while f"blocks_{b}" in p:
        blk = p[f"blocks_{b}"]
        put_ln(f"blocks.{b}.norm1", blk["norm1"])
        put_ln(f"blocks.{b}.norm2", blk["norm2"])
        put_linear(f"blocks.{b}.attn.qkv", blk["attn"]["qkv"])
        put_linear(f"blocks.{b}.attn.proj", blk["attn"]["proj"])
        put_linear(f"blocks.{b}.mlp.fc1", blk["mlp"]["fc1"])
        put_linear(f"blocks.{b}.mlp.fc2", blk["mlp"]["fc2"])
        b += 1

    put_ln("norm", p["norm"])

    i = 0
    while f"head_{i}" in p:
        put_linear(f"head.{2 * i}", p[f"head_{i}"])
        i += 1
    put_linear(f"head.{2 * i}", p["head_out"])

    put_conv("conv_out", p["conv_out"])
    put_conv("path2.0", p["path2_conv1"])
    put_conv("path2.3", p["path2_conv2"])
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}
