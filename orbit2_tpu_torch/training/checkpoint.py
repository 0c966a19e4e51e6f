"""Checkpoints and weights across the two packages.

Checkpoints (counterparts of orbit2_tpu/training/checkpoint.py:41-204), in
the port's own format: `epoch_{e}/` is a directory holding one `torch.save`
file (CHECKPOINT_FILE) of {"model": state_dict, "optimizer": AdamW state,
"epoch": e}, every tensor on the host, read back with `torch.load(...,
weights_only=True)`. The port imports no JAX, so it cannot read an Orbax
checkpoint of the JAX package: a JAX run reaches the port through
`export_torch_state_dict`'s reference-layout npz (`load_state_npz`).
  * `save_checkpoint` copies CUDA tensors into pinned host buffers (one
    synchronisation), writes into a hidden temporary sibling and renames it
    into place, so a reader never sees half a checkpoint (Orbax commits by
    rename too). `async_save=True` copies every tensor to the host before
    it returns and writes in a background thread, so the training that goes
    on cannot change what is written; `wait_for_async_saves` joins the
    writer. Saves run one at a time, as Orbax's do.
  * `restore_checkpoint(path, template)` casts each tensor to the
    template's dtype, as Orbax casts to its template: an fp32-moment
    checkpoint resumes under bf16 moments, and the reverse.
  * `latest_checkpoint` and `prune_checkpoints` take JAX's names and cut-off;
    `latest_port_checkpoint`, which the Trainer and the CLIs search with,
    skips an epoch directory of the JAX package's Orbax format.
  * `load_pretrained_params` is the reference's fine-tune filter on the
    port's reference-layout state dicts.

`state_dict_from_jax_params` is the numpy-only counterpart of
orbit2_tpu/training/checkpoint.py::export_torch_state_dict: it maps the JAX
ResSlimViT param tree (numpy or array-likes, no JAX needed) onto the
reference state-dict layout that orbit2_tpu_torch's ResSlimViT carries, ready
for `load_state_dict(strict=True)`; an MoE Block's `moe_mlp` maps onto
`blocks.{b}.moe_mlp.{router_kernel,wi,bi,wo,bo}` without transposes (the JAX
export, `export_torch_state_dict`, reads every Block's `mlp` and so fails on
an MoE trunk). A pipelined model's tree, its Blocks stacked under
`blocks_stacked` [depth, ...] or `blocks_stacked_iv` [V, S, dc, ...], is
unstacked into `blocks.{i}` first (JAX's export reads only `blocks_{b}`
and so exports no Block of it). Any tree shaped like the params maps the
same way: JAX gradients (jax.grad of a loss in the params) land on the port's
parameter names, to be held against each parameter's .grad, and so do
optimizer moments.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from orbit2_tpu_torch.ops.pos_embed import interpolate_pos_embed_checkpoint
from orbit2_tpu_torch.parallel.pipeline import STACKED_IV_KEY, STACKED_KEY, unstack_any

log = logging.getLogger("orbit2_tpu_torch")

CHECKPOINT_FILE = "state.pt"
# where the CLIs save and look for checkpoints, as the JAX drivers do
# through the JAX Trainer's default (orbit2_tpu/training/trainer.py:30)
DEFAULT_CHECKPOINT_DIR = os.path.join("checkpoints", "climate")


def _map_tensors(obj, fn):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, Mapping):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    return obj


def _host_copy(state, own: bool):
    """`state` with every tensor on the host: device tensors copied into
    pinned buffers by non-blocking copies, followed by one synchronisation
    of each device (the buffers return to PyTorch's pinned-memory cache once
    written, for the next save); host tensors as they are, or cloned with
    own=True, for a write that runs while training goes on."""
    devices = set()

    def copy(t):
        t = t.detach()
        if t.device.type == "cpu":
            return t.clone() if own else t
        devices.add(t.device)
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        return out

    host = _map_tensors(state, copy)
    for device in devices:
        torch.cuda.synchronize(device)
    return host


def _write(path: str, host_state) -> None:
    """torch.save into a hidden temporary sibling, then renamed into place.
    An existing checkpoint at `path` is renamed aside first and removed after,
    so `path` holds either the old checkpoint, none, or the new one."""
    parent, name = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{name}.", dir=parent)
    old = None
    try:
        torch.save(host_state, os.path.join(tmp, CHECKPOINT_FILE))
        if os.path.exists(path):
            old = tempfile.mkdtemp(prefix=f".{name}.old.", dir=parent)
            os.replace(path, old)  # onto an empty directory
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if old is not None:
        shutil.rmtree(old)


class AsyncWriter:
    """One background checkpoint write at a time. `submit` first waits for
    the previous write, which bounds the host copies held to one checkpoint;
    `wait` joins the writer and raises what it raised. Driven from one
    training thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, path: str, host_state) -> None:
        self.wait()
        held = [host_state]

        def run():
            try:
                _write(path, held.pop())  # the host copies go once written
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, name=f"checkpoint {path}")
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error


_WRITER = AsyncWriter()


def save_checkpoint(path: str, state: Dict[str, Any], async_save: bool = False) -> None:
    """Writes `state` (nested dicts of tensors and numbers) to the directory
    `path` (JAX checkpoint.py:41-60). With async_save the host copies are
    made before this returns and written by a background thread."""
    path = os.path.abspath(path)
    if async_save:
        _WRITER.submit(path, _host_copy(state, own=True))
    else:
        _WRITER.wait()  # saves run one at a time
        _write(path, _host_copy(state, own=False))


def wait_for_async_saves() -> None:
    """Joins the background writer (JAX checkpoint.py:63-65)."""
    _WRITER.wait()


def _cast_like(state, template, where: str):
    if isinstance(state, Mapping) and isinstance(template, Mapping):
        return {k: _cast_like(v, template[k], f"{where}/{k}") if k in template else v
                for k, v in state.items()}
    if isinstance(state, torch.Tensor) and isinstance(template, torch.Tensor):
        if state.shape != template.shape:
            raise ValueError(f"checkpoint {where}: shape {tuple(state.shape)}, the template's "
                             f"{tuple(template.shape)}")
        return state.to(template.dtype)
    return state


def restore_checkpoint(path: str, template: Optional[Dict[str, Any]] = None):
    """The state saved at `path`, its tensors on the host (memory-mapped:
    what the caller does not touch is not read). With a template, each
    tensor is cast to the dtype of the template's tensor at the same place
    and must have its shape (JAX checkpoint.py:96-102)."""
    state = torch.load(os.path.join(os.path.abspath(path), CHECKPOINT_FILE), map_location="cpu",
                       weights_only=True, mmap=True)
    return state if template is None else _cast_like(state, template, path)


def _epochs(directory: str, prefix: str) -> List[Tuple[int, str]]:
    epochs = []
    for name in os.listdir(directory):
        if name.startswith(prefix):
            try:
                epochs.append((int(name[len(prefix):]), name))
            except ValueError:
                continue
    return epochs


def latest_checkpoint(directory: str, prefix: str = "epoch_") -> Optional[str]:
    """The checkpoint of the highest epoch under `directory`, None if there
    is none (JAX checkpoint.py:105-117)."""
    if not os.path.isdir(directory):
        return None
    best, best_e = None, -1
    for e, name in _epochs(directory, prefix):
        if e > best_e:
            best, best_e = os.path.join(directory, name), e
    return best


def latest_port_checkpoint(directory: str, prefix: str = "epoch_") -> Optional[str]:
    """The newest epoch checkpoint under `directory` that holds
    CHECKPOINT_FILE, None if there is none. An epoch directory without it
    (an Orbax checkpoint of the JAX package: the two share the default
    directory and the names) is skipped with a log line."""
    if not os.path.isdir(directory):
        return None
    for _, name in sorted(_epochs(directory, prefix), reverse=True):
        path = os.path.join(directory, name)
        if os.path.isfile(os.path.join(path, CHECKPOINT_FILE)):
            return path
        log.warning("skipping %s: it holds no %s (not a checkpoint of this package)", path,
                    CHECKPOINT_FILE)
    return None


def prune_checkpoints(directory: str, keep_last: int, prefix: str = "epoch_",
                      current_epoch: Optional[int] = None) -> None:
    """Keeps the newest `keep_last` epoch checkpoints (JAX checkpoint.py:
    68-93). Given `current_epoch`, the cut-off is by epoch number (delete
    <= current_epoch - keep_last), since an asynchronous save of the newest
    may not be committed yet; saves run one at a time, so what lies at or
    below the cut-off is written."""
    if not os.path.isdir(directory) or keep_last <= 0:
        return
    epochs = _epochs(directory, prefix)
    if current_epoch is not None:
        doomed = [n for e, n in epochs if e <= current_epoch - keep_last]
    else:
        doomed = [n for _, n in sorted(epochs)[:-keep_last]]
    for name in doomed:
        shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def _shape(mapping: Mapping[str, Any], key: str) -> Tuple[int, ...]:
    """The shape of mapping[key], without reading an NpzState member."""
    if isinstance(mapping, NpzState):
        return mapping.shape(key)
    return tuple(np.shape(mapping[key]))


def unstack_state_dict(state: Mapping[str, Any]) -> Mapping[str, Any]:
    """A reference-layout state dict whose Blocks lie stacked
    (`blocks_stacked.<key>` [depth, ...] or `blocks_stacked_iv.<key>` [V, S,
    dc, ...]) with them unstacked into `blocks.{i}.<key>`; `state` itself
    where nothing is stacked (an NpzState stays unread)."""
    stacked = {}
    for key in (STACKED_IV_KEY, STACKED_KEY):
        sub = {k[len(key) + 1:]: np.asarray(state[k]) for k in state
               if k.startswith(key + ".")}
        if sub:
            stacked[key] = sub
    if not stacked:
        return state
    rest = {k: v for k, v in state.items()
            if not k.startswith((STACKED_KEY + ".", STACKED_IV_KEY + "."))}
    for key, sub in stacked.items():
        for name, tree in unstack_any({key: sub}).items():
            rest.update({f"blocks.{name[len('blocks_'):]}.{k}": torch.from_numpy(np.array(a))
                         for k, a in tree.items()})
    return rest


def load_pretrained_params(state_dict: Mapping[str, torch.Tensor], pretrained: Mapping[str, Any],
                           patch_size: int, img_size=None, strict: bool = False,
                           keys: Optional[Sequence[str]] = None):
    """Fine-tune import with the reference's filter (JAX checkpoint.py:
    120-204, reference intermediate_downscaling.py:116-153), on
    reference-layout state dicts: a key of `pretrained` missing from
    `state_dict` is dropped; a key of another shape is dropped, except
    `pos_embed`, which is resized bicubically to `img_size`'s token grid;
    strict=True raises on a shape mismatch. The merged values take the
    target's dtype. Returns (merged state dict, {"used": [key], "dropped":
    [(reason, key)], "resized": [key]}).

    `keys` restricts the merge to those keys of `state_dict`: merged then
    holds only the ones `pretrained` fills, and only they are read from it
    (the report, made from shapes, covers every key). So a caller can merge
    a large state piece by piece from an NpzState, which reads a member
    when it is taken.

    The port's models, pipelined ones too, keep the Blocks in the reference
    layout; a source in the JAX pipeline's stacked layouts
    (`blocks_stacked.<Block key>` [depth, ...] or `blocks_stacked_iv.<Block
    key>` [V, S, dc, ...], as JAX converts, checkpoint.py:120-171) is
    unstacked into `blocks.{i}.<Block key>` first (`unstack_state_dict`)."""
    pretrained = unstack_state_dict(pretrained)
    used, dropped, resized = [], [], []
    merged = dict(state_dict) if keys is None else {}
    take = (lambda key: True) if keys is None else set(keys).__contains__
    for key in pretrained:
        if key not in state_dict:
            dropped.append(("missing", key))
            continue
        want = state_dict[key]
        shape = _shape(pretrained, key)
        if shape == tuple(want.shape):
            used.append(key)
            if take(key):
                merged[key] = torch.as_tensor(pretrained[key]).to(want.dtype)
        elif key.rsplit(".", 1)[-1] == "pos_embed" and img_size is not None:
            resized.append(key)
            if take(key):
                merged[key] = interpolate_pos_embed_checkpoint(
                    torch.as_tensor(pretrained[key]), patch_size, tuple(img_size)).to(want.dtype)
        else:
            dropped.append(("shape", key))
            if strict:
                raise ValueError(f"shape mismatch for {key}: {shape} vs {tuple(want.shape)}")
    return merged, {"used": used, "dropped": dropped, "resized": resized}


class NpzState(Mapping):
    """A reference-layout state dict saved as an npz of numpy arrays (the
    CLIs' --torch-npz), read member by member: `state[key]` reads that one
    array, `shape(key)` its shape, read with every member's header when the
    file is opened, so a merge holds one tensor of it at a time."""

    def __init__(self, path: str):
        self.path = path
        self._shapes: Dict[str, Tuple[int, ...]] = {}
        with np.load(path) as raw:
            for key in raw.files:
                with raw.zip.open(f"{key}.npy") as f:
                    version = np.lib.format.read_magic(f)
                    read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                            else np.lib.format.read_array_header_2_0)
                    self._shapes[key] = tuple(read(f)[0])

    def __getitem__(self, key: str) -> torch.Tensor:
        if key not in self._shapes:
            raise KeyError(key)
        with np.load(self.path) as raw:
            return torch.from_numpy(raw[key])

    def __iter__(self):
        return iter(self._shapes)

    def __len__(self) -> int:
        return len(self._shapes)

    def shape(self, key: str) -> Tuple[int, ...]:
        return self._shapes[key]


def load_state_npz(path: str) -> NpzState:
    """A reference-layout state dict saved as an npz of numpy arrays (the
    CLIs' --torch-npz), opened lazily: an NpzState."""
    return NpzState(path)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _put_hub(p: dict, stats: Optional[dict], fixed: Optional[dict],
             patch_size: Optional[int]) -> Dict[str, np.ndarray]:
    """The model hub's trees (JAX models/{resnet,unet,vit,baselines}.py)
    onto the port's reference keys: HWIO conv kernels to OIHW, dense kernels
    transposed, flax ConvTranspose kernels flipped and laid out as torch's
    [I, O, kH, kW] (it does not flip, torch does), BatchNorm scale/bias and,
    where `stats` (the batch_stats collection) is given, its running
    averages with num_batches_tracked 0."""
    sd: Dict[str, np.ndarray] = {}

    def linear(dst, sub):
        sd[f"{dst}.weight"] = sub["kernel"].T
        if "bias" in sub:
            sd[f"{dst}.bias"] = sub["bias"]

    def conv(dst, sub):
        sd[f"{dst}.weight"] = sub["kernel"].transpose(3, 2, 0, 1)
        if "bias" in sub:
            sd[f"{dst}.bias"] = sub["bias"]

    def conv_t(dst, sub):
        sd[f"{dst}.weight"] = sub["kernel"][::-1, ::-1].transpose(2, 3, 0, 1)
        sd[f"{dst}.bias"] = sub["bias"]

    def bn(dst, sub, st):
        sd[f"{dst}.weight"], sd[f"{dst}.bias"] = sub["scale"], sub["bias"]
        if st is not None:
            sd[f"{dst}.running_mean"], sd[f"{dst}.running_var"] = st["mean"], st["var"]
            sd[f"{dst}.num_batches_tracked"] = np.zeros((), np.int64)

    def sub_stats(st, name):
        return None if st is None else st.get(name)

    def residual(dst, sub, st):
        conv(f"{dst}.conv1.conv", sub["PeriodicConv2D_0"]["Conv_0"])
        conv(f"{dst}.conv2.conv", sub["PeriodicConv2D_1"]["Conv_0"])
        for i in (0, 1):
            if f"BatchNorm_{i}" in sub:
                bn(f"{dst}.norm{i + 1}", sub[f"BatchNorm_{i}"], sub_stats(st, f"BatchNorm_{i}"))
        if "shortcut" in sub:
            conv(f"{dst}.shortcut", sub["shortcut"])

    def block(dst, sub, st, res="res"):
        residual(f"{dst}.{res}", sub["ResidualBlock_0"], sub_stats(st, "ResidualBlock_0"))
        if "AttentionBlock_0" in sub:
            linear(f"{dst}.attn.projection", sub["AttentionBlock_0"]["Dense_0"])
            linear(f"{dst}.attn.output", sub["AttentionBlock_0"]["Dense_1"])

    def stem_and_head(st):
        conv("image_proj.conv", p["PeriodicConv2D_0"]["Conv_0"])
        if "BatchNorm_0" in p:
            bn("norm", p["BatchNorm_0"], sub_stats(st, "BatchNorm_0"))
        conv("final.conv", p["PeriodicConv2D_1"]["Conv_0"])

    def count(name):
        n = 0
        while f"{name}_{n}" in p:
            n += 1
        return n

    if "patch_embed" in p:  # VisionTransformer
        kern = p["patch_embed"]["kernel"]  # [C p p, D], features (C, p, p)-ordered
        sd["patch_embed.proj.weight"] = kern.T.reshape(kern.shape[1], -1, patch_size, patch_size)
        sd["patch_embed.proj.bias"] = p["patch_embed"]["bias"]
        sd["pos_embed"] = p["pos_embed"] if "pos_embed" in p else fixed["pos_embed"]
        _put_blocks(sd, p)
        sd["norm.weight"], sd["norm.bias"] = p["norm"]["scale"], p["norm"]["bias"]
        _put_head(sd, p)
    elif "DownBlock_0" in p:  # Unet
        stem_and_head(stats)
        n_res = count("Downsample") + 1
        n_blocks = count("DownBlock") // n_res
        j = down = 0
        for i in range(n_res):
            for _ in range(n_blocks):
                block(f"down.{j}", p[f"DownBlock_{down}"], sub_stats(stats, f"DownBlock_{down}"))
                j, down = j + 1, down + 1
            if i < n_res - 1:
                conv(f"down.{j}.conv", p[f"Downsample_{i}"]["Conv_0"])
                j += 1
        mid, mst = p["MiddleBlock_0"], sub_stats(stats, "MiddleBlock_0")
        residual("middle.res1", mid["ResidualBlock_0"], sub_stats(mst, "ResidualBlock_0"))
        if "AttentionBlock_0" in mid:
            linear("middle.attn.projection", mid["AttentionBlock_0"]["Dense_0"])
            linear("middle.attn.output", mid["AttentionBlock_0"]["Dense_1"])
        residual("middle.res2", mid["ResidualBlock_1"], sub_stats(mst, "ResidualBlock_1"))
        j = upb = ups = 0
        for i in reversed(range(n_res)):
            for _ in range(n_blocks + 1):
                block(f"up.{j}", p[f"UpBlock_{upb}"], sub_stats(stats, f"UpBlock_{upb}"))
                j, upb = j + 1, upb + 1
            if i > 0:
                conv_t(f"up.{j}.conv", p[f"Upsample_{ups}"]["ConvTranspose_0"])
                j, ups = j + 1, ups + 1
    elif "ResidualBlock_0" in p:  # ResNet
        stem_and_head(stats)
        for i in range(count("ResidualBlock")):
            residual(f"blocks.{i}", p[f"ResidualBlock_{i}"], sub_stats(stats, f"ResidualBlock_{i}"))
    elif set(p) == {"Dense_0"}:  # LinearRegression
        linear("linear", p["Dense_0"])
    else:
        raise KeyError(f"no port model has the JAX tree with top-level keys {sorted(p)}")
    return sd


def _put_blocks(sd: Dict[str, np.ndarray], p: dict) -> None:
    b = 0
    while f"blocks_{b}" in p:
        blk = p[f"blocks_{b}"]
        for name in ("norm1", "norm2"):
            sd[f"blocks.{b}.{name}.weight"] = blk[name]["scale"]
            sd[f"blocks.{b}.{name}.bias"] = blk[name]["bias"]
        pairs = [("attn.qkv", blk["attn"]["qkv"]), ("attn.proj", blk["attn"]["proj"])]
        if "moe_mlp" in blk:  # JAX's layouts, kept as they are
            for name, t in blk["moe_mlp"].items():
                sd[f"blocks.{b}.moe_mlp.{name}"] = t
        else:
            pairs += [("mlp.fc1", blk["mlp"]["fc1"]), ("mlp.fc2", blk["mlp"]["fc2"])]
        for dst, sub in pairs:
            sd[f"blocks.{b}.{dst}.weight"] = sub["kernel"].T
            if "bias" in sub:
                sd[f"blocks.{b}.{dst}.bias"] = sub["bias"]
        b += 1


def _put_head(sd: Dict[str, np.ndarray], p: dict) -> None:
    i = 0
    while f"head_{i}" in p:
        sd[f"head.{2 * i}.weight"] = p[f"head_{i}"]["kernel"].T
        sd[f"head.{2 * i}.bias"] = p[f"head_{i}"]["bias"]
        i += 1
    sd[f"head.{2 * i}.weight"] = p["head_out"]["kernel"].T
    sd[f"head.{2 * i}.bias"] = p["head_out"]["bias"]


def state_dict_from_jax_params(params_np: Dict[str, Any], patch_size: Optional[int] = None,
                               batch_stats: Optional[Dict[str, Any]] = None,
                               fixed: Optional[Dict[str, Any]] = None,
                               prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX model's param tree as the port model's state dict (module
    docstring). The model is told by the tree: the ResSlimViT or the ViT
    (both need `patch_size`), or a model-hub tree (ViT, Unet, ResNet,
    LinearRegression), whose BatchNorm running averages come from
    `batch_stats` and whose fixed pos_embed, if not learned, from `fixed`.
    `prefix` is put before every key: "backbone." for the downscaling
    presets behind utils/loaders.py::PreInterpolated."""
    p = unstack_any(_to_numpy(params_np))
    if "token_embed_kernel" not in p:
        sd = _put_hub(p, None if batch_stats is None else _to_numpy(batch_stats),
                      None if fixed is None else _to_numpy(fixed), patch_size)
        return {prefix + k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}
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

    _put_blocks(sd, p)
    put_ln("norm", p["norm"])
    _put_head(sd, p)

    put_conv("conv_out", p["conv_out"])
    put_conv("path2.0", p["path2_conv1"])
    put_conv("path2.3", p["path2_conv2"])
    return {prefix + k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}
