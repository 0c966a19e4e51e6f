"""w8a8 serving in the port against the JAX package: the int8 weights and
scales bit for bit, the int32 accumulators exactly, the rescaled output within
atol = rtol = 1e-6 (fp32) or 1 ulp (bf16), and a tiny w8a8 ResSlimViT within
relative Frobenius error 1e-3 of JAX's `quant="w8a8"` model on
`quantize_params`, well under the ~1e-2 that the quantization itself costs.
Plus the counterparts of tests/test_quant.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbit2_tpu.models import ResSlimViT as JaxResSlimViT
from orbit2_tpu.ops import quant as jq
from orbit2_tpu.utils.quantize import quantize_params
from orbit2_tpu_torch.models import ResSlimViT
from orbit2_tpu_torch.models.components.blocks import QLinear
from orbit2_tpu_torch.ops.quant import (
    int8_matmul, pad_operands, quantize_rows, quantize_weight, w8a8_matmul)
from orbit2_tpu_torch.training.checkpoint import state_dict_from_jax_params
from orbit2_tpu_torch.utils.quantize import quantize_state_dict, w8a8_twin

IN_VARS = ("land_sea_mask", "orography", "lattitude", "landcover", "t2m")
OUT_VARS = ("t2m",)
H, W = 8, 16
TRUNK = (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2"))


def _operands(shape, seed):
    """x [..., K] with rows of very different magnitude, w [K, N] (JAX
    layout), bias [N]."""
    *lead, k, n = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*lead, k)) * rng.uniform(0.05, 20.0, size=(*lead, 1))
    w = rng.normal(size=(k, n)) * 0.05
    b = rng.normal(size=(n,))
    return x.astype(np.float32), w.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 48), (256, 768), (24, 3072)])
def test_quantize_weight_bit_equal_to_jax(shape):
    _, w, _ = _operands((1,) + shape, 0)
    w[:, 0] = 0.0  # a channel at the 1e-8 floor
    want_q, want_s = jq.quantize_weight(jnp.asarray(w))
    got_q, got_s = quantize_weight(torch.from_numpy(w.T.copy()))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q).T)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("shape", [(32, 64, 48), (2, 40, 128, 96), (5, 64, 32)],
                         ids=["rows32", "batched", "rows5-padded"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_w8a8_matmul_matches_jax(shape, dtype):
    x, w, b = _operands(shape, 1)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    wq, ws = jq.quantize_weight(jnp.asarray(w))
    xj = jnp.asarray(x, jdtype)
    # JAX's row quantization and int8 product (orbit2_tpu/ops/quant.py:63-71)
    xf = xj.astype(jnp.float32)
    xs = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-6) / 127.0
    xq = jnp.clip(jnp.round(xf / xs), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(xq, wq, (((xq.ndim - 1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    want = np.array(jq.w8a8_matmul(xj, wq, ws, jnp.asarray(b)).astype(jnp.float32))

    xt = torch.from_numpy(x).to(dtype)
    twq, tws = torch.from_numpy(np.asarray(wq).T.copy()), torch.from_numpy(np.array(ws))
    got_xq, got_xs = quantize_rows(xt)
    np.testing.assert_array_equal(got_xq.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(got_xs.numpy(), np.asarray(xs))
    got_acc = int8_matmul(got_xq.reshape(-1, shape[-2]), twq)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(acc).reshape(-1, shape[-1]))
    got = w8a8_matmul(xt, twq, tws, torch.from_numpy(b))
    assert got.dtype == dtype and tuple(got.shape) == tuple(want.shape)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    else:
        ulps = (got.view(torch.int16).int()
                - torch.from_numpy(want).bfloat16().view(torch.int16).int()).abs()
        assert ulps.max().item() <= 1


def _int8_operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(k, n)).astype(np.int8)  # JAX layout [K, N]
    return xq, wq


@pytest.mark.parametrize("m,k,n", [(32, 12, 6), (3, 12, 6), (17, 20, 9)],
                         ids=["k12-n6", "rows3-k12-n6", "k20-n9"])
def test_int8_product_takes_any_k_and_n_like_jax(m, k, n):
    """JAX's int8 dot_general takes any K and N (orbit2_tpu/ops/quant.py:
    49-75); so does int8_matmul, with int32 accumulators equal to JAX's. The
    operands the card's product takes (pad_operands: K and N to multiples of
    8, at least 17 rows) give the same accumulators on the CPU."""
    xq, wq = _int8_operands(m, k, n)
    want = np.asarray(jax.lax.dot_general(jnp.asarray(xq), jnp.asarray(wq),
                                          (((1,), (0,)), ((), ())),
                                          preferred_element_type=jnp.int32))
    txq, twq = torch.from_numpy(xq), torch.from_numpy(wq.T.copy())
    got = int8_matmul(txq, twq)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    xp, wp = pad_operands(txq, twq)
    assert xp.shape[0] >= 17 and xp.shape[1] % 8 == 0 and wp.shape[0] % 8 == 0
    assert xp.shape[1] == wp.shape[1] and (xp.shape[1] - k) < 8 and (wp.shape[0] - n) < 8
    np.testing.assert_array_equal(torch._int_mm(xp, wp.t())[:m, :n].numpy(), want)


def test_pad_operands_leaves_aligned_operands_as_they_are():
    xq, wq = (torch.from_numpy(a) for a in _int8_operands(32, 16, 8))
    wq = wq.t().contiguous()
    xp, wp = pad_operands(xq, wq)
    assert xp is xq and wp is wq


def test_w8a8_matmul_close_to_fp():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(32, 64)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(48, 64)) * 0.05).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(48,)).astype(np.float32))
    wq, ws = quantize_weight(w)
    assert wq.dtype == torch.int8 and ws.shape == (48,)
    ref = x @ w.T + b
    rel = ((w8a8_matmul(x, wq, ws, b) - ref).norm() / ref.norm()).item()
    assert rel < 0.02, rel


def test_w8a8_weight_roundtrip_bound():
    # per-channel symmetric: |w - wq*s| <= s/2 elementwise
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(8, 16)).astype(np.float32))
    wq, s = quantize_weight(w)
    err = (wq.float() * s[:, None] - w).abs()
    assert (err - s[:, None] / 2).max().item() <= 1e-6


def _jax_pair():
    model = JaxResSlimViT(
        default_vars=IN_VARS, img_size=(H, W), in_channels=len(IN_VARS), out_channels=1,
        superres_mag=2, patch_size=2, embed_dim=64, depth=2, decoder_depth=1, num_heads=4,
        learn_pos_emb=True, spatial_resolution=111.0, attention_impl="xla",
        drop_rate=0.0, drop_path=0.0, dtype=jnp.float32)
    return model, dataclasses.replace(model, quant="w8a8")


def _torch_model(quant="none", **kw):
    return ResSlimViT(IN_VARS, (H, W), len(IN_VARS), 1, superres_mag=2, patch_size=2,
                      embed_dim=64, depth=2, decoder_depth=1, num_heads=4, learn_pos_emb=True,
                      spatial_resolution=111.0, attention_impl="auto", drop_rate=0.0,
                      drop_path=0.0, quant=quant, **kw)


def _twin(model):
    """The w8a8 twin of a _torch_model, built on the meta device."""
    with torch.device("meta"):
        twin = _torch_model("w8a8")
    return w8a8_twin(twin, model.state_dict())


def test_w8a8_model_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, len(IN_VARS), H, W)).astype(np.float32)
    jm, jqm = _jax_pair()
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), IN_VARS, OUT_VARS,
                     deterministic=True)["params"]
    # perturbed, so that the zero-initialised var_query/var_embed hide no path
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32), params)
    qparams = quantize_params(jqm, params, jnp.asarray(x), IN_VARS, OUT_VARS)
    want = np.asarray(jqm.apply({"params": qparams}, jnp.asarray(x), IN_VARS, OUT_VARS,
                                deterministic=True))
    fp = np.asarray(jm.apply({"params": params}, jnp.asarray(x), IN_VARS, OUT_VARS,
                             deterministic=True))

    tm = _torch_model()
    tm.load_state_dict(state_dict_from_jax_params(params, patch_size=2), strict=True)
    qm = _twin(tm)
    sd = qm.state_dict()
    for mod, name in TRUNK:
        node = qparams["blocks_1"][mod][name]
        np.testing.assert_array_equal(sd[f"blocks.1.{mod}.{name}.weight_q"].numpy(),
                                      np.asarray(node["kernel_q"]).T)
        np.testing.assert_array_equal(sd[f"blocks.1.{mod}.{name}.weight_scale"].numpy(),
                                      np.asarray(node["kernel_scale"]))
    with torch.no_grad():
        got = qm(torch.from_numpy(x), IN_VARS, OUT_VARS).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    quant_cost = np.linalg.norm(want - fp) / np.linalg.norm(fp)
    assert rel <= 1e-3, rel
    assert quant_cost > 10 * rel, (quant_cost, rel)


def test_model_quant_forward_close_and_int8():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, len(IN_VARS), H, W))
                         .astype(np.float32))
    model = _torch_model(generator=torch.Generator().manual_seed(0)).eval()
    qmodel = _twin(model)
    sd = qmodel.state_dict()
    for mod, name in TRUNK:
        assert sd[f"blocks.0.{mod}.{name}.weight_q"].dtype == torch.int8
        assert f"blocks.0.{mod}.{name}.weight" not in sd
    with torch.no_grad():
        ref = model(x, IN_VARS, OUT_VARS)
        got = qmodel(x, IN_VARS, OUT_VARS)
    rel = ((got - ref).norm() / ref.norm()).item()
    assert rel < 0.05, rel
    assert not torch.allclose(got, ref)  # int8 is not a no-op


def test_scale_and_bias_stay_fp32_through_a_dtype_cast():
    qmodel = _torch_model("w8a8").to(torch.bfloat16)
    lin = qmodel.blocks[0].mlp.fc1
    assert isinstance(lin, QLinear)
    assert lin.weight_q.dtype == torch.int8
    assert lin.weight_scale.dtype == torch.float32 and lin.bias.dtype == torch.float32
    assert qmodel.blocks[0].norm1.weight.dtype == torch.bfloat16
    qmodel.half().float()
    assert lin.weight_scale.dtype == torch.float32 and lin.weight_q.dtype == torch.int8


def test_quantize_state_dict_refuses_a_mismatch():
    qmodel = _torch_model("w8a8")
    sd = _torch_model().state_dict()
    quantize_state_dict(qmodel, sd)
    with pytest.raises(ValueError, match="missing"):
        quantize_state_dict(qmodel, {k: v for k, v in sd.items() if "blocks.1.mlp.fc2" not in k})
    sd["norm.weight"] = torch.ones(3)
    with pytest.raises(ValueError, match="shape"):
        quantize_state_dict(qmodel, sd)


def test_quant_is_serving_only():
    qmodel = _torch_model("w8a8", generator=torch.Generator().manual_seed(0))
    x = torch.zeros(1, len(IN_VARS), H, W)
    # ValueError, not AssertionError: the guard must survive python -O
    with pytest.raises(ValueError, match="serving-only"):
        qmodel.train()(x, IN_VARS, OUT_VARS, dropout_gen=torch.Generator().manual_seed(1))


def test_unknown_quant_mode_raises():
    with pytest.raises(ValueError, match="unknown quant"):
        _torch_model("w4a16")
