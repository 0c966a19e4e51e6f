"""Fused MLP of the PyTorch port (ops/fused_mlp.py, csrc/fused_mlp.cu).

CPU: the port's fused op (on CPU tensors, its plain versions) against the
JAX Pallas kernels run in interpret mode (`force=True`, blocks 32 x 128 at
T, D, F, D2 = 64, 128, 256, 128: several blocks in both grid dims), the
cases of tests/test_fused_mlp.py: forward and the five gradients at fp32,
dropout on the JAX kernel's own multipliers, mask statistics, shape
declines, [B, N, D] input, 384 rows; then the port's own Philox masks
against the unfused chain, and `Mlp(use_fused=True)` / a tiny ResSlimViT
against the JAX package on weights carried across by
state_dict_from_jax_params.

CUDA (marker `cuda`, skipped without a card): each kernel against its plain
version. Run without JAX's conftest on the chip machine:
`python -m pytest --noconftest -m cuda tests/test_torch_fused_mlp.py`.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import orbit2_tpu_torch.models.components.blocks as port_blocks
from orbit2_tpu_torch.models import ResSlimViT
from orbit2_tpu_torch.ops.dropout import FUSED_DROPOUT, dropout
from orbit2_tpu_torch.ops.fused_mlp import (
    FUSED_MLP_DW,
    FUSED_MLP_DX,
    FUSED_MLP_FWD,
    fused_mlp,
    fused_mlp_bwd,
    fused_mlp_bwd_reference,
    fused_mlp_fwd,
    fused_mlp_reference,
    mlp_masks,
)
from orbit2_tpu_torch.ops.kernel_prng import draw_seed
from orbit2_tpu_torch.training.checkpoint import state_dict_from_jax_params

T, D, FH, D2 = 64, 128, 256, 128
BT, BF = 32, 128
GRAD_NAMES = ("dx", "dw1", "db1", "dw2", "db2")
DEFAULT_VARS = ("land_sea_mask", "orography", "lattitude", "landcover",
                "total_precipitation_24hr", "2m_temperature_min", "2m_temperature_max")


def inputs(seed=0, t=T, d=D, f=FH, d2=D2):
    """numpy (x [t, d], w1 [d, f], b1, w2 [f, d2], b2) in the JAX layout."""
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(t, d)) * 0.5).astype(np.float32),
            (rng.normal(size=(d, f)) * d ** -0.5).astype(np.float32),
            (rng.normal(size=(f,)) * 0.1).astype(np.float32),
            (rng.normal(size=(f, d2)) * f ** -0.5).astype(np.float32),
            (rng.normal(size=(d2,)) * 0.1).astype(np.float32))


def to_port(x, w1, b1, w2, b2, requires_grad=False):
    """The same arrays as torch tensors, weights in the Linear layout."""
    ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, w1.T, b1, w2.T, b2)]
    return [t.requires_grad_(requires_grad) for t in ts]


def jax_fused(args, **kw):
    import jax.numpy as jnp

    from orbit2_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp

    kw.setdefault("block_t", BT)
    kw.setdefault("block_f", BF)
    return jax_fused_mlp(*(jnp.asarray(a) for a in args), force=True, **kw)


def jax_grads(args, **kw):
    """Gradients of sum(fused ** 2) in the port's layout (dw1 [F, D], dw2 [D2, F])."""
    import jax
    import jax.numpy as jnp

    g = jax.grad(lambda *a: jnp.sum(jax_fused(a, **kw) ** 2), argnums=tuple(range(5)))(
        *(jnp.asarray(a) for a in args))
    dx, dw1, db1, dw2, db2 = (np.asarray(a) for a in g)
    return dx, dw1.T, db1, dw2.T, db2


def port_grads(args, rate=0.0, generator=None):
    ts = to_port(*args, requires_grad=True)
    out = fused_mlp(*ts, drop_rate=rate, generator=generator)
    (out ** 2).sum().backward()
    return out.detach(), [t.grad.numpy() for t in ts]


def test_forward_matches_jax_kernel():
    args = inputs(0)
    want = np.asarray(jax_fused(args))
    with torch.no_grad():
        got = fused_mlp(*to_port(*args))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_gradients_match_jax_kernel():
    args = inputs(1)
    _, got = port_grads(args)
    for name, a, b in zip(GRAD_NAMES, got, jax_grads(args)):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4, err_msg=name)


def jax_masks(seed, rate, t=T):
    """The JAX kernel's multipliers [T, F] / [T, D2], rebuilt block by block
    with its own _mask1/_mask2."""
    import jax.numpy as jnp

    from orbit2_tpu.ops.fused_mlp import _mask1, _mask2

    s = jnp.asarray(seed, jnp.int32)
    m1 = np.concatenate([np.concatenate([np.asarray(_mask1(s, i, j, (BT, BF), rate))
                                         for j in range(FH // BF)], axis=1)
                         for i in range(t // BT)], axis=0)
    m2 = np.concatenate([np.asarray(_mask2(s, i, (BT, D2), rate)) for i in range(t // BT)])
    return torch.from_numpy(m1), torch.from_numpy(m2)


def test_dropout_matches_jax_kernel_on_its_own_masks():
    import jax
    import jax.numpy as jnp

    rate = 0.25
    args = inputs(2)
    key = jax.random.PRNGKey(5)
    seed = np.asarray(jax.random.randint(key, (2,), -2 ** 31, 2 ** 31 - 1, dtype=jnp.int32))
    m1, m2 = jax_masks(seed, rate)
    want = np.asarray(jax_fused(args, drop_rate=rate, rng=key))
    x, w1, b1, w2, b2 = to_port(*args)
    got = fused_mlp_reference(x, w1, b1, w2, b2, m1, m2)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-4)
    assert np.array_equal(got.numpy() == 0, want == 0)

    got_grads = fused_mlp_bwd_reference(x, w1, b1, w2, 2 * got, m1, m2)
    for name, a, b in zip(GRAD_NAMES, got_grads,
                          jax_grads(args, drop_rate=rate, rng=key)):
        np.testing.assert_allclose(a.numpy(), b, atol=5e-4, rtol=5e-4, err_msg=name)


def unfused_chain(x, w1, b1, w2, b2, rate, generator):
    """The port's unfused Mlp in training: F.linear, GELU, the fused dropout."""
    h = dropout(F.gelu(F.linear(x, w1, b1)), rate, True, generator)
    return dropout(F.linear(h, w2, b2), rate, True, generator)


def test_philox_masks_are_the_unfused_chains():
    rate = 0.3
    args = inputs(3)
    fused = to_port(*args, requires_grad=True)
    plain = to_port(*args, requires_grad=True)
    got = fused_mlp(*fused, drop_rate=rate, generator=torch.Generator().manual_seed(7))
    want = unfused_chain(*plain, rate, torch.Generator().manual_seed(7))
    assert torch.equal(got == 0, want == 0)
    assert 0 < (got == 0).float().mean().item() < 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    g = torch.from_numpy(np.random.default_rng(4).normal(size=got.shape).astype(np.float32))
    got.backward(g)
    want.backward(g)
    for name, a, b in zip(GRAD_NAMES, fused, plain):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-5, msg=name)


def test_mask_kept_fraction():
    rate = 0.5
    x, w1, b1, w2, b2 = to_port(*inputs(3))
    with torch.no_grad():
        out = fused_mlp(torch.ones_like(x), w1, b1, w2, b2, drop_rate=rate,
                        generator=torch.Generator().manual_seed(9))
    kept = (out != 0).float().mean().item()
    assert abs(kept - (1 - rate)) < 4 * np.sqrt(rate * (1 - rate) / out.numel())


def test_shape_declines_return_none():
    x, w1, b1, w2, b2 = to_port(*inputs(4))
    assert fused_mlp(x, w1, None, w2, b2) is None
    assert fused_mlp(x, w1, b1, w2, None) is None
    xb, w1b = to_port(*inputs(4, d=D + 3))[:2]
    assert fused_mlp(xb, w1b, b1, w2, b2) is None  # D % 128
    assert fused_mlp(x[:60], w1, b1, w2, b2) is None  # tokens % 8
    a = to_port(*inputs(4, f=FH + 8))
    assert fused_mlp(*a) is None  # F % 128
    a = to_port(*inputs(4, d2=D2 - 8))
    assert fused_mlp(*a) is None  # D2 % 128
    with pytest.raises(ValueError):
        fused_mlp(x, w1, b1, w2, b2, drop_rate=0.1)  # dropout without a generator


def test_batched_input_shape():
    args = inputs(6)
    xb = args[0].reshape(4, T // 4, D)
    want = np.asarray(jax_fused((xb,) + args[1:]))
    x, w1, b1, w2, b2 = to_port(*args)
    with torch.no_grad():
        got = fused_mlp(x.reshape(4, T // 4, D), w1, b1, w2, b2)
    assert got.shape == (4, T // 4, D2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_gradients_at_384_rows():
    args = inputs(3, t=384, f=512)
    _, got = port_grads(args)
    want = jax_grads(args, block_t=None, block_f=None)
    for name, a, b in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4, err_msg=name)


def test_cpu_tensors_take_the_plain_versions_without_launching():
    before = [k.launches for k in (FUSED_MLP_FWD, FUSED_MLP_DX, FUSED_MLP_DW)]
    x, w1, b1, w2, b2 = to_port(*inputs(5))
    out = fused_mlp_fwd(x, w1, b1, w2, b2, 0.1, 1, 2)
    grads = fused_mlp_bwd(x, w1, b1, w2, out, 0.1, 1, 2)
    assert [g.dtype for g in grads] == [torch.float32] * 5
    assert [k.launches for k in (FUSED_MLP_FWD, FUSED_MLP_DX, FUSED_MLP_DW)] == before


# ---- the fused path in the model ------------------------------------------------

def jax_model_pair(embed=128, depth=2, seed=0):
    """A tiny JAX ResSlimViT with perturbed params and the port's twin loaded
    from state_dict_from_jax_params; x [2, 7, 8, 16] (64 tokens)."""
    import jax
    import jax.numpy as jnp

    from orbit2_tpu.models import ResSlimViT as JaxResSlimViT

    kw = dict(default_vars=DEFAULT_VARS, img_size=(8, 16), in_channels=7, out_channels=3,
              superres_mag=4, patch_size=2, embed_dim=embed, depth=depth, decoder_depth=1,
              num_heads=2, learn_pos_emb=True, spatial_resolution=625.0)
    jm = JaxResSlimViT(attention_impl="xla", **kw)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 7, 8, 16)).astype(np.float32)
    params = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x), DEFAULT_VARS,
                     DEFAULT_VARS[4:], deterministic=True)["params"]
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32), params)
    tm = ResSlimViT(attention_impl="xla", **kw).eval()
    tm.load_state_dict(state_dict_from_jax_params(params, patch_size=2), strict=True)
    return jm, params, tm, x


@pytest.fixture
def fused_calls(monkeypatch):
    """Records, for each call of fused_mlp from the model, whether it ran (True)
    or declined (False)."""
    calls = []
    original = port_blocks.fused_mlp

    def spy(*args, **kwargs):
        out = original(*args, **kwargs)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(port_blocks, "fused_mlp", spy)
    return calls


def test_mlp_use_fused_matches_jax_mlp(fused_calls):
    import jax.numpy as jnp

    from orbit2_tpu.models.components.blocks import Mlp as JaxMlp

    _, params, tm, _ = jax_model_pair()
    x = np.random.default_rng(1).normal(size=(2, 32, 128)).astype(np.float32)
    want = JaxMlp(hidden_features=512, use_fused=True).apply(
        {"params": params["blocks_0"]["mlp"]}, jnp.asarray(x), deterministic=True)
    mlp = tm.blocks[0].mlp
    assert not port_blocks.Block(128, 2).mlp.use_fused  # Block leaves it off, as in JAX
    mlp.use_fused = True
    with torch.no_grad():
        got = mlp(torch.from_numpy(x))
    assert fused_calls == [True]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # the parameters are fc1/fc2 with or without the fused path
    assert sorted(n for n, _ in mlp.named_parameters()) == ["fc1.bias", "fc1.weight",
                                                            "fc2.bias", "fc2.weight"]


def test_mlp_use_fused_only_in_eval_with_erf(fused_calls):
    mlp = port_blocks.Mlp(128, 256, drop=0.1, use_fused=True)
    x = torch.randn(2, 8, 128, generator=torch.Generator().manual_seed(0))
    mlp(x, torch.Generator().manual_seed(1))  # training: the unfused chain
    port_blocks.Mlp(128, 256, gelu_tanh=True, use_fused=True).eval()(x)  # tanh: unfused
    assert fused_calls == []
    mlp.eval()(x[:, :7])  # 14 tokens: declined on shape, the plain chain runs
    assert fused_calls == [False]


def test_res_slimvit_with_fused_mlps_matches_jax(fused_calls):
    import jax.numpy as jnp

    jm, params, tm, x = jax_model_pair()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), DEFAULT_VARS,
                               DEFAULT_VARS[4:], deterministic=True))
    for m in tm.modules():
        if isinstance(m, port_blocks.Mlp):
            m.use_fused = True
    with torch.no_grad():
        got = tm(torch.from_numpy(x), DEFAULT_VARS, DEFAULT_VARS[4:]).numpy()
    assert fused_calls == [True, True]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# bf16: both sides read the same bf16 inputs, accumulate in fp32 and round h
# (and dpre, do2) to bf16 at the same points; sums in another order can move a
# rounding by one bf16 ulp, so atol 2e-2 of the largest value and rtol 2e-2.
# fp32: summation order only.
REL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
CARD_SHAPES = [(64, 128, 256, 128), (72, 256, 384, 128), (8, 128, 128, 384)]


def close(got, want, dtype, name):
    scale = want.float().abs().max().item()
    tol = REL[dtype]
    atol = tol * scale if dtype == torch.bfloat16 else tol
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=tol, msg=name)


def card_inputs(shape, dtype, device, seed=0):
    t, d, f, d2 = shape
    return [a.to(device, dtype) for a in to_port(*inputs(seed, t=t, d=d, f=f, d2=d2))]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["nodrop", "drop"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=["small", "ragged", "d2_gt_d"])
def test_kernels_match_plain_on_card(cuda, shape, dtype, rate):
    x, w1, b1, w2, b2 = card_inputs(shape, dtype, cuda)
    do = torch.randn(x.shape[0], w2.shape[0], generator=torch.Generator().manual_seed(1)).to(
        cuda, dtype)
    masks = mlp_masks(rate, 11, 12, x.shape[0], w1.shape[0], w2.shape[0], device=cuda)
    before = [k.launches for k in (FUSED_MLP_FWD, FUSED_MLP_DX, FUSED_MLP_DW)]
    out = fused_mlp_fwd(x, w1, b1, w2, b2, rate, 11, 12)
    grads = fused_mlp_bwd(x, w1, b1, w2, do, rate, 11, 12)
    again = fused_mlp_bwd(x, w1, b1, w2, do, rate, 11, 12)
    torch.cuda.synchronize()
    assert [k.launches for k in (FUSED_MLP_FWD, FUSED_MLP_DX, FUSED_MLP_DW)] == [
        before[0] + 1, before[1] + 2, before[2] + 2]
    want = fused_mlp_reference(x, w1, b1, w2, b2, *masks)
    close(out, want, dtype, "out")
    if rate:
        assert torch.equal(out == 0, want == 0)
    for name, a, b, c in zip(GRAD_NAMES, grads, fused_mlp_bwd_reference(x, w1, b1, w2, do, *masks),
                             again):
        assert a.dtype == (dtype if name == "dx" else torch.float32), name
        close(a, b, dtype, name)
        assert torch.equal(a, c), f"{name} differs between two runs"


@pytest.mark.cuda
def test_fused_zero_pattern_is_the_unfused_k5_chains_on_card(cuda):
    args = card_inputs((4104, 128, 256, 128), torch.bfloat16, cuda)
    with torch.no_grad():
        got = fused_mlp(*args, drop_rate=0.1, generator=torch.Generator().manual_seed(3))
        before = FUSED_DROPOUT.launches
        want = unfused_chain(*args, 0.1, torch.Generator().manual_seed(3))
    torch.cuda.synchronize()
    assert FUSED_DROPOUT.launches == before + 2
    g = torch.Generator().manual_seed(3)
    dropped = mlp_masks(0.1, draw_seed(g), draw_seed(g), 4104, 256, 128, device=cuda)[1] == 0
    # both drop exactly the mask's elements (a kept one is an exact zero by
    # cancellation about once in 2^24 elements: none expected at this size)
    assert torch.equal(got == 0, dropped) and torch.equal(want == 0, dropped)


@pytest.mark.cuda
def test_strided_batch_one_input_on_card(cuda):
    """A [1, N, D] view of a wider tensor goes through a contiguous copy."""
    x, w1, b1, w2, b2 = card_inputs((64, 128, 256, 128), torch.bfloat16, cuda)
    wide = torch.cat([x, x], dim=1).view(1, 64, 256)[..., 128:]
    got = fused_mlp(wide, w1, b1, w2, b2)
    close(got[0], fused_mlp_reference(x, w1, b1, w2, b2), torch.bfloat16, "out")


@pytest.mark.cuda
def test_kernels_raise_on_what_they_do_not_take(cuda):
    x, w1, b1, w2, b2 = card_inputs((64, 128, 256, 128), torch.float32, cuda)
    with pytest.raises(TypeError):
        fused_mlp_fwd(x.half(), w1.half(), b1.half(), w2.half(), b2.half())
    with pytest.raises(TypeError):
        fused_mlp_fwd(x.bfloat16(), w1, b1, w2, b2)
    with pytest.raises(ValueError):
        fused_mlp_fwd(x[:60], w1, b1, w2, b2)
