"""Fused dropout of the PyTorch port (ops/dropout.py, csrc/fused_dropout.cu).

CPU: the port's plain K5 math, given the multiplier the JAX kernel uses
(rebuilt block by block from orbit2_tpu kernel_prng.keep_mult with the block
seeds of orbit2_tpu/ops/dropout.py:36), equals the JAX Pallas kernel
(`_core`, interpret mode) exactly, in value and in gradient, at fp32; then
the cases of tests/test_dropout.py on the port's own bits.

CUDA (marker `cuda`, skipped without a card): the kernel equals the plain
version bit for bit, forward and backward, on its vector path (rows of a
multiple of 8 columns, 16-byte aligned: one Philox call a unit of 8) with
a tail of units, and on its scalar path (odd and other column counts, an
unaligned base). Run without JAX's conftest on the chip machine:
`python -m pytest --noconftest -m cuda tests/test_torch_dropout.py`.
"""

import numpy as np
import pytest
import torch

from orbit2_tpu_torch.ops.dropout import (
    FUSED_DROPOUT,
    FusedDropout,
    apply_dropout,
    dropout,
    dropout_reference,
)
from orbit2_tpu_torch.ops.kernel_prng import keep_mult

RATE = 0.25


def jax_block_mult(seed, shape, rate):
    """The multiplier `_core` applies: keep_mult per (512, 1024) block with
    block seed seed + i * 1000003 + j * 7919 (int32 arithmetic)."""
    import jax.numpy as jnp

    from orbit2_tpu.ops import dropout as jd
    from orbit2_tpu.ops.kernel_prng import keep_mult as jax_keep_mult

    r, c = shape
    br, bc = min(jd.BLOCK_R, r), min(jd.BLOCK_C, c)
    s = jnp.int32(seed)
    rows = []
    for i in range(r // br):
        rows.append(np.concatenate([
            np.asarray(jax_keep_mult(s + jnp.int32(i) * 1000003 + jnp.int32(j) * 7919,
                                     (br, bc), rate))
            for j in range(c // bc)], axis=1))
    return np.concatenate(rows, axis=0)


def test_plain_math_with_jax_mask_equals_jax_kernel():
    import jax
    import jax.numpy as jnp

    from orbit2_tpu.ops.dropout import _core

    rng = np.random.default_rng(0)
    x = rng.normal(size=(1024, 2048)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    seed = 123457
    want, vjp = jax.vjp(lambda a: _core(a, jnp.asarray([seed], jnp.int32), RATE), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))

    mult = torch.from_numpy(jax_block_mult(seed, x.shape, RATE))
    xt = torch.from_numpy(x).requires_grad_()
    got = dropout_reference(xt, mult)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_dx))


def test_gradient_is_the_forward_mask():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32))
    out = FusedDropout.apply(x, 99, RATE)
    (out * w).sum().backward()
    mask = keep_mult(99, 64, 96, RATE)
    torch.testing.assert_close(out.detach(), x.detach() * mask, atol=0, rtol=0)
    torch.testing.assert_close(x.grad, w * mask, atol=0, rtol=0)


def test_scaling_and_determinism():
    x = torch.ones(512, 1024)
    o1, o2, o3 = apply_dropout(x, 0, RATE), apply_dropout(x, 0, RATE), apply_dropout(x, 1, RATE)
    assert torch.equal(o1, o2)
    assert (o1 - o3).abs().max() > 0
    keep = 1.0 - RATE
    assert set(torch.unique(o1).tolist()) <= {0.0, float(np.float32(1.0 / keep))}
    assert abs((o1 == 0).float().mean().item() - RATE) < 0.02
    assert abs(o1.mean().item() - 1.0) < 0.02


@pytest.mark.parametrize("shape", [(2, 512, 512), (3, 7, 200)], ids=["3d", "ragged"])
def test_nd_shapes_need_no_padding(shape):
    x = torch.ones(shape)
    o = apply_dropout(x, 7, RATE)
    assert o.shape == shape
    assert abs((o == 0).float().mean().item() - RATE) < 0.05
    # the bits are those of the [rows, cols] view with cols the last dim
    want = keep_mult(7, x.numel() // shape[-1], shape[-1], RATE).view(shape)
    assert torch.equal(o, want)


def test_bf16_rounds_once_from_fp32():
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(8, 40)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    got = apply_dropout(xb, 5, 0.1)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (xb.float() * keep_mult(5, 8, 40, 0.1)).to(torch.bfloat16))


def test_dispatcher_is_identity_without_training_or_rate():
    x = torch.ones(8, 128)
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    assert dropout(x, 0.5, False, g) is x
    assert dropout(x, 0.0, True, g) is x
    assert torch.equal(g.get_state(), state)  # no seed drawn
    out = dropout(x, 0.5, True, g)
    assert not torch.equal(g.get_state(), state)
    assert set(torch.unique(out).tolist()) <= {0.0, 2.0}
    with pytest.raises(ValueError):
        dropout(x, 0.5, True, None)


def test_cpu_tensors_take_the_plain_version_without_launching():
    before = FUSED_DROPOUT.launches
    apply_dropout(torch.ones(4, 8), 3, RATE)
    assert FUSED_DROPOUT.launches == before


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape,offset", [((64, 1024), 0), ((21, 200), 0), ((3, 5, 7), 0),
                                          ((16, 64), 1), ((5, 296), 0), ((9, 1001), 0),
                                          ((7, 100), 0), ((4100, 24), 0)],
                         ids=["aligned", "ragged", "3d", "unaligned", "vector_tail", "odd_cols",
                              "not_multiple_of_8", "many_rows"])
def test_kernel_matches_plain_bit_for_bit(cuda, dtype, shape, offset):
    n = int(np.prod(shape))
    flat = torch.randn(n + offset, generator=torch.Generator().manual_seed(0)).to(cuda, dtype)
    x = flat[offset:].view(shape)
    before = FUSED_DROPOUT.launches
    got = apply_dropout(x, 2 ** 40 + 17, 0.1)
    torch.cuda.synchronize()
    assert FUSED_DROPOUT.launches == before + 1
    want = dropout_reference(x, keep_mult(2 ** 40 + 17, n // shape[-1], shape[-1], 0.1,
                                          device=cuda))
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(64, 1024), (9, 1001)], ids=["vector", "scalar"])
def test_kernel_backward_is_the_forward_mask(cuda, dtype, shape):
    """The backward launches the same kernel on the gradient with the saved
    seed: bit-equal to the plain version's gradient."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=gen).to(cuda, dtype).requires_grad_()
    g = torch.randn(shape, generator=gen).to(cuda, dtype)
    before = FUSED_DROPOUT.launches
    FusedDropout.apply(x, 2 ** 33 + 5, 0.1).backward(g)
    torch.cuda.synchronize()
    assert FUSED_DROPOUT.launches == before + 2
    mult = keep_mult(2 ** 33 + 5, shape[0], shape[1], 0.1, device=cuda)
    assert torch.equal(x.grad, dropout_reference(g, mult))


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        apply_dropout(torch.ones(4, 8, device=cuda, dtype=torch.float16), 0, 0.1)
