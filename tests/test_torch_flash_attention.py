"""Flash-attention forward of the PyTorch port.

CPU: the port's plain version (`flash_attention_reference`, the path its
wrapper takes for CPU tensors) against the JAX package's Pallas kernels run in
interpret mode, on the same numpy inputs, at fp32: o within atol 2e-5 and the
base-2 lse within atol 1e-5 (both sides sum in fp32 in different orders).

CUDA (marker `cuda`, skipped without a card): the hand-written kernel against
the plain version on the card. JAX is imported only inside the CPU parity
tests, so the CUDA cases run on a machine without JAX:
`python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py`.
"""

import math

import numpy as np
import pytest
import torch

from orbit2_tpu_torch.ops.flash_attention import (
    FLASH_FWD,
    flash_attention,
    flash_attention_fwd,
    flash_attention_reference,
)


def make_qkv(b, n_q, n_k, h, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, n_q, h, d)).astype(np.float32)
    k = rng.normal(size=(b, n_k, h, d)).astype(np.float32)
    v = rng.normal(size=(b, n_k, h, d)).astype(np.float32)
    return q, k, v


def jax_flash_fwd(q, k, v, block_q, block_k):
    """The JAX package's forward kernels (`_flash_fwd`, interpret mode on the
    CPU) on [B, N, H, D] numpy inputs, padded to blocks as its public wrapper
    pads them; returns (o [B, N_q, H, D], base-2 lse [B*H, N_q])."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from orbit2_tpu.ops import flash_attention as jfa

    b, n_q, h, d = q.shape
    n_k = k.shape[1]

    def to_bhnd(x, n_pad):
        x = jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, x.shape[1], d)
        return jnp.pad(x, ((0, 0), (0, n_pad - x.shape[1]), (0, 0)))

    nq_pad = math.ceil(n_q / block_q) * block_q
    nk_pad = math.ceil(n_k / block_k) * block_k
    o, lse = jfa._flash_fwd(
        to_bhnd(q, nq_pad), to_bhnd(k, nk_pad), to_bhnd(v, nk_pad),
        jnp.zeros((1,), jnp.int32), d ** -0.5, block_q, block_k, n_k, 0.0)
    o = np.asarray(o)[:, :n_q].reshape(b, h, n_q, d).transpose(0, 2, 1, 3)
    return o, np.asarray(lse)[:, 0, :n_q]


@pytest.mark.parametrize("n_q,n_k,block_k", [
    (128, 128, 128),   # one-shot kernel: kv fits one block
    (384, 384, 128),   # streaming kernel, three kv blocks
    (200, 200, 128),   # padded N: masked kv tail, unstored q rows
    (128, 300, 128),   # N_q != N_k, ragged kv
], ids=["oneshot", "multiblock", "padded", "rectangular"])
def test_reference_matches_jax_pallas(n_q, n_k, block_k):
    q, k, v = make_qkv(1, n_q, n_k, 2, 64)
    want_o, want_lse = jax_flash_fwd(q, k, v, 128, block_k)
    o, lse = flash_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v))
    np.testing.assert_allclose(o.numpy(), want_o, atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=0)


def test_public_wrapper_matches_jax_flash_attention():
    """The public o-only entry points of both packages at their default blocks."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from orbit2_tpu.ops.flash_attention import flash_attention as jax_flash

    q, k, v = make_qkv(2, 160, 160, 2, 32, seed=1)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_lse_is_base2_logsumexp():
    q, k, v = make_qkv(2, 33, 47, 3, 64, seed=2)
    q, k = torch.from_numpy(q), torch.from_numpy(k)
    _, lse = flash_attention_reference(q, k, torch.from_numpy(v), 0.3)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.3
    want = torch.logsumexp(s, dim=-1).reshape(-1, 33) / math.log(2.0)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=0)


def test_cpu_tensors_take_the_plain_version_without_launching():
    q, k, v = (torch.from_numpy(a) for a in make_qkv(1, 20, 20, 1, 64))
    before = FLASH_FWD.launches
    o, lse = flash_attention_fwd(q, k, v)
    want_o, want_lse = flash_attention_reference(q, k, v)
    assert FLASH_FWD.launches == before
    torch.testing.assert_close(o, want_o, atol=0, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=0, rtol=0)


def test_dropout_is_not_ported_yet():
    q, k, v = (torch.from_numpy(a) for a in make_qkv(1, 8, 8, 1, 64))
    with pytest.raises(NotImplementedError):
        flash_attention(q, k, v, dropout_rate=0.1)


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# bf16: both sides read the same bf16 inputs and accumulate in fp32; the kernel
# rounds p to bf16 for the tensor-core value product and o once at the end.
# fp32: summation order only.
TOL = {torch.bfloat16: dict(atol=1e-2, rtol=1e-2), torch.float32: dict(atol=1e-5, rtol=1e-5)}
LSE_TOL = dict(atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,n_q,n_k,h,d", [
    (2, 512, 512, 4, 64),
    (1, 1, 1, 1, 64),       # one query, one key
    (1, 100, 70, 2, 128),   # ragged tails, N_q != N_k
    (1, 300, 4100, 2, 256),  # many kv tiles at the widest head
])
def test_kernel_matches_plain_on_card(cuda, dtype, b, n_q, n_k, h, d):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in make_qkv(b, n_q, n_k, h, d, seed=3))
    before = FLASH_FWD.launches
    o, lse = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert FLASH_FWD.launches == before + 1
    want_o, want_lse = flash_attention_reference(q, k, v)
    torch.testing.assert_close(o, want_o, **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **LSE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_kernel_reads_strided_qkv_views(cuda, offset):
    """The views of a packed [B, N, 3, H, D] projection go in with no copy;
    offset 1 shifts every row off 16-byte alignment (the kernel's
    element-wise load path)."""
    b, n, h, d = 2, 130, 4, 64
    g = torch.Generator(device="cpu").manual_seed(0)
    flat = torch.randn(b * n * 3 * h * d + offset, generator=g).to(cuda, torch.bfloat16)
    q, k, v = flat[offset:].view(b, n, 3, h, d).unbind(2)
    assert not q.is_contiguous()
    o, lse = flash_attention_fwd(q, k, v)
    want_o, want_lse = flash_attention_reference(q, k, v)
    torch.testing.assert_close(o, want_o, **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, want_lse, **LSE_TOL)


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 1, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 8, 1, 96, device=cuda)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, q, q)
