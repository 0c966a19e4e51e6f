"""Flash attention of the PyTorch port, forward and backward.

CPU: the port's plain versions (the paths its wrappers take for CPU tensors)
against the JAX package's Pallas kernels run in interpret mode, on the same
numpy inputs, at fp32: o within atol 2e-5, the base-2 lse within atol 1e-5,
dq/dk/dv within atol=rtol 1e-4 (both sides sum in fp32 in different orders).
With dropout the port's plain math is given the JAX kernels' own multiplier,
rebuilt block by block, since the two packages draw different bits.

CUDA (marker `cuda`, skipped without a card): the hand-written kernels
against the plain versions on the card. JAX is imported only inside the CPU
parity tests, so the CUDA cases run on a machine without JAX:
`python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py`.
"""

import math

import numpy as np
import pytest
import torch

from orbit2_tpu_torch.ops.flash_attention import (
    BWD_TILES,
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    FLASH_FWD,
    attention_mult,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_reference,
    kernel_operands,
    tile_edge_lengths,
    tma_layout,
    tma_operands,
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


def torch_grads(q, k, v, do, fn):
    """(o, dq, dk, dv) of o = fn(q, k, v) under the cotangent do."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = fn(q, k, v)
    o.backward(torch.from_numpy(do))
    return o.detach().numpy(), q.grad.numpy(), k.grad.numpy(), v.grad.numpy()


def jax_grads(q, k, v, do, **kw):
    """(o, dq, dk, dv) of the JAX package's public flash_attention (Pallas
    forward and backward kernels, interpret mode) through jax.vjp."""
    import jax
    import jax.numpy as jnp

    from orbit2_tpu.ops.flash_attention import flash_attention as jax_flash

    o, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, **kw),
                     *(jnp.asarray(a) for a in (q, k, v)))
    return (np.asarray(o),) + tuple(np.asarray(g) for g in vjp(jnp.asarray(do)))


@pytest.mark.parametrize("n_q,n_k,d", [
    (256, 256, 64),
    (300, 300, 64),    # ragged N: padded blocks in JAX, masked tails here
    (300, 200, 128),   # N_q != N_k at head dim 128
], ids=["n256-d64", "n300-d64", "rect-d128"])
def test_backward_matches_jax_pallas(n_q, n_k, d):
    q, k, v = make_qkv(2, n_q, n_k, 2, d, seed=4)
    do = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)
    want = jax_grads(q, k, v, do)
    got = torch_grads(q, k, v, do, flash_attention)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=name)


def jax_dropout_mult(key, b, h, n_q, n_k, d, rate):
    """The multiplier the JAX kernels apply for `key`: the wrapper's seed
    (flash_attention.py:506-509), its block sizes (:494-504) and block seeds
    seed + bh * 1000003 + q_block * 7919 + k_block (:111), cropped to
    [B*H, N_q, N_k]."""
    import jax
    import jax.numpy as jnp

    from orbit2_tpu.ops import flash_attention as jfa
    from orbit2_tpu.ops.kernel_prng import keep_mult as jax_keep_mult

    bq = jfa.scale_block_for_head_dim(jfa.DEFAULT_BLOCK_Q_DROPOUT, d)
    bk = jfa.scale_block_for_head_dim(jfa.DEFAULT_BLOCK_K, d)
    while bq > 128 and bq > n_q:
        bq //= 2
    while bk > 128 and bk > n_k:
        bk //= 2
    seed = jax.random.randint(key, (1,), -2 ** 31, 2 ** 31 - 1, dtype=jnp.int32)[0]
    nqb, nkb = math.ceil(n_q / bq), math.ceil(n_k / bk)
    mult = np.zeros((b * h, nqb * bq, nkb * bk), np.float32)
    for bh in range(b * h):
        for i in range(nqb):
            for kb in range(nkb):
                block_seed = seed + jnp.int32(bh) * 1000003 + jnp.int32(i) * 7919 + jnp.int32(kb)
                mult[bh, i * bq:(i + 1) * bq, kb * bk:(kb + 1) * bk] = np.asarray(
                    jax_keep_mult(block_seed, (bq, bk), rate))
    return torch.from_numpy(mult[:, :n_q, :n_k].copy())


@pytest.mark.parametrize("n_q,n_k,d", [(256, 256, 64), (300, 200, 128)],
                         ids=["n256-d64", "rect-d128"])
def test_dropout_matches_jax_pallas_on_its_mask(n_q, n_k, d):
    """Dropout after the normalizer, lse unchanged, dp masked, the delta
    identity: the port's plain forward and backward on the JAX kernels' own
    multiplier equal the JAX kernels."""
    import jax

    b, h, rate = 1, 2, 0.1
    key = jax.random.PRNGKey(11)
    q, k, v = make_qkv(b, n_q, n_k, h, d, seed=6)
    do = np.random.default_rng(7).normal(size=q.shape).astype(np.float32)
    want = jax_grads(q, k, v, do, dropout_rate=rate, dropout_rng=key)
    mult = jax_dropout_mult(key, b, h, n_q, n_k, d, rate)
    scale = d ** -0.5
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash_attention_reference(qt, kt, vt, scale, mult)
    _, want_lse = flash_attention_reference(qt, kt, vt, scale)
    torch.testing.assert_close(lse, want_lse, atol=0, rtol=0)
    np.testing.assert_allclose(o.numpy(), want[0], atol=2e-5, rtol=0)
    grads = flash_attention_bwd_reference(qt, kt, vt, o, lse, dot, scale, mult)
    for name, a, w in zip(("dq", "dk", "dv"), grads, want[1:]):
        np.testing.assert_allclose(a.numpy(), w, atol=1e-4, rtol=1e-4, err_msg=name)


def sdpa_masked(q, k, v, mult):
    """Autograd reference: softmax attention with the given probability multiplier."""
    b, n_q, h, d = q.shape
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5, dim=-1)
    if mult is not None:
        p = p * mult.view(b, h, n_q, -1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def test_dropout_gradients_match_masked_reference():
    """The autograd.Function with dropout (plain path: the mask regenerated in
    the backward from the seed) vs autograd of SDPA with the same mask."""
    n, d, rate, seed = 256, 64, 0.25, 2 ** 33 + 5
    q, k, v = make_qkv(1, n, n, 1, d, seed=7)
    q, k = q * 0.3, k * 0.3
    do = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    mult = attention_mult(torch.from_numpy(q), torch.from_numpy(k), rate, seed)
    got = torch_grads(q, k, v, do, lambda a, b, c: flash_attention(a, b, c, dropout_rate=rate,
                                                                   seed=seed))
    want = torch_grads(q, k, v, do, lambda a, b, c: sdpa_masked(a, b, c, mult))
    for name, a, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, w, atol=2e-5, rtol=2e-5, err_msg=name)


def test_gradients_with_padding():
    q, k, v = make_qkv(1, 160, 160, 1, 64, seed=3)
    do = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    got = torch_grads(q, k, v, do, flash_attention)
    want = torch_grads(q, k, v, do, lambda a, b, c: sdpa_masked(a, b, c, None))
    for name, a, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, w, atol=2e-5, rtol=2e-5, err_msg=name)


def test_cpu_backward_takes_the_plain_version_without_launching():
    q, k, v = (torch.from_numpy(a) for a in make_qkv(1, 20, 30, 2, 64))
    do = torch.ones_like(q)
    o, lse = flash_attention_fwd(q, k, v, 0.125, 0.1, 3)
    before = (FLASH_BWD_DQ.launches, FLASH_BWD_DKV.launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, 0.125, 0.1, 3)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, 0.125,
                                         attention_mult(q, k, 0.1, 3))
    assert (FLASH_BWD_DQ.launches, FLASH_BWD_DKV.launches) == before
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=0, rtol=0)


@pytest.mark.parametrize("case", ["packed", "packed_b1", "contiguous", "contiguous_b1",
                                  "unaligned"])
def test_tma_layout(case):
    """The dims and byte strides of the bf16 forward's TMA maps, and when the
    wrapper must copy an operand first: the q/k/v views of the packed
    [B, N, 3, H, D] projection (the main path) go in as they are; an
    operand whose base is off 16-byte alignment is copied."""
    b, n, h, d = (1 if case.endswith("b1") else 2), 130, 4, 64
    offset = 1 if case == "unaligned" else 0
    flat = torch.zeros(b * n * 3 * h * d + 16, dtype=torch.bfloat16)
    base = flat[8 - flat.data_ptr() % 16 // 2:]  # 16-byte aligned
    if case.startswith("contiguous"):
        t = base[:b * n * h * d].view(b, n, h, d)
        want = (2 * d, 2 * h * d, 2 * n * h * d)
    else:
        t = base[offset:offset + b * n * 3 * h * d].view(b, n, 3, h, d)[:, :, 1]
        want = (2 * d, 2 * 3 * h * d, 2 * n * 3 * h * d)
    dims, strides, needs_copy = tma_layout(t)
    assert dims == (d, h, n, b)
    assert strides == want
    assert needs_copy == (case == "unaligned")
    if not needs_copy:
        assert all(s % 16 == 0 for s in strides) and t.data_ptr() % 16 == 0


def test_tma_layout_replaces_the_strides_of_size_one_dims():
    """A dim of size 1 is never stepped: its stride (here one that breaks
    TMA's rule) becomes a contiguous one, and the operand needs no copy."""
    t = torch.zeros(7 * 320, dtype=torch.bfloat16).as_strided((1, 7, 1, 64), (3, 320, 1, 1))
    dims, strides, needs_copy = tma_layout(t)
    assert dims == (64, 1, 7, 1)
    assert strides == (128, 640, 640 * 7)
    assert not needs_copy


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_tma_operands_of_the_probes_layout(offset):
    """The probes' [BH, N, 64] operands, seen as K1's [B = BH, N, H = 1, 64]:
    an aligned contiguous one goes in as it is with element strides
    {N 64, 64, 64}; one off 16-byte alignment goes in as a contiguous copy
    with the same strides."""
    bh, n = 3, 192
    flat = torch.arange(bh * n * 64 + 16, dtype=torch.float32).to(torch.bfloat16)
    base = flat[8 - flat.data_ptr() % 16 // 2 + offset:]
    q = base[:bh * n * 64].view(bh, n, 64)
    got, strides = tma_operands(q[:, :, None])
    assert tuple(got.shape) == (bh, n, 1, 64)
    assert list(strides) == [n * 64, 64, 64]
    assert (got.data_ptr() == q.data_ptr()) == (offset == 0)
    assert got.data_ptr() % 16 == 0
    torch.testing.assert_close(got[:, :, 0], q, atol=0, rtol=0)


@pytest.mark.parametrize("case", ["bf16-aligned", "bf16-unaligned", "bf16-strided-do", "fp32"])
def test_kernel_operands(case):
    """The backward's operand rule: bf16 operands go in by TMA, as they are
    where TMA's rule allows (the packed qkv views, a strided `do` whose rows
    are 16-byte aligned) and as contiguous copies where it does not; fp32
    ones go in as they are, with their own element strides."""
    b, n, h, d = 2, 70, 3, 64
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    offset = 1 if case == "bf16-unaligned" else 0
    flat = torch.randn(b * n * 3 * h * d + 16, generator=torch.Generator().manual_seed(0)).to(dtype)
    base = flat[(-flat.data_ptr() % 16) // flat.element_size() + offset:]
    q, k, v = base[:b * n * 3 * h * d].view(b, n, 3, h, d).unbind(2)
    wide = torch.randn(b, n, h, 2 * d).to(dtype)
    do = wide[..., :d] if case == "bf16-strided-do" else torch.randn(b, n, h, d).to(dtype)
    *got, strides = kernel_operands(q, k, v, do)
    copied = [g.data_ptr() != t.data_ptr() for g, t in zip(got, (q, k, v, do))]
    assert copied == [case == "bf16-unaligned"] * 3 + [False]
    for g, t in zip(got, (q, k, v, do)):
        torch.testing.assert_close(g, t, atol=0, rtol=0)
    want = [st for g in got for st in g.stride()[:3]]
    assert list(strides) == want
    if dtype == torch.bfloat16:
        assert all(g.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in g.stride()[:3])
                   for g in got)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_tile_edge_lengths(d):
    """The backward's tile-edge lengths: 1, each tile size of the plan less
    one, itself and plus one, and one past three of the largest tile."""
    sizes = {n for pair in BWD_TILES[d].values() for n in pair}
    want = {1, 3 * max(sizes) + 1} | {n + e for n in sizes for e in (-1, 0, 1)}
    assert tile_edge_lengths(d) == tuple(sorted(want))
    assert {64, 63, 65, 1} <= set(tile_edge_lengths(d))


def loss_grads(q, k, v, fn):
    """Gradients of sum(fn(q, k, v) ** 2), the JAX tests' loss."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    fn(q, k, v).float().square().sum().backward()
    return q.grad, k.grad, v.grad


def jax_loss_grads(q, k, v, **kw):
    """The same gradients from the JAX package's flash_attention (Pallas
    kernels in interpret mode)."""
    import jax
    import jax.numpy as jnp

    from orbit2_tpu.ops.flash_attention import flash_attention as jax_flash

    loss = lambda a, b, c: jnp.sum(jax_flash(a, b, c, **kw) ** 2)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    return tuple(np.asarray(g) for g in grads)


# the JAX package's gradient tests (tests/test_flash_attention.py:43, :59,
# :186, :219): their shapes, loss and blocks
JAX_GRAD_CASES = {
    "match_sdpa": dict(b=1, n=256, h=2, d=32, seed=0, kw={}),
    "padding": dict(b=1, n=160, h=1, d=32, seed=3, kw={}),
    "multiblock": dict(b=1, n=512, h=2, d=32, seed=10, kw=dict(block_q=128, block_k=256)),
    "large_head_dim": dict(b=1, n=256, h=2, d=256, seed=12, kw={}),
}


@pytest.mark.parametrize("case", list(JAX_GRAD_CASES))
def test_gradients_match_jax_grad_tests(case):
    """The port's autograd (the plain path on CPU tensors) against the JAX
    package's Pallas backward on its own gradient tests' cases, at fp32
    (atol=rtol 1e-4: both sum in fp32 in different orders)."""
    c = JAX_GRAD_CASES[case]
    q, k, v = make_qkv(c["b"], c["n"], c["n"], c["h"], c["d"], seed=c["seed"])
    want = jax_loss_grads(q, k, v, **c["kw"])
    got = loss_grads(*(torch.from_numpy(a) for a in (q, k, v)), flash_attention)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), w, atol=1e-4, rtol=1e-4, err_msg=name)


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
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["nodrop", "drop"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("b,n_q,n_k,h", [
    (3, 1, 129, 5),    # one query; one key past a 128-key tile; odd B*H
    (1, 200, 129, 3),  # N_q not a multiple of the 128-query tile; odd B*H
    (1, 129, 257, 1),  # one query past a tile; one key past 2 (4 at d 256) kv tiles
], ids=["nq1-nk129", "nq200-nk129", "nq129-nk257"])
def test_kernel_tile_edges_on_card(cuda, rate, d, b, n_q, n_k, h):
    """The bf16 kernel's ragged tiles: TMA's zero rows past N_k get p = 0 and
    query rows past N_q are not stored, with and without dropout (the same
    Philox mask as the plain version)."""
    seed = 2 ** 37 + 1
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16)
               for a in make_qkv(b, n_q, n_k, h, d, seed=5))
    o, lse = flash_attention_fwd(q, k, v, None, rate, seed)
    want_o, want_lse = flash_attention_reference(q, k, v, None, attention_mult(q, k, rate, seed))
    torch.testing.assert_close(o, want_o, **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, want_lse, **LSE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_kernel_reads_strided_qkv_views(cuda, offset):
    """The views of a packed [B, N, 3, H, D] projection go in with no copy;
    offset 1 shifts every row off 16-byte alignment, and the wrapper hands
    the kernel a contiguous copy (tma_layout)."""
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
def test_kernel_launches_on_a_second_device(cuda):
    """The shared-memory limit of the bf16 kernel belongs to each device's
    context: after a launch on the first card, a launch on the second works
    and matches its plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
                   for a in make_qkv(2, 256, 256, 4, 64, seed=4))
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


def grad_tol(dtype, *grads):
    """fp32: atol=rtol 1e-4 (summation order). bf16: the kernels round p and
    ds to bf16 for the tensor-core products, so 2e-2 of the largest gradient."""
    if dtype == torch.float32:
        return dict(atol=1e-4, rtol=1e-4)
    return dict(atol=2e-2 * max(g.abs().max().item() for g in grads), rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["nodrop", "drop"])
@pytest.mark.parametrize("b,n_q,n_k,h,d", [
    (2, 256, 256, 4, 64),
    (1, 100, 70, 2, 128),   # ragged tails, N_q != N_k
    (1, 130, 300, 2, 256),  # several tiles at the widest head
])
def test_kernels_fwd_bwd_match_plain_on_card(cuda, dtype, rate, b, n_q, n_k, h, d):
    """Forward (with dropout) and the dq and dk/dv kernels against the plain
    forward and autograd of it, with the same seed."""
    seed = 2 ** 35 + 3
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in make_qkv(b, n_q, n_k, h, d, seed=3))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(cuda, dtype)
    mult = attention_mult(q, k, rate, seed)
    o, lse = flash_attention_fwd(q, k, v, None, rate, seed)
    want_o, want_lse = flash_attention_reference(q, k, v, None, mult)
    torch.testing.assert_close(o, want_o, **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **LSE_TOL)
    before = (FLASH_BWD_DQ.launches, FLASH_BWD_DKV.launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, rate, seed)
    torch.cuda.synchronize()
    assert (FLASH_BWD_DQ.launches, FLASH_BWD_DKV.launches) == (before[0] + 1, before[1] + 1)
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    flash_attention_reference(qf, kf, vf, None, mult)[0].backward(do.float())
    want = (qf.grad, kf.grad, vf.grad)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), w, **grad_tol(dtype, w), msg=name)


@pytest.mark.cuda
def test_backward_reads_strided_qkv_views(cuda):
    b, n, h, d = 2, 130, 4, 64
    g = torch.Generator(device="cpu").manual_seed(0)
    qkv = torch.randn(b, n, 3, h, d, generator=g).to(cuda, torch.bfloat16).requires_grad_()
    q, k, v = qkv.unbind(2)
    flash_attention(q, k, v, dropout_rate=0.1, seed=9).float().square().sum().backward()
    got = qkv.grad.clone()
    qkv.grad = None
    mult = attention_mult(q, k, 0.1, 9)
    qf = qkv.detach().float().requires_grad_()
    flash_attention_reference(*qf.unbind(2), None, mult)[0].square().sum().backward()
    torch.testing.assert_close(got.float(), qf.grad, **grad_tol(torch.bfloat16, qf.grad))


def bwd_case(dev, b, n_q, n_k, h, d, seed, dtype=torch.bfloat16):
    """q, k, v and do on `dev`, made with numpy from `seed`."""
    q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in make_qkv(b, n_q, n_k, h, d, seed=seed))
    do = np.random.default_rng(seed + 1).normal(size=q.shape).astype(np.float32)
    return q, k, v, torch.from_numpy(do).to(dev, dtype)


def check_bwd_on_card(q, k, v, do, rate, seed):
    """flash_attention_bwd against autograd of the plain forward with the
    same multiplier (grad_tol), and two runs bit-equal."""
    d = q.shape[-1]
    mult = attention_mult(q, k, rate, seed)
    o, lse = flash_attention_fwd(q, k, v, None, rate, seed)
    got = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, rate, seed)
    again = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, rate, seed)
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    flash_attention_reference(qf, kf, vf, None, mult)[0].backward(do.float())
    refs = (qf.grad, kf.grad, vf.grad)
    for name, a, w, a2 in zip(("dq", "dk", "dv"), got, refs, again):
        # an identically zero gradient (dq at N_k = 1: a softmax over one key
        # has none) is held against the case's largest gradient
        scale = (w,) if w.abs().max() > 0 else refs
        torch.testing.assert_close(a.float(), w, **grad_tol(q.dtype, *scale), msg=name)
        assert torch.equal(a, a2), f"{name}: two runs differ"


def edge_pairs(d):
    """(N_q, N_k) at the backward's tile edges: N_q rising against N_k falling."""
    lengths = tile_edge_lengths(d)
    return list(zip(lengths, reversed(lengths)))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["nodrop", "drop"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_backward_tile_edges_on_card(cuda, rate, d):
    """The bf16 dq and dk/dv kernels at N_q and N_k of 1, each tile size less
    one, itself and plus one, and past three tiles, with and without dropout
    (the forward's mask), at an odd B*H."""
    for n_q, n_k in edge_pairs(d):
        q, k, v, do = bwd_case(cuda, 1, n_q, n_k, 3, d, seed=n_q + 7 * n_k)
        check_bwd_on_card(q, k, v, do, rate, 2 ** 36 + n_q)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_backward_reads_a_strided_do(cuda, offset):
    """`do` as a strided view (autograd may hand one over): its rows 16-byte
    aligned, it goes in with no copy; shifted by one element, as a copy."""
    q, k, v, _ = bwd_case(cuda, 2, 130, 200, 4, 64, seed=21)
    wide = torch.randn(2 * 130 * 4 * 128 + offset, generator=torch.Generator().manual_seed(3))
    do = wide.to(cuda, torch.bfloat16)[offset:].view(2, 130, 4, 128)[..., 32:96]
    assert not do.is_contiguous()
    check_bwd_on_card(q, k, v, do, 0.1, 2 ** 33 + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("d", [64, 128])
def test_backward_reads_packed_qkv_views(cuda, offset, d):
    """The q, k and v views of a packed [B, N, 3, H, D] projection through
    tma_operands: as they are when aligned, as contiguous copies when the
    whole projection is shifted off 16-byte alignment."""
    b, n, h = 2, 150, 4
    g = torch.Generator().manual_seed(d + offset)
    flat = torch.randn(b * n * 3 * h * d + offset, generator=g).to(cuda, torch.bfloat16)
    q, k, v = flat[offset:].view(b, n, 3, h, d).unbind(2)
    do = torch.randn(b, n, h, d, generator=g).to(cuda, torch.bfloat16)
    check_bwd_on_card(q, k, v, do, 0.1, 2 ** 34 + d)


@pytest.mark.cuda
def test_backward_launches_on_a_second_device(cuda):
    """The backward kernels raise their shared-memory limit in each device's
    context: after launches on the first card, launches on the second work."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        for d in (64, 128):
            check_bwd_on_card(*bwd_case(dev, 2, 200, 200, 4, d, seed=d), 0.1, 2 ** 32 + d)


# the JAX gradient tests' cases on the card, at the kernels' smallest head
# dim where the JAX test takes 32
CARD_GRAD_CASES = {name: dict(c, d=max(c["d"], 64)) for name, c in JAX_GRAD_CASES.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", list(CARD_GRAD_CASES))
def test_gradients_of_jax_grad_tests_on_card(cuda, dtype, case):
    """The JAX package's gradient tests (sum o^2 through the flash
    attention) on the card: the kernels against autograd of the plain
    forward on the same inputs (grad_tol)."""
    c = CARD_GRAD_CASES[case]
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in make_qkv(c["b"], c["n"], c["n"], c["h"], c["d"], seed=c["seed"]))
    got = loss_grads(q, k, v, flash_attention)
    want = loss_grads(q.float(), k.float(), v.float(),
                      lambda a, b, c_: flash_attention_reference(a, b, c_)[0])
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), w, **grad_tol(dtype, w), msg=name)
