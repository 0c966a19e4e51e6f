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

The bf16 kernels' stages (csrc/fused_mlp_hopper.cuh) in plain torch: the
forward's F1 and F2 against the one-shot plain forward and the JAX kernel,
its h_r against stage H's; stage H and the three products of the backward
against the one-shot plain backward; ragged token counts padded as TMA
fills them, and the tile plans and workspaces.

CUDA (marker `cuda`, skipped without a card): each kernel against its plain
version; the forward's and the backward's launches, repeats, ragged and odd
shapes, strided inputs and a second device; the forward's h_r against stage
H's. Run without JAX's conftest on the chip machine:
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
    TOKEN_TILE,
    fused_mlp,
    fused_mlp_bwd,
    fused_mlp_bwd_reference,
    fused_mlp_bwd_staged,
    fused_mlp_fwd,
    fused_mlp_fwd_staged,
    fused_mlp_reference,
    hidden_bwd_reference,
    mlp_bwd_plan,
    mlp_fwd_plan,
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


# ---- the bf16 backward's stages, in plain torch ------------------------------------

def stage_inputs(dtype, t=256, d=D, f=FH, d2=D2, seed=7):
    """x, w1, b1, w2 (Linear layout) and do [t, d2] in `dtype`."""
    x, w1, b1, w2, _ = to_port(*inputs(seed, t=t, d=d, f=f, d2=d2))
    do = torch.from_numpy(np.random.default_rng(seed + 1).normal(size=(t, d2)).astype(np.float32))
    return [a.to(dtype) for a in (x, w1, b1, w2, do)]


@pytest.mark.parametrize("rate", [0.0, 0.25], ids=["nodrop", "drop"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_staged_backward_matches_the_plain_backward(dtype, rate):
    """Stage H, then dx = dpre_r W1, dW1 = dpre_r^T x, dW2 = do2^T h_r and the
    bias sums from their partials: the same five outputs as the one-shot plain
    backward; dx, dW1 and dW2 equal, db1 and db2 within 1e-6 (their sums run
    in another order)."""
    x, w1, b1, w2, do = stage_inputs(dtype)
    masks = mlp_masks(rate, 5, 6, x.shape[0], w1.shape[0], w2.shape[0])
    want = fused_mlp_bwd_reference(x, w1, b1, w2, do, *masks)
    got = fused_mlp_bwd_staged(x, w1, b1, w2, do, *masks)
    for name, a, b in zip(GRAD_NAMES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name.startswith("db"):
            torch.testing.assert_close(a, b, atol=1e-6 * b.abs().max().item(), rtol=1e-6, msg=name)
        else:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("rate", [0.0, 0.25], ids=["nodrop", "drop"])
def test_stage_h_outputs(rate):
    """Stage H's outputs: h_r = bf16(gelu(x W1^T + b1) m1), dpre_r =
    bf16(do2 W2 m1 gelu'), do2 = bf16(do m2), and db1's partials, one row a
    token tile of TOKEN_TILE rows, summing to the plain db1."""
    x, w1, b1, w2, do = stage_inputs(torch.bfloat16, t=3 * TOKEN_TILE)
    m1, m2 = mlp_masks(rate, 5, 6, x.shape[0], w1.shape[0], w2.shape[0])
    dpre, h, db1_part, do2 = hidden_bwd_reference(x, w1, b1, w2, do, m1, m2)
    h_pre = x.float() @ w1.float().t() + b1.float()
    keep1 = 1.0 if m1 is None else m1
    want_h = (F.gelu(h_pre) * keep1).bfloat16()
    want_do2 = (do.float() * (1.0 if m2 is None else m2)).bfloat16()
    assert torch.equal(h, want_h) and torch.equal(do2, want_do2)
    g = 0.5 * (1 + torch.erf(h_pre / np.sqrt(2))) + h_pre * torch.exp(-0.5 * h_pre ** 2) / np.sqrt(2 * np.pi)
    dpre32 = (want_do2.float() @ w2.float()) * keep1 * g
    torch.testing.assert_close(dpre.float(), dpre32.bfloat16().float(), atol=1e-2, rtol=0)
    assert db1_part.shape == (3, w1.shape[0])
    torch.testing.assert_close(db1_part, dpre32.view(3, TOKEN_TILE, -1).sum(1), atol=1e-5,
                               rtol=1e-5)
    want_db1 = fused_mlp_bwd_reference(x, w1, b1, w2, do, m1, m2)[2]
    torch.testing.assert_close(db1_part.sum(0), want_db1, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.25], ids=["nodrop", "drop"])
def test_ragged_tokens_padded_as_tma_fills_them(rate):
    """136 tokens: x and do padded by zero rows to 256, as TMA fills a ragged
    token tile, give the five outputs of the unpadded stages; h_r is not
    zero in the padded rows (gelu(b1) m1), but do2 and dpre are."""
    x, w1, b1, w2, do = stage_inputs(torch.bfloat16, t=136)
    masks = mlp_masks(rate, 5, 6, 136, w1.shape[0], w2.shape[0])
    padded = fused_mlp_bwd_staged(x, w1, b1, w2, do, *masks, pad=True)
    exact = fused_mlp_bwd_staged(x, w1, b1, w2, do, *masks, pad=False)
    for name, a, b in zip(GRAD_NAMES, padded, exact):
        assert torch.equal(a, b), name
    dpre, h, _, do2 = hidden_bwd_reference(x, w1, b1, w2, do, *masks, pad=True)
    assert dpre.shape[0] == h.shape[0] == do2.shape[0] == 2 * TOKEN_TILE
    assert h[136:].abs().sum() > 0
    assert not dpre[136:].any() and not do2[136:].any()


@pytest.mark.parametrize("shape", [(4096, 1024, 4096, 1024), (16384, 1024, 4096, 1024),
                                   (4104, 1024, 4096, 1024), (512, 256, 640, 384)],
                         ids=["117m", "117m_bench", "ragged", "odd"])
def test_backward_tile_plan_and_workspace(shape):
    """The plan the wrapper allocates by: dpre_r and h_r bf16 [T, F] (64 MiB at
    4,096 tokens, 256 MiB at 16,384: what the unfused chain's autograd keeps
    for GELU's and fc2's inputs), db1's partials one row a 128-token tile,
    db2's one row a 64-token slice; 128 x 256 output tiles where the widths
    allow."""
    t, d, f, d2 = shape
    plan = mlp_bwd_plan(t, d, f, d2)
    tiles = -(-t // TOKEN_TILE)
    assert plan["token_tiles"] == tiles
    assert plan["workspace"] == {"dpre": (t, f), "h": (t, f), "db1_part": (tiles, f),
                                 "db2_part": (-(-t // 64), d2)}
    hidden = 2 * 2 * t * f
    assert plan["workspace_bytes"] == hidden + 4 * (tiles * f + -(-t // 64) * d2)
    if shape[0] == 4096:
        assert hidden == 64 * 2 ** 20
    if shape[0] == 16384:
        assert hidden == 256 * 2 ** 20
    assert plan["hidden_tiles"] == (f // 128, tiles)
    bn = plan["tile_cols"]
    assert bn == {"dx": 256 if d % 256 == 0 else 128,
                  "dw": 256 if d % 256 == 0 and f % 256 == 0 else 128}
    assert plan["dx_tiles"] == tiles * (d // bn["dx"])
    assert plan["dw_tiles"] == (f // 128) * (d // bn["dw"]) + (d2 // 128) * (f // bn["dw"])


# ---- the bf16 forward's stages, in plain torch -------------------------------------

# chip_smoke.py's MLP_SHAPES: the 117M serving slice, bench.py's 117M geometry,
# a ragged token count, a small case, F != 4 D with a partial D2 tile
SMOKE_MLP_SHAPES = [(4096, 1024, 4096, 1024), (16384, 1024, 4096, 1024), (4104, 1024, 4096, 1024),
                    (64, 128, 256, 128), (512, 256, 640, 384)]


@pytest.mark.parametrize("shape", SMOKE_MLP_SHAPES,
                         ids=["117m", "117m_bench", "ragged", "small", "odd"])
def test_forward_tile_plan_and_workspace(shape):
    """F1's tiles (token tiles x F / BN) and F2's (token tiles x D2 / BN), BN
    256 where the output width allows, and the one bf16 [T, F] workspace h_r
    (32 MiB at 4,096 tokens: what the unfused chain stores)."""
    t, d, f, d2 = shape
    plan = mlp_fwd_plan(t, d, f, d2)
    tiles = -(-t // TOKEN_TILE)
    bn1, bn2 = (256 if f % 256 == 0 else 128), (256 if d2 % 256 == 0 else 128)
    assert plan["token_tiles"] == tiles
    assert plan["tile_cols"] == {"hidden": bn1, "out": bn2}
    assert plan["hidden_tiles"] == tiles * (f // bn1) and plan["out_tiles"] == tiles * (d2 // bn2)
    assert plan["workspace"] == {"h": (t, f)} and plan["workspace_bytes"] == 2 * t * f
    if t == 4096:
        assert plan["workspace_bytes"] == 32 * 2 ** 20
        assert (plan["hidden_tiles"], plan["out_tiles"]) == (512, 128)


@pytest.mark.parametrize("tokens", [256, 136], ids=["t256", "t136_ragged"])
@pytest.mark.parametrize("rate", [0.0, 0.25], ids=["nodrop", "drop"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_staged_forward_matches_the_plain_forward(dtype, rate, tokens):
    """F1 (h_r = gelu(x W1^T + b1) m1, rounded) then F2 ((h_r W2^T + b2) m2,
    rounded once), x padded by zero rows to a multiple of TOKEN_TILE as TMA
    fills it: the one-shot plain forward, equal; h_r of the padded rows is
    gelu(b1) m1, and unpadded the same stages give the same rows."""
    x, w1, b1, w2, _ = stage_inputs(dtype, t=tokens)
    b2 = torch.from_numpy(inputs(8, d2=D2)[4]).to(dtype)
    masks = mlp_masks(rate, 5, 6, tokens, w1.shape[0], w2.shape[0])
    want = fused_mlp_reference(x, w1, b1, w2, b2, *masks)
    out, h = fused_mlp_fwd_staged(x, w1, b1, w2, b2, *masks)
    assert out.dtype == want.dtype and torch.equal(out, want)
    assert h.shape == (-(-tokens // TOKEN_TILE) * TOKEN_TILE, w1.shape[0]) and h.dtype == dtype
    exact_out, exact_h = fused_mlp_fwd_staged(x, w1, b1, w2, b2, *masks, pad=False)
    assert torch.equal(exact_out, out) and torch.equal(exact_h, h[:tokens])
    if tokens % TOKEN_TILE:
        assert torch.equal(h[tokens:], F.gelu(b1.float()).to(dtype).expand_as(h[tokens:]))


@pytest.mark.parametrize("rate", [0.0, 0.25], ids=["nodrop", "drop"])
def test_forward_hidden_is_stage_hs(rate):
    """The forward's h_r is stage H's on the same inputs and seeds (a ragged
    136 tokens, padded as TMA fills both)."""
    x, w1, b1, w2, do = stage_inputs(torch.bfloat16, t=136)
    b2 = torch.zeros(w2.shape[0], dtype=torch.bfloat16)
    masks = mlp_masks(rate, 5, 6, 136, w1.shape[0], w2.shape[0])
    _, h = fused_mlp_fwd_staged(x, w1, b1, w2, b2, *masks)
    assert torch.equal(h, hidden_bwd_reference(x, w1, b1, w2, do, *masks)[1])


@pytest.mark.parametrize("path, rate", [("fused_mlp_fwd", 0.0), ("staged", 0.0), ("staged", 0.25)],
                         ids=["fused_mlp_fwd", "staged", "staged_jax_masks"])
def test_forward_paths_match_jax_kernel(path, rate):
    """fused_mlp_fwd on CPU tensors and the staged forward against the JAX
    kernel in interpret mode at fp32 (atol 1e-5); the staged forward also
    with dropout on the JAX kernel's own multipliers."""
    import jax
    import jax.numpy as jnp

    args = inputs(9)
    kw, masks = {}, (None, None)
    if rate:
        kw = dict(drop_rate=rate, rng=jax.random.PRNGKey(3))
        seed = np.asarray(jax.random.randint(kw["rng"], (2,), -2 ** 31, 2 ** 31 - 1,
                                             dtype=jnp.int32))
        masks = jax_masks(seed, rate)
    want = np.asarray(jax_fused(args, **kw))
    x, w1, b1, w2, b2 = to_port(*args)
    if path == "staged":
        got = fused_mlp_fwd_staged(x, w1, b1, w2, b2, *masks)[0]
    else:
        got = fused_mlp_fwd(x, w1, b1, w2, b2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


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


def launches():
    return [k.launches for k in (FUSED_MLP_DX, FUSED_MLP_DW, FUSED_DROPOUT)]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["nodrop", "drop"])
def test_backward_runs_stage_h_once_on_card(cuda, rate):
    """One fused_mlp_bwd: K6b and K6c tick once each (stage H runs in the dW
    call, dx takes its dpre_r), and the fused dropout makes do2 at rate > 0;
    two runs are bit-equal, and dx from the handed-over dpre_r equals dx
    alone."""
    x, w1, b1, w2, _ = card_inputs((256, 256, 512, 256), torch.bfloat16, cuda)
    do = torch.randn(256, 256, generator=torch.Generator().manual_seed(1)).to(cuda, torch.bfloat16)
    before = launches()
    got = fused_mlp_bwd(x, w1, b1, w2, do, rate, 11, 12)
    torch.cuda.synchronize()
    assert launches() == [before[0] + 1, before[1] + 1, before[2] + (1 if rate else 0)]
    again = fused_mlp_bwd(x, w1, b1, w2, do, rate, 11, 12)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(FUSED_MLP_DX(x, w1, b1, w2, do, rate, 11, 12), got[0])
    assert all(torch.equal(a, b) for a, b in zip(FUSED_MLP_DW(x, w1, b1, w2, do, rate, 11, 12),
                                                 got[1:]))
    masks = mlp_masks(rate, 11, 12, 256, 512, 256, device=cuda)
    for name, a, b in zip(GRAD_NAMES, got, fused_mlp_bwd_staged(x, w1, b1, w2, do, *masks)):
        close(a, b, torch.bfloat16, name)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["nodrop", "drop"])
@pytest.mark.parametrize("shape", [(4104, 256, 512, 256), (136, 128, 256, 128),
                                   (512, 256, 640, 384)], ids=["t4104", "t136", "f640_d2_384"])
def test_backward_shapes_on_card(cuda, shape, rate):
    """Ragged token tiles (4104, 136 tokens) and F, D2 not multiples of 256
    (128-column output tiles), against the plain backward."""
    x, w1, b1, w2, _ = card_inputs(shape, torch.bfloat16, cuda)
    do = torch.randn(shape[0], shape[3], generator=torch.Generator().manual_seed(2)).to(
        cuda, torch.bfloat16)
    masks = mlp_masks(rate, 3, 4, shape[0], shape[2], shape[3], device=cuda)
    got = fused_mlp_bwd(x, w1, b1, w2, do, rate, 3, 4)
    for name, a, b in zip(GRAD_NAMES, got, fused_mlp_bwd_reference(x, w1, b1, w2, do, *masks)):
        close(a, b, torch.bfloat16, name)


@pytest.mark.cuda
def test_backward_strided_x_on_card(cuda):
    """A strided x (a column slice of a wider tensor) goes through a
    contiguous copy: the same gradients as the contiguous x."""
    x, w1, b1, w2, _ = card_inputs((136, 128, 256, 128), torch.bfloat16, cuda)
    wide = torch.cat([x, x], dim=1)[:, 128:]
    assert not wide.is_contiguous()
    do = torch.randn(136, 128, generator=torch.Generator().manual_seed(3)).to(cuda, torch.bfloat16)
    for a, b in zip(fused_mlp_bwd(wide, w1, b1, w2, do), fused_mlp_bwd(x, w1, b1, w2, do)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_backward_on_a_second_device(cuda):
    """The shared-memory limit belongs to each device's context: the kernels
    launch on a second card too."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    x, w1, b1, w2, _ = card_inputs((136, 128, 256, 128), torch.bfloat16, dev)
    do = torch.randn(136, 128, generator=torch.Generator().manual_seed(4)).to(dev, torch.bfloat16)
    got = fused_mlp_bwd(x, w1, b1, w2, do)
    for name, a, b in zip(GRAD_NAMES, got, fused_mlp_bwd_reference(x, w1, b1, w2, do)):
        assert a.device == dev, name
        close(a, b, torch.bfloat16, name)


# ---- the bf16 forward on the card: F1 and F2 -----------------------------------

def bf16_ulps(a, b):
    """Per element, how many bf16 steps apart a and b are (0 = equal; +0 and
    -0 are equal)."""
    line = lambda v: (lambda i: torch.where(i < 0, -(i & 0x7FFF), i))(v.view(torch.int16).int())
    return (line(a) - line(b)).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["nodrop", "drop"])
@pytest.mark.parametrize("shape", CARD_SHAPES + [(4104, 256, 512, 256), (136, 128, 256, 128),
                                                 "strided"],
                         ids=["small", "ragged", "d2_gt_d", "t4104", "t136", "strided_b1"])
def test_forward_matches_plain_on_card(cuda, shape, rate):
    """The bf16 forward (F1 then F2, one launch count) against its plain
    version, both dropout instances, at 128- and 256-column tiles, ragged
    token tiles and a strided [1, N, D] input (a contiguous copy); the zero
    pattern is the output mask's and two runs are bit-equal."""
    strided = shape == "strided"
    x, w1, b1, w2, b2 = card_inputs((64, 128, 256, 128) if strided else shape, torch.bfloat16, cuda)
    if strided:
        x = torch.cat([x, x], dim=1).view(1, 64, 256)[..., 128:].reshape(64, 128)
    t, f, d2 = x.shape[0], w1.shape[0], w2.shape[0]
    masks = mlp_masks(rate, 11, 12, t, f, d2, device=cuda)
    before = FUSED_MLP_FWD.launches
    out = fused_mlp_fwd(x, w1, b1, w2, b2, rate, 11, 12)
    again = fused_mlp_fwd(x, w1, b1, w2, b2, rate, 11, 12)
    torch.cuda.synchronize()
    assert FUSED_MLP_FWD.launches == before + 2
    assert out.dtype == torch.bfloat16 and out.shape == (t, d2)
    close(out, fused_mlp_reference(x, w1, b1, w2, b2, *masks), torch.bfloat16, "out")
    assert torch.equal(out, again), "two forward runs differ"
    if rate:
        assert torch.equal(out == 0, masks[1] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["nodrop", "drop"])
@pytest.mark.parametrize("shape", [(4104, 256, 512, 256), (136, 128, 640, 384)],
                         ids=["t4104", "t136_f640"])
def test_forward_hidden_is_stage_hs_on_card(cuda, shape, rate):
    """F1's h_r (keep_h) against stage H's h_r (FUSED_MLP_DW's keep_h) on the
    same inputs and seeds: the same accumulator through the same GELU, so
    within 1 bf16 ulp (the products' tiles differ); the count of unequal
    elements is printed."""
    x, w1, b1, w2, b2 = card_inputs(shape, torch.bfloat16, cuda)
    do = torch.randn(shape[0], shape[3], generator=torch.Generator().manual_seed(5)).to(
        cuda, torch.bfloat16)
    _, h = FUSED_MLP_FWD(x, w1, b1, w2, b2, rate, 11, 12, keep_h=True)
    *_, h_stage = FUSED_MLP_DW(x, w1, b1, w2, do, rate, 11, 12, keep_h=True)
    torch.cuda.synchronize()
    ulps = bf16_ulps(h, h_stage)
    print(f"h_r vs stage H's at {shape} drop {rate}: {int((ulps > 0).sum())} of {h.numel()} "
          f"unequal, at most {int(ulps.max())} ulp")
    assert h.shape == h_stage.shape == (shape[0], shape[2]) and int(ulps.max()) <= 1


@pytest.mark.cuda
def test_forward_on_a_second_device(cuda):
    """F1 and F2 raise their shared-memory limit in each device's context:
    they launch on a second card too."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    x, w1, b1, w2, b2 = card_inputs((136, 128, 256, 256), torch.bfloat16, dev)
    out = fused_mlp_fwd(x, w1, b1, w2, b2, 0.1, 3, 4)
    assert out.device == dev
    masks = mlp_masks(0.1, 3, 4, 136, 256, 256, device=dev)
    close(out, fused_mlp_reference(x, w1, b1, w2, b2, *masks), torch.bfloat16, "out")


@pytest.mark.cuda
def test_bf16_forward_raises_on_what_it_does_not_take(cuda):
    """Shapes off the kernels' grid, mixed dtypes and devices raise before a
    launch; the C entry refuses a bf16 call without its workspace."""
    x, w1, b1, w2, b2 = card_inputs((64, 128, 256, 128), torch.bfloat16, cuda)
    before = FUSED_MLP_FWD.launches
    with pytest.raises(ValueError):
        fused_mlp_fwd(x[:60], w1, b1, w2, b2)  # tokens % 8
    with pytest.raises(ValueError):
        fused_mlp_fwd(x[:, :120], w1[:, :120], b1, w2, b2)  # D % 128
    with pytest.raises(ValueError):
        fused_mlp_fwd(x, w1, b1, w2, b2[:64])  # b2 is not [D2]
    with pytest.raises(TypeError):
        fused_mlp_fwd(x, w1.float(), b1, w2, b2)
    with pytest.raises(ValueError):
        fused_mlp_fwd(x, w1, b1, w2, b2.cpu())
    out = torch.empty(64, 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(RuntimeError, match="no kernel instance"):
        FUSED_MLP_FWD.launch(cuda, 1, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                             b2.data_ptr(), out.data_ptr(), 0, 64, 128, 256, 128, 0, 0, 0, 0, 0.0)
    assert FUSED_MLP_FWD.launches == before
