"""The model hub of the PyTorch port against the JAX package: the periodic
CNN components, ResNet, Unet, the plain ViT and the baselines.

Weights are JAX's (perturbed so no unit scale or zero bias hides a path),
carried across by `state_dict_from_jax_params` with the BatchNorm running
averages; JAX gradients land on the port's parameter names the same way.
fp32, dropout 0 (the port's Philox masks are not jax.random's).
Tolerances: forward atol 1e-5 / rtol 1e-4, gradients the same, the running
averages after 3 train steps the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbit2_tpu.models.baselines import Interpolation as JaxInterpolation
from orbit2_tpu.models.baselines import LinearRegression as JaxLinearRegression
from orbit2_tpu.models.components import cnn as jcnn
from orbit2_tpu.models.resnet import ResNet as JaxResNet
from orbit2_tpu.models.unet import Unet as JaxUnet
from orbit2_tpu.models.vit import VisionTransformer as JaxViT
from orbit2_tpu_torch.models.baselines import (
    Climatology, Interpolation, LinearRegression, Persistence)
from orbit2_tpu_torch.models.components import cnn
from orbit2_tpu_torch.models.resnet import ResNet
from orbit2_tpu_torch.models.unet import Unet
from orbit2_tpu_torch.models.vit import VisionTransformer
from orbit2_tpu_torch.training.checkpoint import state_dict_from_jax_params

TOL = dict(atol=1e-5, rtol=1e-4)


def perturb(tree, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.normal(size=np.shape(a)).astype(np.float32), tree)


def nchw(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def to_nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


def conv_weight(k):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1)))


# -- components ---------------------------------------------------------------

def test_periodic_pad_matches_jax():
    x = nchw(0, (2, 3, 5, 7))
    want = np.asarray(jcnn.periodic_pad_nhwc(to_nhwc(x), 2)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(cnn.periodic_pad(torch.from_numpy(x), 2).numpy(), want)


@pytest.mark.parametrize("kind", ["conv", "conv_transpose", "upsample", "downsample"])
def test_convolutions_match_jax(kind):
    """The periodic conv and transposed conv, Upsample (flax padding (2, 2)
    against torch's padding 1) and Downsample, on flax's kernels; the
    transposed kernels flipped and laid out [I, O, kH, kW]."""
    x = nchw(1, (2, 3, 8, 16))
    jm, tm = {
        "conv": (jcnn.PeriodicConv2D(5, 3, pad_width=1), cnn.PeriodicConv2D(3, 5, 3, padding=1)),
        "conv_transpose": (jcnn.PeriodicConvTranspose2D(5, 3, pad_width=1),
                           cnn.PeriodicConvTranspose2D(3, 5, 3, padding=1)),
        "upsample": (jcnn.Upsample(3), cnn.Upsample(3)),
        "downsample": (jcnn.Downsample(3), cnn.Downsample(3)),
    }[kind]
    v = perturb(jm.init(jax.random.PRNGKey(0), to_nhwc(x)))
    (sub,) = v["params"].values()
    k = np.asarray(sub["kernel"])
    w = (torch.from_numpy(np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1)))
         if kind in ("conv_transpose", "upsample") else conv_weight(k))
    with torch.no_grad():
        tm.conv.weight.copy_(w)
        tm.conv.bias.copy_(torch.from_numpy(np.asarray(sub["bias"])))
        got = tm(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply(v, to_nhwc(x))).transpose(0, 3, 1, 2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_batchnorm_updates_running_variance_with_the_biased_variance():
    """flax moves ra_var with the biased batch variance; torch's BatchNorm2d
    with the unbiased one. At B2 x 4 x 8 = 64 values a channel the two
    differ by 1/63 of the variance: the port's BatchNorm2d holds flax's
    running averages, normalized output and gradient within 1e-5 / 1e-4,
    and torch's own running_var misses by far more."""
    import flax.linen as fnn

    x = nchw(2, (2, 5, 4, 8)) * 3.0 + 1.0
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = perturb(bn.init(jax.random.PRNGKey(0), to_nhwc(x)), scale=0.3)
    y, upd = bn.apply(v, to_nhwc(x), mutable=["batch_stats"])

    tb = cnn.BatchNorm2d(5)
    with torch.no_grad():
        tb.weight.copy_(torch.from_numpy(np.asarray(v["params"]["scale"])))
        tb.bias.copy_(torch.from_numpy(np.asarray(v["params"]["bias"])))
        tb.running_mean.copy_(torch.from_numpy(np.asarray(v["batch_stats"]["mean"])))
        tb.running_var.copy_(torch.from_numpy(np.asarray(v["batch_stats"]["var"])))
    ref = torch.nn.BatchNorm2d(5, eps=1e-5, momentum=0.1)
    ref.load_state_dict(tb.state_dict())
    xt = torch.from_numpy(x)
    got = tb.train()(xt)
    ref.train()(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y).transpose(0, 3, 1, 2), **TOL)
    want_var = np.asarray(upd["batch_stats"]["var"])
    np.testing.assert_allclose(tb.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               **TOL)
    np.testing.assert_allclose(tb.running_var.numpy(), want_var, **TOL)
    # torch's own update (unbiased) fails the same tolerance by ~60x
    miss = np.abs(ref.running_var.numpy() - want_var) - (1e-5 + 1e-4 * np.abs(want_var))
    assert miss.max() > 10 * (1e-5 + 1e-4 * want_var.max())
    # eval mode normalizes by the running averages
    y_eval = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5).apply(
        upd | {"params": v["params"]}, to_nhwc(x))
    np.testing.assert_allclose(tb.eval()(xt).detach().numpy(),
                               np.asarray(y_eval).transpose(0, 3, 1, 2), **TOL)


@pytest.mark.parametrize("kind", ["residual", "attention"])
def test_residual_and_attention_blocks_match_jax(kind):
    """A ResidualBlock with BatchNorm and a 1x1 shortcut (train mode), and
    the AttentionBlock (softmax over the queries)."""
    x = nchw(3, (2, 4, 6, 8))
    if kind == "residual":
        jm, tm = jcnn.ResidualBlock(6, norm=True, dropout=0.0), cnn.ResidualBlock(4, 6, norm=True,
                                                                                   dropout=0.0)
    else:
        jm, tm = jcnn.AttentionBlock(), cnn.AttentionBlock(4)
    v = perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), to_nhwc(x)))
    p = v["params"]
    with torch.no_grad():
        if kind == "residual":
            tm.conv1.conv.weight.copy_(conv_weight(p["PeriodicConv2D_0"]["Conv_0"]["kernel"]))
            tm.conv1.conv.bias.copy_(torch.from_numpy(p["PeriodicConv2D_0"]["Conv_0"]["bias"]))
            tm.conv2.conv.weight.copy_(conv_weight(p["PeriodicConv2D_1"]["Conv_0"]["kernel"]))
            tm.conv2.conv.bias.copy_(torch.from_numpy(p["PeriodicConv2D_1"]["Conv_0"]["bias"]))
            tm.shortcut.weight.copy_(conv_weight(p["shortcut"]["kernel"]))
            tm.shortcut.bias.copy_(torch.from_numpy(p["shortcut"]["bias"]))
            for i, norm in enumerate((tm.norm1, tm.norm2)):
                norm.weight.copy_(torch.from_numpy(p[f"BatchNorm_{i}"]["scale"]))
                norm.bias.copy_(torch.from_numpy(p[f"BatchNorm_{i}"]["bias"]))
            want, _ = jax.jit(lambda v, x: jm.apply(v, x, False, mutable=["batch_stats"]))(
                v, to_nhwc(x))
            tm.train()
        else:
            for dense, lin in (("Dense_0", tm.projection), ("Dense_1", tm.output)):
                lin.weight.copy_(torch.from_numpy(p[dense]["kernel"].T.copy()))
                lin.bias.copy_(torch.from_numpy(p[dense]["bias"]))
            want = jm.apply(v, to_nhwc(x))
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want).transpose(0, 3, 1, 2), **TOL)


# -- models -------------------------------------------------------------------

def resnet_pair():
    kw = dict(hidden_channels=8, n_blocks=2, dropout=0.0)
    return JaxResNet(3, 2, history=2, **kw), ResNet(3, 2, history=2, **kw)


def unet_pair():
    kw = dict(hidden_channels=4, ch_mults=(1, 2), is_attn=(False, False), mid_attn=True,
              n_blocks=1, dropout=0.0)
    return JaxUnet(6, 2, **kw), Unet(6, 2, **kw)


def carried(jm, tm, x, seed=0):
    """JAX's variables (perturbed) and the port model holding them."""
    v = perturb(jax.jit(jm.init)({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x)),
                seed=seed)
    tm.load_state_dict(state_dict_from_jax_params(v["params"], 2,
                                                  batch_stats=v.get("batch_stats")), strict=True)
    return v


@pytest.mark.parametrize("arch", ["resnet", "unet"])
def test_cnn_models_match_jax_forward_gradients_and_running_stats(arch):
    """3 train-mode steps of a mean loss of the output against a fixed
    cotangent (as the train losses are means): each step's output and
    parameter gradients; the running averages after the 3 steps, and the
    eval-mode forward on them ([B, T, C, H, W] input for the ResNet). At
    these tiny widths both packages' fp32 gradients lie ~5e-5 (relative
    Frobenius) from an fp64 run; the Unet's input is 16 x 32 so that its
    BatchNorm statistics, over 2 x 8 x 16 values at the lowest level, keep
    each element within the tolerance. Attention sits in the middle block
    only: an AttentionBlock in the decoder, its softmax over the queries fed
    by eval-mode activations of ~80, puts both fp32 outputs ~1e-5 of their
    largest from an fp64 run, beyond an elementwise 1e-5 (it is held alone
    by test_residual_and_attention_blocks_match_jax)."""
    jm, tm = resnet_pair() if arch == "resnet" else unet_pair()
    x = nchw(4, (2, 2, 3, 8, 16)) if arch == "resnet" else nchw(4, (2, 6, 16, 32))
    v = carried(jm, tm, x)
    params, stats = v["params"], v["batch_stats"]
    want = jax.eval_shape(jm.apply, v, jnp.asarray(x))

    @jax.jit
    def loss_and_grads(p, s, xs, ct):
        def loss(p):
            y, upd = jm.apply({"params": p, "batch_stats": s}, xs, deterministic=False,
                              mutable=["batch_stats"])
            return jnp.mean(y * ct), (y, upd["batch_stats"])
        return jax.value_and_grad(loss, has_aux=True)(p)

    tm.train()
    for step in range(3):
        xs = x + 0.5 * step
        ct = nchw(10 + step, want.shape)
        (_, (y, stats)), grads = loss_and_grads(params, stats, jnp.asarray(xs), jnp.asarray(ct))
        tm.zero_grad()
        out = tm(torch.from_numpy(xs))
        (out * torch.from_numpy(ct)).mean().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), **TOL)
        want_g = state_dict_from_jax_params(jax.tree.map(np.asarray, grads), 2)
        for k, p in tm.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), **TOL,
                                       err_msg=f"step {step} {k}")
    want_sd = state_dict_from_jax_params(params, 2, batch_stats=jax.tree.map(np.asarray, stats))
    got_sd = tm.state_dict()
    running = [k for k in want_sd if "running" in k]
    assert running
    for k in running:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(), **TOL, err_msg=k)
    # eval mode normalizes by the running averages the steps left
    want = jax.jit(jm.apply)({"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(tm.eval()(torch.from_numpy(x)).numpy(), np.asarray(want),
                                   **TOL)


@pytest.mark.parametrize("embed,heads", [(128, 2), (64, 2)], ids=["d64", "d32"])
def test_vit_matches_jax_forward_and_gradients(embed, heads):
    """The plain ViT on the plain attention path (the CPU's) at head dim 64
    and 32: train-mode forward (dropout and drop-path 0) and every
    parameter's gradient, a [B, T, C, H, W] input folded to channels."""
    kw = dict(patch_size=2, embed_dim=embed, depth=2, decoder_depth=2, num_heads=heads,
              learn_pos_emb=True, drop_rate=0.0, drop_path=0.0)
    jm = JaxViT((8, 16), 3, 2, history=2, attention_impl="xla", **kw)
    tm = VisionTransformer((8, 16), 3, 2, history=2, attention_impl="auto", **kw)
    x = nchw(5, (2, 2, 3, 8, 16))
    v = perturb(jax.jit(jm.init)({"params": jax.random.PRNGKey(0)}, jnp.asarray(x)), scale=0.02)
    tm.load_state_dict(state_dict_from_jax_params(v["params"], 2), strict=True)
    ct = nchw(6, (2, 2, 8, 16))

    def loss(p):
        y = jm.apply({"params": p}, jnp.asarray(x), deterministic=False,
                     rngs={"dropout": jax.random.PRNGKey(1), "drop_path": jax.random.PRNGKey(2)})
        return jnp.mean(y * ct), y

    (_, y), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
    out = tm.train()(torch.from_numpy(x), dropout_gen=torch.Generator(),
                     drop_path_gen=torch.Generator())
    (out * torch.from_numpy(ct)).mean().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), **TOL)
    want_g = state_dict_from_jax_params(jax.tree.map(np.asarray, grads), 2)
    assert set(want_g) == {k for k, _ in tm.named_parameters()}
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), **TOL, err_msg=k)


def test_vit_fixed_pos_embed_is_the_sincos_table():
    jm = JaxViT((8, 16), 3, 2, patch_size=2, embed_dim=32, depth=1, decoder_depth=1,
                num_heads=2, learn_pos_emb=False)
    v = jax.jit(jm.init)({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 3, 8, 16)))
    tm = VisionTransformer((8, 16), 3, 2, patch_size=2, embed_dim=32, depth=1, decoder_depth=1,
                           num_heads=2, learn_pos_emb=False)
    assert not tm.pos_embed.requires_grad
    np.testing.assert_allclose(tm.pos_embed.detach().numpy(),
                               np.asarray(v["fixed"]["pos_embed"]), rtol=1e-6, atol=1e-7)
    sd = state_dict_from_jax_params(v["params"], 2, fixed=v["fixed"])
    tm.load_state_dict(sd, strict=True)


def test_baselines_match_jax():
    x = nchw(7, (2, 3, 4, 8))
    clim = nchw(8, (2, 4, 8))[0]
    np.testing.assert_array_equal(Climatology(clim)(torch.from_numpy(x)).numpy(),
                                  np.broadcast_to(clim[None], (2,) + clim.shape))
    x5 = nchw(9, (2, 2, 3, 4, 8))
    np.testing.assert_array_equal(Persistence([2, 0])(torch.from_numpy(x5)).numpy(),
                                  x5[:, -1][:, [2, 0]])
    jl = JaxLinearRegression(2 * 3 * 4 * 8, 2 * 4 * 8, (2, 4, 8))
    v = perturb(jl.init(jax.random.PRNGKey(0), jnp.asarray(x5)))
    tl = LinearRegression(2 * 3 * 4 * 8, 2 * 4 * 8, (2, 4, 8))
    tl.load_state_dict(state_dict_from_jax_params(v["params"]), strict=True)
    np.testing.assert_allclose(tl(torch.from_numpy(x5)).detach().numpy(),
                               np.asarray(jl.apply(v, jnp.asarray(x5))), **TOL)


@pytest.mark.parametrize("mode,scale", [("bilinear", 4.0), ("nearest", 4.0), ("nearest", 1.5),
                                        ("bilinear", 2.5)])
def test_interpolation_matches_jax_image_resize(mode, scale):
    """jax.image.resize's bilinear is half-pixel with weights renormalised
    at the borders (F.interpolate without align_corners or antialias for an
    upsample); its nearest is torch's nearest-exact, at a non-integer scale
    too, where torch's "nearest" picks other pixels."""
    x = nchw(10, (2, 3, 6, 10))
    want = np.asarray(JaxInterpolation(scale, mode)(jnp.asarray(x)))
    got = Interpolation(scale, mode)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    if mode == "nearest" and scale != int(scale):
        legacy = torch.nn.functional.interpolate(torch.from_numpy(x), size=want.shape[2:],
                                                 mode="nearest").numpy()
        assert not np.allclose(legacy, want)


def test_initialisers_draw_jax_standard_deviations():
    """Each layer kind's drawn standard deviation against JAX's at the same
    shape (lecun_normal conv, transposed-conv and dense kernels; the ViT's
    trunc_normal(0.02) dense kernels), within 5%; biases zero."""
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    x = jnp.zeros((1, 4, 4, 64))
    cases = []
    for jm, tm, path in ((jcnn.PeriodicConv2D(96, 3, pad_width=1),
                          cnn.PeriodicConv2D(64, 96, 3, padding=1), ("Conv_0",)),
                         (jcnn.Upsample(64), cnn.Upsample(64), ("ConvTranspose_0",)),
                         (jcnn.AttentionBlock(), cnn.AttentionBlock(64), ("Dense_0",))):
        sub = jax.jit(jm.init)(key, x)["params"][path[0]]
        tm.reset_parameters(gen)
        t = {"Conv_0": lambda m: m.conv, "ConvTranspose_0": lambda m: m.conv,
             "Dense_0": lambda m: m.projection}[path[0]](tm)
        cases.append((float(np.std(np.asarray(sub["kernel"]))), t.weight.std().item()))
        assert float(t.bias.detach().abs().max()) == 0.0
    jv = JaxViT((16, 32), 8, 2, patch_size=2, embed_dim=256, depth=1, decoder_depth=1,
                num_heads=4)
    pv = jax.jit(jv.init)(key, jnp.zeros((1, 8, 16, 32)))["params"]
    tv = VisionTransformer((16, 32), 8, 2, patch_size=2, embed_dim=256, depth=1,
                           decoder_depth=1, num_heads=4, generator=gen)
    cases.append((float(np.std(np.asarray(pv["head_0"]["kernel"]))), tv.head[0].weight.std().item()))
    cases.append((float(np.std(np.asarray(pv["patch_embed"]["kernel"]))),
                  tv.patch_embed.proj.weight.std().item()))
    for want, got in cases:
        assert abs(got / want - 1) < 0.05, cases
