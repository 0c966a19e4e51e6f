"""Per-Block activation recomputation (`remat`) in the port.

The port's counterpart of the JAX package's `nn.remat(Block)` (policy None
or `checkpoint_dots`, orbit2_tpu/models/res_slimvit.py:87-93, :312-316):
  * in train mode with dropout and drop-path 0.1, remat "full" and "dots"
    against no remat: equal outputs, losses and gradients bit for bit, and
    both host generators left in equal states (the recomputation replays the
    dropout seeds and DropPath masks of the first run);
  * the recomputation runs the flash forward again under both policies and
    the fused dropout again, the launch counts chip_smoke.py asserts;
  * against JAX `ResSlimViT(remat=True)` at fp32 and dropout 0 (the two
    packages draw different dropout bits): gradients within atol 1e-5 /
    rtol 1e-4, the rates of tests/test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbit2_tpu_torch.ops.dropout as port_dropout
import orbit2_tpu_torch.ops.flash_attention as port_flash
from orbit2_tpu.models import ResSlimViT as JaxResSlimViT
from orbit2_tpu_torch.models import ResSlimViT
from orbit2_tpu_torch.training.checkpoint import state_dict_from_jax_params

DEFAULT_VARS = (
    "land_sea_mask", "orography", "lattitude", "landcover",
    "total_precipitation_24hr", "2m_temperature_min", "2m_temperature_max",
)
OUT_VARS = DEFAULT_VARS[4:]
# head dim 64: the flash path (its plain version on the CPU)
TINY = dict(img_size=(8, 16), in_channels=7, out_channels=3, superres_mag=4, patch_size=2,
            embed_dim=128, depth=3, decoder_depth=1, num_heads=2, learn_pos_emb=True,
            spatial_resolution=625.0)


def port_model(remat, policy="full", drop=0.1, impl="auto"):
    return ResSlimViT(DEFAULT_VARS, attention_impl=impl, drop_rate=drop, drop_path=drop,
                      remat=remat, remat_policy=policy,
                      generator=torch.Generator().manual_seed(0), **TINY).train()


def inputs(seed=1, batch=4):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(batch, 7, 8, 16)).astype(np.float32))


def train_pass(model, x):
    """(output, loss, gradients by name and of the input, the two generators'
    states after the step) of one forward and backward."""
    dropout_gen, drop_path_gen = torch.Generator().manual_seed(2), torch.Generator().manual_seed(3)
    x = x.clone().requires_grad_()
    out = model(x, DEFAULT_VARS, OUT_VARS, dropout_gen, drop_path_gen)
    loss = out.square().mean()
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    grads["input"] = x.grad
    return out.detach(), loss.detach(), grads, (dropout_gen.get_state(), drop_path_gen.get_state())


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_is_bit_equal_to_no_remat(policy, impl):
    x = inputs()
    want = train_pass(port_model(False, impl=impl), x)
    got = train_pass(port_model(True, policy, impl=impl), x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert set(got[2]) == set(want[2])
    for k in want[2]:
        assert torch.equal(got[2][k], want[2][k]), k
    for g, w in zip(got[3], want[3]):
        assert torch.equal(g, w)  # the generators moved as without remat


def test_remat_draws_the_masks_it_was_given():
    """The recomputation replays the first run's draws: a model whose masks
    differ (other generator seeds) gives other gradients, so equality above
    is not the masks being inert."""
    x = inputs()
    a = train_pass(port_model(True), x)
    model = port_model(True)
    xg = x.clone().requires_grad_()
    model(xg, DEFAULT_VARS, OUT_VARS, torch.Generator().manual_seed(20),
          torch.Generator().manual_seed(30)).square().mean().backward()
    assert not torch.equal(xg.grad, a[2]["input"])


def count_calls(monkeypatch):
    calls = {"flash_fwd": 0, "flash_bwd": 0, "dropout": 0}

    def counted(module, name, key):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)

    counted(port_flash, "flash_attention_fwd", "flash_fwd")
    counted(port_flash, "flash_attention_bwd", "flash_bwd")
    counted(port_dropout, "apply_dropout", "dropout")
    return calls


@pytest.mark.parametrize("policy", ["full", "dots", None])
def test_remat_recomputes_the_kernels(monkeypatch, policy):
    """Where the kernels run in one train step (their plain versions here; the
    same calls launch them on the card): without remat, the flash forward
    and backward once a Block, the fused dropout at pos_drop and three sites
    a Block, forward and backward. With remat (either policy: the kernels
    are no products) the backward runs each Block's flash forward and
    dropouts again, but for the last dropout of Block 0: its drop-path rate
    is 0, so nothing after its fc2 is saved and the recomputation stops
    there (torch.utils.checkpoint's early stop)."""
    calls = count_calls(monkeypatch)
    depth = TINY["depth"]
    train_pass(port_model(policy is not None, policy or "full"), inputs())
    recompute = 0 if policy is None else 1
    assert calls == {"flash_fwd": (1 + recompute) * depth, "flash_bwd": depth,
                     "dropout": 2 * (1 + 3 * depth) + recompute * (3 * depth - 1)}


def test_no_recomputation_without_grad():
    model = port_model(True).eval()
    with torch.no_grad():
        want = port_model(False).eval()(inputs(), DEFAULT_VARS, OUT_VARS)
        assert torch.equal(model(inputs(), DEFAULT_VARS, OUT_VARS), want)


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        port_model(True, "offload")


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gradients_match_jax_remat(policy):
    jm = JaxResSlimViT(default_vars=DEFAULT_VARS, attention_impl="xla", drop_rate=0.0,
                       drop_path=0.0, remat=True, remat_policy=policy, **TINY)
    x = inputs(seed=4, batch=2).numpy()
    params = jax.jit(lambda k: jm.init({"params": k}, jnp.asarray(x), DEFAULT_VARS, OUT_VARS))(
        jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(5)
    # noise so the zero-initialised var_query/var_embed and unit LN scales hide no path
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32), params)

    def loss_fn(p):
        out = jm.apply({"params": p}, jnp.asarray(x), DEFAULT_VARS, OUT_VARS, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(0),
                             "drop_path": jax.random.PRNGKey(1)})
        return jnp.mean(jnp.square(out.astype(jnp.float32)))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, params))
    model = port_model(True, policy, drop=0.0)
    model.load_state_dict(state_dict_from_jax_params(params, patch_size=2), strict=True)
    loss = model(torch.from_numpy(x), DEFAULT_VARS, OUT_VARS, torch.Generator(),
                 torch.Generator()).square().mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5, rtol=1e-4)
    want_g = state_dict_from_jax_params(jax.tree.map(np.asarray, want_grads), patch_size=2)
    got_g = {k: p.grad for k, p in model.named_parameters()}
    assert set(got_g) == set(want_g)
    for k in want_g:
        np.testing.assert_allclose(got_g[k].numpy(), want_g[k].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=k)
