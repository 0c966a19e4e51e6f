"""ResSlimViT of the PyTorch port against the JAX package, on the same weights.

JAX params are drawn from a PRNG key and then perturbed with numpy noise
(so the zero-initialised var_query/var_embed and unit LayerNorm scales do not
hide any path), carried across with `state_dict_from_jax_params`, and loaded
with `load_state_dict(strict=True)`. The fp32 forwards then agree within
atol 1e-5, rtol 1e-4: the same math summed in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbit2_tpu.models import ResSlimViT as JaxResSlimViT
from orbit2_tpu.training.checkpoint import export_torch_state_dict
from orbit2_tpu_torch.models import ResSlimViT
from orbit2_tpu_torch.training.checkpoint import state_dict_from_jax_params

DEFAULT_VARS = (
    "land_sea_mask", "orography", "lattitude", "landcover",
    "total_precipitation_24hr", "2m_temperature_min", "2m_temperature_max",
)
OUT_VARS = DEFAULT_VARS[4:]

# interm_8m: the shape of __graft_entry__.py:20-25
INTERM_8M = dict(img_size=(32, 64), embed_dim=256, depth=6, decoder_depth=4, num_heads=4)
# interm_117m widths (embed 1024, 16 heads, decoder_depth 4) at depth 1
WIDTH_117M = dict(img_size=(16, 32), embed_dim=1024, depth=1, decoder_depth=4, num_heads=16)


def make_pair(geom, attention_impl="auto", seed=0, batch=2):
    kw = dict(default_vars=DEFAULT_VARS, in_channels=len(DEFAULT_VARS), out_channels=3,
              superres_mag=4, patch_size=2, learn_pos_emb=True, spatial_resolution=625.0,
              **geom)
    jm = JaxResSlimViT(attention_impl="xla", **kw)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, len(DEFAULT_VARS)) + geom["img_size"]).astype(np.float32)
    params = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x), DEFAULT_VARS,
                     OUT_VARS, deterministic=True)["params"]
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32), params)
    tm = ResSlimViT(attention_impl=attention_impl, **kw).eval()
    tm.load_state_dict(state_dict_from_jax_params(params, patch_size=2), strict=True)
    return jm, params, tm, x


def jax_forward(jm, params, x):
    return np.asarray(jm.apply({"params": params}, jnp.asarray(x), DEFAULT_VARS, OUT_VARS,
                               deterministic=True))


def torch_forward(tm, x):
    with torch.no_grad():
        return tm(torch.from_numpy(x), DEFAULT_VARS, OUT_VARS).numpy()


def test_state_dict_matches_jax_export_key_for_key():
    _, params, tm, _ = make_pair(dict(INTERM_8M, depth=2))
    want = export_torch_state_dict(params, patch_size=2)
    got = state_dict_from_jax_params(params, patch_size=2)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert set(tm.state_dict()) == set(want)


@pytest.mark.parametrize("geom,impl", [
    (INTERM_8M, "auto"),
    (INTERM_8M, "xla"),
    (WIDTH_117M, "auto"),
], ids=["interm_8m-auto", "interm_8m-xla", "117m_width_depth1-auto"])
def test_forward_matches_jax(geom, impl):
    jm, params, tm, x = make_pair(geom, impl)
    want = jax_forward(jm, params, x)
    got = torch_forward(tm, x)
    assert got.shape == (2, 3, geom["img_size"][0] * 4, geom["img_size"][1] * 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_for_phase_resizes_pos_embed_like_jax():
    """A phase at another image size resizes the pos embed on the fly with the
    bicubic weight matrix (pos_embed.py:45-91) in both packages."""
    geom = dict(INTERM_8M, depth=1)
    jm, params, tm, _ = make_pair(geom)
    x = np.random.default_rng(5).normal(size=(1, 7, 16, 32)).astype(np.float32)
    jm2 = jm.for_phase(spatial_resolution=111.0, img_size=(16, 32), in_channels=7,
                       out_channels=3)
    tm.for_phase(spatial_resolution=111.0, img_size=(16, 32), in_channels=7, out_channels=3)
    np.testing.assert_allclose(torch_forward(tm, x), jax_forward(jm2, params, x),
                               atol=1e-5, rtol=1e-4)


def test_train_mode_forward_raises():
    tm = ResSlimViT(DEFAULT_VARS, (8, 16), 7, 3, embed_dim=32, depth=1, decoder_depth=1,
                    num_heads=2, learn_pos_emb=True)
    x = torch.zeros(1, 7, 8, 16)
    with pytest.raises(NotImplementedError):
        tm.train()(x, DEFAULT_VARS, OUT_VARS)
    assert tm.eval()(x, DEFAULT_VARS, OUT_VARS).shape == (1, 3, 32, 64)


@pytest.mark.parametrize("kwargs", [dict(moe_experts=4), dict(pipeline_stages=2),
                                    dict(seq_shard=True), dict(quant="w8a8")],
                         ids=["moe", "pipeline", "seq_shard", "w8a8"])
def test_unported_trunks_raise(kwargs):
    with pytest.raises(NotImplementedError):
        ResSlimViT(DEFAULT_VARS, (8, 16), 7, 3, embed_dim=32, depth=2, decoder_depth=1,
                   num_heads=2, **kwargs)


def test_init_is_seeded_by_the_generator():
    def build(seed):
        return ResSlimViT(DEFAULT_VARS, (8, 16), 7, 3, embed_dim=32, depth=1,
                          decoder_depth=1, num_heads=2,
                          generator=torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = build(0), build(0), build(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.attn.qkv.weight"], c["blocks.0.attn.qkv.weight"])
