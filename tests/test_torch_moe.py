"""The MoE trunk of the PyTorch port (models/components/moe.py and the MoE
Blocks of models/res_slimvit.py) against the JAX package.

CPU, on weights carried across (JAX's init, perturbed with numpy noise) and
inputs drawn with numpy:
  * MoEMlp at fp32 against JAX MoEMlp, top-k 1 and 2, a capacity that binds
    (factor 0.5) and one that cannot: y and gradients (x, router, wi, bi, wo,
    bo) within atol 1e-5 / rtol 1e-4, the aux loss and the dropped tokens
    the same, the router's top-1 choices equal (a flip is a failure);
  * the cases of tests/test_moe.py on the port: one expert is the dense Mlp,
    overflow tokens get no output, aux near 1 for a fresh router, the router
    gets a gradient, a Block refuses w8a8, the output dropout drops, top-2
    with one live expert places nothing twice; the router stays fp32 through
    casts of the module's dtype;
  * a tiny MoE ResSlimViT (embed 64, depth 2, 4 experts in every Block):
    forward, aux losses and one train step's loss and gradients against JAX
    (atol 1e-5 / rtol 1e-4), a 5-epoch Trainer.fit trajectory against JAX
    Trainer.fit (rtol 2e-4, the aux term included), the tiled Evaluator.test
    against JAX Trainer.test (rtol 1e-4); remat full / dots / none bit for
    bit with dropout, each MoE Block's aux counted once, and the kernels'
    launches in a remat step;
  * configs/interm_1b_moe.yaml at 66 x 132 tiles: the port's meta build has
    JAX's parameters key for key by `jax.eval_shape` (nothing allocated).

CUDA (marker `cuda`, skipped without a card): the MoE layer in bf16 on the
card against fp32 on the CPU, its router kept fp32:
`python -m pytest --noconftest -m cuda tests/test_torch_moe.py`.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import orbit2_tpu_torch.ops.dropout as port_dropout
import orbit2_tpu_torch.ops.flash_attention as port_flash
from orbit2_tpu_torch.config import load_config
from orbit2_tpu_torch.evaluate import Evaluator, make_data_module, model_kwargs
from orbit2_tpu_torch.metrics.metrics import METRICS_REGISTRY
from orbit2_tpu_torch.models import ResSlimViT
from orbit2_tpu_torch.models.components.blocks import Block, Mlp
from orbit2_tpu_torch.models.components.moe import MoEMlp
from orbit2_tpu_torch.training.checkpoint import state_dict_from_jax_params
from orbit2_tpu_torch.training.optim import make_optimizer
from orbit2_tpu_torch.training.train import make_train_step
from orbit2_tpu_torch.training.trainer import Trainer
from orbit2_tpu_torch.utils.loaders import load_architecture

DEFAULT_VARS = (
    "land_sea_mask", "orography", "lattitude", "landcover",
    "total_precipitation_24hr", "2m_temperature_min", "2m_temperature_max",
)
OUT_VARS = DEFAULT_VARS[4:]
VAR_WEIGHTS = {"2m_temperature_min": 10, "2m_temperature_max": 10, "total_precipitation_24hr": 1}
HP = {"lr": 2e-3, "weight_decay": 1e-5, "betas": (0.9, 0.99)}
MOE = dict(moe_experts=4, moe_every=1, moe_capacity_factor=1.25)
# head dim 64: the flash path (its plain version on the CPU)
TINY = dict(img_size=(8, 16), in_channels=7, out_channels=3, superres_mag=4, patch_size=2,
            embed_dim=64, depth=2, decoder_depth=1, num_heads=1, learn_pos_emb=True,
            spatial_resolution=625.0, **MOE)
CONFIG_MOE = Path(__file__).resolve().parents[1] / "configs" / "interm_1b_moe.yaml"
D, H, B, L = 32, 64, 2, 16


def noisy(params, seed, scale=0.02):
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.normal(size=a.shape).astype(np.float32), params)


def jax_layer(num_experts, capacity_factor, top_k, seed=0):
    """JAX MoEMlp, its perturbed params and an input [B, L, D]."""
    import jax
    import jax.numpy as jnp

    from orbit2_tpu.models.components.moe import MoEMlp as JaxMoEMlp

    jm = JaxMoEMlp(dim=D, hidden_features=H, num_experts=num_experts,
                   capacity_factor=capacity_factor, top_k=top_k)
    x = np.random.default_rng(seed).normal(size=(B, L, D)).astype(np.float32)
    params = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x))["params"]
    return jm, noisy(params, seed + 1), x


def port_layer(params, capacity_factor, top_k, drop=0.0):
    tm = MoEMlp(D, H, params["wi"].shape[0], capacity_factor, top_k, drop=drop)
    tm.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()},
                       strict=True)
    return tm


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity_factor", [0.5, 4.0], ids=["binding", "ample"])
def test_moe_layer_matches_jax(top_k, capacity_factor):
    import jax
    import jax.numpy as jnp

    jm, params, x = jax_layer(4, capacity_factor, top_k)
    r = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)

    def loss(p, xj):
        y, sown = jm.apply({"params": p}, xj, mutable=["moe_loss"])
        (aux,) = jax.tree.leaves(sown["moe_loss"])
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (y_j, aux_j)), (g_p, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tm = port_layer(params, capacity_factor, top_k)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = tm(xt)
    ((y * torch.from_numpy(r)).sum() + aux).backward()

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(aux.item(), float(aux_j), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=1e-5, rtol=1e-4)
    for name in ("router_kernel", "wi", "bi", "wo", "bo"):
        np.testing.assert_allclose(getattr(tm, name).grad.numpy(), np.asarray(g_p[name]),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
    # the router's first choices, and the tokens over capacity, are JAX's
    rk = jnp.asarray(params["router_kernel"])
    want_top1 = np.asarray(jnp.argmax(jax.nn.softmax(jnp.asarray(x) @ rk, axis=-1), axis=-1))
    with torch.no_grad():
        np.testing.assert_array_equal(tm.router_probs(xt).argmax(-1).numpy(), want_top1)
    dropped = (y.detach().abs().sum(-1) == 0).numpy()
    np.testing.assert_array_equal(dropped, np.abs(np.asarray(y_j)).sum(-1) == 0)
    assert dropped.any() == (capacity_factor < 1.0)
    assert tm.capacity(L) == (min(L, int(np.ceil(L / 4 * capacity_factor * top_k))))


def drawn_layer(num_experts=4, capacity_factor=2.0, top_k=1, drop=0.0, seed=1):
    tm = MoEMlp(D, H, num_experts, capacity_factor, top_k, drop=drop)
    tm.reset_parameters(torch.Generator().manual_seed(seed))
    return tm


def inputs(b=B, l=L, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(b, l, D)).astype(np.float32))


def test_moe_single_expert_matches_dense_mlp():
    """One expert with ample capacity takes every token at gate 1: the dense
    Mlp with the same weights (tests/test_moe.py:26)."""
    tm = drawn_layer(num_experts=1, capacity_factor=1.0)
    with torch.no_grad():
        tm.bi.normal_(generator=torch.Generator().manual_seed(2))
        tm.bo.normal_(generator=torch.Generator().manual_seed(3))
    dense = Mlp(D, H)
    dense.load_state_dict({"fc1.weight": tm.wi[0].T, "fc1.bias": tm.bi[0],
                           "fc2.weight": tm.wo[0].T, "fc2.bias": tm.bo[0]})
    x = inputs()
    with torch.no_grad():
        torch.testing.assert_close(tm(x)[0], dense(x), rtol=1e-6, atol=1e-6)


def test_moe_capacity_drops_overflow_tokens():
    """Capacity 1 token an expert: at most E x C tokens of a batch row get a
    nonzero output (tests/test_moe.py:43)."""
    tm = drawn_layer(num_experts=2, capacity_factor=2 / 16)
    assert tm.capacity(L) == 1
    with torch.no_grad():
        y, _ = tm(inputs())
    nonzero = y.abs().sum(-1) > 1e-8
    assert (nonzero.sum(dim=1) <= 2).all()


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_aux_loss_near_one_for_uniform_router(top_k):
    """E x sum f_e p_e is 1 at perfect balance; a fresh router sits near it
    (tests/test_moe.py:57)."""
    tm = drawn_layer(top_k=top_k)
    with torch.no_grad():
        _, aux = tm(inputs(b=4, l=64))
    assert aux.dtype == torch.float32 and 0.9 < aux.item() < 1.3


def test_moe_router_receives_gradient():
    tm = drawn_layer()
    y, aux = tm(inputs())
    (y.square().mean() + 0.01 * aux).backward()
    assert tm.router_kernel.grad.abs().max() > 0 and tm.wi.grad.abs().max() > 0


def test_moe_block_rejects_quant():
    """w8a8 serving of an MoE Block fails loudly, with JAX's ValueError
    (tests/test_moe.py:200), in the Block and in the model."""
    with pytest.raises(ValueError, match="quant"):
        Block(D, 2, moe_experts=2, quant="w8a8")
    with pytest.raises(ValueError, match="expert FFN has no quantized path"):
        ResSlimViT(DEFAULT_VARS, quant="w8a8", **TINY)
    Block(D, 2, moe_experts=2)  # and serves unquantized


def test_quantize_refuses_moe():
    """utils/quantize.py refuses an MoE model or state dict rather than
    leave its experts unquantized: a dense w8a8 twin handed an MoE model's
    state dict, and an MoE model handed as the twin."""
    from orbit2_tpu_torch.utils.quantize import quantize_state_dict, w8a8_twin

    kw = dict(TINY, moe_experts=0)
    with torch.device("meta"):
        twin = ResSlimViT(DEFAULT_VARS, quant="w8a8", **kw)
    moe_state = port_model().state_dict()
    for run in (lambda: quantize_state_dict(twin, moe_state, partial=True),
                lambda: w8a8_twin(port_model(), moe_state)):
        with pytest.raises(ValueError, match="expert FFN has no quantized path"):
            run()


def test_moe_mlp_applies_proj_dropout():
    """drop > 0 drops y in training, through the fused dropout's plain
    version here (tests/test_moe.py:211); the hidden has no dropout."""
    tm = drawn_layer(drop=0.5)
    x = inputs()
    with torch.no_grad():
        y_det, _ = tm.eval()(x)
        y_tr, _ = tm.train()(x, torch.Generator().manual_seed(2))
    assert not torch.allclose(y_det, y_tr)
    assert (y_tr == 0).float().mean().item() > 0.2
    kept = y_tr != 0
    torch.testing.assert_close(y_tr[kept], y_det[kept] / 0.5)


def test_moe_top_k2_single_expert_no_double_placement():
    """top_k 2 where one expert's probability underflows to 0 for every
    token: round 2 places nothing, the gate renormalises to 1, and the
    output is the single expert's dense pass (tests/test_moe.py:229)."""
    tm = drawn_layer(num_experts=2, capacity_factor=1.0, top_k=2)
    with torch.no_grad():
        tm.router_kernel.zero_()
        tm.router_kernel[:, 0] = 10.0
    x = torch.ones(2, 16, D)
    assert tm.router_probs(x[:1, :1])[0, 0, 1].item() == 0.0  # the underflow is built
    dense = Mlp(D, H)
    dense.load_state_dict({"fc1.weight": tm.wi[0].T, "fc1.bias": tm.bi[0],
                           "fc2.weight": tm.wo[0].T, "fc2.bias": tm.bo[0]})
    with torch.no_grad():
        torch.testing.assert_close(tm(x)[0], dense(x), rtol=1e-5, atol=1e-5)


def test_router_stays_fp32_through_casts():
    """A cast of the module's dtype (model.to, the Evaluator's materialize)
    leaves the router fp32, as JAX keeps it; the experts take the dtype; a
    meta build moves to a device with to_empty as usual."""
    tm = drawn_layer()
    tm.to(torch.bfloat16)
    assert tm.router_kernel.dtype == torch.float32 and tm.wi.dtype == torch.bfloat16
    with torch.device("meta"):
        meta = drawn_layer()
    meta.to_empty(device="cpu")
    assert meta.router_kernel.device.type == "cpu"
    with torch.no_grad():
        y, aux = tm(inputs().bfloat16())
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32


def jax_model(drop=0.0, **kw):
    import jax
    import jax.numpy as jnp

    from orbit2_tpu.models import ResSlimViT as JaxResSlimViT

    jm = JaxResSlimViT(default_vars=DEFAULT_VARS, attention_impl="xla", drop_rate=drop,
                       drop_path=drop, **dict(TINY, **kw))
    x = jnp.zeros((2, 7, 8, 16), jnp.float32)
    params = jax.jit(lambda k: jm.init({"params": k}, x, DEFAULT_VARS, OUT_VARS))(
        jax.random.PRNGKey(0))["params"]
    return jm, noisy(params, 3)


def port_model(params=None, drop=0.0, remat=False, policy="full"):
    tm = ResSlimViT(DEFAULT_VARS, attention_impl="auto", drop_rate=drop, drop_path=drop,
                    remat=remat, remat_policy=policy,
                    generator=torch.Generator().manual_seed(0), **TINY)
    if params is not None:
        tm.load_state_dict(state_dict_from_jax_params(params, patch_size=2), strict=True)
    return tm


def batch(seed=1, b=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 7, 8, 16)).astype(np.float32),
            (rng.normal(size=(b, 3, 32, 64)) * 0.5).astype(np.float32))


def test_tiny_moe_trunk_forward_and_step_match_jax():
    """The eval forward and its aux losses, then one train step's loss (the
    aux term weighted 0.01, JAX make_train_step's) and every gradient."""
    import jax
    import jax.numpy as jnp

    from orbit2_tpu.registry import METRICS_REGISTRY as JAX_METRICS
    from orbit2_tpu.training.optim import make_optimizer as jax_make_optimizer
    from orbit2_tpu.training.train import clip_replace_constant as jax_clip
    from orbit2_tpu.training.train import make_train_step as jax_make_train_step

    jm, params = jax_model()
    x, y = batch()
    jp = jax.tree.map(jnp.asarray, params)
    want, sown = jm.apply({"params": jp}, jnp.asarray(x), DEFAULT_VARS, OUT_VARS,
                          mutable=["moe_loss"])
    want_aux = [float(a) for a in jax.tree.leaves(sown["moe_loss"])]
    tm = port_model(params)
    assert [blk.moe for blk in tm.blocks] == [True, True]
    with torch.no_grad():
        got, aux = tm.eval()(torch.from_numpy(x), DEFAULT_VARS, OUT_VARS, return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose([a.item() for a in aux], want_aux, atol=1e-5, rtol=1e-4)

    jloss = JAX_METRICS["bayesian_tv"](aggregate_only=True)

    def loss_fn(p):
        yhat, s = jm.apply({"params": p}, jnp.asarray(x), DEFAULT_VARS, OUT_VARS,
                           deterministic=False, mutable=["moe_loss"],
                           rngs={"dropout": jax.random.PRNGKey(0),
                                 "drop_path": jax.random.PRNGKey(1)})
        yhat = jax_clip(jnp.asarray(y), yhat.astype(jnp.float32), OUT_VARS)
        leaves = jax.tree.leaves(s["moe_loss"])
        return (jloss(yhat, jnp.asarray(y), var_names=list(OUT_VARS), var_weights=VAR_WEIGHTS)
                + 0.01 * sum(leaves) / len(leaves))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    tx = jax_make_optimizer("adamw", HP)
    jstep = jax_make_train_step(jm, jloss, VAR_WEIGHTS, tx, DEFAULT_VARS, OUT_VARS,
                                moe_aux_weight=0.01)
    _, _, step_loss = jstep(jp, tx.init(jp), jnp.asarray(x), jnp.asarray(y),
                            jax.random.PRNGKey(2))
    np.testing.assert_allclose(float(step_loss), float(want_loss), rtol=1e-6)

    tm = port_model(params)
    opt = make_optimizer("adamw", HP, tm.named_parameters())
    step = make_train_step(tm, METRICS_REGISTRY["bayesian_tv"](aggregate_only=True), VAR_WEIGHTS,
                           opt, DEFAULT_VARS, OUT_VARS, moe_aux_weight=0.01)
    loss = step(torch.from_numpy(x), torch.from_numpy(y), torch.Generator(), None)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5, rtol=1e-4)
    want_g = state_dict_from_jax_params(jax.tree.map(np.asarray, want_grads), patch_size=2)
    got_g = {k: p.grad for k, p in tm.named_parameters()}
    assert set(got_g) == set(want_g) and any(".moe_mlp.router_kernel" in k for k in got_g)
    for k in want_g:
        np.testing.assert_allclose(got_g[k].numpy(), want_g[k].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=k)


def tiny_raw(ds, **model):
    """tests/test_torch_train.py's tiny config with 4 experts in every Block."""
    return {
        "trainer": {"max_epochs": 5, "batch_size": 4, "buffer_size": 8, "num_workers": 0,
                    "data_type": "float32", "train_loss": "bayesian_tv", "remat": False,
                    "interval_epochs": 1},
        "parallelism": {"fsdp": 1, "simple_ddp": 1, "tensor_par": 1},
        "tiling": {"do_tiling": False},
        "model": {"preset": "res_slimvit", "lr": 1e-3, "warmup_epochs": 1, "superres_mag": 4,
                  "patch_size": 2, "embed_dim": 64, "depth": 2, "decoder_depth": 1,
                  "num_heads": 2, "drop_path": 0.0, "drop_rate": 0.0, "attention_impl": "auto",
                  "moe_aux_weight": 0.5, **MOE, **model},
        "data": {
            "low_res_dir": {"SYNTH": ds["low"]}, "high_res_dir": {"SYNTH": ds["high"]},
            "spatial_resolution": {"SYNTH": 625}, "default_vars": list(ds["in_vars"]),
            "dict_in_variables": {"SYNTH": list(ds["in_vars"])},
            "dict_out_variables": {"SYNTH": list(ds["out_vars"])},
            "var_weights": VAR_WEIGHTS,
        },
    }


def test_moe_trainer_fit_trajectory_matches_jax(synth_dataset, tmp_path):
    """Trainer.fit on the MoE config, 5 epochs of one step, from the JAX
    Trainer's initial parameters: each epoch's loss, the aux term (weighted
    0.5 here, so that it shows) included, within rtol 2e-4 of JAX's."""
    import jax

    from orbit2_tpu.config import load_config as jax_load_config
    from orbit2_tpu.training.trainer import Trainer as JaxTrainer

    raw = tiny_raw(synth_dataset)
    jt = JaxTrainer(jax_load_config(raw), checkpoint_dir=str(tmp_path / "ck"))
    jt.test(max_batches=0)  # builds the model and draws the initial parameters
    init = state_dict_from_jax_params(jax.tree.map(np.asarray, jt.params), patch_size=2)
    assert any(".moe_mlp." in k for k in init)
    want = jt.fit(max_epochs=5, max_steps_per_epoch=1)
    trainer = Trainer(load_config(raw), "cpu", state_dict=init)
    got = trainer.fit(max_epochs=5, max_steps_per_epoch=1)
    assert [r["lr"] for r in got] == [r["lr"] for r in want]
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want], rtol=2e-4)
    # the aux term is in the loss: without it the first step's loss is less
    dense = Trainer(load_config(tiny_raw(synth_dataset, moe_aux_weight=0.0)), "cpu",
                    state_dict=init).fit(max_epochs=1, max_steps_per_epoch=1)
    assert got[0]["loss"] - dense[0]["loss"] > 0.4


def test_moe_tiled_evaluator_matches_jax_trainer_test(synth_dataset, tmp_path):
    """Evaluator.test on div 2 / overlap 2 tiles against JAX Trainer.test on
    the same perturbed weights (rtol 1e-4); w8a8 is refused wherever it is
    asked for, with JAX's ValueError, and the default Evaluator builds the
    bf16-capable model alone."""
    import jax

    from orbit2_tpu.config import load_config as jax_load_config
    from orbit2_tpu.training.trainer import Trainer as JaxTrainer

    raw = tiny_raw(synth_dataset)
    raw["tiling"] = {"do_tiling": True, "div": 2, "overlap": 2}
    jt = JaxTrainer(jax_load_config(raw), checkpoint_dir=str(tmp_path / "ck"))
    jt.test(max_batches=1)
    jt.params = noisy(jt.params, 1, scale=0.3)
    want = jt.test(max_batches=2)
    with pytest.raises(ValueError) as jax_refusal:
        jt.test(max_batches=1, quant="w8a8")

    ev = Evaluator(load_config(raw), "cpu",
                   state_dict=state_dict_from_jax_params(jax.tree.map(np.asarray, jt.params),
                                                         patch_size=2))
    assert ev.quant_modes == ("none",) and not ev._twins
    got = ev.test(max_batches=2)
    assert list(got) == list(want) and len(got) == 12
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError) as refusal:
        ev.test(max_batches=1, quant="w8a8")
    assert str(refusal.value) == str(jax_refusal.value)
    with pytest.raises(ValueError, match="expert FFN has no quantized path"):
        Evaluator(load_config(raw), "cpu", quant_modes=("none", "w8a8"))


def test_moe_serving_clis(synth_dataset, tmp_path, monkeypatch, capsys):
    """The evaluate and visualize CLIs serve an MoE config in bf16 and refuse
    --quant w8a8; a bf16 Evaluator keeps the routers fp32."""
    import json

    from orbit2_tpu_torch import evaluate, visualize

    monkeypatch.chdir(tmp_path)
    raw = tiny_raw(synth_dataset)
    raw["trainer"]["data_type"] = "bfloat16"
    path = tmp_path / "moe.yaml"
    path.write_text(yaml.safe_dump(raw))
    evaluate.main([str(path), "--max-batches", "1", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert len(out) == 12 and all(np.isfinite(v) for v in out.values())
    res = visualize.main([str(path), "--out-dir", str(tmp_path / "vis"), "--device", "cpu"])
    capsys.readouterr()
    assert set(res["metrics"]) == set(OUT_VARS)
    for cli in (evaluate, visualize):
        with pytest.raises(ValueError, match="expert FFN has no quantized path"):
            cli.main([str(path), "--quant", "w8a8", "--device", "cpu"])
    ev = Evaluator(load_config(raw), "cpu")
    routers = [b.moe_mlp.router_kernel for b in ev.model.blocks]
    assert all(r.dtype == torch.float32 for r in routers)
    assert ev.model.blocks[0].moe_mlp.wi.dtype == torch.bfloat16


def test_moe_mc_dropout_drops_the_moe_output(monkeypatch):
    """The MC ensemble runs the MoE output's dropout: one fused-dropout call
    fewer a Block than a dense Block's three, samples that differ."""
    from orbit2_tpu_torch.utils.mc_dropout import get_monte_carlo_predictions

    calls = count_calls(monkeypatch)
    x, _ = batch()
    ens = get_monte_carlo_predictions(port_model(drop=0.1), torch.from_numpy(x), DEFAULT_VARS,
                                      OUT_VARS, n_samples=2)
    assert ens.shape == (2, 4, 3, 32, 64) and not torch.equal(ens[0], ens[1])
    assert calls["dropout"] == 2 * (1 + 2 * TINY["depth"])


def train_pass(model, x):
    """(output, loss with the aux mean, aux losses, gradients by name and of
    the input, the generators' states) of one forward and backward."""
    dropout_gen, drop_path_gen = torch.Generator().manual_seed(2), torch.Generator().manual_seed(3)
    x = x.clone().requires_grad_()
    out, aux = model(x, DEFAULT_VARS, OUT_VARS, dropout_gen, drop_path_gen, return_aux=True)
    loss = out.square().mean() + 0.01 * sum(aux) / len(aux)
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    grads["input"] = x.grad
    return (out.detach(), loss.detach(), [a.detach() for a in aux], grads,
            (dropout_gen.get_state(), drop_path_gen.get_state()))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_moe_remat_is_bit_equal_to_no_remat(policy):
    """Remat with dropout and drop-path 0.1 on the MoE trunk: output, loss,
    every aux loss (one a MoE Block: the recomputation adds none), every
    gradient and both generators' states equal no remat's bit for bit."""
    x = torch.from_numpy(batch()[0])
    want = train_pass(port_model(drop=0.1), x)
    got = train_pass(port_model(drop=0.1, remat=True, policy=policy), x)
    assert len(got[2]) == len(want[2]) == TINY["depth"]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(g, w) for g, w in zip(got[2], want[2]))
    assert set(got[3]) == set(want[3]) and any("router_kernel" in k for k in got[3])
    for k in want[3]:
        assert torch.equal(got[3][k], want[3][k]), k
    for g, w in zip(got[4], want[4]):
        assert torch.equal(g, w)


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


@pytest.mark.parametrize("moe_every", [1, 2])
@pytest.mark.parametrize("policy", ["full", None])
def test_moe_remat_recomputes_the_kernels(monkeypatch, policy, moe_every):
    """An MoE Block runs the fused dropout at two sites (attention's
    projection, the MoE output) where a dense Block has three; the rest as
    tests/test_torch_remat.py counts it: forward and backward, and again in
    the recomputation but for Block 0's last site (drop-path rate 0 there,
    so the recomputation stops early)."""
    calls = count_calls(monkeypatch)
    depth = 3
    model = ResSlimViT(DEFAULT_VARS, attention_impl="auto", drop_rate=0.1, drop_path=0.1,
                       remat=policy is not None, remat_policy=policy or "full",
                       generator=torch.Generator().manual_seed(0),
                       **dict(TINY, depth=depth, moe_every=moe_every))
    train_pass(model, torch.from_numpy(batch()[0]))
    sites = sum(2 if blk.moe else 3 for blk in model.blocks)
    assert sites == 3 * depth - depth // moe_every
    again = int(policy is not None)
    assert calls == {"flash_fwd": (1 + again) * depth, "flash_bwd": depth,
                     "dropout": 2 * (1 + sites) + again * (sites - 1)}


def write_prism(root: Path, low=(252, 504), mag=4):
    """A PRISM test split of one field at `low` -> mag x finer (the
    tests/conftest.py layout), every split's climatology."""
    in_vars, out_vars = list(DEFAULT_VARS), list(OUT_VARS)
    rng = np.random.default_rng(0)
    for base, (h, w), variables in ((root / "low", low, in_vars),
                                    (root / "high", (low[0] * mag, low[1] * mag), out_vars)):
        for split in ("train", "val", "test"):
            (base / split).mkdir(parents=True)
            if split == "test":
                np.savez(base / split / "shard_0.npz", **{
                    v: rng.normal(280, 10, (1, 1, h, w)).astype(np.float32) for v in variables})
            np.savez(base / split / "climatology.npz", **{
                v: rng.normal(280, 1, (1, h, w)).astype(np.float32) for v in variables})
        np.save(base / "lat.npy", np.linspace(-88, 88, h).astype(np.float32))
        np.save(base / "lon.npy", np.linspace(0, 358, w).astype(np.float32))
        np.savez(base / "normalize_mean.npz", **{v: np.array([280.0], np.float32)
                                                 for v in variables})
        np.savez(base / "normalize_std.npz", **{v: np.array([10.0], np.float32)
                                                for v in variables})
    return str(root / "low"), str(root / "high")


# the port's parameters of interm_1b_moe.yaml at 66 x 132 tiles (JAX's count)
PARAMS_1B_MOE = 3_103_984_003


def test_1b_moe_parameters_match_jax_key_for_key(tmp_path, monkeypatch):
    """configs/interm_1b_moe.yaml (mesh cut to one device) on a synthetic
    PRISM split of 252 x 504: div 4 / overlap 3 tiles of 66 x 132 (2,178
    tokens). The port's meta build holds JAX's parameters (jax.eval_shape of
    the JAX Trainer's phase model), every tensor's shape key for key through
    the export's key map on zero-byte arrays: nothing is allocated."""
    import jax
    import jax.numpy as jnp

    from orbit2_tpu.config import load_config as jax_load_config
    from orbit2_tpu.training.trainer import Trainer as JaxTrainer
    from orbit2_tpu_torch.training import checkpoint as ck

    raw = yaml.safe_load(CONFIG_MOE.read_text())
    lo, hi = write_prism(tmp_path)
    data = raw["data"]
    data["low_res_dir"], data["high_res_dir"] = {"PRISM": lo}, {"PRISM": hi}
    raw["parallelism"] = {"fsdp": 1, "simple_ddp": 1, "tensor_par": 1, "seq_par": 1,
                          "expert_par": 1}
    raw["trainer"].update({"batch_size": 2, "num_workers": 0})
    cfg = load_config(copy.deepcopy(raw))
    dm = make_data_module(cfg, "PRISM", 4, 3, "test")
    in_shape, _ = dm.get_data_dims()
    assert tuple(in_shape[1:]) == (7, 66, 132)
    with torch.device("meta"):
        model = load_architecture(dm, "res_slimvit", **dict(model_kwargs(cfg), generator=None))
    port = model.state_dict()
    assert [blk.moe for blk in model.blocks] == [False, True] * 4
    assert tuple(port["blocks.1.moe_mlp.wi"].shape) == (8, 3072, 12288)
    assert sum(t.numel() for t in port.values()) == PARAMS_1B_MOE

    jt = JaxTrainer(jax_load_config(copy.deepcopy(raw)), checkpoint_dir=str(tmp_path / "ck"))
    jdm = jt._make_data_module("PRISM")
    jdm.setup("test")
    jt._build_model(jdm, "PRISM")
    phase_model = jt._phase_model(jdm, "PRISM")
    in_vars, out_vars = jdm.get_data_variables()
    dummy = jnp.zeros((2,) + tuple(in_shape[1:]), jnp.float32)
    params = jax.eval_shape(lambda r: phase_model.init(
        {"params": r}, dummy, tuple(in_vars), tuple(out_vars), deterministic=True),
        jax.random.PRNGKey(0))["params"]
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params)) == PARAMS_1B_MOE
    empty = jax.tree.map(lambda a: np.zeros(a.shape, np.dtype([])), params)
    monkeypatch.setattr(ck.torch, "from_numpy", lambda a: torch.empty(a.shape, device="meta"))
    want = ck.state_dict_from_jax_params(empty, patch_size=2)
    assert sorted(want) == sorted(port)
    for k, t in port.items():
        assert tuple(want[k].shape) == tuple(t.shape), k


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_layer_on_the_card(cuda, top_k):
    """The layer in bf16 on the card (its router fp32 after .to(bf16)) near
    the same layer at fp32 on the CPU: the routing agrees on every token
    whose two best probabilities differ by more than 1e-2, and y within a
    bf16 tolerance where it does."""
    cpu = drawn_layer(top_k=top_k, capacity_factor=4.0)
    card = copy.deepcopy(cpu).to(cuda, torch.bfloat16)
    assert card.router_kernel.dtype == torch.float32
    x = inputs(b=4, l=256)
    with torch.no_grad():
        want, aux_want = cpu(x)
        got, aux = card(x.to(cuda, torch.bfloat16))
        probs = cpu.router_probs(x)
    top2 = probs.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-2
    with torch.no_grad():
        choice = card.router_probs(x.to(cuda, torch.bfloat16)).argmax(-1).cpu()
    assert torch.equal(choice[clear], probs.argmax(-1)[clear])
    torch.testing.assert_close(got.float().cpu()[clear], want[clear], atol=2e-2, rtol=2e-2)
    assert abs(aux.item() - aux_want.item()) < 1e-2
