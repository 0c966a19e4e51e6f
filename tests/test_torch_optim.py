"""AdamW and the warmup-cosine schedule of the PyTorch port against the JAX
package's optax chain (orbit2_tpu/training/optim.py::make_optimizer), with
interm_117m's hyperparameters on a small random tree of parameters, gradients
made with numpy. fp32 moments agree within rtol 1e-6 and bf16 moments within
rtol 1e-5 (both sides do the same fp32 arithmetic; a division may be a
multiplication by the reciprocal on one side), the parameters within
rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from orbit2_tpu.training.optim import linear_warmup_cosine_annealing as jax_schedule
from orbit2_tpu.training.optim import make_optimizer as jax_make_optimizer
from orbit2_tpu.training.optim import set_learning_rate as jax_set_lr
from orbit2_tpu_torch.training.optim import (
    make_lr_scheduler,
    make_optimizer,
    set_learning_rate,
)

# configs/interm_117m.yaml
HP = {"lr": 2e-3, "weight_decay": 1e-5, "betas": (0.9, 0.99)}
SHAPES = {"w": (16, 24), "b": (24,), "g": (3, 5, 7)}


def _moments(state):
    adam = state.inner_state[0]
    return adam.mu, adam.nu


@pytest.mark.parametrize("mu_dtype,nu_dtype", [(None, None), ("bfloat16", "bfloat16")],
                         ids=["fp32", "bf16"])
def test_adamw_matches_optax_five_steps(mu_dtype, nu_dtype):
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    hp = dict(HP, mu_dtype=mu_dtype, nu_dtype=nu_dtype)
    tx = jax_make_optimizer("adamw", hp)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    opt = make_optimizer("adamw", hp, tp.items())
    moment_tol = 1e-6 if mu_dtype is None else 1e-5
    for step in range(5):
        lr = 2e-3 * (step + 1) / 5  # the per-epoch lr path
        state = jax_set_lr(state, lr)
        set_learning_rate(opt, lr)
        grads = {k: (rng.normal(size=s) * 10.0 ** rng.integers(-4, 1)).astype(np.float32)
                 for k, s in SHAPES.items()}
        updates, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        mu, nu = _moments(state)
        for i, k in enumerate(tp):
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {step} param {k}")
            for name, got, want in (("mu", opt.mu[i], mu[k]), ("nu", opt.nu[i], nu[k])):
                assert str(got.dtype).split(".")[-1] == str(want.dtype)
                np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                           rtol=moment_tol, atol=0,
                                           err_msg=f"step {step} {name} {k}")


def test_step_needs_every_gradient():
    """Every parameter gets a gradient in the step: one the loss did not
    reach (its .grad is None) takes a zero gradient, as optax does with the
    zeros JAX's grad gives it, so its moments decay and weight decay still
    moves it."""
    rng = np.random.default_rng(1)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    hp = dict(HP, weight_decay=0.5)
    tx = jax_make_optimizer("adamw", hp)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    opt = make_optimizer("adamw", hp, tp.items())
    for step in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
        grads["b"] = np.zeros_like(grads["b"]) if step else grads["b"]
        updates, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = None if k == "b" and step else torch.from_numpy(grads[k])
        opt.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert not np.array_equal(tp["b"].detach().numpy(), params["b"])


@pytest.mark.parametrize("group_bytes", [1, 4 * 24 + 4 * 16 * 24, 1 << 30],
                         ids=["one-a-group", "two-groups", "one-group"])
def test_grouped_step_equals_one_foreach_over_all(monkeypatch, group_bytes):
    """The step runs over groups of at most GROUP_BYTES of parameters (its
    fp32 temporaries must fit beside a 3B model's state): three steps under
    bf16 moments give the parameters and moments of a step over all of
    them at once, bit for bit."""
    import orbit2_tpu_torch.training.optim as optim

    rng = np.random.default_rng(2)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3)]

    def run():
        named = [(k, torch.from_numpy(v.copy()).requires_grad_()) for k, v in params.items()]
        opt = make_optimizer("adamw", dict(HP, mu_dtype="bfloat16", nu_dtype="bfloat16"), named)
        for g in grads:
            for k, p in named:
                p.grad = torch.from_numpy(g[k])
            opt.step()
        return opt

    whole = run()
    monkeypatch.setattr(optim, "GROUP_BYTES", group_bytes)
    grouped = run()
    want = {1: 3, 4 * 24 + 4 * 16 * 24: 2, 1 << 30: 1}[group_bytes]
    assert len(grouped.groups) == want and len(whole.groups) == 1
    for a, b in zip(grouped.params + grouped.mu + grouped.nu, whole.params + whole.mu + whole.nu):
        assert torch.equal(a, b)


def test_warmup_cosine_matches_jax_every_epoch():
    kw = dict(lr=2e-3, warmup_epochs=2, max_epochs=10, warmup_start_lr=1e-7, eta_min=1e-8)
    got = make_lr_scheduler("linear-warmup-cosine-annealing", kw)
    want = jax_schedule(base_lr=kw["lr"], warmup_epochs=2, max_epochs=10,
                        warmup_start_lr=1e-7, eta_min=1e-8)
    assert [got(e) for e in range(12)] == [want(e) for e in range(12)]
    with pytest.raises(NotImplementedError):
        make_lr_scheduler("cosine", kw)


@pytest.mark.parametrize("name,kw", [
    ("constant", dict(lr=3e-4)),
    ("linear", dict(lr=1e-3, end_lr=1e-5, total_iters=6)),
    ("exponential", dict(lr=1e-3, gamma=0.9)),
], ids=["constant", "linear", "exponential"])
def test_schedules_match_jax_every_epoch(name, kw):
    from orbit2_tpu.training.optim import make_lr_scheduler as jax_make_lr_scheduler

    got, want = make_lr_scheduler(name, kw), jax_make_lr_scheduler(name, kw)
    assert [got(e) for e in range(10)] == [want(e) for e in range(10)]


def test_reduce_lr_on_plateau_matches_jax_over_a_metric_sequence():
    from orbit2_tpu.training.optim import make_lr_scheduler as jax_make_lr_scheduler

    kw = dict(lr=1e-2, factor=0.5, patience=2, min_lr=2e-3)
    got = make_lr_scheduler("reduce-lr-on-plateau", kw)
    want = jax_make_lr_scheduler("reduce-lr-on-plateau", kw)
    metrics = [1.0, 0.9, 0.95, 0.93, 0.92, 0.91, 0.95, 0.96, 0.97, 0.98, 0.5, 0.6, 0.7, 0.8, 0.9]
    lrs = []
    for epoch, m in enumerate(metrics):
        assert got(epoch) == want(epoch)
        lrs.append(got.step(m))
        assert lrs[-1] == want.step(m)
    assert lrs[0] == 1e-2 and min(lrs) == 2e-3 and len(set(lrs)) == 4  # halved twice, then floored


@pytest.mark.parametrize("name,hp", [("adam", dict(lr=2e-3, betas=(0.9, 0.99))),
                                     ("sgd", dict(lr=1e-2, momentum=0.0)),
                                     ("sgd", dict(lr=1e-2, momentum=0.9))],
                         ids=["adam", "sgd", "sgd_momentum"])
def test_adam_and_sgd_match_optax_five_steps(name, hp):
    """optax.adam and optax.sgd (the JAX package's make_optimizer) against
    the port's over 5 steps of numpy gradients, the lr set per step."""
    rng = np.random.default_rng(1)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    tx = jax_make_optimizer(name, hp)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    opt = make_optimizer(name, hp, tp.items())
    for step in range(5):
        lr = hp["lr"] * (step + 1) / 5
        state = jax_set_lr(state, lr)
        set_learning_rate(opt, lr)
        grads = {k: (rng.normal(size=s) * 10.0 ** rng.integers(-3, 1)).astype(np.float32)
                 for k, s in SHAPES.items()}
        updates, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{name} step {step} param {k}")
    with pytest.raises(NotImplementedError):
        make_optimizer("lamb", hp, tp.items())
