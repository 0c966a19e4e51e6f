"""Optimizers (AdamW, Adam, SGD) and the per-epoch learning-rate schedules
(counterpart of orbit2_tpu/training/optim.py).

`AdamW` reproduces optax.adamw and the JAX package's `_adamw_2dtypes`
(optim.py:21-89) step for step:
  * the moments are updated in fp32 whatever their storage dtype; the update
    is computed from these fresh fp32 moments and only then are the stored
    moments cast down (one rounding per step), so bf16 mu/nu storage halves
    their memory without bf16 arithmetic;
  * update = mu_hat / (sqrt(nu_hat) + eps) with eps = 1e-8 outside the root,
    mu_hat = mu / (1 - b1^t), nu_hat = nu / (1 - b2^t);
  * weight decay is added after the Adam scaling and before the learning
    rate, on every parameter: p -= lr * (update + wd * p);
  * every hyperparameter, 1 - b, and b^t are fp32 values, as the pinned fp32
    hyperparameters make optax compute them (optim.py:117-123); b^t is
    computed on the host from the step count by squaring in fp32, as XLA
    evaluates a power with an integral exponent, so a step never waits for
    the device.
torch.optim.AdamW is not used: it cannot keep bf16 moments beside fp32
parameters. The step runs as torch._foreach_* ops over groups of the
parameter list of at most GROUP_BYTES of fp32 each: its fp32 temporaries
(the fresh moments, the moments read up to fp32, the update) come to about
five times the parameters they cover, so over the whole list at once they
would not fit beside a 3B model's state on an 80 GB card
(configs/interm_1b_moe.yaml). Every op is elementwise: the grouping changes
no value.

`state_dict()` / `load_state_dict()` carry `count`, `lr` and the moments
keyed by parameter name (AdamW is built from `named_parameters()`); a load
casts each moment to this optimizer's storage dtype, as Orbax casts to the
template on a JAX restore, so a checkpoint with fp32 moments resumes under
bf16 moments and the reverse.

On a device mesh (parallel/sharding.py) the parameters are DTensors: the
moments are made like them (DTensors of the same placements, so sharded
like their parameters), the step runs on the local shards, a load copies
each rank's part of a whole moment in (`shard_like`), and state_dict()'s
moments are the DTensors, which a checkpoint gathers whole.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from orbit2_tpu_torch.parallel.tensor import local

_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}
# the fp32 bytes of parameters a step's foreach ops cover at once
GROUP_BYTES = 1 << 30


def _f32(x: float) -> float:
    """x rounded to fp32 (returned as the Python float of that fp32 value)."""
    return float(np.float32(x))


def _pow_f32(base: np.float32, n: int) -> np.float32:
    """base ** n by binary exponentiation, every product rounded to fp32."""
    out, sq = np.float32(1.0), np.float32(base)
    while n:
        if n & 1:
            out = np.float32(out * sq)
        sq = np.float32(sq * sq)
        n >>= 1
    return out


class AdamW:
    """AdamW over `named_params`, (name, tensor) pairs as `named_parameters()`
    gives them: the step reads each tensor's .grad, the state is keyed by
    the names. mu_dtype / nu_dtype: storage dtype of the moments, None for
    the parameter's."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, mu_dtype=None, nu_dtype=None):
        pairs = [(n, p) for n, p in named_params if p.requires_grad]
        self.names = [n for n, _ in pairs]
        self.params = [p for _, p in pairs]
        self.b1, self.b2 = np.float32(b1), np.float32(b2)
        self.eps = _f32(eps)
        self.weight_decay = _f32(weight_decay)
        self.lr = _f32(lr)
        self.count = 0
        with torch.no_grad():
            self.mu = [torch.zeros_like(p, dtype=_DTYPES[mu_dtype] or p.dtype)
                       for p in self.params]
            self.nu = [torch.zeros_like(p, dtype=_DTYPES[nu_dtype] or p.dtype)
                       for p in self.params]
        # consecutive slices of the parameters, each GROUP_BYTES of fp32 at
        # most (or one larger parameter)
        self.groups, start, size = [], 0, 0
        for i, p in enumerate(self.params):
            if i > start and size + 4 * p.numel() > GROUP_BYTES:
                self.groups.append(slice(start, i))
                start, size = i, 0
            size += 4 * p.numel()
        if self.params:
            self.groups.append(slice(start, len(self.params)))

    def set_learning_rate(self, lr: float) -> None:
        self.lr = _f32(lr)

    def state_dict(self) -> Dict[str, Any]:
        """{"count", "lr", "mu": {name: moment}, "nu": {name: moment}}: the
        live moments, not copies."""
        return {"count": self.count, "lr": self.lr, "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copies `state` (state_dict's layout) in, each moment cast to its
        storage dtype here and moved to its parameter's device."""
        for key, mine in (("mu", self.mu), ("nu", self.nu)):
            got = state[key]
            missing, extra = set(self.names) - set(got), set(got) - set(self.names)
            if missing or extra:
                raise KeyError(f"optimizer state {key}: missing {sorted(missing)}, unexpected "
                               f"{sorted(extra)}")
            for name, m in zip(self.names, mine):
                if got[name].shape != m.shape:
                    raise ValueError(f"optimizer state {key}/{name}: shape "
                                     f"{tuple(got[name].shape)}, the parameter's {tuple(m.shape)}")
                _copy_whole(m, got[name])
        self.count = int(state["count"])
        self.lr = _f32(state["lr"])

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        one = np.float32(1.0)
        bc1 = float(one - _pow_f32(self.b1, self.count))
        bc2 = float(one - _pow_f32(self.b2, self.count))
        for group in self.groups:
            self._update(group, bc1, bc2)

    def _update(self, group: slice, bc1: float, bc2: float) -> None:
        b1, b2, one = self.b1, self.b2, np.float32(1.0)
        # the local shards on a mesh (every op is elementwise)
        params = [local(p) for p in self.params[group]]
        mus, nus = [local(m) for m in self.mu[group]], [local(v) for v in self.nu[group]]
        # a parameter the loss does not reach (the token embedding of a
        # default variable the phase does not feed) has a zero gradient, as
        # in optax: its moments decay and weight decay still moves it
        grads = [torch.zeros_like(p, dtype=torch.float32) if q.grad is None
                 else local(q.grad).float() for p, q in zip(params, self.params[group])]

        # fresh fp32 moments: (1 - b) g^k + b m, each product rounded as optax does
        mu = torch._foreach_mul(grads, float(one - b1))
        torch._foreach_add_(mu, torch._foreach_mul([m.float() for m in mus], float(b1)))
        nu = torch._foreach_mul(torch._foreach_mul(grads, grads), float(one - b2))
        torch._foreach_add_(nu, torch._foreach_mul([v.float() for v in nus], float(b2)))

        upd = torch._foreach_div(mu, bc1)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(params, upd)

        torch._foreach_copy_(mus, mu)  # the stored moments, cast to their dtype
        torch._foreach_copy_(nus, nu)


def _copy_whole(mine: torch.Tensor, whole: torch.Tensor) -> None:
    """Copies `whole` into `mine`, or its rank's part where `mine` is a
    DTensor (parallel/sharding.py::shard_like)."""
    if isinstance(mine, DTensor):
        from orbit2_tpu_torch.parallel.sharding import shard_like

        mine.to_local().copy_(shard_like(whole.to(mine.dtype), mine))
    else:
        mine.copy_(whole)


class SGD:
    """optax.sgd over `named_params` (JAX optim.py:159-162): the trace
    t = g + momentum * t (in the parameter's dtype), then p += -lr * t;
    momentum 0 keeps a trace equal to the gradient, as optax's trace(0)
    does. The same protocol as AdamW: set_learning_rate, state_dict (count,
    lr, the traces by name), load_state_dict."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], lr: float,
                 momentum: float = 0.0):
        pairs = [(n, p) for n, p in named_params if p.requires_grad]
        self.names = [n for n, _ in pairs]
        self.params = [p for _, p in pairs]
        self.lr = _f32(lr)
        self.momentum = _f32(momentum)
        self.count = 0
        with torch.no_grad():
            self.trace = [torch.zeros_like(p) for p in self.params]

    def set_learning_rate(self, lr: float) -> None:
        self.lr = _f32(lr)

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "lr": self.lr, "trace": dict(zip(self.names, self.trace))}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        got = state["trace"]
        if set(got) != set(self.names):
            raise KeyError(f"optimizer state trace: keys {sorted(set(got) ^ set(self.names))} "
                           "differ")
        for name, t in zip(self.names, self.trace):
            t.copy_(got[name])
        self.count = int(state["count"])
        self.lr = _f32(state["lr"])

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        new = torch._foreach_mul(self.trace, self.momentum)
        torch._foreach_add_(new, grads)
        torch._foreach_copy_(self.trace, new)
        torch._foreach_add_(self.params, torch._foreach_mul(new, -self.lr))


def make_optimizer(name: str, hyperparams: Dict[str, Any], named_params):
    """reference load_optimizer (loaders.py:390-406), over `named_params` (a
    model's `named_parameters()`): "adamw" (betas, weight_decay, mu_dtype,
    nu_dtype), "adam" (optax.adam: AdamW without weight decay, the moments
    in the parameters' dtype) or "sgd" (momentum). The learning rate is
    changed per epoch with `set_learning_rate`."""
    lr = float(hyperparams.get("lr", 1e-3))
    if name in ("adamw", "adam"):
        b1, b2 = hyperparams.get("betas", (0.9, 0.999))
        if name == "adam":
            return AdamW(named_params, lr=lr, b1=float(b1), b2=float(b2))
        return AdamW(named_params, lr=lr, b1=float(b1), b2=float(b2),
                     weight_decay=float(hyperparams.get("weight_decay", 0.0)),
                     mu_dtype=hyperparams.get("mu_dtype"), nu_dtype=hyperparams.get("nu_dtype"))
    if name == "sgd":
        return SGD(named_params, lr=lr, momentum=float(hyperparams.get("momentum", 0.0)))
    raise NotImplementedError(f"optimizer {name} not supported")


def set_learning_rate(optimizer, lr: float):
    optimizer.set_learning_rate(lr)
    return optimizer


def linear_warmup_cosine_annealing(base_lr: float, warmup_epochs: int, max_epochs: int,
                                   warmup_start_lr: float = 0.0, eta_min: float = 0.0):
    """Returns epoch -> lr (reference lr_scheduler.py:93-115 closed form)."""

    def schedule(epoch: int) -> float:
        if epoch < warmup_epochs:
            return warmup_start_lr + epoch * (base_lr - warmup_start_lr) / max(
                1, warmup_epochs - 1)
        t = (epoch - warmup_epochs) / max(1, max_epochs - warmup_epochs)
        return eta_min + 0.5 * (base_lr - eta_min) * (1 + math.cos(math.pi * t))

    return schedule


def make_lr_scheduler(name: str, hyperparams: Dict[str, Any]):
    """reference load_lr_scheduler (loaders.py:409-433) -> epoch -> lr (JAX
    optim.py:165-228): constant, linear (to end_lr over total_iters
    epochs), exponential (gamma per epoch), linear-warmup-cosine-annealing,
    or reduce-lr-on-plateau (a ReduceLROnPlateau: `step(metric)` each
    epoch, read as schedule(epoch))."""
    if name == "constant":
        lr = float(hyperparams["lr"])
        return lambda epoch: lr
    if name == "linear":
        base = float(hyperparams["lr"])
        end = float(hyperparams.get("end_lr", 0.0))
        total = int(hyperparams.get("total_iters", 1))
        return lambda e: base + (end - base) * min(1.0, e / max(1, total))
    if name == "exponential":
        base = float(hyperparams["lr"])
        gamma = float(hyperparams.get("gamma", 0.99))
        return lambda e: base * gamma ** e
    if name == "linear-warmup-cosine-annealing":
        return linear_warmup_cosine_annealing(
            base_lr=float(hyperparams["lr"]), warmup_epochs=int(hyperparams["warmup_epochs"]),
            max_epochs=int(hyperparams["max_epochs"]),
            warmup_start_lr=float(hyperparams.get("warmup_start_lr", 0.0)),
            eta_min=float(hyperparams.get("eta_min", 0.0)))
    if name == "reduce-lr-on-plateau":
        return ReduceLROnPlateau(
            base_lr=float(hyperparams["lr"]), factor=float(hyperparams.get("factor", 0.1)),
            patience=int(hyperparams.get("patience", 10)),
            min_lr=float(hyperparams.get("min_lr", 0.0)))
    raise NotImplementedError(f"lr scheduler {name} not supported")


class ReduceLROnPlateau:
    """The metric-driven schedule (reference loaders.py:428-431 exposes
    torch's; JAX optim.py:196-228): `step(metric)` once an epoch; after more
    than `patience` epochs without a better metric the lr is multiplied by
    `factor` (not below min_lr). Read as `schedule(epoch)` it returns the
    current lr, so the epoch-based protocol still works."""

    def __init__(self, base_lr: float, factor: float = 0.1, patience: int = 10,
                 min_lr: float = 0.0, mode: str = "min"):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.mode = mode
        self.best = None
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        better = (self.best is None
                  or (metric < self.best if self.mode == "min" else metric > self.best))
        if better:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.min_lr, self.lr * self.factor)
                self.bad_epochs = 0
        return self.lr

    def __call__(self, epoch: int) -> float:
        return self.lr


__all__ = ["AdamW", "SGD", "ReduceLROnPlateau", "make_optimizer", "make_lr_scheduler",
           "set_learning_rate", "linear_warmup_cosine_annealing"]
