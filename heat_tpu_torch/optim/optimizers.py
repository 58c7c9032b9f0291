"""The torch-style optimizer names of heat_tpu.optim, with optax's arguments,
defaults and update rules (counterpart of heat_tpu/optim/__init__.py:18-37).

``SGD(0.1)``, ``Adam(1e-3)``... take no parameters: like the optax
transformation the JAX package returns, each is an optimizer not yet bound
to a model. It returns a factory, ``factory(params) -> torch.optim.Optimizer``,
which a trainer (``DataParallel``, ``DASO``, ``DataParallelOptimizer``)
calls on the parameters of each replica.

Where ``torch.optim``'s rule is optax's (SGD with momentum and Nesterov,
Adam, AdamW's decoupled decay), the factory binds the torch optimizer with
optax's defaults; AdamW's weight decay is optax's 1e-4, not torch's 1e-2.
Where the rules differ, the optax rule is written out below:

* Adagrad: the accumulator starts at 0.1 and epsilon sits inside the root,
  ``g / sqrt(Σg² + eps)``; torch starts at 0 and adds eps outside.
* RMSprop: decay 0.9, ``g / sqrt(ν + eps)`` (eps in the root by default),
  the learning rate applied before the momentum trace; torch's alpha is
  0.99 with eps outside the root.
* Adadelta: ``learning_rate=None`` applies no scaling, so the update is
  ``+Δ`` (optax 0.2's rule: with no rate it does not flip the sign);
  torch's rate defaults to 1 and subtracts.

``learning_rate`` is a float; optax's schedules are not ported.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch

__all__ = [
    "SGD",
    "Adam",
    "AdamW",
    "Adagrad",
    "RMSprop",
    "Adadelta",
    "LBFGS",
    "OptaxAdagrad",
    "OptaxRMSprop",
    "OptaxAdadelta",
]

Factory = Callable[..., torch.optim.Optimizer]


def SGD(learning_rate: float, momentum: Optional[float] = None, nesterov: bool = False) -> Factory:
    """``optax.sgd``: ``t = g + momentum·t``, the step ``-lr·t`` (or
    ``-lr·(g + momentum·t)`` with Nesterov); torch's SGD is the same rule."""
    m = float(momentum) if momentum is not None else 0.0
    return partial(torch.optim.SGD, lr=learning_rate, momentum=m, nesterov=bool(nesterov and m))


def Adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Factory:
    """``optax.adam``: bias-corrected moments, ``-lr·m̂/(sqrt(v̂) + eps)``."""
    return partial(torch.optim.Adam, lr=learning_rate, betas=(b1, b2), eps=eps)


def AdamW(
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
) -> Factory:
    """``optax.adamw``: Adam's step plus the decoupled decay ``-lr·wd·p``."""
    return partial(
        torch.optim.AdamW, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay
    )


def Adagrad(learning_rate: float, initial_accumulator_value: float = 0.1, eps: float = 1e-7) -> Factory:
    """``optax.adagrad``; see :class:`OptaxAdagrad`."""
    return partial(
        OptaxAdagrad, lr=learning_rate, initial_accumulator_value=initial_accumulator_value, eps=eps
    )


def RMSprop(
    learning_rate: float,
    decay: float = 0.9,
    eps: float = 1e-8,
    initial_scale: float = 0.0,
    eps_in_sqrt: bool = True,
    centered: bool = False,
    momentum: Optional[float] = None,
    nesterov: bool = False,
    bias_correction: bool = False,
) -> Factory:
    """``optax.rmsprop``; see :class:`OptaxRMSprop`."""
    return partial(
        OptaxRMSprop, lr=learning_rate, decay=decay, eps=eps, initial_scale=initial_scale,
        eps_in_sqrt=eps_in_sqrt, centered=centered, momentum=momentum, nesterov=nesterov,
        bias_correction=bias_correction,
    )


def Adadelta(
    learning_rate: Optional[float] = None, rho: float = 0.9, eps: float = 1e-6, weight_decay: float = 0.0
) -> Factory:
    """``optax.adadelta``; see :class:`OptaxAdadelta`."""
    return partial(OptaxAdadelta, lr=learning_rate, rho=rho, eps=eps, weight_decay=weight_decay)


def LBFGS(*args, **kwargs):
    """``optax.lbfgs`` needs the loss inside its update, which no trainer of
    the package passes: not ported."""
    raise NotImplementedError(
        "LBFGS is not ported: optax's lbfgs takes the loss inside update, and no "
        "trainer passes it (ROADMAP.md, queue A)"
    )


class _OptaxRule(torch.optim.Optimizer):
    """One optax update per parameter: ``update(p, g, state, group)`` gives
    the increment that ``optax.apply_updates`` adds to ``p``."""

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.add_(self.update(p, p.grad, self.state[p], group))
        return loss

    def update(self, p, g, state, group) -> torch.Tensor:
        raise NotImplementedError


def _moment(state, key, g, decay, power, init=0.0):
    """optax's ``update_moment``: ``(1 - decay)·g^power + decay·t``."""
    if key not in state:
        state[key] = torch.full_like(g, init)
    t = (1 - decay) * g**power + decay * state[key]
    state[key] = t
    return t


class OptaxAdagrad(_OptaxRule):
    """optax's adagrad: ``s = g² + s`` from ``initial_accumulator_value``,
    the step ``-lr·g/sqrt(s + eps)`` (zero where s is 0)."""

    def __init__(self, params, lr: float, initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value, eps=eps))

    def update(self, p, g, state, group):
        if "sum_of_squares" not in state:
            state["sum_of_squares"] = torch.full_like(p, group["initial_accumulator_value"])
        s = g * g + state["sum_of_squares"]
        state["sum_of_squares"] = s
        scale = torch.where(s > 0, torch.rsqrt(s + group["eps"]), torch.zeros_like(s))
        return -group["lr"] * (scale * g)


class OptaxRMSprop(_OptaxRule):
    """optax's rmsprop: ``ν = (1-decay)·g² + decay·ν`` from
    ``initial_scale`` (centered: minus the squared mean ``μ``), optionally
    bias-corrected, the step ``-lr·g/sqrt(ν + eps)`` (``eps_in_sqrt``) or
    ``-lr·g/(sqrt(ν) + eps)``, then optax's momentum trace."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0, eps_in_sqrt: bool = True, centered: bool = False,
                 momentum: Optional[float] = None, nesterov: bool = False,
                 bias_correction: bool = False):
        super().__init__(params, dict(
            lr=lr, decay=decay, eps=eps, initial_scale=initial_scale, eps_in_sqrt=eps_in_sqrt,
            centered=centered, momentum=momentum, nesterov=nesterov, bias_correction=bias_correction,
        ))

    def update(self, p, g, state, group):
        decay, eps = group["decay"], group["eps"]
        nu = _moment(state, "nu", g, decay, 2, group["initial_scale"])
        mu = _moment(state, "mu", g, decay, 1) if group["centered"] else None
        if group["bias_correction"]:
            state["count"] = state.get("count", 0) + 1
            correction = 1 - decay ** state["count"]
            nu = nu / correction
            mu = mu / correction if mu is not None else None
        if mu is not None:
            nu = nu - mu * mu
        scale = torch.rsqrt(nu + eps) if group["eps_in_sqrt"] else 1 / (torch.sqrt(nu) + eps)
        u = -group["lr"] * (scale * g)
        m = group["momentum"]
        if m is None:
            return u
        trace = u + m * state.get("trace", torch.zeros_like(u))
        state["trace"] = trace
        return u + m * trace if group["nesterov"] else trace


class OptaxAdadelta(_OptaxRule):
    """optax's adadelta: ``g += wd·p``; ``E[g²]`` and ``E[Δ²]`` with decay
    ``rho``; ``Δ = sqrt(E[Δ²] + eps)/sqrt(E[g²] + eps)·g``; the step ``-lr·Δ``,
    or ``+Δ`` when ``lr`` is None."""

    def __init__(self, params, lr: Optional[float] = None, rho: float = 0.9, eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, rho=rho, eps=eps, weight_decay=weight_decay))

    def update(self, p, g, state, group):
        rho, eps = group["rho"], group["eps"]
        g = g + group["weight_decay"] * p
        e_g = _moment(state, "e_g", g, rho, 2)
        e_x = state.get("e_x", torch.zeros_like(g))
        u = torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps) * g
        _moment(state, "e_x", u, rho, 2)
        return u if group["lr"] is None else -group["lr"] * u
