"""Optimizers over parameter trees (counterpart of
``repro.optim.optimizers``).

Each factory returns an object with
  init(params) -> state
  update(grads, state, params) -> (updates, new_state)   # updates are ADDED
The arithmetic follows the reference op for op.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]


def _zeros_like(params):
    return tree_map(torch.zeros_like, params)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": _zeros_like(params)} if momentum else {}

    def update(grads, state, params):
        del params
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            updates = tree_map(lambda m: -lr * m, mu)
            return updates, {"mu": mu}
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def adagrad(lr: float, eps: float = 1e-7) -> Optimizer:
    def init(params):
        return {"v": _zeros_like(params)}

    def update(grads, state, params):
        del params
        v = tree_map(lambda v_, g: v_ + g * g, state["v"], grads)
        updates = tree_map(lambda g, v_: -lr * g / (torch.sqrt(v_) + eps),
                           grads, v)
        return updates, {"v": v}

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params):
        return {"m": _zeros_like(params), "v": _zeros_like(params), "t": 0}

    def update(grads, state, params):
        del params
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g,
                     state["v"], grads)
        mhat_scale = 1.0 / (1 - b1 ** t)
        vhat_scale = 1.0 / (1 - b2 ** t)
        updates = tree_map(
            lambda m_, v_: -lr * (m_ * mhat_scale)
            / (torch.sqrt(v_ * vhat_scale) + eps), m, v)
        return updates, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def get_optimizer(name: str, lr: float, **kw) -> Optimizer:
    return {"sgd": sgd, "adagrad": adagrad, "adam": adam}[name](lr, **kw)
