"""Client-side local training: E passes of mini-batch SGD on local data
(counterpart of ``repro.federated.client``).

Batches keep the reference's fixed shape (pad + mask) and come from the
port's ``client_batches`` with the server's numpy rng, consuming it exactly
as the reference does.  Gradients come from ``torch.autograd``.  Supports
the FedProx proximal term (mu/2 ||theta - theta_global||^2).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.loader import client_batches
from repro_torch.federated.aggregation import ClientUpdate
from repro_torch.models.registry import Model
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import leaves, tree_map, unflatten_like


def _loss(model: Model, params, batch, global_params, prox_mu: float):
    l, metrics = model.loss_fn(params, batch)
    if prox_mu > 0.0:
        sq = sum(torch.sum((a - b) ** 2) for a, b in zip(
            leaves(params), leaves(global_params)))
        l = l + 0.5 * prox_mu * sq
    return l, metrics


def local_train(model: Model, global_params, x: np.ndarray, y: np.ndarray,
                *, passes: float, batch_size: int, optimizer: Optimizer,
                rng: np.random.Generator, prox_mu: float = 0.0
                ) -> ClientUpdate:
    """Run ``passes`` epochs over (x, y) starting from the global model, on
    the device that holds ``global_params``.

    The client's data goes to the device once: row 0 of the staged arrays
    is zeros, and the batch plan indexes rows 1..n, so a padded slot (index
    0) gathers the zero example the reference pads with.  The loss stays on
    the device and is read once, after the last step."""
    dev = leaves(global_params)[0].device
    n = len(y)
    x_dev = torch.from_numpy(np.concatenate(
        [np.zeros((1,) + x.shape[1:], x.dtype), x])).to(dev)
    y_dev = torch.from_numpy(np.concatenate(
        [np.zeros(1, y.dtype), y]).astype(np.int64)).to(dev)
    rows = np.arange(1, n + 1)
    plan = [(idx, mask) for idx, _, mask in
            client_batches(rows, rows, batch_size, passes, rng)]
    params = global_params
    opt_state = optimizer.init(params)
    if not plan:
        return ClientUpdate(params=params, n_examples=n, n_steps=0,
                            last_loss=0.0)
    idx_all = torch.from_numpy(np.stack([i for i, _ in plan])).to(dev)
    mask_all = torch.from_numpy(np.stack([m for _, m in plan])).to(dev)
    l = None
    for s in range(len(plan)):
        idx = idx_all[s]
        batch = {"x": x_dev[idx], "y": y_dev[idx], "mask": mask_all[s]}
        p_leaves = [t.detach().requires_grad_(True) for t in leaves(params)]
        p = unflatten_like(params, p_leaves)
        l, _ = _loss(model, p, batch, global_params, prox_mu)
        grads = unflatten_like(params, torch.autograd.grad(l, p_leaves))
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, p)
            params = tree_map(lambda a, u: a + u, p, updates)
    params = tree_map(lambda t: t.detach(), params)
    return ClientUpdate(params=params, n_examples=n, n_steps=len(plan),
                        last_loss=float(l.detach()))
