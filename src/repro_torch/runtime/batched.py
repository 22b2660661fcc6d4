"""Vectorized client execution: a whole cohort's local training as one
stacked step sequence instead of a Python loop over clients (counterpart of
``repro.runtime.batched``).

The cohort is padded to a common step count T = max_k T_k, client batches
are stacked into (T, M, B, ...) arrays moved to the device in one copy per
array, and a Python loop over steps runs one stacked step of every client
(a ``torch.func.vmap`` of one client's loss, one backward pass): the
per-step matrix products become batched products over the cohort.  Clients that run out of real
batches keep computing on padding, but their params and optimizer state
are frozen by a step mask (``torch.where``).

Padding waste is bounded by SIZE BUCKETING: clients are grouped by their
step count rounded up to the next power of two, and each bucket runs as its
own cohort, so one data-rich straggler cannot force the whole cohort to its
step count.

Batch order per client comes from the same ``client_batches`` generator and
the same rng stream as the sequential path (streams are materialized in
client order BEFORE bucketing), so the two paths are update-for-update
comparable.  They are not bit-identical: a batched product does not give
each lane the bits of a single product, so params agree within float
tolerance (tests/test_torch_sweep.py pins 1e-5).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.data.loader import client_batches
from repro_torch.federated.aggregation import ClientUpdate
from repro_torch.models.registry import Model
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import leaves, tree_map, unflatten_like


def make_client_step(model: Model, optimizer: Optimizer, prox_mu: float):
    """One micro-step of a stacked cohort's local training: (params_b,
    opt_b, batch_b, global_params) -> updated params and optimizer state
    plus each lane's step loss, with the FedProx proximal term folded in.

    The lanes' losses come from one ``torch.func.vmap`` of one client's
    loss, and their gradients from one backward pass of the lanes' summed
    loss: lanes share no parameters, so lane i's gradient is its own loss's
    gradient.  (A ``vmap`` of ``torch.func.grad`` computes the same thing
    with about twice the host time per step.)  The optimizer then updates
    the stacked trees elementwise, and updates are added to params, as in
    ``optim/optimizers.py``; its state must hold tensors only (``sgd``
    does)."""

    def lane_loss(params, bx, by, bm, global_params):
        l, _ = model.loss_fn(params, {"x": bx, "y": by, "mask": bm})
        if prox_mu > 0.0:
            sq = sum(torch.sum((a - b) ** 2) for a, b in zip(
                leaves(params), leaves(global_params)))
            l = l + 0.5 * prox_mu * sq
        return l

    def cohort_step(params_b, opt_b, bx, by, bm, global_params,
                    global_in_axis=None):
        losses_of = torch.func.vmap(lane_loss,
                                    in_dims=(0, 0, 0, 0, global_in_axis))
        p_leaves = [t.detach().requires_grad_(True) for t in leaves(params_b)]
        p = unflatten_like(params_b, p_leaves)
        with torch.enable_grad():
            losses = losses_of(p, bx, by, bm, global_params)
            grads = torch.autograd.grad(losses.sum(), p_leaves)
        updates, opt_b = optimizer.update(
            unflatten_like(params_b, list(grads)), opt_b, params_b)
        params_b = tree_map(lambda a, u: a + u, params_b, updates)
        return params_b, opt_b, losses.detach()

    return cohort_step


def cohort_scan(cohort_step, params_b, opt_b, xs, ys, masks, active,
                global_params, *, global_in_axis=None):
    """A loop over steps with the stacked cohort step inside: the cohort
    body shared by the batched path and the multi-trial sweep (clients of
    many trials packed flat).

    xs: (T, M, B, ...); active: (T, M) bool step mask freezing clients
    that ran out of real batches.  ``global_in_axis`` is the lane axis of
    ``global_params``: None broadcasts one global model to every client; 0
    gives each client its own reference params (what the sweep runner uses
    to pack clients of trials whose global models differ).  Returns the
    trained params and each client's last real step loss."""
    last_loss = torch.zeros(active.shape[1], dtype=torch.float32,
                            device=active.device)

    def keep(act):
        def gate(new, old):
            return torch.where(act.reshape((-1,) + (1,) * (new.dim() - 1)),
                               new, old)
        return gate

    with torch.no_grad():
        for t in range(active.shape[0]):
            act = active[t]
            new_p, new_o, l = cohort_step(params_b, opt_b, xs[t], ys[t],
                                          masks[t], global_params,
                                          global_in_axis)
            params_b = tree_map(keep(act), new_p, params_b)
            opt_b = tree_map(keep(act), new_o, opt_b)
            last_loss = torch.where(act, l, last_loss)
    return params_b, last_loss


def _stack_streams(streams, batch_size: int, t_pad: int):
    """Pad a bucket's batch streams into (T, M, B, ...) host arrays."""
    m = len(streams)
    bx0, by0, _ = streams[0][0]
    feat_shape = bx0.shape[1:]
    xs = np.zeros((t_pad, m, batch_size) + feat_shape, np.float32)
    ys = np.zeros((t_pad, m, batch_size), by0.dtype)
    masks = np.zeros((t_pad, m, batch_size), np.bool_)
    active = np.zeros((t_pad, m), np.bool_)
    for i, stream in enumerate(streams):
        for t, (bx, by, bm) in enumerate(stream):
            xs[t, i] = bx
            ys[t, i] = by
            masks[t, i] = bm
            active[t, i] = True
    return xs, ys, masks, active


def to_device(device, xs, ys, masks, active):
    """A bucket's stacked arrays on ``device``: one host-to-device copy per
    array (labels as int64, the loss's gather index)."""
    dev = torch.device(device)
    return (torch.from_numpy(xs).to(dev),
            torch.from_numpy(ys.astype(np.int64)).to(dev),
            torch.from_numpy(masks).to(dev),
            torch.from_numpy(active).to(dev))


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def materialize_streams(data, batch_size: int, passes: float,
                        rng: np.random.Generator):
    """Materialize every client's batch stream IN CLIENT ORDER: the rng
    contract shared by the sequential and batched paths (batch permutations
    must consume the server rng identically).  Returns (streams, per-client
    step counts)."""
    streams = [list(client_batches(x, y, batch_size, passes, rng))
               for x, y in data]
    return streams, [len(s) for s in streams]


def bucket_by_steps(n_steps: Sequence[int]):
    """Size-bucket client indices by pow2-rounded step count to bound
    padding waste; 0-step clients are left out (they never train)."""
    buckets = {}
    for i, t in enumerate(n_steps):
        if t == 0:
            continue
        buckets.setdefault(_pow2(t), []).append(i)
    return buckets


def note_pack_metrics(t_pad: int, m_pad: int, n_lanes: int,
                      real_steps: int):
    """Pack-shape metrics for one bucket: lanes and steps actually used
    against the padded (m_pad, t_pad) grid.  ``padding_waste`` is the
    fraction of that grid spent on padding, the series the bucketing and
    coalescing heuristics are judged by.  Shared by every cohort runner;
    callers gate on ``obs.enabled()``."""
    padded_steps = m_pad * t_pad
    obs.registry.inc("pack_dispatches")
    obs.registry.inc("pack_lanes_real", n_lanes)
    obs.registry.inc("pack_lanes_padded", m_pad)
    obs.registry.inc("pack_steps_real", real_steps)
    obs.registry.inc("pack_steps_padded", padded_steps)
    obs.registry.sample("pack_width", n_lanes, t_pad=t_pad, m_pad=m_pad)
    obs.registry.sample(
        "padding_waste",
        1.0 - real_steps / padded_steps if padded_steps else 0.0,
        t_pad=t_pad)
    obs.registry.observe("pack_width_lanes", n_lanes)


def batched_local_train(model: Model, global_params,
                        data: Sequence[Tuple[np.ndarray, np.ndarray]], *,
                        passes: float, batch_size: int, optimizer: Optimizer,
                        rng: np.random.Generator, prox_mu: float = 0.0,
                        client_ids: Optional[Sequence[int]] = None,
                        compression: Optional[str] = None
                        ) -> List[ClientUpdate]:
    """Train all clients in ``data`` from ``global_params`` concurrently, on
    the device that holds ``global_params``.  Returns one ClientUpdate per
    client (in input order), matching ``local_train`` run sequentially with
    the same rng.  ``compression`` applies the upload round trip to every
    trained lane, as the sequential path does per client."""
    dev = leaves(global_params)[0].device
    cohort_step = make_client_step(model, optimizer, prox_mu)
    streams, n_steps = materialize_streams(data, batch_size, passes, rng)
    assert max(n_steps) > 0, "cohort with zero local steps"

    buckets = bucket_by_steps(n_steps)
    params_out: List[Any] = [global_params] * len(data)  # 0-step clients
    loss_out = np.zeros(len(data), np.float64)
    for t_pad in sorted(buckets):
        idx = buckets[t_pad]
        xs, ys, masks, active = to_device(dev, *_stack_streams(
            [streams[i] for i in idx], batch_size, t_pad))
        m = len(idx)
        if obs.enabled():
            note_pack_metrics(t_pad, m, m, sum(n_steps[i] for i in idx))
        global_b = tree_map(
            lambda p: p.expand((m,) + tuple(p.shape)).clone(), global_params)
        opt_b = optimizer.init(global_b)
        params_b, last_loss = cohort_scan(
            cohort_step, global_b, opt_b, xs, ys, masks, active,
            global_params)
        if compression not in (None, "none"):
            from repro_torch.federated.compression import compress_delta_lanes
            params_b = compress_delta_lanes(global_b, params_b)
        last_loss = last_loss.cpu().numpy()
        for j, i in enumerate(idx):
            params_out[i] = tree_map(lambda p, j=j: p[j], params_b)
            loss_out[i] = float(last_loss[j])

    updates = []
    for i, (x, y) in enumerate(data):
        cid = int(client_ids[i]) if client_ids is not None else -1
        updates.append(ClientUpdate(
            params=params_out[i], n_examples=len(y), n_steps=n_steps[i],
            last_loss=loss_out[i], client_id=cid))
    return updates
