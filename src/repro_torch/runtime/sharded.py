"""Clients-as-ranks sharded cohort execution (counterpart of
``repro.runtime.sharded``).

The batched path (``batched.py``) trains a whole cohort with one device's
FLOPs.  Here the same size-bucketed cohort is laid over the ``clients``
axis of a ``torch.distributed`` group (``launch/mesh.py``): every rank
holds M/D client slots of each bucket, runs the ``cohort_scan`` body
shared with ``batched.py`` on them, reduces its slots' trained params to a
weighted partial sum with ONE ``fed_reduce`` call (the int8 upload round
trip of a compressed cohort runs inside the same call), and the partials
of all ranks, all-gathered and folded in rank order, complete the FedAvg
weighted mean on every rank.  Only the (N,) partials and the per-client
losses cross ranks; per-client params never leave the rank that trained
them.

Every rank runs the whole host side, as the reference's one controller
does: each draws every client's batch stream from the shared rng in
client order (the rng contract of the sequential and batched paths),
buckets the cohort by step count, and stages only its own block of each
bucket on its device.  Each bucket is padded to a multiple of D with
zero-weight client slots (all-False step masks freeze them at the global
params; zero weights are bit-neutral in ``fed_reduce``), so every block
has one shape and rank r holds slots ``[r*M/D, (r+1)*M/D)``.

Parity contract (tests/test_torch_sharded.py, as tests/test_sharded.py
pins the reference): the aggregate is FedAvg over the batched path's
per-client params up to float reassociation, and bitwise the same on
every rank.  The sum across ranks is ``launch.mesh.fold``'s rank-order fold
of the gathered partials, once per step bucket, where the reference adds
a ``psum`` per bucket (ROADMAP.md section 3 lists it among the port's
departures).
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.federated.aggregation import _flatten, _unflatten
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.registry import Model
from repro_torch.optim.optimizers import Optimizer
from repro_torch.runtime.batched import (_stack_streams, bucket_by_steps,
                                         cohort_scan, make_client_step,
                                         materialize_streams, to_device)
from repro_torch.tree import leaves, tree_map

# Sharded cohort rounds run in this process (set it to 0 to start a count):
# one per ``sharded_fedavg_train`` call and one per model group of a
# sharded sweep round.  It tells a sharded run from its batched fallback.
rounds = 0

_default_mesh: Optional[mesh_mod.ClientsMesh] = None


def default_clients_mesh() -> mesh_mod.ClientsMesh:
    """The ``clients`` mesh over the default process group (one rank when
    there is none), cached while that group lives."""
    global _default_mesh
    group = torch.distributed.group.WORLD if mesh_mod.initialized() else None
    if _default_mesh is None or _default_mesh.group is not group:
        _default_mesh = mesh_mod.make_clients_mesh()
    return _default_mesh


class ShardedRound(NamedTuple):
    """Result of one sharded cohort round (input client order)."""
    params: Any                # FedAvg weighted mean over the cohort
    last_losses: np.ndarray    # per-client final local loss
    n_steps: List[int]         # local steps actually taken per client
    n_examples: List[int]      # client dataset sizes (the FedAvg weights)


def flatten_cohort(params_b) -> torch.Tensor:
    """A stacked (M, ...) params tree -> (M, N) rows, in the leaf order of
    ``aggregation._flatten``, so flat vectors interconvert."""
    ls = leaves(params_b)
    m = ls[0].shape[0]
    return torch.cat([l.reshape(m, -1) for l in ls], dim=1)


def sharded_fedavg_train(model: Model, global_params,
                         data: Sequence[Tuple[np.ndarray, np.ndarray]], *,
                         passes: float, batch_size: int,
                         optimizer: Optimizer, rng: np.random.Generator,
                         prox_mu: float = 0.0,
                         client_ids: Optional[Sequence[int]] = None,
                         mesh: Optional[mesh_mod.ClientsMesh] = None,
                         compression: Optional[str] = None) -> ShardedRound:
    """Train the whole cohort sharded over the ``clients`` ranks of
    ``mesh`` (default: the default process group) and return the FedAvg
    aggregate (weights n_k / n_total) on every rank, without gathering
    per-client params.  Each rank trains on the device that holds its
    ``global_params``.  ``client_ids`` is accepted for signature symmetry
    with ``batched_local_train``; results come back in input order.
    ``compression`` applies the upload round trip per lane inside the
    rank's ``fed_reduce`` call, before the weighted sum."""
    global rounds
    del client_ids
    mesh = mesh if mesh is not None else default_clients_mesh()
    dev = leaves(global_params)[0].device
    cohort_step = make_client_step(model, optimizer, prox_mu)
    streams, n_steps = materialize_streams(data, batch_size, passes, rng)
    assert max(n_steps) > 0, "cohort with zero local steps"
    sizes = [len(y) for _, y in data]
    w = np.asarray(sizes, np.float64) / float(sum(sizes))  # FedAvg weights

    global_flat, meta = _flatten(global_params)
    n = global_flat.shape[0]
    compressed = compression not in (None, "none")
    rounds += 1
    agg = torch.zeros_like(global_flat)
    losses = np.zeros(len(data), np.float64)
    for t_pad, idx in sorted(bucket_by_steps(n_steps).items()):
        m_pad = len(idx) + (-len(idx)) % mesh.size
        blk = mesh.block(m_pad)
        slots = (list(idx) + [None] * (m_pad - len(idx)))[blk]
        m_loc = len(slots)
        xs, ys, masks, active = to_device(dev, *_stack_streams(
            [streams[i] if i is not None else [] for i in slots],
            batch_size, t_pad, like=streams[idx[0]]))
        global_b = tree_map(
            lambda p: p.expand((m_loc,) + tuple(p.shape)).clone(),
            global_params)
        opt_b = optimizer.init(global_b)
        params_b, last_loss = cohort_scan(
            cohort_step, global_b, opt_b, xs, ys, masks, active,
            global_params)
        wb = np.zeros(m_pad, np.float32)
        wb[:len(idx)] = w[idx]
        partial = kernel_ops.fed_reduce(                  # (1, N)
            torch.from_numpy(wb[blk]).to(dev), flatten_cohort(params_b),
            torch.zeros(m_loc, dtype=torch.int32, device=dev), 1,
            leaf_sizes=tuple(meta[2]) if compressed else None,
            quant_ref=global_flat[None, :] if compressed else None)
        # one gather a bucket: every rank's partial and its lanes' losses
        both = mesh.gather(torch.cat([partial[0], last_loss]))
        agg = agg + mesh_mod.fold(both[:, :n])
        losses[idx] = both[:, n:].reshape(-1).cpu().numpy()[:len(idx)]

    # 0-step clients never trained: they enter the FedAvg mean at the
    # global params, exactly as the batched/sequential paths include them
    zero_w = float(sum(w[i] for i, t in enumerate(n_steps) if t == 0))
    if zero_w > 0.0:
        agg = agg + zero_w * global_flat
    return ShardedRound(params=_unflatten(agg, meta), last_losses=losses,
                        n_steps=n_steps, n_examples=sizes)
