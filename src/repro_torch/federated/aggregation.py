"""Server-side aggregation algorithms (counterpart of
``repro.federated.aggregation``).

All aggregators consume per-participant results
  ClientUpdate(params, n_examples, n_steps)
and produce the new global params.  The weighted sums run through the port's
``fed_reduce`` kernel (the Hopper kernel on CUDA, the plain version on the
CPU) on flattened parameter vectors as a single-segment (T=1) call, and the
FedAsync mix through ``fed_aggregate``.

FedAvg passes RAW example counts with ``normalize=True`` so the weight
normalisation happens inside the kernel, with the op sequence the fused
multi-trial reduce uses.

Implemented: FedAvg [McMahan'17], FedNova [Wang'20], and the adaptive
server optimizers FedAdagrad / FedAdam / FedYogi [Reddi'21].  FedProx is a
client-side proximal term (federated/client.py) aggregated by FedAvg.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.tree import leaves, tree_map, unflatten_like


class ClientUpdate(NamedTuple):
    params: Any        # client's local params after E passes
    n_examples: int
    n_steps: int       # local optimizer steps actually taken (tau_k)
    last_loss: float = 0.0  # final local loss (guided selection signal)
    client_id: int = -1     # which client produced it (runtime bookkeeping)


def _flatten(params):
    """Concatenate the leaves in ``jax.tree.flatten`` order (sorted dict
    keys: an MLP layer's ``b`` before its ``w``)."""
    ls = leaves(params)
    meta = (params, [l.shape for l in ls], [l.numel() for l in ls])
    return torch.cat([l.reshape(-1) for l in ls]), meta


def _unflatten(flat, meta):
    template, shapes, sizes = meta
    out = []
    off = 0
    for shape, size in zip(shapes, sizes):
        out.append(flat[off:off + size].reshape(shape))
        off += size
    return unflatten_like(template, out)


def _weighted_combine(weights: np.ndarray, param_list: List[Any],
                      base: Optional[Any] = None, *,
                      normalize: bool = False):
    """sum_k w_k * params_k (+ base), one fused fed_reduce call (T=1)."""
    flats = []
    meta = None
    for p in param_list:
        f, meta = _flatten(p)
        flats.append(f)
    rows = torch.stack(flats)                       # (M, N)
    dev = rows.device
    w = torch.as_tensor(np.asarray(weights, np.float32), device=dev)
    seg = torch.zeros(rows.shape[0], dtype=torch.int32, device=dev)
    base_flat = _flatten(base)[0][None, :] if base is not None else None
    out = kernel_ops.fed_reduce(w, rows, seg, 1, base_flat,
                                normalize=normalize)
    return _unflatten(out[0], meta)


# ---------------------------------------------------------------------------
# aggregators
# ---------------------------------------------------------------------------

class Aggregator:
    name = "base"

    def __call__(self, global_params, updates: List[ClientUpdate]):
        raise NotImplementedError


class FedAvg(Aggregator):
    name = "fedavg"

    def __call__(self, global_params, updates):
        # raw counts; the n_k / sum(n) division runs inside fed_reduce
        w = np.array([u.n_examples for u in updates], np.float32)
        return _weighted_combine(w, [u.params for u in updates],
                                 normalize=True)


class FedNova(Aggregator):
    """Normalised averaging: re-weights client *deltas* by their local step
    counts tau_k so heterogeneous E does not bias the update direction."""
    name = "fednova"

    def __call__(self, global_params, updates):
        n = float(sum(u.n_examples for u in updates))
        p = np.array([u.n_examples / n for u in updates], np.float32)
        tau = np.array([max(u.n_steps, 1) for u in updates], np.float32)
        tau_eff = float((p * tau).sum())
        # delta_k = (theta_k - theta) / tau_k ; theta' = theta + tau_eff * sum p_k d_k
        deltas = [tree_map(lambda a, b: a - b, u.params, global_params)
                  for u in updates]
        w = (p / tau) * tau_eff
        return _weighted_combine(w.astype(np.float32), deltas,
                                 base=global_params)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root.  PyTorch's CPU f32 ``sqrt`` is
    off by an ulp on some inputs; the f64 root rounded to f32 is exact."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


@dataclass
class _AdaptiveServer(Aggregator):
    """Reddi et al. adaptive server optimizers over the pseudo-gradient
    Delta = sum_k p_k (theta_k - theta)."""
    lr: float = 0.1
    b1: float = 0.0
    tau: float = 1e-3
    name = "adaptive"

    def __post_init__(self):
        self._m = None
        self._v = None

    def _second_moment(self, v, d2):
        raise NotImplementedError

    def __call__(self, global_params, updates):
        n = float(sum(u.n_examples for u in updates))
        w = np.array([u.n_examples / n for u in updates], np.float32)
        deltas = [tree_map(lambda a, b: a - b, u.params, global_params)
                  for u in updates]
        delta = _weighted_combine(w, deltas)
        if self._m is None:
            self._m = tree_map(torch.zeros_like, delta)
            self._v = tree_map(lambda x: torch.full_like(x, self.tau ** 2),
                               delta)
        self._m = tree_map(lambda m, d: self.b1 * m + (1 - self.b1) * d,
                           self._m, delta)
        self._v = tree_map(self._second_moment, self._v,
                           tree_map(lambda d: d * d, delta))
        return tree_map(
            lambda t, m, v: t + self.lr * m / (_sqrt(v) + self.tau),
            global_params, self._m, self._v)


class FedAdagrad(_AdaptiveServer):
    name = "fedadagrad"

    def _second_moment(self, v, d2):
        return v + d2


class FedAdam(_AdaptiveServer):
    name = "fedadam"
    b2: float = 0.99

    def _second_moment(self, v, d2):
        return 0.99 * v + 0.01 * d2


class FedYogi(_AdaptiveServer):
    name = "fedyogi"

    def _second_moment(self, v, d2):
        return v - 0.01 * torch.sign(v - d2) * d2


# ---------------------------------------------------------------------------
# staleness-aware aggregation (async / buffered runtimes)
# ---------------------------------------------------------------------------

def staleness_weight(staleness: float, alpha: float = 0.5,
                     kind: str = "polynomial") -> float:
    """Down-weighting of stale updates s(tau) in [0, 1].

    polynomial — FedAsync's s(tau) = (1 + tau)^-alpha (default).
    constant   — no discounting.
    hinge      — full weight up to ``b = 1/alpha`` versions, then harmonic
                 decay 1 / (1 + alpha * (tau - b)).
    """
    s = max(float(staleness), 0.0)
    if kind == "constant":
        return 1.0
    if kind == "polynomial":
        return float((1.0 + s) ** (-alpha))
    if kind == "hinge":
        b = 1.0 / max(alpha, 1e-9)
        return 1.0 if s <= b else float(1.0 / (1.0 + alpha * (s - b)))
    raise KeyError(f"unknown staleness kind {kind!r}")


class FedBuffAggregator:
    """FedBuff [Nguyen'22]: the server buffers K client *deltas* (each taken
    against the params the client was dispatched with) and applies their
    staleness-discounted average ``(server_lr / K) * sum_i s(tau_i) d_i``
    in one shot through the ``fed_reduce`` kernel.  The discount is
    ABSOLUTE (divide by K, not by the weight sum)."""

    name = "fedbuff"

    def __init__(self, buffer_k: int = 8, server_lr: float = 1.0,
                 staleness_alpha: float = 0.5,
                 staleness_kind: str = "polynomial"):
        self.buffer_k = buffer_k
        self.server_lr = server_lr
        self.staleness_alpha = staleness_alpha
        self.staleness_kind = staleness_kind
        self._deltas: List[Any] = []
        self._weights: List[float] = []

    def __len__(self) -> int:
        return len(self._deltas)

    @property
    def full(self) -> bool:
        return len(self._deltas) >= self.buffer_k

    def add(self, delta, staleness: int = 0):
        self._deltas.append(delta)
        self._weights.append(staleness_weight(
            staleness, self.staleness_alpha, self.staleness_kind))

    def flush(self, global_params):
        """Apply the buffered deltas; returns new params and clears."""
        if not self._deltas:
            raise RuntimeError("flush() on an empty buffer")
        w = np.asarray(self._weights, np.float32)
        w = (w / len(w)) * self.server_lr
        out = _weighted_combine(w, self._deltas, base=global_params)
        self._deltas, self._weights = [], []
        return out


def apply_async_update(global_params, client_params, *, mix: float,
                       staleness: int, alpha: float = 0.5,
                       kind: str = "polynomial"):
    """FedAsync [Xie'19] model mixing: theta <- (1-a) theta + a theta_k with
    a = mix * s(staleness), through the ``fed_aggregate`` kernel (M=1).
    ``a`` and ``1 - a`` are f32, as in the reference's jitted mix."""
    a = np.float32(np.clip(mix * staleness_weight(staleness, alpha, kind),
                           0.0, 1.0))
    one_minus_a = float(np.float32(1.0) - a)
    flat_c, meta = _flatten(client_params)
    flat_b, _ = _flatten(tree_map(lambda p: p * one_minus_a, global_params))
    w = torch.full((1,), float(a), dtype=torch.float32, device=flat_c.device)
    return _unflatten(kernel_ops.fed_aggregate(w, flat_c[None, :], flat_b),
                      meta)


AGGREGATORS = {
    "fedavg": FedAvg,
    "fedprox": FedAvg,     # proximal term lives client-side
    "fednova": FedNova,
    "fedadagrad": FedAdagrad,
    "fedadam": FedAdam,
    "fedyogi": FedYogi,
}


def get_aggregator(name: str, **kw) -> Aggregator:
    try:
        cls = AGGREGATORS[name]
    except KeyError:
        valid = ", ".join(sorted(AGGREGATORS))
        raise ValueError(f"unknown aggregator {name!r}; valid aggregators: "
                         f"{valid}") from None
    return cls(**kw)
