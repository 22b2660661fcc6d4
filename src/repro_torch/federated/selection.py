"""Participant selection strategies (beyond-paper; paper §6 'Extensions').

  random  — the paper's setting (uniform without replacement).
  guided  — Oort-lite utility selection: utility_k = last_loss_k * sqrt(n_k)
            with epsilon-greedy exploration.  Clients that hurt the model
            most (high loss) and carry more data are preferred.
  smallest— deadline-style: prefer clients with the least data (bounds the
            straggler term max_k n_k in CompT, eq. 2).
  deadline— heterogeneity-aware: prefer clients with the smallest *expected
            round time* (data size / device speed, runtime fleet profile),
            with epsilon-greedy exploration so slow clients still
            contribute occasionally (avoids fast-device bias).

Copy of ``repro.federated.selection``; the port imports nothing of ``repro``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class Selector:
    name = "random"

    def __init__(self, n_clients: int, rng: np.random.Generator):
        self.n_clients = n_clients
        self.rng = rng

    def select(self, m: int) -> np.ndarray:
        return self.rng.choice(self.n_clients, size=m, replace=False)

    def update(self, client_id: int, loss: float, n_examples: int):
        pass


class GuidedSelector(Selector):
    name = "guided"

    def __init__(self, n_clients: int, rng: np.random.Generator,
                 epsilon: float = 0.2):
        super().__init__(n_clients, rng)
        self.epsilon = epsilon
        self.utility = np.full(n_clients, np.inf)  # unexplored = max utility

    def select(self, m: int) -> np.ndarray:
        m = min(m, self.n_clients)
        n_explore = int(round(self.epsilon * m))
        n_exploit = m - n_explore
        order = np.argsort(-np.nan_to_num(self.utility, posinf=1e30))
        exploit = order[:n_exploit]
        rest = np.setdiff1d(np.arange(self.n_clients), exploit)
        explore = self.rng.choice(rest, size=min(n_explore, len(rest)),
                                  replace=False)
        return np.concatenate([exploit, explore]).astype(np.int64)

    def update(self, client_id: int, loss: float, n_examples: int):
        self.utility[client_id] = float(loss) * np.sqrt(max(n_examples, 1))


class SmallestFirstSelector(Selector):
    name = "smallest"

    def __init__(self, n_clients: int, rng: np.random.Generator,
                 client_sizes=None):
        super().__init__(n_clients, rng)
        self.sizes = np.asarray(client_sizes)

    def select(self, m: int) -> np.ndarray:
        m = min(m, self.n_clients)
        # jitter to avoid always picking the identical smallest set
        noisy = self.sizes + self.rng.uniform(0, 1, self.n_clients)
        return np.argsort(noisy)[:m]


class DeadlineAwareSelector(Selector):
    """Ranks clients by expected dispatch->arrival time under the runtime's
    device fleet; an epsilon fraction of each cohort is still drawn uniformly
    from the remainder so stragglers are not starved of participation."""
    name = "deadline"

    def __init__(self, n_clients: int, rng: np.random.Generator,
                 est_times, epsilon: float = 0.1):
        super().__init__(n_clients, rng)
        self.est_times = np.asarray(est_times, np.float64)
        self.epsilon = epsilon

    def select(self, m: int) -> np.ndarray:
        m = min(m, self.n_clients)
        n_explore = int(round(self.epsilon * m))
        n_fast = m - n_explore
        # jitter breaks ties between identical devices
        noisy = self.est_times * (1.0 + self.rng.uniform(
            0, 1e-6, self.n_clients))
        fast = np.argsort(noisy)[:n_fast]
        rest = np.setdiff1d(np.arange(self.n_clients), fast)
        explore = self.rng.choice(rest, size=min(n_explore, len(rest)),
                                  replace=False)
        return np.concatenate([fast, explore]).astype(np.int64)


def get_selector(name: str, n_clients: int, rng: np.random.Generator,
                 client_sizes=None, est_times=None) -> Selector:
    if name == "random":
        return Selector(n_clients, rng)
    if name == "guided":
        return GuidedSelector(n_clients, rng)
    if name == "smallest":
        return SmallestFirstSelector(n_clients, rng, client_sizes)
    if name == "deadline":
        if est_times is None:
            if client_sizes is None:
                raise ValueError(
                    "deadline selection needs est_times (from a runtime "
                    "fleet) or client_sizes as a completion-time proxy")
            # no fleet wired in: every client looks equally fast, fall back
            # to data size as the completion-time proxy
            est_times = np.asarray(client_sizes, np.float64)
        return DeadlineAwareSelector(n_clients, rng, est_times)
    raise KeyError(name)
