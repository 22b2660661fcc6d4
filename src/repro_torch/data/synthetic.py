"""Synthetic federated datasets (offline substitute for the paper's
speech-to-command / EMNIST / CIFAR-100, see DESIGN.md §5).

The three defining FL data properties are reproduced and tested:
  * massively distributed — thousands of clients, few examples each;
  * unbalanced            — client sizes follow a clipped log-normal
                            (1..~316 points, matching the paper's Fig. 2a);
  * non-IID               — per-client label distributions drawn from a
                            Dirichlet, plus a per-client feature shift.

Construction: class-conditional Gaussian mixtures.  Each class c has a mean
vector mu_c; client k draws labels from Dirichlet-skewed class weights and
features  x = sep * mu_y + client_shift_k + noise.  A fraction of labels is
flipped so accuracy climbs gradually over many rounds (the regime FedTune's
accuracy-gated decisions need).  Client features are generated lazily from
per-client seeds — only the participants of a round are materialized.

Copy of ``repro.data.synthetic``; the port imports nothing of ``repro``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class DataSpec:
    name: str
    n_classes: int
    shape: Tuple[int, ...]          # per-example feature shape
    n_train_clients: int
    n_test_clients: int
    size_log_mean: float = 3.0      # client-size log-normal parameters
    size_log_std: float = 1.2
    size_min: int = 1
    size_max: int = 316
    dirichlet_alpha: float = 0.5    # label skew (smaller = more non-IID)
    separation: float = 1.1         # class-mean scaling (difficulty)
    noise: float = 1.0
    client_shift: float = 0.35      # non-IID feature skew
    label_noise: float = 0.08
    seed: int = 0


@dataclass
class FederatedDataset:
    spec: DataSpec
    client_sizes: np.ndarray                  # (K,) train client sizes
    _class_means: np.ndarray = field(repr=False, default=None)
    _test_cache: Optional[Tuple[np.ndarray, np.ndarray]] = field(
        default=None, repr=False)
    _test_exhausted: bool = field(default=False, repr=False)

    # ------------------------------------------------------------------
    @property
    def n_clients(self) -> int:
        return len(self.client_sizes)

    @property
    def feat_dim(self) -> int:
        return int(np.prod(self.spec.shape))

    def client_data(self, client_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """Materialize one training client -> (x (n, *shape), y (n,))."""
        return self._materialize(client_id, self.client_sizes[client_id],
                                 test=False)

    def test_data(self, max_points: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
        """Pooled test set from the held-out test clients.

        Generation stops once ``max_points`` examples exist, and the result
        is cached.  The cache is only a valid answer for a LARGER request if
        it already holds ``max_points`` examples or the test clients were
        exhausted building it — otherwise it is regenerated at the larger
        size (same rng seed, so the previously returned points are a prefix
        of the regenerated set).  A first small call therefore never
        permanently truncates the test set for later callers."""
        if self._test_cache is not None and (
                len(self._test_cache[1]) >= max_points or self._test_exhausted):
            x, y = self._test_cache
            return x[:max_points], y[:max_points]
        rng = np.random.default_rng(self.spec.seed + 777)
        xs, ys = [], []
        total = 0
        exhausted = True
        for tc in range(self.spec.n_test_clients):
            n = int(np.clip(rng.lognormal(self.spec.size_log_mean,
                                          self.spec.size_log_std),
                            self.spec.size_min, self.spec.size_max))
            x, y = self._materialize(10_000_000 + tc, n, test=True)
            xs.append(x)
            ys.append(y)
            total += n
            if total >= max_points:
                exhausted = False
                break
        x = np.concatenate(xs)[:max_points]
        y = np.concatenate(ys)[:max_points]
        self._test_cache = (x, y)
        self._test_exhausted = exhausted
        return x, y

    # ------------------------------------------------------------------
    def _materialize(self, client_key: int, n: int, *, test: bool):
        s = self.spec
        rng = np.random.default_rng(
            (s.seed * 1_000_003 + client_key) % (2 ** 63))
        # label distribution: Dirichlet over classes (non-IID)
        label_p = rng.dirichlet(np.full(s.n_classes, s.dirichlet_alpha))
        y = rng.choice(s.n_classes, size=n, p=label_p)
        shift = rng.normal(0.0, s.client_shift, size=(self.feat_dim,))
        x = (s.separation * self._class_means[y]
             + shift[None, :]
             + rng.normal(0.0, s.noise, size=(n, self.feat_dim)))
        if s.label_noise > 0:
            flip = rng.random(n) < s.label_noise
            y = np.where(flip, rng.integers(0, s.n_classes, n), y)
        x = x.astype(np.float32).reshape((n,) + s.shape)
        return x, y.astype(np.int32)


def make_dataset(spec: DataSpec) -> FederatedDataset:
    rng = np.random.default_rng(spec.seed)
    feat_dim = int(np.prod(spec.shape))
    class_means = rng.normal(0.0, 1.0, size=(spec.n_classes, feat_dim))
    class_means /= np.linalg.norm(class_means, axis=1, keepdims=True)
    class_means *= np.sqrt(feat_dim) / 8.0
    sizes = np.clip(
        rng.lognormal(spec.size_log_mean, spec.size_log_std,
                      size=spec.n_train_clients),
        spec.size_min, spec.size_max).astype(np.int64)
    return FederatedDataset(spec=spec, client_sizes=sizes,
                            _class_means=class_means.astype(np.float32))


# ---------------------------------------------------------------------------
# the paper's three datasets (plus reduced variants for CPU benchmarks)
# ---------------------------------------------------------------------------

def speech_command_like(*, reduced: bool = False, seed: int = 0) -> FederatedDataset:
    """35-class 32x32x1 'spectrograms'; 2112 train / 506 test clients."""
    if reduced:
        return make_dataset(DataSpec(
            name="speech_command_like_reduced", n_classes=10, shape=(16, 16, 1),
            n_train_clients=128, n_test_clients=32, seed=seed))
    return make_dataset(DataSpec(
        name="speech_command_like", n_classes=35, shape=(32, 32, 1),
        n_train_clients=2112, n_test_clients=506, seed=seed))


def emnist_like(*, reduced: bool = False, seed: int = 0) -> FederatedDataset:
    """62-class 28x28 handwriting; writer-partitioned 70/30."""
    if reduced:
        return make_dataset(DataSpec(
            name="emnist_like_reduced", n_classes=16, shape=(28 * 28,),
            n_train_clients=128, n_test_clients=32, seed=seed))
    return make_dataset(DataSpec(
        name="emnist_like", n_classes=62, shape=(28 * 28,),
        n_train_clients=2520, n_test_clients=1080, seed=seed))


def cifar100_like(*, reduced: bool = False, seed: int = 0) -> FederatedDataset:
    """100-class 32x32x3; 1200 clients x 50 points (1000 train / 200 test)."""
    spec = DataSpec(
        name="cifar100_like" + ("_reduced" if reduced else ""),
        n_classes=20 if reduced else 100,
        shape=(16, 16, 3) if reduced else (32, 32, 3),
        n_train_clients=100 if reduced else 1000,
        n_test_clients=25 if reduced else 200,
        size_log_mean=np.log(50.0), size_log_std=1e-6,   # fixed 50/client
        size_min=50, size_max=50, seed=seed)
    return make_dataset(spec)
