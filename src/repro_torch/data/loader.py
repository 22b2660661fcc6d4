"""Per-client batching with fixed shapes (pad + mask) so jit never retraces
when FedTune changes E or clients have different amounts of data.

Copy of ``repro.data.loader``; the port imports nothing of ``repro``.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def client_batches(x: np.ndarray, y: np.ndarray, batch_size: int,
                   passes: float, rng: np.random.Generator
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (x, y, mask) batches covering ``passes`` epochs of the client's
    data.  ``passes`` may be fractional (paper's E=0.5: half the data).
    Batches are padded to ``batch_size`` with mask=0 rows."""
    n = len(y)
    total = int(round(passes * n))
    if total <= 0:
        return
    order = np.concatenate([
        rng.permutation(n) for _ in range(int(np.ceil(total / n)))
    ])[:total]
    for start in range(0, total, batch_size):
        idx = order[start:start + batch_size]
        bx, by = x[idx], y[idx]
        mask = np.ones(len(idx), np.bool_)
        pad = batch_size - len(idx)
        if pad:
            bx = np.concatenate([bx, np.zeros((pad,) + bx.shape[1:], bx.dtype)])
            by = np.concatenate([by, np.zeros((pad,), by.dtype)])
            mask = np.concatenate([mask, np.zeros(pad, np.bool_)])
        yield bx, by, mask


def num_local_steps(n_examples: int, batch_size: int, passes: float) -> int:
    total = int(round(passes * n_examples))
    return int(np.ceil(total / batch_size)) if total > 0 else 0
