"""Evaluation: staged test batches and one trial's accuracy (counterpart of
``repro.federated.evaluation``).

The host-side accumulation ``correct += float(acc) * n`` over 256-example
batches is the reference's float sequence, so equal per-batch accuracies
give equal results.  ``StackedEvaluator`` (many trials in one dispatch)
comes with the sweep engine's slice.
"""

from __future__ import annotations

from typing import List, Optional

import torch

EVAL_BATCH = 256               # test batch staging granularity (bounds memory)


def staged_batches(dataset, eval_points: int, device,
                   batch_size: int = EVAL_BATCH) -> List[tuple]:
    """The dataset's test set as a list of on-device ``(x, y, n)``
    batches."""
    x, y = dataset.test_data(eval_points)
    dev = torch.device(device)
    return [(torch.from_numpy(x[i:i + batch_size]).to(dev),
             torch.from_numpy(y[i:i + batch_size]).to(dev).long(),
             len(y[i:i + batch_size])) for i in range(0, len(y), batch_size)]


def eval_due(round_idx: int, eval_every: int, max_rounds: int) -> bool:
    """The shared evaluation schedule: every ``eval_every`` rounds and on
    the final round of the budget."""
    return (round_idx + 1) % eval_every == 0 or round_idx == max_rounds - 1


class Evaluator:
    """One trial's evaluation over test batches staged on ``device`` once,
    at the first call."""

    def __init__(self, model, dataset, eval_points: int, device):
        self.model = model
        self.dataset = dataset
        self.eval_points = eval_points
        self.device = torch.device(device)
        self._batches: Optional[List[tuple]] = None

    def evaluate(self, params) -> float:
        """Accuracy of ``params`` over the staged test batches."""
        if self._batches is None:
            self._batches = staged_batches(self.dataset, self.eval_points,
                                           self.device)
        correct, total = 0.0, 0
        with torch.no_grad():
            for bx, by, n in self._batches:
                logits = self.model.forward(params, bx)
                acc = (logits.argmax(-1) == by).to(torch.float32).mean()
                correct += float(acc) * n
                total += n
        return correct / total
