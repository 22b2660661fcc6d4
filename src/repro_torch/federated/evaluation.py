"""Evaluation: staged test batches and one trial's accuracy (counterpart of
``repro.federated.evaluation``).

The host-side accumulation ``correct += float(acc) * n`` over 256-example
batches is the reference's float sequence, so equal per-batch accuracies
give equal results.  ``StackedEvaluator`` evaluates T trials' params in
one ``torch.func.vmap`` of the accuracy per test batch, over test batches
staged on the device once per (dataset, eval_points, device).  Lane i's
logits are not the bits of ``Evaluator.evaluate``'s single forward: a
batched product rounds differently (within 4.4e-6 on the H100, 3.8e-6 on
the CPU).  Its accuracy is the same unless an argmax margin is that thin:
on the card the two routes gave the same argmax on all 512 eval points of
the sweep's int8 FedAvg lane (``chip_smoke.py``'s eval-route phase).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs, perf
from repro_torch.tree import leaves, tree_stack

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

    def __init__(self, model, dataset, eval_points: int, device,
                 batches: Optional[List[tuple]] = None):
        self.model = model
        self.dataset = dataset
        self.eval_points = eval_points
        self.device = torch.device(device)
        self._batches = batches

    def evaluate(self, params) -> float:
        """Accuracy of ``params`` over the staged test batches."""
        if self._batches is None:
            self._batches = staged_batches(self.dataset, self.eval_points,
                                           self.device)
        correct, total = 0.0, 0
        with torch.no_grad(), perf.timed("eval"), obs.span(
                "eval", phase="eval", n_lanes=1):
            for bx, by, n in self._batches:
                logits = self.model.forward(params, bx)
                acc = (logits.argmax(-1) == by).to(torch.float32).mean()
                correct += float(acc) * n  # noqa: REPRO003 -- one sync a batch: the reference's float sequence
                total += n
        return correct / total


# staged test batches shared by the stacked evaluations, per (dataset,
# eval_points, device); the dataset is kept with them so its id stays taken
_STAGED: Dict[tuple, Tuple[Any, List[tuple]]] = {}


def shared_batches(dataset, eval_points: int, device) -> List[tuple]:
    """``staged_batches`` of ``dataset``, staged once per device."""
    key = (id(dataset), eval_points, str(torch.device(device)))
    if key in _STAGED:
        if obs.enabled():
            obs.registry.inc("eval_batch_cache_hits")
        return _STAGED[key][1]
    if obs.enabled():
        obs.registry.inc("eval_batch_cache_misses")
    _STAGED[key] = (dataset, staged_batches(dataset, eval_points, device))
    return _STAGED[key][1]


class StackedEvaluator:
    """T trials' evaluation as one workload: a T-stacked params tree
    through ``torch.func.vmap`` of the accuracy over the shared staged
    batches, one launch sequence per test batch instead of one per (trial,
    batch).  Lane i's accuracy is ``Evaluator.evaluate(params_list[i])``'s
    unless an argmax margin is within the last-bit difference of a batched
    product (see the module docstring)."""

    def __init__(self, model, dataset, eval_points: int, device):
        self.model = model
        self.dataset = dataset
        self.eval_points = eval_points
        self.device = torch.device(device)

    def evaluate(self, params_list: Sequence[Any], mesh=None,
                 pad_to: Optional[int] = None) -> List[float]:
        """Per-trial accuracies for a list of params trees.  ``pad_to``
        pads the lane axis up to a caller-chosen width first (extra lanes
        repeat lane 0 and are discarded), as the sweep engines ask for a
        pow2 of the due count.  With ``mesh`` (a ``launch.mesh.
        ClientsMesh``) the lanes are padded to a multiple of its ranks,
        each rank evaluates its contiguous block of them, and the
        per-batch accuracies are all-gathered, so every rank folds the
        same numbers and returns the same list; every rank must pass the
        same params."""
        t = len(params_list)
        if t == 0:
            return []
        batches = shared_batches(self.dataset, self.eval_points, self.device)
        if t == 1:
            # a singleton gains nothing from the stacked variant
            return [Evaluator(self.model, self.dataset, self.eval_points,
                              self.device, batches).evaluate(params_list[0])]
        stacked_list = list(params_list)
        if pad_to is not None and pad_to > t:
            stacked_list = stacked_list + [stacked_list[0]] * (pad_to - t)
        if mesh is not None:
            stacked_list += [stacked_list[0]] * (
                (-len(stacked_list)) % mesh.size)
            stacked_list = stacked_list[mesh.block(len(stacked_list))]
        stacked = tree_stack(stacked_list)
        forward = self.model.forward

        def accuracy(params, bx, by):
            logits = forward(params, bx)
            return (logits.argmax(-1) == by).to(torch.float32).mean()

        lanes = torch.func.vmap(accuracy, in_dims=(0, None, None))
        with torch.no_grad(), perf.timed("eval"), obs.span(
                "eval_stacked", phase="eval", n_lanes=t):
            accs = torch.stack([lanes(stacked, bx, by)
                                for bx, by, _ in batches])
            if mesh is not None:      # (ranks, batches, block) -> lanes
                accs = mesh.gather(accs).permute(1, 0, 2).reshape(
                    len(batches), -1)
            accs = accs.cpu().numpy()
        correct = [0.0] * t
        total = 0
        for row, (_, _, n) in zip(accs, batches):
            for i in range(t):
                correct[i] += float(row[i]) * n  # noqa: REPRO003 -- a numpy row: the accuracies came over once, above
            total += n
        return [c / total for c in correct]


def _pow2_lanes(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def evaluate_stacked(items: Sequence[Tuple[Any, Any, int, Any]],
                     mesh=None, pad_pow2: bool = False) -> List[float]:
    """Batch-evaluate many trials: ``items`` holds one ``(model, dataset,
    eval_points, params)`` per trial; trials sharing a (model, dataset,
    eval_points) group run as one stacked evaluation on the device of the
    group's params.  Returns accuracies in item order.  ``pad_pow2`` pads
    each group's lane axis to a pow2 of its size; ``mesh`` lays each
    group's lanes over its ranks (``StackedEvaluator.evaluate``)."""
    groups: Dict[tuple, List[int]] = {}
    for i, (model, dataset, eval_points, _params) in enumerate(items):
        groups.setdefault((id(model), id(dataset), eval_points),
                          []).append(i)
    out: List[float] = [0.0] * len(items)
    for idx in groups.values():
        model, dataset, eval_points, params = items[idx[0]]
        pad_to = _pow2_lanes(len(idx)) if pad_pow2 else None
        device = leaves(params)[0].device
        accs = StackedEvaluator(model, dataset, eval_points, device).evaluate(
            [items[i][3] for i in idx], mesh=mesh, pad_to=pad_to)
        for i, acc in zip(idx, accs):
            out[i] = acc
    return out
