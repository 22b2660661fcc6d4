"""Tuner API: the hook the FL server calls after every round.

A tuner observes (accuracy, per-round and cumulative SystemCost) and may
return new hyper-parameters (M, E).  ``FixedTuner`` is the paper's baseline
(constant M, E); ``FedTune`` (core/fedtune.py) is the paper's contribution.

Copy of ``repro.core.tuner``; the port imports nothing of ``repro``.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.costs import SystemCost


@dataclass
class HyperParams:
    m: int  # participants per round
    e: float  # local training passes

    def clamped(self, m_max: int, e_max: float) -> "HyperParams":
        return HyperParams(m=int(min(max(self.m, 1), m_max)),
                           e=float(min(max(self.e, 1.0), e_max)))


class Tuner:
    """Base: never changes anything."""

    def on_round(self, round_idx: int, accuracy: float,
                 round_cost: SystemCost, total_cost: SystemCost,
                 current: HyperParams) -> HyperParams:
        return current


class FixedTuner(Tuner):
    """The paper's baseline: fixed (M, E) for the whole training."""
