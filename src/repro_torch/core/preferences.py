"""Application training preferences (paper §4): weights over the four
system overheads CompT, TransT, CompL, TransL.

Copy of ``repro.core.preferences``; the port imports nothing of ``repro``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Preference:
    alpha: float   # CompT (computation time)
    beta: float    # TransT (transmission time)
    gamma: float   # CompL (computation load, FLOPs)
    delta: float   # TransL (transmission load, bytes)

    def __post_init__(self):
        s = self.alpha + self.beta + self.gamma + self.delta
        assert abs(s - 1.0) < 1e-6, f"preferences must sum to 1, got {s}"
        assert min(self.alpha, self.beta, self.gamma, self.delta) >= 0

    def as_tuple(self):
        return (self.alpha, self.beta, self.gamma, self.delta)

    def __str__(self):
        return (f"({self.alpha:g},{self.beta:g},{self.gamma:g},{self.delta:g})")


# The paper's 15 evaluation combinations (Table 4, first column).
PAPER_PREFERENCES = [
    Preference(1.0, 0.0, 0.0, 0.0),
    Preference(0.0, 1.0, 0.0, 0.0),
    Preference(0.0, 0.0, 1.0, 0.0),
    Preference(0.0, 0.0, 0.0, 1.0),
    Preference(0.5, 0.5, 0.0, 0.0),
    Preference(0.5, 0.0, 0.5, 0.0),
    Preference(0.5, 0.0, 0.0, 0.5),
    Preference(0.0, 0.5, 0.5, 0.0),
    Preference(0.0, 0.5, 0.0, 0.5),
    Preference(0.0, 0.0, 0.5, 0.5),
    Preference(1 / 3, 1 / 3, 1 / 3, 0.0),
    Preference(1 / 3, 1 / 3, 0.0, 1 / 3),
    Preference(1 / 3, 0.0, 1 / 3, 1 / 3),
    Preference(0.0, 1 / 3, 1 / 3, 1 / 3),
    Preference(0.25, 0.25, 0.25, 0.25),
]
