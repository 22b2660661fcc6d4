"""System-overhead accounting (paper §3.1, eqs. 2-5).

Clients are homogeneous in hardware/network (paper assumption), so

  CompT  = C1 * E * sum_r max_k b_{k,r} n_k      (slowest participant)
  TransT = C2 * R
  CompL  = C3 * E * sum_r sum_k b_{k,r} n_k
  TransL = C4 * R * M

Paper convention for the constants: C1 = C3 = model FLOPs per input,
C2 = C4 = model parameter count.  ``CostModel.add_round`` accumulates the
four overheads from per-round telemetry (participant example counts and the
passes actually run), which also supports heterogeneous E (FedNova-style
extensions) because it sums what each participant actually did.

Copy of ``repro.core.costs``; the port imports nothing of ``repro``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from repro_torch.core.preferences import Preference

_EPS = 1e-12   # zero-baseline clamp, same convention as FedTune._comparison


@dataclass
class SystemCost:
    comp_t: float = 0.0
    trans_t: float = 0.0
    comp_l: float = 0.0
    trans_l: float = 0.0

    def as_tuple(self):
        return (self.comp_t, self.trans_t, self.comp_l, self.trans_l)

    def copy(self) -> "SystemCost":
        return SystemCost(*self.as_tuple())

    def __sub__(self, other: "SystemCost") -> "SystemCost":
        return SystemCost(self.comp_t - other.comp_t,
                          self.trans_t - other.trans_t,
                          self.comp_l - other.comp_l,
                          self.trans_l - other.trans_l)

    def weighted_relative_to(self, baseline: "SystemCost",
                             pref: Preference) -> float:
        """Paper eq. (6): I(baseline, self). Negative => self is better.

        A zero baseline overhead is legitimate (e.g. a compressed-upload
        run whose window accrues no transmission), so it is clamped to
        ``_EPS`` — the same convention as ``FedTune._comparison`` — rather
        than asserted away."""
        terms = []
        for w, a, b in zip(pref.as_tuple(), self.as_tuple(),
                           baseline.as_tuple()):
            if w == 0.0:
                continue
            terms.append(w * (a - b) / max(b, _EPS))
        return float(sum(terms))


@dataclass
class CostModel:
    """Accumulates eqs. (2)-(5) round by round."""

    flops_per_example: float      # C1 = C3
    param_count: float            # C2 = C4
    backward_multiplier: float = 3.0  # fwd+bwd ~= 3x fwd FLOPs
    total: SystemCost = field(default_factory=SystemCost)
    rounds: int = 0

    @property
    def train_flops_per_example(self) -> float:
        """C1 (= C3): forward+backward FLOPs per training example."""
        return self.flops_per_example * self.backward_multiplier

    def traffic_halves(self, upload_factor: float = 1.0):
        """(download, upload) units per client round under the paper's
        convention that a full round moves ``param_count`` total, split
        half down / half up, with only the upload compressible.  Single
        source of truth for the runtime clock AND the deadline selector's
        ranking signal — they must not drift apart."""
        return self.param_count * 0.5, self.param_count * upload_factor * 0.5

    def add_round(self, participant_examples: Sequence[float],
                  passes: float, *, upload_factor: float = 1.0) -> SystemCost:
        """participant_examples: examples per selected client this round
        (already scaled by the fraction of data a pass covers);
        passes: E; upload_factor < 1 models compressed uploads (the
        download half of the round stays full precision).
        Returns this round's cost."""
        m = len(participant_examples)
        assert m >= 1
        c1 = c3 = self.flops_per_example * self.backward_multiplier
        c2 = c4 = self.param_count
        r = SystemCost(
            comp_t=c1 * passes * max(participant_examples),
            trans_t=c2 * (1.0 + upload_factor) / 2.0,
            comp_l=c3 * passes * sum(participant_examples),
            trans_l=c4 * m * (1.0 + upload_factor) / 2.0,
        )
        self._accumulate(r)
        return r

    def add_timed_round(self, *, comp_time: float, trans_time: float,
                        comp_load: float, trans_load: float) -> SystemCost:
        """Heterogeneous-runtime accounting: the *time* overheads come from
        per-client simulated wall-clock (critical path over the round's
        participants, or virtual-clock deltas in async modes) instead of the
        homogeneous ``C1 * E * max_k n_k`` proxy; the *load* overheads stay
        exact work sums.  Over a homogeneous unit-rate fleet the critical
        path degenerates to eqs. (2)-(5), so this strictly generalizes
        ``add_round``."""
        r = SystemCost(comp_t=comp_time, trans_t=trans_time,
                       comp_l=comp_load, trans_l=trans_load)
        self._accumulate(r)
        return r

    def _accumulate(self, r: SystemCost):
        self.total.comp_t += r.comp_t
        self.total.trans_t += r.trans_t
        self.total.comp_l += r.comp_l
        self.total.trans_l += r.trans_l
        self.rounds += 1
