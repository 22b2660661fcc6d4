"""Sweep grids: TrialSpec (one FL training, fully determined) and SweepSpec
(a product grid over the paper's experiment axes).

A TrialSpec pins EVERYTHING a trial needs — dataset, aggregator, preference
vector, seed, tuner, runtime mode, (M0, E0), rounds — so its ``key()`` is a
stable resume handle: re-running a sweep skips every key already present in
the result store.  Validation is EAGER and round-trips through the real
constructors (``get_aggregator``, ``RuntimeConfig``, ``Preference``,
``upload_factor``, ``get_profile``): an unknown aggregator or client-exec
name raises a ValueError naming the valid options at grid-expansion time,
not minutes into trial 37.

``SweepSpec.expand()`` is the product over
    preferences x aggregators x datasets x seeds x (M0, E0) x tuners
    x runtime modes x fleet profiles,
with one reduction: fixed-tuner (baseline) trials ignore the preference
vector, so the preference axis is collapsed to ``CANONICAL_PREFERENCE`` for
them and duplicates are dropped — T fedtune trials share one fixed baseline
per (dataset, aggregator, seed, M0, E0) cell, exactly how the paper's
tables normalize.

Copy of ``repro.experiments.grid``; the port imports nothing of ``repro``.
``validate`` checks against the port's aggregators, compression methods,
runtime config and fleet profiles, and ``key()`` gives the reference's
string for the same spec, so a store written by one package resumes in the
other.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, fields, replace
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.preferences import PAPER_PREFERENCES, Preference

VALID_DATASETS = ("speech_command", "emnist", "cifar100")
VALID_TUNERS = ("fedtune", "fixed")
CANONICAL_PREFERENCE = (0.25, 0.25, 0.25, 0.25)


@dataclass(frozen=True)
class TrialSpec:
    """One FL training, fully determined — the unit of sweep work.

    Result-bearing fields (all part of ``key()``):
      dataset     — synthetic federation family: speech_command | emnist
                    | cifar100 (``reduced`` selects the small CI variant).
      aggregator  — server aggregation: fedavg | fedprox | fednova |
                    fedadagrad | fedadam | fedyogi.
      preference  — the paper's (α, β, γ, δ) weights over CompT/TransT/
                    CompL/TransL; must sum to 1.
      seed        — drives model init, server rng (selection + batch
                    order), system rng, and fleet sampling.
      tuner       — fedtune (Alg. 1 controller) | fixed (the baseline
                    the tables normalize against).
      mode        — runtime regime: sync | async (FedAsync) | buffered
                    (FedBuff).
      het         — fleet heterogeneity profile: homogeneous | mild |
                    stragglers | mobile (runtime/profiles.py).
      m0, e0      — initial participants per round / local passes: the
                    (M, E) pair FedTune tunes from.
      rounds      — max rounds (sync) or max aggregations (async/
                    buffered); target_accuracy stops a trial early.
      compression — None | 'int8' upload deltas; compressed trials
                    vectorize like any others (the quantize->dequantize
                    round trip is a per-lane transform in the cohort
                    packers).
      failure_rate— per-dispatch hard-failure hazard in [0, 1); nonzero
                    arms the coordinator's retry/reassignment policy
                    (runtime/engine.py). 0 keeps keys and results
                    bit-identical to pre-failure runs.
      churn       — fleet membership schedule "period:rate[:min_active]"
                    (runtime/profiles.ChurnSchedule) or None.

    Execution-only fields (absent from ``key()`` because every backend is
    result-parity-equal, pinned in tests): ``client_exec``.
    """
    dataset: str = "emnist"
    aggregator: str = "fedavg"
    preference: Tuple[float, float, float, float] = CANONICAL_PREFERENCE
    seed: int = 0
    tuner: str = "fedtune"              # fedtune | fixed
    mode: str = "sync"                  # runtime mode (sync|async|buffered)
    client_exec: str = "sequential"     # sequential-engine backend
    het: str = "homogeneous"            # fleet heterogeneity profile
    m0: int = 5
    e0: float = 2.0
    rounds: int = 30
    target_accuracy: float = 0.5
    batch_size: int = 10
    prox_mu: float = 0.0
    compression: Optional[str] = None
    reduced: bool = True
    eval_points: int = 512
    lr: float = 0.03
    failure_rate: float = 0.0           # per-dispatch hard-failure hazard
    churn: Optional[str] = None         # "period:rate[:min_active]" schedule

    # ------------------------------------------------------------------
    def validate(self) -> "TrialSpec":
        """Raise ValueError (naming the valid options) on any axis value the
        real constructors would reject.  Returns self so expansion can chain
        ``spec.validate()``."""
        from repro_torch.federated.aggregation import get_aggregator
        from repro_torch.federated.compression import upload_factor
        from repro_torch.runtime.engine import RuntimeConfig
        from repro_torch.runtime.profiles import PROFILES

        if self.dataset not in VALID_DATASETS:
            raise ValueError(f"unknown dataset {self.dataset!r}; valid "
                             "datasets: " + ", ".join(VALID_DATASETS))
        if self.tuner not in VALID_TUNERS:
            raise ValueError(f"unknown tuner {self.tuner!r}; valid tuners: "
                             + ", ".join(VALID_TUNERS))
        if self.het != "homogeneous" and self.het not in PROFILES:
            raise ValueError(f"unknown het profile {self.het!r}; valid "
                             "profiles: homogeneous, "
                             + ", ".join(sorted(PROFILES)))
        get_aggregator(self.aggregator)                  # ValueError w/ names
        RuntimeConfig(mode=self.mode, client_exec=self.client_exec)
        upload_factor(self.compression)
        try:
            Preference(*self.preference)
        except AssertionError as e:
            raise ValueError(f"bad preference {self.preference}: {e}") from None
        if self.rounds < 1 or self.m0 < 1 or self.e0 <= 0:
            raise ValueError(f"bad (rounds={self.rounds}, m0={self.m0}, "
                             f"e0={self.e0}); all must be positive")
        if not 0.0 <= self.failure_rate < 1.0:
            raise ValueError(f"bad failure_rate {self.failure_rate}; "
                             "must be in [0, 1)")
        if self.churn is not None:
            from repro_torch.runtime.profiles import ChurnSchedule
            ChurnSchedule.from_string(self.churn)    # ValueError on bad spec
        return self

    # ------------------------------------------------------------------
    def key(self) -> str:
        """Stable trial identity — the resume handle in the result store.
        Every field that changes a trial's RESULTS is in the key;
        ``client_exec`` is deliberately absent because the execution
        backends are result-parity-equal (pinned in tests)."""
        p = ",".join(f"{v:g}" for v in self.preference)
        parts = [
            f"ds={self.dataset}", f"agg={self.aggregator}", f"pref={p}",
            f"seed={self.seed}", f"tuner={self.tuner}", f"mode={self.mode}",
            f"het={self.het}", f"m0={self.m0}", f"e0={self.e0:g}",
            f"rounds={self.rounds}", f"target={self.target_accuracy:g}",
            f"bs={self.batch_size}", f"lr={self.lr:g}",
            f"ev={self.eval_points}",
            f"red={int(self.reduced)}",
        ]
        if self.prox_mu:
            parts.append(f"mu={self.prox_mu:g}")
        if self.compression:
            parts.append(f"comp={self.compression}")
        # fault axes append only when enabled: pre-existing keys stay stable
        if self.failure_rate:
            parts.append(f"fail={self.failure_rate:g}")
        if self.churn:
            parts.append(f"churn={self.churn}")
        return "|".join(parts)

    def baseline_key(self) -> str:
        """Key of this trial's FixedTuner twin (the paper's normalization
        baseline): same cell, tuner=fixed, canonical preference."""
        return replace(self, tuner="fixed",
                       preference=CANONICAL_PREFERENCE).key()

    @property
    def is_baseline(self) -> bool:
        return self.tuner == "fixed"

    def preference_obj(self) -> Preference:
        return Preference(*self.preference)

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


def spec_from_dict(d: dict) -> TrialSpec:
    names = {f.name for f in fields(TrialSpec)}
    kw = {k: v for k, v in d.items() if k in names}
    if "preference" in kw:
        kw["preference"] = tuple(kw["preference"])
    return TrialSpec(**kw)


# ---------------------------------------------------------------------------
# sweep grids
# ---------------------------------------------------------------------------

@dataclass
class SweepSpec:
    """Product grid over the experiment axes.  ``inits`` carries the
    (M0, E0) axis as pairs; ``modes`` spans the runtime regimes
    (sync/async/buffered), ``hets`` the fleet heterogeneity profiles
    (homogeneous/mild/stragglers/mobile — see runtime/profiles.py), and
    ``compressions`` the upload-compression methods (None/'int8'), so one
    grid can cover the paper's aggregator rows ACROSS runtime regimes,
    device fleets, and upload budgets.  Any axis left at its default
    contributes a single column, keeping pre-existing store keys stable."""
    datasets: Sequence[str] = ("emnist",)
    aggregators: Sequence[str] = ("fedavg",)
    preferences: Sequence[Tuple[float, float, float, float]] = (
        CANONICAL_PREFERENCE,)
    seeds: Sequence[int] = (0,)
    tuners: Sequence[str] = VALID_TUNERS
    inits: Sequence[Tuple[int, float]] = ((5, 2.0),)
    modes: Sequence[str] = ("sync",)
    hets: Sequence[str] = ("homogeneous",)
    compressions: Sequence[Optional[str]] = (None,)
    base: TrialSpec = field(default_factory=TrialSpec)   # shared settings

    def expand(self) -> List[TrialSpec]:
        """The validated product grid, fixed-baseline duplicates collapsed.
        Order is deterministic (itertools.product over the given axis
        order), so ``--limit N`` resume prefixes are stable."""
        seen = {}
        for ds, agg, pref, seed, tn, (m0, e0), mode, het, comp in \
                itertools.product(
                    self.datasets, self.aggregators, self.preferences,
                    self.seeds, self.tuners, self.inits, self.modes,
                    self.hets, self.compressions):
            if tn == "fixed":
                pref = CANONICAL_PREFERENCE   # baseline ignores preference
            if comp in (None, "none"):
                comp = None                   # one spelling, stable keys
            spec = replace(self.base, dataset=ds, aggregator=agg,
                           preference=tuple(pref), seed=seed, tuner=tn,
                           m0=m0, e0=e0, mode=mode, het=het,
                           compression=comp).validate()
            seen.setdefault(spec.key(), spec)
        return list(seen.values())


def parse_preferences(text: str) -> List[Tuple[float, float, float, float]]:
    """CLI preference parsing: 'all' -> the paper's 15 vectors; '0,4,14' ->
    indices into PAPER_PREFERENCES; '1,0,0,0;0.25,0.25,0.25,0.25' ->
    literal quads separated by ';'.

    A bare 4-element comma list is ambiguous (four indices or one quad);
    quads must sum to 1, so it parses as a quad only when it does —
    '1,0,0,0' is the first paper vector, '0,1,4,14' is four indices."""
    text = text.strip()
    if text == "all":
        return [p.as_tuple() for p in PAPER_PREFERENCES]

    def quads() -> List[Tuple[float, float, float, float]]:
        out = []
        for quad in text.split(";"):
            vals = tuple(float(v) for v in quad.split(","))  # noqa: REPRO003 -- a string's fields
            if len(vals) != 4:
                raise ValueError(f"preference {quad!r} is not a quad")
            out.append(vals)
        return out

    if ";" in text:
        return quads()
    if text.count(",") == 3 and abs(sum(
            float(v) for v in text.split(",")) - 1.0) < 1e-6:
        return quads()
    out = []
    for idx in text.split(","):
        i = int(idx)
        if not 0 <= i < len(PAPER_PREFERENCES):
            raise ValueError(f"preference index {i} out of range 0.."
                             f"{len(PAPER_PREFERENCES) - 1}")
        out.append(PAPER_PREFERENCES[i].as_tuple())
    return out
