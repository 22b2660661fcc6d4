"""Per-client device profiles for the heterogeneous runtime.

The paper (and ``core/costs.py``) assumes homogeneous clients, so CompT is
``C1 * E * max_k n_k``: every client computes at unit speed and transfers at
unit bandwidth.  A ``Fleet`` generalizes this: each client k gets a compute
``speed_k`` (relative FLOP/s), link bandwidths ``up_bw_k`` / ``down_bw_k``
(relative bytes/s), an availability probability (chance the client answers a
dispatch at all), and a dropout probability (chance it dies mid-round after
doing the work).  Virtual times are expressed in the same units as the
paper's overheads: with the reference rates at 1.0, a homogeneous unit fleet
reproduces eqs. (2)-(5) exactly — compute time IS ``C1 * E * n_k`` and
transfer time IS ``C2`` — so the legacy cost model is the special case.

Named profiles (``--het <name>``):
  homogeneous — unit fleet; the paper's setting.
  mild        — 3 device classes (1.5x/1x/0.5x) with 20% lognormal jitter.
  stragglers  — 85% unit devices, 15% 10x-slower tail (the FedBuff regime).
  mobile      — slow, narrow links, flaky availability (cross-device FL).

Copy of ``repro.runtime.profiles``; the port imports nothing of ``repro``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Callable, Dict, Optional, Tuple

import numpy as np


def hash01(*ints: int) -> float:
    """Stateless uniform draw in [0, 1) from a tuple of non-negative ints.

    Failure and churn decisions must be pure functions of the virtual
    clock: the sync planner, the async event loop, and the buffered event
    loop all ask "does client k fail at time t?" at DIFFERENT points in
    their sequential rng streams, so consuming the shared ``sys_rng``
    would desynchronize the engines (and break the failure-rate-0
    bit-parity contract the moment a rate goes nonzero).  A seeded-hash
    draw keyed on (seed, cid, time, attempt) gives every engine the same
    answer with zero stream consumption."""
    seq = np.random.SeedSequence(list(ints))  # noqa: REPRO004 -- entropy is the explicit int tuple, not process state
    return float(seq.generate_state(1)[0] / 2**32)


def _time_bits(t: float) -> int:
    """The virtual instant as hashable entropy (exact float64 bits, so two
    engines asking about the same instant agree to the last ulp)."""
    return int(np.float64(t).view(np.uint64))


# -- vectorized stateless draws (client-state virtualization) ---------------
#
# ``hash01`` pays a SeedSequence construction per draw (~10us) — fine for
# the engines' per-dispatch failure checks, hopeless for deriving a
# million-client cohort's device parameters.  ``_hash01_many`` is the bulk
# counterpart: a numpy-vectorized splitmix64 finalizer over client ids, so
# a VirtualFleet can gather any cohort's draws in one array pass.  It is a
# DIFFERENT hash domain from ``hash01`` (virtual-fleet device draws never
# have to match a materialized sample_fleet's rng sequence — determinism
# and K-independence per cid are the contract, pinned in test_runtime.py);
# the failure model keeps ``hash01`` itself so a VirtualFleet's ``fails``
# answers bit-match a materialized Fleet's.

_SM64 = dict(gamma=np.uint64(0x9E3779B97F4A7C15),
             m1=np.uint64(0xBF58476D1CE4E5B9),
             m2=np.uint64(0x94D049BB133111EB))


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (Steele et al.), elementwise over uint64."""
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * _SM64["m1"]
        x = (x ^ (x >> np.uint64(27))) * _SM64["m2"]
    return x ^ (x >> np.uint64(31))


def _hash01_many(seed: int, salt: int, cids) -> np.ndarray:
    """Uniform [0, 1) per client id, vectorized: hash(seed, salt, cid) via
    splitmix64.  A given (seed, salt, cid) always maps to the same draw —
    independent of how many other clients exist or which cohort asks."""
    c = np.asarray(cids, dtype=np.uint64)
    with np.errstate(over="ignore"):
        stream = _mix64(np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
                        + np.uint64(salt) * _SM64["gamma"])
        x = _mix64((c + stream) * _SM64["gamma"])
    # top 53 bits -> float64 mantissa: strictly < 1.0
    return (x >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)


@dataclass(frozen=True)
class ChurnSchedule:
    """Deterministic fleet membership over virtual time (clients joining
    and leaving between rounds).

    Time is cut into epochs of ``period`` virtual seconds; within an
    epoch membership is frozen (churn happens BETWEEN rounds, not inside
    a client's dispatch->arrival window).  Epoch 0 is full — a trial's
    first round sees the whole fleet, so a schedule only perturbs later
    rounds.  In every later epoch each client is away with probability
    ``rate``, drawn by the stateless ``hash01`` on (seed, cid, epoch) —
    a pure function of virtual time, consuming no rng stream, so sync
    and event engines agree bit-for-bit.  ``min_active`` clients are
    guaranteed present (the lowest absent ids are forced back in) so a
    harsh schedule can never empty the fleet under the selector."""
    period: float
    rate: float
    seed: int = 0
    min_active: int = 1

    def __post_init__(self):
        assert self.period > 0, "churn period must be positive"
        assert 0.0 <= self.rate < 1.0, "churn rate must be in [0, 1)"

    def epoch_of(self, t: float) -> int:
        return int(t // self.period)

    def active_mask(self, n_clients: int, t: float) -> np.ndarray:
        return _churn_mask(self, n_clients, self.epoch_of(t))

    @classmethod
    def from_string(cls, text: str, *, seed: int = 0) -> "ChurnSchedule":
        """Parse the TrialSpec encoding ``"period:rate[:min_active]"``
        (e.g. ``"5000:0.3"``)."""
        parts = str(text).split(":")
        if len(parts) not in (2, 3):
            raise ValueError(
                f"bad churn spec {text!r}; expected 'period:rate' or "
                "'period:rate:min_active'")
        period, rate = float(parts[0]), float(parts[1])
        min_active = int(parts[2]) if len(parts) == 3 else 1
        if period <= 0 or not 0.0 <= rate < 1.0 or min_active < 1:
            raise ValueError(
                f"bad churn spec {text!r}; need period > 0, "
                "0 <= rate < 1, min_active >= 1")
        return cls(period=period, rate=rate, seed=seed,
                   min_active=min_active)


@lru_cache(maxsize=512)
def _churn_mask(schedule: ChurnSchedule, n_clients: int,
                epoch: int) -> np.ndarray:
    if epoch == 0:
        return np.ones(n_clients, dtype=bool)
    mask = np.array([hash01(schedule.seed, cid, epoch) >= schedule.rate
                     for cid in range(n_clients)])
    need = schedule.min_active - int(mask.sum())
    if need > 0:
        absent = np.flatnonzero(~mask)
        mask[absent[:need]] = True
    mask.setflags(write=False)     # cached: callers must not mutate
    return mask


@dataclass(frozen=True)
class DeviceClass:
    """One hardware tier inside a profile."""
    name: str
    speed: float          # relative compute rate (1.0 = reference device)
    bandwidth: float      # relative link rate (applied to up and down)
    weight: float         # sampling probability of this tier


@dataclass(frozen=True)
class HeterogeneityProfile:
    name: str
    classes: Tuple[DeviceClass, ...]
    speed_jitter: float = 0.0     # lognormal sigma multiplied onto speed
    availability: float = 1.0     # P(client answers a dispatch)
    dropout: float = 0.0          # P(client dies mid-round; work lost)
    failure: float = 0.0          # P(a dispatch hard-fails; update never
                                  # returns — triggers coordinator retry)

    def __post_init__(self):
        total = sum(c.weight for c in self.classes)
        assert abs(total - 1.0) < 1e-6, "class weights must sum to 1"


PROFILES: Dict[str, HeterogeneityProfile] = {
    "homogeneous": HeterogeneityProfile(
        name="homogeneous",
        classes=(DeviceClass("ref", 1.0, 1.0, 1.0),),
    ),
    "mild": HeterogeneityProfile(
        name="mild",
        classes=(DeviceClass("fast", 1.5, 1.5, 0.3),
                 DeviceClass("mid", 1.0, 1.0, 0.5),
                 DeviceClass("slow", 0.5, 0.6, 0.2)),
        speed_jitter=0.2, availability=0.95, dropout=0.02,
    ),
    "stragglers": HeterogeneityProfile(
        name="stragglers",
        classes=(DeviceClass("ref", 1.0, 1.0, 0.85),
                 DeviceClass("straggler", 0.1, 0.3, 0.15)),
        speed_jitter=0.1, availability=1.0, dropout=0.05,
    ),
    "mobile": HeterogeneityProfile(
        name="mobile",
        classes=(DeviceClass("hi", 0.8, 0.5, 0.25),
                 DeviceClass("mid", 0.5, 0.3, 0.5),
                 DeviceClass("lo", 0.2, 0.1, 0.25)),
        speed_jitter=0.3, availability=0.7, dropout=0.1,
    ),
}


@dataclass
class Fleet:
    """Sampled per-client device parameters (vectorized as arrays)."""
    profile: HeterogeneityProfile
    speed: np.ndarray         # (K,) relative FLOP/s
    up_bw: np.ndarray         # (K,) relative upload bytes/s
    down_bw: np.ndarray       # (K,) relative download bytes/s
    availability: np.ndarray  # (K,) P(answers dispatch)
    dropout: np.ndarray       # (K,) P(dies mid-round)
    ref_flops_per_s: float = 1.0   # unit rates keep times in cost units
    ref_bytes_per_s: float = 1.0
    # --- failure/churn model (fault-tolerant elastic serving) -----
    failure: Optional[np.ndarray] = None     # (K,) per-dispatch hazard
    failure_seed: int = 0                    # hash01 domain separation
    failure_fn: Optional[Callable[[int, float, int], bool]] = None
    #   scripted override (tests/faultlib.py): fails(cid, t, attempt)
    churn: Optional[ChurnSchedule] = None    # membership over virtual time

    @property
    def n_clients(self) -> int:
        return len(self.speed)

    # -- failure model --------------------------------------------------
    def has_failures(self) -> bool:
        """Gate: every failure code path in the engines is skipped — and
        draws nothing — unless this is true, which is what keeps the
        fault-free path bit-identical to the pre-failure runtime."""
        if self.failure_fn is not None:
            return True
        return self.failure is not None and bool(np.any(self.failure > 0.0))

    def fails(self, cid: int, t: float, attempt: int = 0) -> bool:
        """Does attempt ``attempt`` dispatched to ``cid`` at virtual time
        ``t`` hard-fail?  Stateless (hash01 on the exact float64 time
        bits) so every engine consuming the same dispatch instant agrees
        without touching any sequential rng stream."""
        if self.failure_fn is not None:
            return bool(self.failure_fn(int(cid), float(t), int(attempt)))
        if self.failure is None:
            return False
        p = float(self.failure[cid])
        if p <= 0.0:
            return False
        return hash01(self.failure_seed, int(cid), _time_bits(t),
                      int(attempt)) < p

    # -- churn ----------------------------------------------------------
    def is_active(self, cid: int, t: float) -> bool:
        """Is ``cid`` a fleet member at virtual time ``t``?  Engines check
        this BEFORE any availability draw so inactive clients consume no
        rng (churn-free runs stay bit-identical)."""
        if self.churn is None:
            return True
        return bool(self.churn.active_mask(self.n_clients, t)[cid])

    def n_active(self, t: float) -> int:
        if self.churn is None:
            return self.n_clients
        return int(self.churn.active_mask(self.n_clients, t).sum())

    def comp_time(self, cid: int, flops: float) -> float:
        """Virtual seconds to run ``flops`` on client ``cid``."""
        return float(flops) / (self.ref_flops_per_s * float(self.speed[cid]))

    def trans_time(self, cid: int, down_units: float, up_units: float) -> float:
        """Virtual seconds to download + upload the given traffic."""
        return (float(down_units) / (self.ref_bytes_per_s
                                     * float(self.down_bw[cid]))
                + float(up_units) / (self.ref_bytes_per_s
                                     * float(self.up_bw[cid])))

    def est_round_time(self, cid: int, n_examples: float, passes: float,
                       flops_per_example: float, down_units: float,
                       up_units: float) -> float:
        """Deadline-aware selection signal: expected dispatch->arrival time
        (download + compute + upload — a fast CPU behind a narrow link is
        correctly ranked slow)."""
        return (self.comp_time(cid, flops_per_example * passes * n_examples)
                + self.trans_time(cid, down_units, up_units))

    def est_round_times(self, cids, n_examples, passes: float,
                        flops_per_example: float, down_units: float,
                        up_units: float) -> np.ndarray:
        """Bulk ``est_round_time`` over a cohort in one vectorized float64
        pass, elementwise bit-identical to the scalar method (same op
        sequence: (fpe * passes) * n, divide, add)."""
        cids = np.asarray(cids)
        n = np.asarray(n_examples, np.float64)
        flops = flops_per_example * passes * n
        comp = flops / (self.ref_flops_per_s * self.speed[cids])
        trans = (float(down_units) / (self.ref_bytes_per_s
                                      * self.down_bw[cids])
                 + float(up_units) / (self.ref_bytes_per_s
                                      * self.up_bw[cids]))
        return comp + trans

    def is_homogeneous(self) -> bool:
        return (np.all(self.speed == self.speed[0])
                and np.all(self.up_bw == self.up_bw[0])
                and np.all(self.down_bw == self.down_bw[0])
                and np.all(self.availability >= 1.0)
                and np.all(self.dropout <= 0.0))


def sample_fleet(profile: "HeterogeneityProfile | str", n_clients: int,
                 *, seed: int = 0) -> Fleet:
    """Draw per-client devices from a profile (deterministic in seed)."""
    if isinstance(profile, str):
        profile = get_profile(profile)
    rng = np.random.default_rng(seed)
    weights = np.array([c.weight for c in profile.classes])
    tier = rng.choice(len(profile.classes), size=n_clients, p=weights)
    speed = np.array([profile.classes[t].speed for t in tier])
    bw = np.array([profile.classes[t].bandwidth for t in tier])
    if profile.speed_jitter > 0:
        speed = speed * rng.lognormal(0.0, profile.speed_jitter, n_clients)
    return Fleet(
        profile=profile,
        speed=speed.astype(np.float64),
        up_bw=bw.astype(np.float64),
        down_bw=bw.astype(np.float64),
        availability=np.full(n_clients, profile.availability),
        dropout=np.full(n_clients, profile.dropout),
        failure=(np.full(n_clients, profile.failure)
                 if profile.failure > 0.0 else None),
        failure_seed=seed,
    )


class _PerClient:
    """A (K,)-array-shaped lazy view: ``view[cid]`` / ``view[cid_array]``
    computes the draw on demand (scalar index -> float, array index ->
    array), so a VirtualFleet exposes the exact attribute surface the
    engines index (``fleet.availability[cid]``…) with O(cohort) work and
    O(1) resident memory regardless of K."""

    def __init__(self, n: int, fn):
        self._n = int(n)
        self._fn = fn

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx):
        arr = np.asarray(idx)
        if arr.ndim == 0:
            return float(self._fn(arr.reshape(1))[0])
        return self._fn(arr)


@dataclass
class VirtualFleet:
    """A fleet whose per-client device parameters are DERIVED, not stored:
    speed/bandwidth tier and jitter for client ``cid`` come from the
    stateless ``_hash01_many`` draws on (seed, salt, cid), availability
    and dropout are the profile's constants, and the failure model is the
    same ``hash01`` draw a materialized ``Fleet`` uses — so no (K,) array
    ever exists and ``n_clients`` can be 10^6+ while the cost model only
    ever gathers the selected cohort.  ``materialize()`` builds the
    equivalent array-backed Fleet (same draws per cid; feasible only for
    small K), which is how tests pin virtual==materialized engine
    behavior.  Churn schedules need population-wide masks, so they stay a
    materialized-Fleet feature."""
    profile: HeterogeneityProfile
    n: int
    seed: int = 0
    ref_flops_per_s: float = 1.0
    ref_bytes_per_s: float = 1.0
    failure_rate: float = 0.0
    failure_seed: int = 0
    failure_fn: Optional[Callable[[int, float, int], bool]] = None
    churn: None = None            # see class docstring

    def __post_init__(self):
        self._cum = np.cumsum(
            [c.weight for c in self.profile.classes]).astype(np.float64)
        self._cls_speed = np.array(
            [c.speed for c in self.profile.classes], np.float64)
        self._cls_bw = np.array(
            [c.bandwidth for c in self.profile.classes], np.float64)
        self.speed = _PerClient(self.n, self.speeds)
        self.up_bw = _PerClient(self.n, self.bws)
        self.down_bw = _PerClient(self.n, self.bws)
        self.availability = _PerClient(
            self.n, lambda c: np.full(len(c), self.profile.availability))
        self.dropout = _PerClient(
            self.n, lambda c: np.full(len(c), self.profile.dropout))
        self.failure = (_PerClient(
            self.n, lambda c: np.full(len(c), self.failure_rate))
            if self.failure_rate > 0.0 else None)

    @property
    def n_clients(self) -> int:
        return self.n

    # -- bulk draws (cohort-sized gathers, the virtualization point) -----
    def _tiers(self, cids) -> np.ndarray:
        u = _hash01_many(self.seed, 0, cids)
        return np.minimum(np.searchsorted(self._cum, u, side="right"),
                          len(self._cum) - 1)

    def speeds(self, cids) -> np.ndarray:
        """(len(cids),) relative FLOP/s: tier speed x lognormal jitter."""
        s = self._cls_speed[self._tiers(cids)]
        if self.profile.speed_jitter > 0:
            u1 = _hash01_many(self.seed, 1, cids)
            u2 = _hash01_many(self.seed, 2, cids)
            z = (np.sqrt(-2.0 * np.log1p(-u1))
                 * np.cos(2.0 * np.pi * u2))          # Box-Muller
            s = s * np.exp(self.profile.speed_jitter * z)
        return s

    def bws(self, cids) -> np.ndarray:
        return self._cls_bw[self._tiers(cids)]

    # -- the Fleet method surface the engines/cost model consume ---------
    def has_failures(self) -> bool:
        return self.failure_fn is not None or self.failure_rate > 0.0

    def fails(self, cid: int, t: float, attempt: int = 0) -> bool:
        # exact Fleet.fails draw path: a virtual fleet and its
        # materialization answer identically at every (cid, t, attempt)
        if self.failure_fn is not None:
            return bool(self.failure_fn(int(cid), float(t), int(attempt)))
        if self.failure_rate <= 0.0:
            return False
        return hash01(self.failure_seed, int(cid), _time_bits(t),
                      int(attempt)) < self.failure_rate

    def is_active(self, cid: int, t: float) -> bool:
        return True

    def n_active(self, t: float) -> int:
        return self.n

    def comp_time(self, cid: int, flops: float) -> float:
        return float(flops) / (self.ref_flops_per_s * float(self.speed[cid]))

    def trans_time(self, cid: int, down_units: float,
                   up_units: float) -> float:
        return (float(down_units) / (self.ref_bytes_per_s
                                     * float(self.down_bw[cid]))
                + float(up_units) / (self.ref_bytes_per_s
                                     * float(self.up_bw[cid])))

    def est_round_time(self, cid: int, n_examples: float, passes: float,
                       flops_per_example: float, down_units: float,
                       up_units: float) -> float:
        return (self.comp_time(cid, flops_per_example * passes * n_examples)
                + self.trans_time(cid, down_units, up_units))

    def est_round_times(self, cids, n_examples, passes: float,
                        flops_per_example: float, down_units: float,
                        up_units: float) -> np.ndarray:
        """Bulk ``est_round_time`` over a cohort: one vectorized pass with
        the scalar method's exact op sequence (elementwise float64), so
        ``est_round_times(cids, ...)[i] == est_round_time(cids[i], ...)``
        to the bit."""
        cids = np.asarray(cids)
        n = np.asarray(n_examples, np.float64)
        flops = flops_per_example * passes * n
        comp = flops / (self.ref_flops_per_s * self.speeds(cids))
        bw = self.bws(cids)
        trans = (float(down_units) / (self.ref_bytes_per_s * bw)
                 + float(up_units) / (self.ref_bytes_per_s * bw))
        return comp + trans

    def is_homogeneous(self) -> bool:
        return (len(self.profile.classes) == 1
                and self.profile.speed_jitter == 0.0
                and self.profile.availability >= 1.0
                and self.profile.dropout <= 0.0)

    def materialize(self) -> Fleet:
        """The equivalent (K,)-array Fleet — same per-cid draws."""
        cids = np.arange(self.n)
        return Fleet(
            profile=self.profile,
            speed=self.speeds(cids),
            up_bw=self.bws(cids),
            down_bw=self.bws(cids),
            availability=np.full(self.n, self.profile.availability),
            dropout=np.full(self.n, self.profile.dropout),
            ref_flops_per_s=self.ref_flops_per_s,
            ref_bytes_per_s=self.ref_bytes_per_s,
            failure=(np.full(self.n, self.failure_rate)
                     if self.failure_rate > 0.0 else None),
            failure_seed=self.failure_seed,
            failure_fn=self.failure_fn)


def virtual_fleet(profile: "HeterogeneityProfile | str", n_clients: int,
                  *, seed: int = 0) -> VirtualFleet:
    """A VirtualFleet over a named or explicit profile (deterministic in
    seed; memory independent of ``n_clients``)."""
    if isinstance(profile, str):
        profile = get_profile(profile)
    return VirtualFleet(profile=profile, n=int(n_clients), seed=seed,
                        failure_rate=float(profile.failure),
                        failure_seed=seed)


def homogeneous_fleet(n_clients: int) -> Fleet:
    """The paper's setting: unit devices, always available, never dropping.
    The sync runtime over this fleet reproduces the legacy loop exactly."""
    return sample_fleet("homogeneous", n_clients, seed=0)


def get_profile(name: str) -> HeterogeneityProfile:
    try:
        return PROFILES[name]
    except KeyError:
        raise KeyError(f"unknown profile {name!r}; known: {sorted(PROFILES)}"
                       ) from None
