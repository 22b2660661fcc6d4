"""FedTune (paper Algorithm 1): online, single-trial tuning of (M, E).

Decision cycle (activated whenever test accuracy improved by >= eps since
the last decision):
  1. Normalize the overheads accumulated since the last decision by the
     accuracy gain (cost per unit of accuracy).
  2. Compare against the previous decision window via eq. (6); a positive
     I() means the last move was bad.
  3. Update slope estimates: eta_* (w.r.t. M) for the overheads that favor
     the direction of the last M move, zeta_* (w.r.t. E) likewise; on a bad
     move, multiply the *opposing* slopes by the penalty factor D.
  4. Form Delta-M (eq. 10) / Delta-E (eq. 11) with Table 3's signs:
       M: CompT +, TransT +, CompL -, TransL -
       E: CompT -, TransT +, CompL -, TransL +
  5. Step M and E by +/-1 according to the signs (or by an adaptive step —
     a beyond-paper option addressing the paper's noted limitation).

The controller is O(tens of multiplications) per decision: negligible next
to a training round, exactly as the paper claims.

Copy of ``repro.core.fedtune``; the port imports nothing of ``repro``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.costs import SystemCost
from repro_torch.core.preferences import Preference
from repro_torch.core.tuner import HyperParams, Tuner

_EPS = 1e-12

# Table 3 signs: does overhead i improve with larger M / larger E?
_M_SIGNS = (+1.0, +1.0, -1.0, -1.0)   # CompT, TransT, CompL, TransL
_E_SIGNS = (-1.0, +1.0, -1.0, +1.0)
# indices of overheads that *favor* larger M (resp. smaller M)
_M_UP_FAVORS = (0, 1)
_M_DOWN_FAVORS = (2, 3)
_E_UP_FAVORS = (1, 3)
_E_DOWN_FAVORS = (0, 2)


@dataclass
class FedTuneConfig:
    preference: Preference
    eps: float = 0.01          # min accuracy improvement to trigger a decision
    penalty: float = 10.0      # D
    m_max: int = 100
    e_max: float = 100.0
    adaptive_step: bool = False   # beyond-paper: step size from |Delta|
    adaptive_max_step: int = 4


@dataclass
class _Window:
    """Normalized overheads of one decision window."""
    values: List[float]   # [t, q, z, v] normalized by accuracy gain


class FedTune(Tuner):
    def __init__(self, config: FedTuneConfig, initial: HyperParams):
        self.cfg = config
        self.current = HyperParams(initial.m, initial.e)
        self.prev_hp: Optional[HyperParams] = None
        self._last_acc = 0.0
        self._acc_at_last_decision = 0.0
        self._window_cost = SystemCost()
        self._prv: Optional[_Window] = None
        self._prvprv: Optional[_Window] = None
        self.eta = [1.0, 1.0, 1.0, 1.0]
        self.zeta = [1.0, 1.0, 1.0, 1.0]
        self.decisions = 0
        self.trace: List[dict] = []

    # ------------------------------------------------------------------
    def on_round(self, round_idx: int, accuracy: float,
                 round_cost: SystemCost, total_cost: SystemCost,
                 current: HyperParams) -> HyperParams:
        """Accumulate this round's overheads; trigger a decision once test
        accuracy has improved by **at least** eps since the last decision
        (gain >= eps, inclusive — the paper's activation convention)."""
        self.current = current
        for name in ("comp_t", "trans_t", "comp_l", "trans_l"):
            setattr(self._window_cost, name,
                    getattr(self._window_cost, name) + getattr(round_cost, name))
        gain = accuracy - self._acc_at_last_decision
        if gain < self.cfg.eps:
            return current
        return self._decide(accuracy, gain)

    # ------------------------------------------------------------------
    def _decide(self, accuracy: float, gain: float) -> HyperParams:
        cur = _Window(values=[v / gain for v in self._window_cost.as_tuple()])
        hp = self.current
        if self._prv is not None:
            bad = self._comparison(self._prv, cur) > 0.0
            self._update_slopes(cur, bad)
            dm = self._delta(cur, self.eta, _M_SIGNS)
            de = self._delta(cur, self.zeta, _E_SIGNS)
            step_m = self._step(dm)
            step_e = self._step(de)
            nxt = HyperParams(m=hp.m + step_m, e=hp.e + step_e).clamped(
                self.cfg.m_max, self.cfg.e_max)
        else:
            # First decision: no history — probe by increasing M
            # (both CompT and TransT favor it initially).
            bad = False
            dm = de = 0.0
            nxt = HyperParams(m=hp.m + 1, e=hp.e).clamped(
                self.cfg.m_max, self.cfg.e_max)
        self.trace.append({
            "decision": self.decisions, "acc": accuracy,
            "m": hp.m, "e": hp.e, "m_next": nxt.m, "e_next": nxt.e,
            "bad": bad, "dm": dm, "de": de,
            "window": tuple(cur.values),
        })
        self.decisions += 1
        self.prev_hp = hp
        self._prvprv = self._prv
        self._prv = cur
        self._acc_at_last_decision = accuracy
        self._window_cost = SystemCost()
        return nxt

    # ------------------------------------------------------------------
    def _comparison(self, prv: _Window, cur: _Window) -> float:
        """Paper eq. (6): I(S_prv, S_cur); positive => cur is worse."""
        w = self.cfg.preference.as_tuple()
        total = 0.0
        for i in range(4):
            if w[i] == 0.0:
                continue
            total += w[i] * (cur.values[i] - prv.values[i]) / max(
                prv.values[i], _EPS)
        return total

    def _update_slopes(self, cur: _Window, bad: bool):
        """Slope estimates eta_i = |x_cur - x_prv| / |x_prv - x_prvprv| for
        the overheads that favor the direction of the last move; penalty on
        the opposing ones when the move was bad (lines 16-25)."""
        hp, prev_hp = self.current, self.prev_hp
        prv, prvprv = self._prv, self._prvprv

        def slope(i: float) -> float:
            num = abs(cur.values[i] - prv.values[i])
            if prvprv is None:
                return 1.0
            den = abs(prv.values[i] - prvprv.values[i])
            return num / max(den, _EPS)

        if prev_hp is None or hp.m != prev_hp.m:
            up = prev_hp is None or hp.m > prev_hp.m
            favored = _M_UP_FAVORS if up else _M_DOWN_FAVORS
            opposing = _M_DOWN_FAVORS if up else _M_UP_FAVORS
            for i in favored:
                self.eta[i] = slope(i)
            if bad:
                for i in opposing:
                    self.eta[i] *= self.cfg.penalty
        if prev_hp is None or hp.e != prev_hp.e:
            up = prev_hp is None or hp.e > prev_hp.e
            favored = _E_UP_FAVORS if up else _E_DOWN_FAVORS
            opposing = _E_DOWN_FAVORS if up else _E_UP_FAVORS
            for i in favored:
                self.zeta[i] = slope(i)
            if bad:
                for i in opposing:
                    self.zeta[i] *= self.cfg.penalty

    def _delta(self, cur: _Window, slopes: List[float], signs) -> float:
        """Eqs. (10)/(11)."""
        w = self.cfg.preference.as_tuple()
        prv = self._prv
        total = 0.0
        for i in range(4):
            if w[i] == 0.0:
                continue
            diff = abs(cur.values[i] - prv.values[i])
            total += signs[i] * w[i] * slopes[i] * diff / max(
                cur.values[i], _EPS)
        return total

    def _step(self, delta: float) -> int:
        """Step direction from Delta (eqs. 10/11).  Delta == 0 — every
        weighted term cancelled, or no active preference weight saw any
        change — is no evidence in either direction, so the hyper-parameter
        HOLDS (step 0) rather than taking a spurious down-step."""
        if delta == 0.0:
            return 0
        base = 1 if delta > 0 else -1
        if not self.cfg.adaptive_step:
            return base
        # beyond-paper: scale the step with the relative magnitude of Delta
        mag = min(self.cfg.adaptive_max_step, max(1, int(abs(delta) * 10)))
        return base * mag
