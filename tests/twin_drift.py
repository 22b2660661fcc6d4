#!/usr/bin/env python
"""How far the port drifts from the reference, beside how far the
reference drifts from itself when its params move by one ulp (CPU only).

A trial whose accuracy is not a continuous function of rounding
(ROADMAP.md departure 16) can leave 0.01 of the reference's accuracy on
the port for no fault of the port's.  This module tells the two apart.
``tests/test_torch_twins.py`` imports its helpers; run as a script it is
the whole study.  Every run starts from the port's own seeded init, as
``chip_smoke.py`` phase 16a does, drawn on the CPU; the twins start from
that init moved one ulp up and one ulp down.  A run records the global
params and the adaptive server's moments after every aggregation, and may
have them replaced after given aggregations (``inject``).

Comparisons, per round:

  * drift: the largest |param difference| of the port from the
    reference, both run whole from the same init; beside it the spread of
    the reference's two whole twins, and whether (M, E), the costs and
    the accuracies (to 0.01) agree;
  * fresh error: each round of the port run from the reference's own
    state after the round before (params and moments), against the
    reference's round; beside it the reference's response to that state
    with its params moved one ulp up and down.  A port round whose error
    stays within that response adds no more than the reference's own
    rounding does; drift beyond it is the reference's amplification;
  * swap: at the round where the drift over the spread peaks, the
    reference run from the port's state after the round before, against
    the port's round and the reference's.

With ``--random-twins K`` the reference also runs from K inits with each
value moved one ulp up or down at random (numpy seed 1), a wider sample
of its own spread.  At the round where the drift over the spread peaks
the study names the hidden units whose params moved by more than 1e-3
(the MLP's ``b0``, ``w0`` columns and ``w1`` rows).  Runs:

  * Table 6's reduced FedTune trials (``launch/paper_tables.build_sweep``:
    speech_command, preference 14, batch 10, 512 eval points), one per
    aggregator and seed, through each package's
    ``experiments.runner.build_server(spec).run(init)``;
  * with ``--preference-sweep``, ``examples/preference_sweep.py``'s
    TransL-only run (preference (0, 0, 0, 1), 80 rounds, seed 0) against
    ``launch/preference_sweep.py``'s, the example loaded by path and its
    ``FLServer.run`` handed the init.

Nothing in ``src/repro`` or ``examples/`` changes.  It imports both
packages, as the CPU tests do; the port itself imports neither.

Usage (from the repo root; a few minutes a run on one core):
  PYTHONPATH=src python tests/twin_drift.py --rounds 6 --seeds 0,1,2 \\
      --aggregators fedadam,fedyogi --preference-sweep --json runs/twin.json
  PYTHONPATH=src python tests/twin_drift.py --rounds 6 --seeds 0 \\
      --aggregators fedadam --random-twins 10
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.experiments import TrialSpec as JTrialSpec
from repro.experiments.runner import build_server as j_build_server
from repro_torch.experiments import runner
from repro_torch.launch import paper_tables
from repro_torch.weights import params_from_numpy, params_to_numpy

REPO = Path(__file__).resolve().parents[1]
ACC_LIMIT = 0.01
TWINS = ("up", "down")


def moved(tree, twin):
    """The numpy tree ``tree`` with every value moved one ulp (``twin`` is
    "up" or "down"), or as it is (None)."""
    if twin is None:
        return tree
    to = np.float32(np.inf if twin == "up" else -np.inf)
    return jax.tree.map(lambda x: np.nextafter(x, to), tree)


def random_twin(init, k):
    """``init`` with each value moved one ulp up or down at random (the
    k-th draw of numpy seed 1)."""
    rng = np.random.default_rng([1, k])

    def leaf(x):
        up = rng.integers(0, 2, x.shape).astype(bool)
        return np.where(up, np.nextafter(x, np.float32(np.inf)),
                        np.nextafter(x, np.float32(-np.inf))).astype(np.float32)
    return jax.tree.map(leaf, init)


def flat(tree) -> np.ndarray:
    """A numpy tree as one f32 vector, in ``jax.tree.flatten`` order (the
    port's leaf order is the reference's)."""
    return np.concatenate([np.ravel(x) for x in jax.tree.leaves(tree)]
                          ).astype(np.float32)


def max_diff(a, b) -> float:
    """The largest |difference| of two numpy trees."""
    return float(np.max(np.abs(flat(a) - flat(b))))


class Recorder:
    """Stands in for a server's aggregator: after every aggregation it
    records the global params and the adaptive server's moments (None for
    an aggregator without them) as numpy trees, and after aggregation k
    (1-based) in ``inject`` replaces them with ``inject[k]``."""

    def __init__(self, inner, package, inject=None):
        self.inner, self.package = inner, package
        self.inject = inject or {}
        self.states = []

    def _numpy(self, tree):
        if tree is None:
            return None
        if self.package == "ref":
            return jax.tree.map(np.asarray, tree)
        return params_to_numpy(tree)

    def _own(self, tree):
        if self.package == "ref":
            return jax.tree.map(jnp.asarray, tree)
        return params_from_numpy(tree, "cpu")

    def __call__(self, global_params, updates):
        out = self.inner(global_params, updates)
        self.states.append(tuple(self._numpy(t) for t in (
            out, getattr(self.inner, "_m", None),
            getattr(self.inner, "_v", None))))
        state = self.inject.get(len(self.states))
        if state is None:
            return out
        params, m, v = state
        if m is not None:
            self.inner._m, self.inner._v = self._own(m), self._own(v)
        return self._own(params)


def reset_to(states, twin=None):
    """An ``inject`` that hands a run the state after every round of
    ``states`` (the last round's aside), its params moved one ulp by
    ``twin``."""
    return {k + 1: (moved(p, twin), m, v)
            for k, (p, m, v) in enumerate(states[:-1])}


def trajectory(res, rec):
    """One run's records: (M, E), accuracy and the round's costs per
    round, the four cost totals, the state after every aggregation."""
    return dict(m_e=[(h.m, float(h.e)) for h in res.history],
                acc=[float(h.accuracy) for h in res.history],
                costs=[tuple(float(c) for c in h.cost.as_tuple())
                       for h in res.history],
                totals=tuple(float(c) for c in res.total_cost.as_tuple()),
                states=rec.states)


def run_trial(spec, init, package, inject=None):
    """Table 6's trial ``spec`` from the numpy tree ``init`` in one
    package: "ref" (JAX) or "port" (PyTorch on the CPU)."""
    if package == "ref":
        srv = j_build_server(JTrialSpec(**spec.to_dict()))
        params = jax.tree.map(jnp.asarray, init)
    else:
        srv = runner.build_server(spec, device="cpu")
        params = params_from_numpy(init, "cpu")
    rec = srv.aggregator = Recorder(srv.aggregator, package, inject)
    return trajectory(srv.run(params), rec)


def table6_spec(aggregator, seed, rounds):
    """Table 6's reduced FedTune trial of ``aggregator`` and ``seed``."""
    return next(s for s in paper_tables.build_sweep(6, "14", 3, rounds,
                                                    0.5).expand()
                if s.aggregator == aggregator and s.seed == seed
                and s.tuner == "fedtune")


def port_init(spec):
    """The port's seeded init of the trial's model, drawn on the CPU."""
    return params_to_numpy(runner._model_for(spec)[0].init(spec.seed, "cpu"))


def example(name):
    """``examples/<name>.py`` as a fresh module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TRANSL_ONLY = "TransL-only (d=1)"


def run_preference(init, package, rounds, inject=None):
    """The preference sweep's TransL-only run from ``init`` in one
    package, cut to ``rounds``: the example (its ``FLServer.run`` handed
    ``init``) or the port's launcher (its ``init_params`` hook)."""
    if package == "ref":
        mod = example("preference_sweep")
    else:
        from repro_torch.launch import preference_sweep as mod
    base_cls, cfg_cls = mod.FLServer, mod.FLConfig
    out = {}

    class Watched(base_cls):
        def run(self, params=None):
            rec = self.aggregator = Recorder(self.aggregator, package, inject)
            if package == "ref":
                params = jax.tree.map(jnp.asarray, init)
            res = super().run(params)
            out["run"] = trajectory(res, rec)
            return res

    def config(*a, **kw):
        return dataclasses.replace(cfg_cls(*a, **kw), max_rounds=rounds)

    saved = (mod.FLServer, mod.FLConfig, mod.PREFS)
    mod.FLServer, mod.FLConfig = Watched, config
    mod.PREFS = {TRANSL_ONLY: mod.PREFS[TRANSL_ONLY]}
    try:
        if package == "ref":
            mod.main()
        else:
            mod.main(["--device", "cpu"], init_params=init)
    finally:
        mod.FLServer, mod.FLConfig, mod.PREFS = saved
    return out["run"]


def compare(a, b):
    """Per round: the largest |param difference|, the accuracy gap, and
    whether the decisions and costs agree; the first round (1-based) whose
    accuracy gap exceeds ``ACC_LIMIT``."""
    n = min(len(a["states"]), len(b["states"]))
    dparam = [max_diff(a["states"][i][0], b["states"][i][0])
              for i in range(n)]
    dacc = [abs(x - y) for x, y in zip(a["acc"], b["acc"])]
    apart = next((i + 1 for i, d in enumerate(dacc) if d > ACC_LIMIT), None)
    return dict(max_dparam=dparam, acc_gap=dacc, first_apart=apart,
                same_m_e=a["m_e"] == b["m_e"],
                same_costs=a["costs"] == b["costs"]
                and a["totals"] == b["totals"])


def verdict(port_vs_ref, ref_twins):
    """The rule of departure 16: through the first round at which the
    port's accuracy leaves ``ACC_LIMIT`` of the reference's (every round
    if it never does), the port's largest |param difference| from the
    reference lies within the spread of the reference's own one-ulp twins
    (the larger of the two twins' at that round).  Returns
    (within, per-round ratio of the port's drift to that spread)."""
    upto = port_vs_ref["first_apart"] or len(port_vs_ref["max_dparam"])
    ratios = []
    for i in range(upto):
        spread = max(t["max_dparam"][i] for t in ref_twins)
        ratios.append(port_vs_ref["max_dparam"][i] / spread
                      if spread > 0 else (0.0 if port_vs_ref["max_dparam"][i]
                                          == 0 else float("inf")))
    return all(r <= 1.0 for r in ratios), ratios


def fresh_errors(ref, port_fresh, ref_fresh_twins):
    """Per round: the port's round from the reference's state against the
    reference's round, the larger of the reference's responses to that
    state moved one ulp up and down, and their ratio."""
    out = []
    for i in range(len(ref["states"])):
        err = max_diff(port_fresh["states"][i][0], ref["states"][i][0])
        resp = max(max_diff(t["states"][i][0], ref["states"][i][0])
                   for t in ref_fresh_twins)
        out.append((err, resp, err / resp if resp > 0 else float("inf")))
    return out


def hidden_units(init, diff, limit=1e-3):
    """The hidden units of the one-hidden-layer MLP whose params differ by
    more than ``limit`` (``diff`` flat, in the leaves' order b0, w0, b1,
    w1), with how many of each unit's params do."""
    b0, w0, b1, w1 = jax.tree.leaves(init)
    parts = np.split(np.abs(diff) > limit,
                     np.cumsum([b0.size, w0.size, b1.size]))
    hit = (parts[0].astype(int) + parts[1].reshape(w0.shape).sum(0)
           + parts[3].reshape(w1.shape).sum(1))
    return {int(u): int(hit[u]) for u in np.nonzero(hit)[0]}


def study(label, run, init, random_twins=0):
    """The runs of one case (``run(init, package, inject)``: the init, its
    two one-ulp twins, ``random_twins`` random ones in the reference, the
    runs reset to the reference's states, the swap) and their
    comparisons."""
    runs = {(pkg, tw): run(moved(init, tw), pkg, None)
            for pkg in ("ref", "port") for tw in (None,) + TWINS}
    rand = [run(random_twin(init, k), "ref", None)
            for k in range(random_twins)]
    ref, port = runs[("ref", None)], runs[("port", None)]
    fresh = fresh_errors(
        ref, run(init, "port", reset_to(ref["states"])),
        [run(moved(init, tw), "ref", reset_to(ref["states"], tw))
         for tw in TWINS])
    out = dict(case=label,
               port_vs_ref=compare(port, ref),
               ref_vs_twin={tw: compare(runs[("ref", tw)], ref)
                            for tw in TWINS},
               port_vs_twin={tw: compare(runs[("port", tw)], port)
                             for tw in TWINS},
               port_twin_vs_ref={tw: compare(runs[("port", tw)], ref)
                                 for tw in TWINS},
               ref_vs_random_twin=[compare(r, ref) for r in rand],
               fresh=fresh)
    within, ratios = verdict(out["port_vs_ref"],
                             list(out["ref_vs_twin"].values()))
    worst = int(np.argmax(ratios))
    out.update(within_ref_twin_spread=within, drift_over_spread=ratios,
               worst_round=worst + 1,
               units_moved_at_worst=hidden_units(
                   init, flat(port["states"][worst][0])
                   - flat(ref["states"][worst][0])),
               acc=dict(ref=ref["acc"], port=port["acc"]))
    if worst > 0:
        swap = run(init, "ref", {worst: port["states"][worst - 1]})
        out["swap"] = dict(
            round=worst + 1,
            vs_port=max_diff(swap["states"][worst][0],
                             port["states"][worst][0]),
            vs_ref=max_diff(swap["states"][worst][0],
                            ref["states"][worst][0]))
    return out


def show(rec):
    print(f"== {rec['case']}: port within the reference's twin spread "
          f"through its first 0.01 round: {rec['within_ref_twin_spread']}")
    rows = [("port vs ref", rec["port_vs_ref"])]
    rows += [(f"ref vs ref {tw}", rec["ref_vs_twin"][tw]) for tw in TWINS]
    rows += [(f"port vs port {tw}", rec["port_vs_twin"][tw]) for tw in TWINS]
    rows += [(f"port {tw} vs ref", rec["port_twin_vs_ref"][tw])
             for tw in TWINS]
    rows += [(f"ref rand {k} vs ref", c)
             for k, c in enumerate(rec["ref_vs_random_twin"])]
    for name, c in rows:
        print(f"  {name:18s} first 0.01 round {c['first_apart']}, (M, E) "
              f"{'equal' if c['same_m_e'] else 'DIFFER'}, costs "
              f"{'equal' if c['same_costs'] else 'DIFFER'}")
        print("    max |dparam| " + " ".join(f"{d:.3g}"
                                             for d in c["max_dparam"]))
        print("    acc gap      " + " ".join(f"{d:.5f}" for d in c["acc_gap"]))
    print("  drift / spread " + " ".join(f"{r:.3g}"
                                         for r in rec["drift_over_spread"]))
    print("  fresh error    " + " ".join(f"{e:.3g}" for e, _, _ in
                                         rec["fresh"]))
    print("  ref's response " + " ".join(f"{r:.3g}" for _, r, _ in
                                         rec["fresh"]))
    print("  ratio          " + " ".join(f"{q:.3g}" for _, _, q in
                                         rec["fresh"]))
    print(f"  at round {rec['worst_round']} the port moved hidden units "
          f"(unit: params > 1e-3) {rec['units_moved_at_worst']}")
    if "swap" in rec:
        s = rec["swap"]
        print(f"  the reference from the port's state after round "
              f"{s['round'] - 1}: round {s['round']} {s['vs_port']:.3g} from "
              f"the port's, {s['vs_ref']:.3g} from its own", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--aggregators", default="fedadam,fedyogi")
    ap.add_argument("--preference-sweep", action="store_true",
                    help="also the preference sweep's TransL-only run")
    ap.add_argument("--sweep-rounds", type=int, default=80)
    ap.add_argument("--random-twins", type=int, default=0,
                    help="reference runs from inits moved one ulp at random")
    ap.add_argument("--json", default=None, help="write the records here")
    args = ap.parse_args(argv)
    torch.set_num_threads(int(os.environ.get("TWIN_THREADS", "1")))

    records = []
    for agg in filter(None, args.aggregators.split(",")):
        for seed in (int(s) for s in args.seeds.split(",")):
            spec = table6_spec(agg, seed, args.rounds)
            rec = study(f"table 6 {agg} seed {seed}",
                        lambda p0, pkg, inj: run_trial(spec, p0, pkg, inj),
                        port_init(spec), args.random_twins)
            show(rec)
            records.append(rec)
    if args.preference_sweep:
        from repro_torch.configs.paper_models import MLPConfig
        from repro_torch.models import build_model
        init = params_to_numpy(build_model(MLPConfig(
            name="mlp", in_dim=784, hidden=(48,), n_classes=16)).init(0, "cpu"))
        rec = study("preference_sweep TransL-only seed 0",
                    lambda p0, pkg, inj: run_preference(
                        p0, pkg, args.sweep_rounds, inj), init,
                    args.random_twins)
        show(rec)
        records.append(rec)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(records, indent=1))
    return records


if __name__ == "__main__":
    main()
