"""Sweep orchestration: whole populations of FL trials as one workload
(counterpart of ``repro.experiments``).

``grid``   — TrialSpec/SweepSpec product grids with eager validation
             (axes: preference x aggregator x dataset x seed x (M0,E0)
             x tuner x runtime mode x fleet profile x compression).
``runner`` — sequential and vectorized (trials-as-an-axis) execution:
             sync trials pack per virtual round, async/buffered trials
             pack off a merged multi-trial event queue.
``store``  — append-only JSONL results, resume keys, paper-style tables.
``scheduler`` — the continuous-batching trial-serving daemon: a lane pool
             over the sweep engines, admitting queued trials as lanes free.
``snapshot`` — crash-safe scheduler snapshots and restore.
"""

from repro_torch.experiments.grid import (CANONICAL_PREFERENCE,  # noqa: F401
                                          SweepSpec, TrialSpec,
                                          parse_preferences, spec_from_dict)
from repro_torch.experiments.runner import (TrialResult,  # noqa: F401
                                            build_server, run_sweep,
                                            run_trial, run_vectorized,
                                            run_vectorized_events)
from repro_torch.experiments.scheduler import (LanePool,  # noqa: F401
                                               ServeStats, TrialQueue,
                                               TrialScheduler, serve)
from repro_torch.experiments.store import (ResultStore,  # noqa: F401
                                           aggregate_over_seeds,
                                           improvement_pct,
                                           pair_with_baselines, paper_table)
