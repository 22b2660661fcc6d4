"""Sweep application preferences (the paper's Fig. 7 trace view): shows how
FedTune steers (M, E) differently per training preference (counterpart of
``examples/preference_sweep.py``).

    PYTHONPATH=src python -m repro_torch.launch.preference_sweep [--device cpu]

Runs on ``--device`` (default ``cuda``; a machine without a GPU needs
``--device cpu``).
"""

from __future__ import annotations

import argparse

from repro_torch.configs.paper_models import MLPConfig
from repro_torch.core import CostModel, FedTune, FedTuneConfig, Preference
from repro_torch.core.tuner import HyperParams
from repro_torch.data import emnist_like
from repro_torch.device import resolve_device
from repro_torch.federated import FLConfig, FLServer, get_aggregator
from repro_torch.models import build_model
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.tree import leaves
from repro_torch.weights import params_from_numpy

PREFS = {
    "CompT-only (a=1)": Preference(1, 0, 0, 0),
    "TransT-only (b=1)": Preference(0, 1, 0, 0),
    "CompL-only (g=1)": Preference(0, 0, 1, 0),
    "TransL-only (d=1)": Preference(0, 0, 0, 1),
    "balanced": Preference(0.25, 0.25, 0.25, 0.25),
}


def main(argv=None, init_params=None):
    """Runs one FedTune trial per preference and returns ``{label:
    (FLResult, FedTune)}``.  ``init_params`` (a numpy tree) starts every
    run from those params (the port's seeded init without it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    dataset = emnist_like(reduced=True)
    model = build_model(MLPConfig(name="mlp", in_dim=784, hidden=(48,),
                                  n_classes=16))
    n_params = sum(p.numel() for p in leaves(model.init(0, device)))

    print(f"{'preference':22s} {'M trace':28s} {'E trace':28s} final")
    runs = {}
    for label, pref in PREFS.items():
        tuner = FedTune(FedTuneConfig(preference=pref), HyperParams(5, 2))
        server = FLServer(
            model, dataset, get_aggregator("fedavg"),
            get_optimizer("sgd", 0.03, momentum=0.9),
            CostModel(flops_per_example=2 * n_params, param_count=n_params),
            FLConfig(m=5, e=2, batch_size=10, target_accuracy=0.55,
                     max_rounds=80),
            tuner=tuner, device=device)
        res = server.run(None if init_params is None
                         else params_from_numpy(init_params, device))
        ms = [t["m_next"] for t in tuner.trace][:8]
        es = [t["e_next"] for t in tuner.trace][:8]
        print(f"{label:22s} {str(ms):28s} {str(es):28s} "
              f"M={res.final_m} E={res.final_e:g} acc={res.final_accuracy:.2f}")
        runs[label] = (res, tuner)
    return runs


if __name__ == "__main__":
    main()
