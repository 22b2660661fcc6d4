"""Quickstart: federated training with FedTune (counterpart of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

Trains a small MLP on the synthetic EMNIST-like federated dataset with
FedAvg, letting FedTune adjust (M, E) for a computation-load-sensitive
application (gamma = 1), on ``--device`` (default ``cuda``; a machine
without a GPU needs ``--device cpu``).
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


def main(argv=None, init_params=None):
    """Runs the example and returns its ``FLResult``.  ``init_params`` (a
    numpy tree) starts the run from those params (the port's seeded init
    without it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    dataset = emnist_like(reduced=True)
    model = build_model(MLPConfig(name="mlp", in_dim=784, hidden=(48,),
                                  n_classes=16))
    n_params = sum(p.numel() for p in leaves(model.init(0, device)))

    preference = Preference(0.0, 0.0, 1.0, 0.0)   # CompL-sensitive app
    tuner = FedTune(FedTuneConfig(preference=preference),
                    HyperParams(m=5, e=2))
    server = FLServer(
        model, dataset,
        aggregator=get_aggregator("fedavg"),
        optimizer=get_optimizer("sgd", 0.03, momentum=0.9),
        cost_model=CostModel(flops_per_example=2 * n_params,
                             param_count=n_params),
        config=FLConfig(m=5, e=2, batch_size=10, target_accuracy=0.5,
                        max_rounds=80, log_every=10),
        tuner=tuner, device=device)
    result = server.run(None if init_params is None
                        else params_from_numpy(init_params, device))

    c = result.total_cost
    print(f"\nreached={result.reached_target} rounds={result.rounds} "
          f"acc={result.final_accuracy:.3f}")
    print(f"final hyper-parameters: M={result.final_m} E={result.final_e:g} "
          f"({tuner.decisions} FedTune decisions)")
    print(f"CompT={c.comp_t:.3g}  TransT={c.trans_t:.3g}  "
          f"CompL={c.comp_l:.3g}  TransL={c.trans_l:.3g}")
    return result


if __name__ == "__main__":
    main()
