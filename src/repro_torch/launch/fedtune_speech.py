"""The paper's headline experiment (counterpart of
``examples/fedtune_speech.py``): ResNet-10 on the speech-command-like
federation, the fixed (M=5, E=2) run against FedTune started from (5, 2),
on the device named by ``--device`` (default ``cuda``; a machine without a
GPU needs ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.launch.fedtune_speech \\
        [--full] [--rounds N] [--target A] [--device cpu]

Without ``--full`` the dataset is the reduced one (128 clients, 16x16, 10
classes); with it, the full federation (2,112 clients, 32x32x1, 35
classes).  ResNet-10 is sized from the dataset.  FedAvg, SGD lr 0.05
momentum 0.9, batch 5, preference (0.25, 0.25, 0.25, 0.25).
"""

from __future__ import annotations

import argparse


def run(tuner, label, args, model, dataset, device):
    from repro_torch.core import CostModel
    from repro_torch.federated import FLConfig, FLServer, get_aggregator
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.tree import leaves

    n_params = sum(p.numel() for p in leaves(model.init(0, device)))
    server = FLServer(
        model, dataset, get_aggregator("fedavg"),
        get_optimizer("sgd", 0.05, momentum=0.9),
        CostModel(flops_per_example=model.flops_per_example,
                  param_count=n_params),
        FLConfig(m=5, e=2, batch_size=5, target_accuracy=args.target,
                 max_rounds=args.rounds, log_every=args.rounds // 10 or 1),
        tuner=tuner, device=device)
    print(f"\n=== {label} ===")
    res = server.run()
    c = res.total_cost
    print(f"{label}: rounds={res.rounds} acc={res.final_accuracy:.3f} "
          f"M={res.final_m} E={res.final_e:g}")
    print(f"  CompT={c.comp_t:.3g} TransT={c.trans_t:.3g} "
          f"CompL={c.comp_l:.3g} TransL={c.trans_l:.3g}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="full-scale dataset (2112 clients, 35 classes)")
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--target", type=float, default=0.5)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs.paper_models import ResNetConfig
    from repro_torch.core import FedTune, FedTuneConfig, Preference
    from repro_torch.core.tuner import HyperParams
    from repro_torch.data import speech_command_like
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model

    device = resolve_device(args.device)
    dataset = speech_command_like(reduced=not args.full)
    cfg = ResNetConfig(
        name="resnet10", stage_blocks=(1, 1, 1, 1), width=8,
        n_classes=dataset.spec.n_classes,
        in_channels=dataset.spec.shape[-1],
        image_size=dataset.spec.shape[0])
    model = build_model(cfg)
    pref = Preference(0.25, 0.25, 0.25, 0.25)

    fixed = run(None, "fixed (M=5, E=2)", args, model, dataset, device)
    tuner = FedTune(FedTuneConfig(preference=pref), HyperParams(5, 2))
    tuned = run(tuner, "FedTune", args, model, dataset, device)

    gain = -100.0 * tuned.total_cost.weighted_relative_to(
        fixed.total_cost, pref)
    print(f"\nFedTune weighted-overhead gain vs fixed: {gain:+.2f}% "
          f"(paper reports +22.48% avg at full scale)")
    return fixed, tuned, gain


if __name__ == "__main__":
    main()
