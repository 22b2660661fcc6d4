"""A federated LM round through ``fl_train_step`` (port of
``examples/distributed_fl.py``).

The reference runs its reduced architecture on a host mesh of 8 devices;
the port runs the same step on one device (the ``("data", "model")`` mesh
is ROADMAP.md item 15b).  By default it takes the example's shape:
``reduced(cfg, n_layers=4)``, 8 participant slots of one 64-token sequence
each with FedAvg weights [1, 2, 1, 4, 1, 2, 3, 2], lr 1e-2, on ``cuda``
(``--device cpu`` for the CPU).  ``--full-width`` takes the full config
(params drawn on the device from ``--seed``); ``--layers`` cuts depth
only, and ``--batch``/``--seq-len`` set the round batch (the weights cycle
over the slots).  ``--dtype`` sets the params' dtype: float32 by default,
as the reference example passes, or bfloat16 (the production steps' own).

  PYTHONPATH=src python -m repro_torch.launch.distributed_fl --arch gemma2-2b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.distributed_fl --arch gemma2-2b \\
      --full-width --batch 2 --seq-len 4096 --rounds 3 [--dtype bfloat16]
"""

from __future__ import annotations

import argparse
import time

import torch

WEIGHTS = (1.0, 2.0, 1.0, 4.0, 1.0, 2.0, 3.0, 2.0)


def round_batch(cfg, batch: int, seq_len: int, gen: torch.Generator,
                device) -> dict:
    """One round's batch drawn from ``gen``: tokens and labels uniform over
    the vocabulary, the FedAvg weights cycled over the slots, and the
    config's stub frontend input."""
    from repro_torch.launch.serve import frontend_input

    b = {
        "tokens": torch.randint(0, cfg.vocab_size, (batch, seq_len),
                                generator=gen, device=device),
        "labels": torch.randint(0, cfg.vocab_size, (batch, seq_len),
                                generator=gen, device=device),
        "weight": torch.tensor([WEIGHTS[i % len(WEIGHTS)]
                                for i in range(batch)], dtype=torch.float32,
                               device=device),
    }
    fe = frontend_input(cfg, batch, gen, device)
    if fe is not None:
        b["frontend"] = fe
    return b


def main(argv=None):
    from repro_torch.configs import ARCH_NAMES, get_config, reduced
    from repro_torch.configs.shapes import InputShape
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import cut_layers
    from repro_torch.launch.steps import make_fl_train_step
    from repro_torch.models import build_model, stacked
    from repro_torch.tree import leaves, tree_map

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="gemma2-2b")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--full-width", action="store_true",
                    help="the full config instead of reduced(cfg, 4)")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep only the first N layers (depth cut)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = reduced(cfg, n_layers=4)
    if args.layers is not None:
        cfg = cut_layers(cfg, args.layers)
    if dev.type == "cuda":          # set-up: nvcc runs here, not in a round
        from repro_torch.kernels import build
        build.library()
    shape = InputShape("mini_train", seq_len=args.seq_len,
                       global_batch=args.batch, kind="train")
    step, _ = make_fl_train_step(cfg, shape, lr=1e-2, dtype=dtype)
    params = stacked.stack_params(build_model(cfg).init(args.seed, dev), cfg)
    if dtype != torch.float32:
        params = tree_map(lambda x: x.to(dtype), params)
    momentum = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), params)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    print(f"arch={args.arch} ({'full width' if args.full_width else 'reduced'}"
          f", {cfg.n_layers} layers)  device={dev}  dtype={args.dtype}  "
          f"params={sum(p.numel() for p in leaves(params)):,}", flush=True)
    for r in range(args.rounds):
        batch = round_batch(cfg, args.batch, args.seq_len, gen, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, momentum, loss, metrics = step(params, momentum, batch)
        loss = float(loss)                      # waits for the step
        dt = time.perf_counter() - t0
        print(f"  round {r}: weighted FL loss={loss:.4f} "
              f"acc={float(metrics['acc']):.3f} step={dt:.3f}s "
              f"({args.batch * args.seq_len / dt:.1f} tok/s)", flush=True)
    if dev.type == "cuda":
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print("federated LM round executed (fl_train_step on one device)")


if __name__ == "__main__":
    main()
