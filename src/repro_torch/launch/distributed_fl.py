"""A federated LM round through ``fl_train_step`` (port of
``examples/distributed_fl.py``).

The reference runs its reduced architecture on a ``("data", "model")`` host
mesh of 4 x 2 devices.  Under ``torchrun --nproc-per-node D*M`` the port
runs the same step on a ``DeviceMesh`` of the ranks (``--mesh DxM``,
default 4x2, the example's): params and momentum DTensors placed by
``param_shardings``, the batch split over "data", the kernels on each
rank's shards, rank 0 alone printing.  One process without ``--mesh``
runs the step on one device (``--mesh 1x1`` takes a mesh of that one
rank).  Ranks get ``nccl`` when each has a card of its own, ``gloo`` on
the CPU (``launch/mesh.py``).  By default it takes the example's shape:
``reduced(cfg, n_layers=4)``, 8 participant slots of one 64-token sequence
each with FedAvg weights [1, 2, 1, 4, 1, 2, 3, 2], lr 1e-2, on ``cuda``
(``--device cpu`` for the CPU).  ``--full-width`` takes the full config
(params drawn on the device from ``--seed``); ``--layers`` cuts depth
only, and ``--batch``/``--seq-len`` set the round batch (the weights cycle
over the slots).  ``--dtype`` sets the params' dtype: float32 by default,
as the reference example passes, or bfloat16 (the production steps' own).
``--inputs FILE.npz`` starts from given params and round batches instead
of drawing them (``p0``, ``p1``, ... the stacked params' leaves in
``tree.leaves`` order; ``r{round}_{name}`` each round's batch field), e.g.
saved from the reference's run, so the losses are comparable.

  PYTHONPATH=src python -m repro_torch.launch.distributed_fl --arch gemma2-2b --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.distributed_fl \
      --arch gemma2-2b --mesh 4x2 --device cpu
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


def _mesh_shape(text: str):
    try:
        d, m = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh wants DxM (e.g. 4x2), got {text!r}")
    return d, m


def _open_mesh(text, dev):
    """(the run's ``("data", "model")`` mesh, its device, whether this run
    joined the group): over the group ``torchrun`` describes or one that is
    already up (``--mesh``, default 4x2), or over a group of this one
    process for ``--mesh 1x1``; no mesh for a one-device run."""
    import os
    import tempfile

    from repro_torch.launch import mesh as mesh_mod
    cm = mesh_mod.init_from_env(dev)
    joined = cm is not None
    if cm is None and mesh_mod.initialized():
        cm = mesh_mod.make_clients_mesh()
    if cm is None and text is None:
        return None, dev, False
    d, m = _mesh_shape(text or "4x2")
    if cm is None:
        joined = True
        if d * m != 1:
            raise SystemExit(f"--mesh {text} needs {d * m} ranks: run "
                             f"torchrun --nproc-per-node {d * m} -m "
                             "repro_torch.launch.distributed_fl ...")
        init = os.path.join(tempfile.mkdtemp(), "rendezvous")
        cm = mesh_mod.join(0, 1, device=dev, init_method=f"file://{init}")
    if cm.size != d * m:
        raise SystemExit(f"--mesh {d}x{m} needs {d * m} ranks; the group "
                         f"has {cm.size}")
    return mesh_mod.make_mesh((d, m), ("data", "model"), cm.device), \
        cm.device, joined


def _inputs(path, params_template, rounds: int):
    """(params, [batch per round]) from ``--inputs``."""
    import numpy as np

    from repro_torch.tree import leaves, unflatten_like
    from repro_torch.weights import params_from_numpy
    data = np.load(path)
    n = len(leaves(params_template))
    params = params_from_numpy(
        unflatten_like(params_template, [data[f"p{i}"] for i in range(n)]),
        leaves(params_template)[0].device, template=params_template)
    batches = []
    for r in range(rounds):
        pre = f"r{r}_"
        batches.append({k[len(pre):]: torch.from_numpy(np.array(data[k]))
                        for k in data.files if k.startswith(pre)})
    return params, batches


def main(argv=None):
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.device import resolve_device
    from repro_torch.launch import mesh as mesh_mod

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
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="a (data, model) mesh over the torchrun ranks "
                         "(default 4x2 under torchrun; 1x1 in one process)")
    ap.add_argument("--inputs", default=None, metavar="NPZ",
                    help="start from these params and round batches")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh, dev, joined = _open_mesh(args.mesh, dev)
    try:
        _run(args, dev, mesh, mesh_mod.is_writer())
    finally:
        if joined:
            mesh_mod.leave()


def _run(args, dev, mesh, writer):
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.serve import cut_layers
    from repro_torch.launch.steps import make_fl_train_step
    from repro_torch.models import build_model, stacked
    from repro_torch.tree import leaves, tree_map

    say = print if writer else (lambda *a, **k: None)
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
    step, _ = make_fl_train_step(cfg, shape, mesh=mesh, lr=1e-2,
                                 dtype=dtype)
    params = stacked.stack_params(build_model(cfg).init(args.seed, dev), cfg)
    batches = None
    if args.inputs is not None:
        params, batches = _inputs(args.inputs, params, args.rounds)
    if dtype != torch.float32:
        params = tree_map(lambda x: x.to(dtype), params)
    momentum = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), params)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    where = "one device" if mesh is None else \
        f"mesh {'x'.join(str(n) for n in mesh.mesh.shape)}"
    say(f"arch={args.arch} ({'full width' if args.full_width else 'reduced'}"
        f", {cfg.n_layers} layers)  device={dev}  {where}  "
        f"dtype={args.dtype}  "
        f"params={sum(p.numel() for p in leaves(params)):,}", flush=True)
    for r in range(args.rounds):
        batch = round_batch(cfg, args.batch, args.seq_len, gen, dev) \
            if batches is None else {k: v.to(dev)
                                     for k, v in batches[r].items()}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, momentum, loss, metrics = step(params, momentum, batch)
        loss = float(loss)                      # waits for the step
        dt = time.perf_counter() - t0
        say(f"  round {r}: weighted FL loss={loss:.6f} "
            f"acc={float(metrics['acc']):.3f} step={dt:.3f}s "
            f"({args.batch * args.seq_len / dt:.1f} tok/s)", flush=True)
    if dev.type == "cuda":
        say(f"peak device memory: "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    say(f"federated LM round executed (fl_train_step on {where})")


if __name__ == "__main__":
    main()
