"""Where a federated LM training step's time goes on the card: one
``fl_train_step`` under ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \\
        [--arch gemma2-2b] [--layers N] [--batch 2] [--seq-len 4096] \\
        [--microbatches 1] [--dtype bfloat16]

Full width by default, params drawn on the card from a seed (f32 unless
``--dtype bfloat16``: then bf16 params, f32 momentum, as the reference's
production step), the
round batch drawn as ``launch/distributed_fl.py`` draws it (FedAvg weights
cycled over the slots), remat on.  One step runs first, unprofiled: it
warms up and gives the unprofiled wall.  Then one step runs under the
profiler.  Prints one JSON line: the step's wall time, the device's busy
time and idle share, its device activities, and the device time split into
matrix products (cuBLAS kernels), the port's LM kernels (the attention's
forward and backward, the scan's forward and backward), copies and the
rest (elementwise, reductions and the optimizer's update), with the top
kernels by device time and operators by host time.  Needs a GPU; raises
without one.
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.launch.profile_trial import (by_class, card_name,
                                              device_activity, kernel_class)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.device import resolve_device
    from repro_torch.launch.distributed_fl import round_batch
    from repro_torch.launch.serve import cut_layers
    from repro_torch.launch.steps import make_fl_train_step
    from repro_torch.models import stacked
    from repro_torch.tree import tree_map

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = cut_layers(cfg, args.layers)
    b, s = args.batch, args.seq_len
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    dtype = getattr(torch, args.dtype)
    params = stacked.init_params_stacked(cfg, gen, dtype)
    momentum = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), params)
    step, _ = make_fl_train_step(
        cfg, InputShape("profile", seq_len=s, global_batch=b, kind="train"),
        microbatches=args.microbatches, dtype=dtype)
    bgen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    def one_step():
        nonlocal params, momentum
        batch = round_batch(cfg, b, s, bgen, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, momentum, loss, _ = step(params, momentum, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, float(loss)

    warm_s, _ = one_step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_s, loss = one_step()
    act = device_activity(torch, prof)
    print(json.dumps(dict(
        phase="train_step", arch=cfg.name, layers=cfg.n_layers,
        dtype=args.dtype, batch=b,
        seq_len=s, microbatches=args.microbatches, remat=True, loss=loss,
        unprofiled_wall_s=warm_s, wall_s=wall_s,
        train_tok_per_s=b * s / wall_s, device_busy_s=act["busy_s"],
        device_idle_share=1.0 - act["busy_s"] / wall_s,
        activities=act["activities"],
        device_ms_by_class=by_class(act["by_name"], kernel_class),
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
        top_device=act["top_device"], top_host=act["top_host"],
        card=card_name())), flush=True)


if __name__ == "__main__":
    main()
