"""Which collectives gloo carries for CUDA tensors of two ranks sharing one
card: each collective runs in a fresh pair of processes
(``launch.mesh.run_ranks``), so a collective that kills its rank is
reported and the next one still runs.

The plain ``torch.distributed`` collectives on a (4, 8) tensor, and
DTensor's own redistributions of an (8, 8) tensor on a ``(1, 2)``
``("data", "model")`` mesh: ``Shard`` -> ``Replicate`` (all-gather),
``Partial`` -> ``Shard`` (reduce-scatter), ``Partial`` -> ``Replicate``
(all-reduce), ``Shard(0)`` -> ``Shard(1)`` (all-to-all).  Then the two
halves of DTensor's all-gather apart: the plain all-gather on the mesh
dim's own group, and the functional collective that DTensor issues
(``all_gather_tensor``) on that group.  Each line says ``ok`` with rank
0's and rank 1's checksum, or the failure.

    python -m repro_torch.launch.gloo_probe
"""

from __future__ import annotations

import sys
import tempfile

OPS = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
       "all_to_all_single", "all_gather", "broadcast", "dt_all_gather",
       "dt_reduce_scatter", "dt_all_reduce", "dt_all_to_all",
       "mesh_group_all_gather_into_tensor", "funcol_all_gather_tensor")


def one_op(cm, op: str) -> float:
    """Run collective ``op`` on this rank; its result's sum."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.launch.mesh import make_mesh
    dev, r, w = cm.device, dist.get_rank(), dist.get_world_size()
    x = torch.full((4, 8), float(r + 1), device=dev)
    if op == "all_gather_into_tensor":
        out = torch.empty((4 * w, 8), device=dev)
        dist.all_gather_into_tensor(out, x)
        return float(out.sum())
    if op == "reduce_scatter_tensor":
        out = torch.empty((4 // w, 8), device=dev)
        dist.reduce_scatter_tensor(out, x)
        return float(out.sum())
    if op == "all_reduce":
        dist.all_reduce(x)
        return float(x.sum())
    if op == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return float(out.sum())
    if op == "all_gather":
        outs = [torch.empty_like(x) for _ in range(w)]
        dist.all_gather(outs, x)
        return float(sum(t.sum() for t in outs))
    if op == "broadcast":
        dist.broadcast(x, 0)
        return float(x.sum())
    mesh = make_mesh((1, w), ("data", "model"), dev)
    full = torch.arange(64.0, device=dev).reshape(8, 8)
    rep, rows = [Replicate(), Replicate()], [Replicate(), Shard(0)]
    if op == "dt_all_gather":
        d = distribute_tensor(full, mesh, rows, src_data_rank=None)
        return float(d.redistribute(mesh, rep).to_local().sum())
    if op == "dt_reduce_scatter":
        d = DTensor.from_local(full.clone(), mesh, [Replicate(), Partial()])
        return float(d.redistribute(mesh, rows).to_local().sum())
    if op == "dt_all_reduce":
        d = DTensor.from_local(full.clone(), mesh, [Replicate(), Partial()])
        return float(d.redistribute(mesh, rep).to_local().sum())
    group = mesh.get_group("model")
    if op == "mesh_group_all_gather_into_tensor":
        out = torch.empty((4 * w, 8), device=dev)
        dist.all_gather_into_tensor(out, x, group=group)
        return float(out.sum())
    if op == "funcol_all_gather_tensor":
        import torch.distributed._functional_collectives as funcol
        return float(funcol.all_gather_tensor(x, 0, group).sum())
    if op == "dt_all_to_all":
        d = distribute_tensor(full, mesh, rows, src_data_rank=None)
        return float(d.redistribute(mesh, [Replicate(), Shard(1)])
                     .to_local().sum())
    raise ValueError(f"unknown collective {op!r}")


def main() -> int:
    import torch

    from repro_torch.launch.gloo_probe import one_op as fn  # by import path
    from repro_torch.launch.mesh import run_ranks
    if not torch.cuda.is_available():
        print("gloo_probe: no CUDA device", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    tmp = tempfile.mkdtemp()
    for op in OPS:
        try:
            sums = run_ranks(fn, 2, device="cuda",
                             init_file=f"{tmp}/{op}", args=(op,),
                             threads=None, timeout_s=120)
            print(f"{op}: ok {sums}", flush=True)
        except (RuntimeError, TimeoutError) as e:
            print(f"{op}: FAILED {str(e).splitlines()[0]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
