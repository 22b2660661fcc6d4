"""The ``clients`` mesh over ``torch.distributed`` ranks (counterpart of
``repro.launch.mesh.make_clients_mesh``).

JAX drives every device from one process through ``shard_map``.  Here each
device is driven by a rank of its own process, and every rank runs the
whole host side: FedTune, the virtual clock, the selector, the numpy rng
that draws the batch streams, and the evaluation.  The ranks stay in
lockstep only if each one gets bitwise the same aggregate and the same
accuracies every round; one differing bit would change FedTune's (M, E) on
one rank and the collectives would no longer match.  So the sum across
ranks is not an ``all_reduce``, whose bits depend on the backend and the
topology: the partials are all-gathered and folded in rank order, in their
own dtype, on every rank (``fold``).

Backends (``pick_backend``): ``nccl`` when every rank has a CUDA device of
its own; ``gloo`` when ranks share a card (NCCL refuses two ranks of one
communicator on one device) or run on the CPU.  Over gloo a CUDA tensor is
staged through the host for each collective.  Rank r of a CUDA run takes
``cuda:{LOCAL_RANK % device_count}``.

  ``init_from_env``      joins the group that ``torchrun --nproc-per-node
                         D`` describes (RANK, WORLD_SIZE, LOCAL_RANK).
  ``run_ranks``          spawns D ranks in fresh processes (``spawn``, a
                         ``FileStore`` rendezvous) and returns each rank's
                         result: the torch counterpart of
                         ``XLA_FLAGS=--xla_force_host_platform_device_count=N``
                         for the tests and ``chip_smoke.py``.
  ``make_clients_mesh``  the ``ClientsMesh`` of a group (the default
                         process group; with none, a mesh of one rank that
                         gathers nothing).

The LM steps' meshes are ``DeviceMesh``es over the same group, counterparts
of ``jax.make_mesh``: ``make_mesh(shape, axes)``, ``make_production_mesh``
(``("data", "model")`` 16 x 16, or ``("pod", "data", "model")`` 2 x 16 x 16)
and ``make_host_mesh`` (1 x world); ``axis_size`` reads an axis as the
reference reads ``mesh.shape[name]``.  Their collectives are DTensor's
(``repro_torch.sharding``), not ``fold``'s rank-order sums.
"""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

_rank_device: Optional[torch.device] = None   # chosen when this rank joined
COLLECTIVE_TIMEOUT_S = 1800.0    # a collective that waits longer raises


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the default process group (1 when there is none)."""
    return dist.get_world_size() if initialized() else 1


def is_writer() -> bool:
    """True on the rank that prints and writes files: rank 0, or the only
    process when there is no process group."""
    return not initialized() or dist.get_rank() == 0


def pick_backend(device, world_size: int,
                 n_cuda: Optional[int] = None) -> str:
    """``nccl`` when every rank has a CUDA device of its own, else
    ``gloo`` (ranks sharing a card, or on the CPU)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    n = torch.cuda.device_count() if n_cuda is None else n_cuda
    return "nccl" if n >= world_size else "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """The device of the rank with ``local_rank`` on this host: the CPU,
    or ``cuda:{local_rank % device_count}``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def fold(parts: torch.Tensor) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` left to right, in ``parts``' dtype:
    the rank-order sum of gathered partials, one add per rank (nothing to
    contract into an FMA), so every rank that folds the same gather gets
    the same bits."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


@dataclass(frozen=True)
class ClientsMesh:
    """A 1-D ``clients`` axis over the ranks of ``group``: rank r owns the
    contiguous block ``[r*M/D, (r+1)*M/D)`` of an M-slot cohort axis, as
    ``clients_spec`` lays it over ``shard_map``'s devices."""
    group: Any                  # process group; None for a single rank
    rank: int
    size: int
    backend: Optional[str]      # nccl | gloo | None (single rank)
    device: torch.device        # this rank's device
    axis_names = ("clients",)

    def block(self, m: int) -> slice:
        """This rank's slots of an axis of ``m`` (a multiple of size)."""
        if m % self.size:
            raise ValueError(f"{m} slots do not split over {self.size} ranks")
        k = m // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape) on ``x``'s device: every rank's ``x``, in rank
        order (a group of one rank still runs the collective)."""
        if self.group is None:
            return x[None]
        if self.backend == "nccl":
            out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype,
                              device=x.device)
            dist.all_gather_into_tensor(out, x.contiguous(),
                                        group=self.group)
            return out
        host = x.detach().to("cpu").contiguous()
        parts = [torch.empty_like(host) for _ in range(self.size)]
        dist.all_gather(parts, host, group=self.group)
        return torch.stack(parts).to(x.device)

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(
            box, src=dist.get_global_rank(self.group, 0), group=self.group,
            device=self.device if self.backend == "nccl" else None)
        return box[0]

    def barrier(self):
        if self.group is not None:
            if self.backend == "nccl":
                dist.barrier(group=self.group, device_ids=[self.device.index])
            else:
                dist.barrier(group=self.group)


def make_clients_mesh(group=None) -> ClientsMesh:
    """The ``clients`` mesh over ``group`` (default: the default process
    group) on the device this rank joined with.  Without a process group
    it is a mesh of one rank on the CPU."""
    if not initialized():
        return ClientsMesh(None, 0, 1, None, torch.device("cpu"))
    g = group if group is not None else dist.group.WORLD
    backend = str(dist.get_backend(g))
    if _rank_device is not None:
        dev = _rank_device
    elif backend == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    return ClientsMesh(g, dist.get_rank(g), dist.get_world_size(g), backend,
                       dev)


def join(rank: int, world_size: int, *, device, init_method: str,
         local_rank: Optional[int] = None) -> ClientsMesh:
    """Join a process group as ``rank`` of ``world_size`` on this rank's
    device (see ``rank_device``), over the backend ``pick_backend``
    chooses, and return its ``clients`` mesh."""
    global _rank_device
    dev = rank_device(device, rank if local_rank is None else local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(pick_backend(dev, world_size),
                            init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    _rank_device = dev
    return make_clients_mesh()


def init_from_env(device="cuda") -> Optional[ClientsMesh]:
    """Join the group ``torchrun`` describes in the environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return its mesh;
    the caller then owns the group (``leave``).  None, joining nothing,
    when the environment describes no more than one rank or a group is
    already up."""
    if initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    rank = int(os.environ.get("RANK", "0"))
    return join(rank, int(os.environ.get("WORLD_SIZE", "1")), device=device,
                init_method="env://",
                local_rank=int(os.environ.get("LOCAL_RANK", str(rank))))


def leave():
    """Leave the process group (if any)."""
    global _rank_device
    if initialized():
        dist.destroy_process_group()
    _rank_device = None


def _to_host(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu")
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(fn, rank, world_size, device, init_method, threads, args,
               results):
    if threads:
        torch.set_num_threads(threads)
    try:
        mesh = join(rank, world_size, device=device, init_method=init_method)
        out = fn(mesh, *args)
        # plain pickle bytes: a tensor put on the queue as such would be
        # shared by a file descriptor that dies with this process
        results.put((rank, True, pickle.dumps(_to_host(out))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        leave()


def run_ranks(fn: Callable[..., Any], world_size: int, *, device,
              init_file: str, args: Sequence[Any] = (),
              threads: Optional[int] = 1,
              timeout_s: float = 1200.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world_size`` ranks, each a fresh
    ``spawn``ed process that joins a group through a ``FileStore`` at
    ``init_file`` (a path that must not exist yet) on its device (see
    ``rank_device``) with ``threads`` torch threads.  Returns each rank's
    result in rank order, its tensors moved to the CPU.  ``fn`` must be
    importable by name.  A rank's exception is raised here with its
    traceback, and the other ranks are stopped."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = "file://" + os.path.abspath(init_file)
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world_size, str(device), init_method, threads, tuple(args),
        results)) for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout_s
    dead_before = False
    try:
        while len(out) < world_size:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                # a rank that died without a word (its last message, if
                # any, had one more second to arrive)
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead and dead_before:
                    raise RuntimeError(f"rank {dead[0][0]} of {world_size} "
                                       f"exited with code {dead[0][1]}")
                dead_before = bool(dead)
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish "
                                       f"in {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{payload}")
            out[rank] = pickle.loads(payload)
    finally:
        for p in procs:
            p.join(timeout=60 if len(out) == world_size else 0.1)
            if p.is_alive():
                p.terminate()
                p.join()
    return [out[r] for r in range(world_size)]


# ---------------------------------------------------------------------------
# ("data", "model") device meshes for the LM steps
# ---------------------------------------------------------------------------

def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group (rank r at row-major place r, as ``jax.make_mesh`` lays out its
    devices), on ``device``'s type (default: this rank's device).  The
    group's size must be the product of ``shape``."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    n = 1
    for k in shape:
        n *= k
    if not initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of {n} "
                           "ranks; none is up")
    if world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the group has "
                         f"{world_size()}")
    if device is None:
        dev_type = _rank_device.type if _rank_device is not None else (
            "cuda" if str(dist.get_backend()) == "nccl" else "cpu")
    else:
        dev_type = torch.device(device).type
    return init_device_mesh(dev_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production mesh: ``("data", "model")`` 16 x 16, or
    ``("pod", "data", "model")`` 2 x 16 x 16 with ``multi_pod``."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device)
    return make_mesh((16, 16), ("data", "model"), device)


def make_host_mesh(device=None):
    """A ``("data", "model")`` mesh of 1 x world over the group's ranks."""
    return make_mesh((1, world_size()), ("data", "model"), device)


def axis_size(mesh, name: str, default: Optional[int] = None) -> int:
    """The size of ``mesh``'s axis ``name`` (``mesh.shape[name]`` in the
    reference); ``default`` where the mesh has no such axis (the
    reference's ``mesh.shape.get("pod", 1)``)."""
    names = tuple(mesh.mesh_dim_names)
    if name not in names:
        if default is None:
            raise KeyError(f"mesh {names} has no axis {name!r}")
        return default
    return int(mesh.mesh.shape[names.index(name)])
