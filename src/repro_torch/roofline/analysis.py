"""Roofline terms of a step that the port runs, per rank (port of
``repro.roofline.analysis``).

  compute term    = FLOPs_per_rank / peak_FLOP/s
  memory term     = bytes_per_rank / HBM_bw
  collective term = collective_bytes_per_rank / (links * link_bw)

The reference reads these from the compiled program: ``cost_analysis()``
for FLOPs and bytes, the HLO text for collectives, ``memory_analysis()``
for memory.  A PyTorch step has no compiled program, so
``analyze_traced`` runs it once under a ``TorchDispatchMode`` of its own
(``_Counter``) and counts what reaches the dispatcher, on ``meta``, CPU
or CUDA tensors alike:

  * only the rank's local work: an op on a DTensor is handed on to
    DTensor (``NotImplemented``), and the local ops and collectives it
    runs come back through the mode; the ops that DTensor's sharding
    propagation runs on fake tensors are not counted;
  * FLOPs from ``torch.utils.flop_counter``'s formula registry (the
    matmul-class ops; elementwise ops count none);
  * bytes: each op's inputs read once and outputs written once, with no
    fusion (XLA's per-op "bytes accessed" before fusion); views and
    aliases cost nothing;
  * collectives: the ``_c10d_functional`` ops that DTensor runs and the
    ``c10d`` ops of plain ``torch.distributed`` calls, by the reference's
    kinds, each the bytes of its result times ``_MULT``;
  * memory: bytes of the live storages, the arguments' from the start;
    the most live at once is the peak, and ``memory_analysis`` splits it
    as the reference's does (argument, output, alias, temp).

Each kernel entry point is one op (``kernel_op``): its FLOPs and bytes
are the kernel's own formula (``roofline.kernels``, what PERF.md's
bounds count), it allocates only its outputs and scratch, and the ops
inside it are not counted.  So a step analysed on the CPU or on ``meta``
is counted as the card runs it, where the kernels are ``ctypes`` calls
that no dispatch mode sees.

A loop that ``sharding.ctx.steps`` cuts on ``meta`` runs its first step,
one middle step and its last; the middle one stands for the other n - 2
(``loop``): its FLOPs, bytes and collectives, forward and backward, count
n - 2 times, and the storages it leaves live count n - 2 times until they
are freed.  Then the same step gives the same counts on ``meta`` as on
the CPU, where the loop runs in full.

What stays different from the reference: no HLO (the counts are of the
ops PyTorch dispatches, not of a compiled program), and the bytes are
unfused.
"""

from __future__ import annotations

import contextlib
import functools
import json
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.hardware import H100, Chip
from repro_torch.roofline.kernels import KernelTraffic

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# moved-bytes multiplier per op (ring algorithms, large-message asymptote)
_MULT = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
         "all-to-all": 1.0, "collective-permute": 1.0}

# torch's collective ops by the reference's kinds; point-to-point moves
# and broadcasts are collective-permutes
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}
# the c10d ops write their result into their first argument; the
# functional ones return it
_C10D = "c10d"
_FUNCTIONAL = ("_c10d_functional", "c10d_functional")
# allocations that write nothing
_ALLOCS = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                     "new_empty_strided"))
# functional collectives' bookkeeping: each returns its input (a fresh
# storage on ``meta``, whose kernels cannot alias)
_PASS = frozenset(("wait_tensor", "_wrap_tensor_autograd"))


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    # per-device quantities
    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_breakdown: Dict[str, float] = field(default_factory=dict)
    # terms (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    # usefulness
    model_flops: float = 0.0           # 6 * N(active) * D tokens (global)
    useful_ratio: float = 0.0          # model_flops / (flops * n_devices)
    peak_memory_bytes: float = 0.0     # per-device, the most bytes live
    notes: str = ""

    def finalize(self, chip: Chip = H100):
        self.t_compute = self.flops / chip.peak_flops_bf16
        self.t_memory = self.hbm_bytes / chip.hbm_bandwidth
        self.t_collective = self.coll_bytes / (
            chip.ici_links_per_chip * chip.ici_link_bandwidth)
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        if self.model_flops and self.flops:
            self.useful_ratio = self.model_flops / (self.flops * self.n_devices)
        return self

    def row(self) -> str:
        return (f"{self.arch:22s} {self.shape:12s} {self.mesh:9s} "
                f"comp={self.t_compute*1e3:9.3f}ms "
                f"mem={self.t_memory*1e3:9.3f}ms "
                f"coll={self.t_collective*1e3:9.3f}ms "
                f"-> {self.bottleneck:10s} useful={self.useful_ratio:6.1%} "
                f"peakmem={self.peak_memory_bytes/2**30:6.2f}GiB")

    def to_json(self) -> str:
        d = dict(self.__dict__)
        return json.dumps(d, indent=1, default=float)


# ---------------------------------------------------------------------------
# the trace: counts and live storages of one analysed step
# ---------------------------------------------------------------------------

# The trace being taken, if any.  Module state, not a context variable:
# CUDA's backward runs on autograd's device thread, where the dispatch mode
# is carried over and a context variable is not.  One trace at a time.
_ACTIVE: Optional["_Trace"] = None


def active() -> bool:
    """True while ``analyze_traced`` runs a step."""
    return _ACTIVE is not None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    """``t``'s storage, or None for a tensor that has none to count (a
    subclass wrapper, a sparse tensor)."""
    if type(t) not in (torch.Tensor, torch.nn.Parameter):
        return None
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _local(x):
    """A DTensor's local shard; anything else as it is."""
    local = getattr(x, "_local_tensor", None)
    return x if local is None else local


def _keep(_storages):
    """A finalizer's no-op: its argument stays alive until it runs."""


def _seq_now() -> int:
    """The sequence number autograd gives the next node it makes on this
    thread (nodes run backward in the order opposite to it)."""
    with torch.enable_grad():
        leaf = torch.empty(0, requires_grad=True)
        return leaf.view(-1).grad_fn._sequence_nr()


class _Loop:
    """A loop cut on ``meta`` (``loop``), from its middle step, which
    stands for ``n - 2``, to the end of its last: the storages the middle
    step made and the most bytes live since it began."""

    def __init__(self, n: int, live: int):
        self.n = n
        self.peak = live
        self.kept: List[Tuple[int, list]] = []


class _Trace:
    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = {k: 0.0 for k in _COLLECTIVES}
        self.counts = {k: 0 for k in _COLLECTIVES}
        self.kernels: Dict[str, int] = {}
        # storage key -> [bytes, multiplicity]; args: the arguments' keys
        self.storages: Dict[int, List[int]] = {}
        self.args: Dict[int, int] = {}
        self.written: set = set()
        self.live = 0
        self.peak = 0
        self.quiet = 0            # > 0 inside a kernel op
        self.scales: List[int] = []   # of the middle steps running now
        self.middle: Optional[_Loop] = None
        self.open: List[_Loop] = []
        # (first, last, scale): the autograd nodes a middle step made
        self.seq_ranges: List[Tuple[int, int, int]] = []

    # -- memory -----------------------------------------------------------

    def _bump(self, amount: int):
        self.live += amount
        if self.live > self.peak:
            self.peak = self.live
        for lp in self.open:
            if self.live > lp.peak:
                lp.peak = self.live

    def _freed(self, key: int):
        entry = self.storages.pop(key, None)
        if entry is not None:
            self.live -= entry[0] * entry[1]

    def track(self, st, *, arg: bool = False) -> bool:
        """Count ``st`` live until it is freed; False if it already is."""
        key = st._cdata
        if key in self.storages:
            return False
        n = st.nbytes()
        entry = self.storages[key] = [n, 1]
        weakref.finalize(st, self._freed, key)
        if arg:
            self.args[key] = n
        elif self.middle is not None:
            # the entry, not the key: a freed storage's address is reused
            self.middle.kept.append((key, entry))
        self._bump(n)
        return True

    # -- scale ------------------------------------------------------------

    def scale(self) -> int:
        """How many ops the op now dispatched stands for: the middle steps
        running now, and in the backward those that made the node it
        belongs to (a gradient summed into an earlier node's is the
        producing node's)."""
        s = 1
        for k in self.scales:
            s *= k
        node = torch._C._current_autograd_node()
        if node is not None:
            nr = node._sequence_nr()
            for lo, hi, k in self.seq_ranges:
                if lo < nr < hi:
                    s *= k
        return s

    # -- ops --------------------------------------------------------------

    def op(self, func, args, kwargs, out):
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return                  # DTensor's sharding propagation
        schema = func._schema
        written = []
        for i, a in enumerate(schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                v = args[i] if i < len(args) else kwargs.get(a.name)
                written += _tensors(v)
        in_st = {}
        for t in ins:
            st = _storage(t)
            if st is not None:
                in_st[st._cdata] = st
        fresh = []
        for t in outs:
            st = _storage(t)
            if st is not None and st._cdata not in in_st:
                fresh.append(st)
        ns, name = schema.name.split("::")
        if ns in _FUNCTIONAL and name in _PASS:
            # the input lives as long as what stands for it
            for st in fresh:
                weakref.finalize(st, _keep, tuple(in_st.values()))
            return
        k = self.scale()
        kind = _KIND.get(name) if ns == _C10D or ns in _FUNCTIONAL else None
        if kind is not None:
            result = _tensors(args[0]) if ns == _C10D else outs
            self.coll[kind] += k * _MULT[kind] * sum(map(_nbytes, result))
            self.counts[kind] += k
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += k * formula(*args, **kwargs, out_val=out)
        # each operand read, each result written (an in-place op's result
        # is its written operand); views and aliases (every output on an
        # input's storage) and bare allocations move nothing
        if name not in _ALLOCS and (fresh or written or kind is not None
                                    or not outs):
            w_ids = {id(t) for t in written}
            wrote = {id(t): t for t in written + outs}
            self.bytes += k * (sum(_nbytes(t) for t in ins
                                   if id(t) not in w_ids)
                               + sum(map(_nbytes, wrote.values())))
        for t in written:
            st = _storage(t)
            if st is not None and st._cdata in self.args:
                self.written.add(st._cdata)
        for st in fresh:
            self.track(st)

    def kernel(self, traffic: KernelTraffic, scratch: int, out):
        """One kernel launch: its formula's FLOPs and bytes; its outputs
        live from here, its scratch only while it runs."""
        k = self.scale()
        self.flops += k * traffic.flops
        self.bytes += k * traffic.bytes_hbm
        self.kernels[traffic.name] = self.kernels.get(traffic.name, 0) + k
        fresh = {}
        for t in _tensors(out):
            st = _storage(t)
            if st is not None and st._cdata not in self.storages:
                fresh[st._cdata] = st
        running = scratch + sum(st.nbytes() for st in fresh.values())
        self._bump(running)
        self.live -= running
        for st in fresh.values():
            self.track(st)

    # -- loops ------------------------------------------------------------

    def _seq_now(self) -> Optional[int]:
        """The number of the next autograd node, where the middle step's
        nodes are the ones that will run backward; None in a backward (a
        recompute's nodes never run, and its thread numbers its own)."""
        if not torch.is_grad_enabled() \
                or torch._C._current_autograd_node() is not None:
            return None
        self.quiet += 1
        try:
            return _seq_now()
        finally:
            self.quiet -= 1

    @contextlib.contextmanager
    def loop_middle(self, n: int):
        """The middle step of an n-step loop, standing for n - 2.  Yields
        the loop to pass to ``loop_end`` after the last step (None for a
        loop inside a middle step: its ops scale, its storages do not)."""
        outer = self.middle is not None
        lp = None if outer else _Loop(n, self.live)
        if lp is not None:
            self.middle = lp
            self.open.append(lp)
        self.scales.append(n - 2)
        first = self._seq_now()
        try:
            yield lp
        finally:
            self.scales.pop()
            if lp is not None:
                self.middle = None
            last = self._seq_now()
            if first is not None and last is not None:
                self.seq_ranges.append((first, last, n - 2))

    def loop_end(self, lp: Optional[_Loop]):
        """After the last step: what the middle step left live counts
        n - 2 times, and every live count from the middle step on sits
        n - 3 steps' worth higher (the full loop's later steps)."""
        if lp is None:
            return
        self.open.remove(lp)
        kept = [entry for key, entry in lp.kept
                if self.storages.get(key) is entry]
        extra = (lp.n - 3) * sum(entry[0] for entry in kept)
        for entry in kept:
            entry[1] += lp.n - 3
        self.live += extra
        self.peak = max(self.peak, lp.peak + extra)


class _Counter(TorchDispatchMode):
    """Counts each op of the trace (``_Trace.op``); an op on a DTensor goes
    on to DTensor, whose local ops come back here."""

    def __init__(self, trace: _Trace, dtensor_type):
        super().__init__()
        self.trace = trace
        self.dtensor = dtensor_type

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.dtensor is not None and any(
                issubclass(t, self.dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not self.trace.quiet:
            self.trace.op(func, args, kwargs, out)
        return out


# ---------------------------------------------------------------------------
# the hooks the port calls: kernel entry points and cut loops
# ---------------------------------------------------------------------------

def kernel_op(cost: Callable[..., Tuple[KernelTraffic, int]]):
    """Decorate a kernel entry point: under ``analyze_traced`` a call is
    one op, ``cost(*args, **kwargs)`` its (traffic, scratch bytes), and
    the ops it runs inside (the plain version on the CPU, the wrapper's
    allocations on CUDA) are not counted.  Elsewhere it costs one test."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            trace = _ACTIVE
            if trace is None or trace.quiet:
                return fn(*args, **kwargs)
            traffic, scratch = cost(*args, **kwargs)
            trace.quiet += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                trace.quiet -= 1
            trace.kernel(traffic, scratch, out)
            return out
        return entry
    return wrap


def loop(n: int):
    """Steps 0, 1 and n - 1 of an n-step loop cut on ``meta``
    (``sharding.ctx.steps``; all of them when n <= 3), step 1 counted for
    the n - 2 steps it stands for while a trace is taken."""
    trace = _ACTIVE
    if n <= 3:
        yield from range(n)
        return
    if trace is None or trace.quiet:
        yield from (0, 1, n - 1)
        return
    yield 0
    lp = None
    try:
        with trace.loop_middle(n) as lp:
            yield 1
        yield n - 1
    finally:
        # also where a checkpoint's recompute stops inside the loop
        trace.loop_end(lp)


class _CutUnbind(torch.autograd.Function):
    """``xs.unbind(0)`` for a loop cut on ``meta``: its backward stacks
    the gradients of all the steps, the middle step's standing for each
    step the loop skipped, and under a trace counts them live while the
    stack runs, as the full loop holds them."""

    @staticmethod
    def forward(ctx, xs):
        ctx.set_materialize_grads(False)
        return xs.unbind(0)

    @staticmethod
    def backward(ctx, *grads):
        stand = grads[1] if grads[1] is not None else next(
            g for g in grads if g is not None)
        extra = sum(_nbytes(stand) for g in grads if g is None)
        trace = _ACTIVE
        if trace is not None:
            trace._bump(extra)
        try:
            return torch.stack([stand if g is None else g for g in grads])
        finally:
            if trace is not None:
                trace._bump(-extra)


def cut_unbind(xs: torch.Tensor):
    """``xs.unbind(0)`` of a loop's inputs on ``meta`` (``_CutUnbind``;
    ``sharding.ctx.step_inputs``)."""
    return _CutUnbind.apply(xs)


# ---------------------------------------------------------------------------
# the analysis
# ---------------------------------------------------------------------------

def analyze_traced(step: Callable, args, *, arch: str, shape: str,
                   mesh: str, n_devices: int, model_flops: float = 0.0,
                   chip: Chip = H100) -> Tuple[RooflineReport, Dict[str, int]]:
    """Run ``step(*args)`` once and count it (the counterpart of
    ``analyze_compiled``).  Returns the report and the memory analysis:
    ``argument_size`` (the local bytes of the arguments' storages),
    ``output_size`` (of the outputs that are not arguments),
    ``alias_size`` (of the arguments the step wrote in place: params and
    momentum, a cache; the port's counterpart of donation) and
    ``temp_size = peak - argument - output + alias``, the reference's
    identity."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("analyze_traced is already tracing a step")
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:             # a build without torch.distributed
        DTensor = None
    trace = _Trace()
    for t in _tensors(pytree.tree_map(_local, args)):
        st = _storage(t)
        if st is not None:
            trace.track(st, arg=True)
    _ACTIVE = trace
    try:
        with _Counter(trace, DTensor):
            out = step(*args)
    finally:
        _ACTIVE = None
    out_bytes = {}
    for t in _tensors(pytree.tree_map(_local, out)):
        st = _storage(t)
        if st is not None and st._cdata not in trace.args:
            out_bytes[st._cdata] = st.nbytes()
    mem = {"argument_size": sum(trace.args.values()),
           "output_size": sum(out_bytes.values()),
           "alias_size": sum(trace.args[k] for k in trace.written)}
    mem["temp_size"] = (trace.peak - mem["argument_size"]
                        - mem["output_size"] + mem["alias_size"])
    rep = RooflineReport(
        arch=arch, shape=shape, mesh=mesh, n_devices=n_devices,
        flops=float(trace.flops), hbm_bytes=float(trace.bytes),
        coll_bytes=float(sum(trace.coll.values())),
        coll_breakdown={**trace.coll, "counts": dict(trace.counts)},
        model_flops=model_flops, peak_memory_bytes=float(trace.peak),
        notes=json.dumps({"kernels": trace.kernels}, sort_keys=True))
    return rep.finalize(chip), mem
