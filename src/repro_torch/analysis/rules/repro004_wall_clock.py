"""REPRO004 — wall clock or host randomness inside virtual-clock code.

The simulator's clock is the event queue's virtual time and its only
legal stochasticity flows from seeded generators (``server rng`` /
``system_seed``).  ``time.*`` reads, ``datetime.now``, the global
``random`` module, unseeded ``np.random``, ``os.urandom`` and
``secrets`` all smuggle host nondeterminism into results — or worse,
into event ordering.  Allowlisted by design: the ``obs/`` tracer and
``perf`` shim (they *measure* wall time, that's their job) and the
store's write-latency metric (``experiments/store.py``, explicitly
carved out by the rule spec).  Wall-time measurements that feed purely
informational fields (e.g. a RoundRecord's ``wall``) stay in scope and
carry per-site justifications instead, so every exemption is visible.

Copy of ``repro.analysis.rules.repro004_wall_clock``.
"""

from __future__ import annotations

import ast

from ..core import FileContext, Rule, register
from ..scopes import dotted_parts

SCOPED_DIRS = {"runtime", "experiments", "federated", "core"}
ALLOWLIST_SUFFIXES = (
    "obs",                       # directory: the wall-clock tracer itself
)
ALLOWLIST_FILES = {
    "perf.py",                   # wall-clock phase counters by contract
    "experiments/store.py",      # store_write_s latency metric
}

TIME_FUNCS = {"time", "perf_counter", "perf_counter_ns", "monotonic",
              "monotonic_ns", "process_time", "time_ns", "sleep"}
DATETIME_NOW = {"now", "utcnow", "today"}
RANDOM_MODULE_FUNCS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "normalvariate", "gauss", "seed", "getrandbits",
}


@register
class WallClockInVirtualTime(Rule):
    id = "REPRO004"
    name = "wall-clock-or-host-randomness"

    def _allowlisted(self, rel: str) -> bool:
        parts = rel.split("/")
        if any(p in ALLOWLIST_SUFFIXES for p in parts):
            return True
        return any(rel.endswith(f) for f in ALLOWLIST_FILES)

    def check_file(self, ctx: FileContext):
        parts = set(ctx.rel.split("/"))
        if not parts & SCOPED_DIRS:
            return
        if self._allowlisted(ctx.rel):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                self._check_call(ctx, node)

    def _check_call(self, ctx: FileContext, node: ast.Call):
        chain = dotted_parts(node.func)
        if not chain:
            return
        base, last = chain[0], chain[-1]
        if base == "time" and last in TIME_FUNCS:
            ctx.add(node, self.id,
                    f"wall-clock call `{'.'.join(chain)}` in virtual-clock "
                    "code — results must depend only on the event queue's "
                    "virtual time (or justify-suppress for informational "
                    "wall fields)")
        elif base == "datetime" and last in DATETIME_NOW:
            ctx.add(node, self.id,
                    f"wall-clock call `{'.'.join(chain)}` in virtual-clock "
                    "code — results must depend only on virtual time")
        elif base == "random" and last in RANDOM_MODULE_FUNCS \
                and len(chain) == 2:
            ctx.add(node, self.id,
                    f"global `random.{last}` is host randomness — draw "
                    "from a seeded np.random.Generator owned by the "
                    "server/system instead")
        elif base in {"np", "numpy"} and len(chain) >= 2 \
                and chain[1] == "random":
            if last == "default_rng":
                if not node.args and not node.keywords:
                    ctx.add(node, self.id,
                            "`np.random.default_rng()` without a seed is "
                            "host randomness — thread a seed from the "
                            "trial/system config")
            else:
                ctx.add(node, self.id,
                        f"global `np.random.{last}` draws from unseeded "
                        "process state — use a seeded Generator instead")
        elif base == "os" and last == "urandom":
            ctx.add(node, self.id,
                    "`os.urandom` is host randomness — virtual-clock code "
                    "must derive all stochasticity from seeds")
        elif base == "secrets":
            ctx.add(node, self.id,
                    f"`secrets.{last}` is host randomness — virtual-clock "
                    "code must derive all stochasticity from seeds")
        elif base == "uuid" and last == "uuid4":
            ctx.add(node, self.id,
                    "`uuid.uuid4` is host randomness — derive ids from "
                    "trial keys or seeded generators")
