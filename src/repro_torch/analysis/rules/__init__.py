"""Rule modules — importing this package registers every rule.

Each module owns one rule id; add a module here (and to the import list)
to ship a new rule.  Copy of ``repro.analysis.rules``, with the port's
own REPRO001, REPRO003 and REPRO006.
"""

from . import (  # noqa: F401 (imported for registration side effect)
    repro001_tf32_conv,
    repro002_unsorted_iteration,
    repro003_host_sync,
    repro004_wall_clock,
    repro005_obs_coverage,
    repro006_func_rebuild,
    repro007_broad_except,
)
