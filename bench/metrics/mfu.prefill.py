"""mfu.prefill: the share of one H100's peak that the cell's model requires
of a step, over a step's time: the larger of its FLOPs at the bf16 peak and
its bytes at HBM bandwidth (``benchlib.counts``), over the untraced steps
timed just before the traced window (the profiler slows the host's
dispatch), in %.  Moves ``prefill_tokens_per_s``."""

from benchlib.counts import bound_s


def read(t):
    c = t.counts
    if "flops" not in c or t.timed_s <= 0:
        return None
    return 100.0 * t.steps * bound_s(c["flops"], c["bytes"]) / t.timed_s
