"""norm_rope_share.prefill: the device time of the operations launched
inside the program's ``norm`` and ``rope`` ranges (RMSNorm and RoPE, each
its own, in f32), over the traced window's busy time, in %
(``benchlib.ranges``).  Moves ``prefill_tokens_per_s``."""

from benchlib.ranges import share


def read(t):
    return share(t, ("norm", "rope"))
