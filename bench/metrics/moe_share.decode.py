"""moe_share.decode: the device time of the operations launched inside the
program's MoE ranges (``moe_router``, ``moe_expert_products``,
``moe_combine``), over the traced window's busy time, in %
(``benchlib.ranges``).  Moves ``decode_tokens_per_s``."""

from benchlib.ranges import share


def read(t):
    return share(t, ("moe_router", "moe_expert_products", "moe_combine"))
