"""attn_core_share.decode: the device time of the operations launched
inside the program's ``attn_core`` ranges (decode attention's f32 cast of
the cache, scores, mask, softmax and PV), over the traced window's busy
time, in % (``benchlib.ranges``).  Moves ``decode_tokens_per_s``."""

from benchlib.ranges import share


def read(t):
    return share(t, ("attn_core",))
