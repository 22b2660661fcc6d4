"""idle_share.decode: the traced window's time in which no operation ran on
the device, in % (1 - the union of its busy intervals / the window).
Moves ``decode_tokens_per_s``."""


def read(t):
    if t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
