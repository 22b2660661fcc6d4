"""launches_per_step.decode: device kernels (copies and memsets left out)
a decode step, counted by the profiler over the traced steps.  Moves
``decode_tokens_per_s``."""


def read(t):
    if t.steps <= 0 or not t.device:
        return None
    return t.kernels() / t.steps
