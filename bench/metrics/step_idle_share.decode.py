"""step_idle_share.decode: the device's idle gaps whose midpoint falls
while the host is inside the program's ``serve_step`` range (the step's
own dispatch, not the harness's token read), over the traced window, in %
(``benchlib.ranges``).  Moves ``decode_tokens_per_s``."""

from benchlib.ranges import step_idle_share


def read(t):
    return step_idle_share(t, "serve_step")
