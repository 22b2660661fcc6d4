"""step_idle_share.prefill: the device's idle gaps whose midpoint falls
while the host is inside the program's ``prefill_step`` range (the step's
own dispatch, not the harness's token read), over the traced window, in %
(``benchlib.ranges``).  Moves ``prefill_tokens_per_s``."""

from benchlib.ranges import step_idle_share


def read(t):
    return step_idle_share(t, "prefill_step")
