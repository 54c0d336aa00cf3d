"""Device time under the program's range ``flash_attention.backward`` (autograd
through the attention oracle) over the device's busy time, in percent."""

RANGE = "flash_attention.backward"


def read(run):
    if run.trace is None or RANGE not in run.trace.ranges_s or run.trace.busy_s <= 0:
        return None
    return 100.0 * run.trace.ranges_s[RANGE] / run.trace.busy_s
