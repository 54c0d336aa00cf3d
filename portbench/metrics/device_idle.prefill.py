"""Share of the traced prefill batches' wall time with no device operation running, in percent."""

from _shared import idle


def read(run):
    return idle(run)
