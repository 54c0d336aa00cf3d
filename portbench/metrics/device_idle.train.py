"""Share of the traced training steps' wall time with no device operation running, in percent."""

from _shared import idle


def read(run):
    return idle(run)
