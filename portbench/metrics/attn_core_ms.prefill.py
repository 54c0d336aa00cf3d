"""Device time under the program's range ``attention.core`` (attention from
q, k and v in every layer, whatever route computes it) per traced batch, in
milliseconds."""

from _span import per_batch_ms

RANGE = "attention.core"


def read(run):
    return per_batch_ms(run, RANGE)
