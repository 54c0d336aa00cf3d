"""Device time under the program's range ``mlp`` (the dense MLP's three
projections and activation in every layer) per traced batch, in
milliseconds."""

from _span import per_batch_ms

RANGE = "mlp"


def read(run):
    return per_batch_ms(run, RANGE)
