"""Device time under the program's range ``optim.update`` (the learning-rate
schedule and the optimizer's update of every parameter and moment) per
traced training step, in milliseconds."""

from _span import per_step_ms

RANGE = "optim.update"


def read(run):
    return per_step_ms(run, RANGE)
