"""Device time under the program's range ``train.grads`` (what the step does
to the gradients between autograd and the optimizer: each microbatch's
bfloat16 cast, the accumulation, the float32 cast and global-norm clip) per
traced training step, in milliseconds."""

from _span import per_step_ms

RANGE = "train.grads"


def read(run):
    return per_step_ms(run, RANGE)
