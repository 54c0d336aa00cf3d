"""K2's share of its roofline in the traced training steps: the least time
of every flash-attention call (`counts.flash_bound` at the shapes the
configuration and traffic give, the calls held to the launch counter) over
the device time of its kernels, in percent."""

from _shared import FLASH_KERNELS, counts, roofline


def read(run):
    if run.trace is None:
        return None
    tr = run.traffic
    calls = counts.k2_calls_train(run.config, tr["rows"], tr["seq_len"], tr["microbatches"])
    calls = [(shape, n * run.traced["steps"]) for shape, n in calls]
    return roofline(run, calls, counts.flash_bound, FLASH_KERNELS, "k2")
