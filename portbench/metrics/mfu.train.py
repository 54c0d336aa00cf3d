"""A training step's model operations (`counts.train_step_flops`: the
forward's times three, no recompute) per second of the unprofiled window's
steps, over the bf16 dense peak, in percent."""

from _shared import counts


def read(run):
    times = run.window.get("step_s")
    if not times:
        return None
    tr = run.traffic
    flops = counts.train_step_flops(run.config, tr["rows"], tr["seq_len"])
    return 100.0 * flops * len(times) / sum(times) / counts.PEAK_BF16_PER_S
