"""The window's prefills' model operations (`counts.prefill_flops` a batch)
per second of the unprofiled window, over the bf16 dense peak, in percent."""

from _shared import counts


def read(run):
    shapes = run.window.get("shapes")
    if not shapes:
        return None
    flops = sum(counts.prefill_flops(run.config, b, t) for b, t in shapes)
    return 100.0 * flops / run.window["window_s"] / counts.PEAK_BF16_PER_S
