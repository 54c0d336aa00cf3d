"""Median time to first token over the unprofiled window's requests (host clock)."""

import statistics


def read(run):
    ttft = run.window.get("ttft_ms")
    return statistics.median(ttft) if ttft else None
