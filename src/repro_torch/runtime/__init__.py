"""Training and serving runtime (port of `repro/runtime`): step factories,
the fault-tolerant train loop and the decode loop.

The tuning daemon (`runtime/serve.py`) comes with ROADMAP Queue 1 item 15.
"""
