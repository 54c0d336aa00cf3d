"""Serving runtime (port of `repro/runtime`): step factories and the decode loop.

Training (`make_train_step`, the train loop) comes with ROADMAP Queue 1
item 10; the tuning daemon with item 15.
"""
