"""Single-device pieces of `repro/parallel`: remat policies and microbatched
gradient accumulation.  Sharding, pipelining and expert parallelism come
with ROADMAP Queue 1 item 17."""
