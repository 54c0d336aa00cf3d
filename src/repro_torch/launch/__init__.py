"""Command-line entry points of the port (port of `repro/launch`): serving
and training.

The reference's mesh, build, dry-run and autotune commands, and training
across a mesh, come with ROADMAP Queue 1 item 17.
"""
