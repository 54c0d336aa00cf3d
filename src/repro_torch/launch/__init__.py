"""Command-line entry points of the port (port of `repro/launch`): serving.

The reference's mesh, build, dry-run, autotune and train commands come with
ROADMAP Queue 1 items 9 and 17.
"""
