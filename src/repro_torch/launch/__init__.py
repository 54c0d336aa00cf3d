"""Entry points of the port (port of `repro/launch`): serving, training,
the meshes (`launch.mesh`) and the rules of a cell (`launch.build.rules_for`).

The reference's `build_cell`, dry-run and training across a mesh come with
ROADMAP Queue 1 item 17c, its autotune command with item 17d.
"""
