"""Entry points of the port (port of `repro/launch`): serving, training
(one device, or across a production mesh with ``--mesh``), the meshes
(`launch.mesh`), `build_cell` and the rules of a cell (`launch.build`),
the step cost analysis (`launch.hlo_analysis`), the dry-run
(`launch.dryrun`) and the autotuner (`launch.autotune`).
"""
