"""Training and serving runtime (port of `repro/runtime`): step factories,
the fault-tolerant train loop, the decode loop, and the tuning-as-a-service
daemon (`TuningDaemon`, `runtime/serve.py`)."""

from repro_torch.runtime.serve import TuningDaemon

__all__ = ["TuningDaemon"]
