"""Named profiler ranges at the port's layer boundaries.

``with span(name):`` opens a `torch.profiler.record_function` range while a
profiler is recording, and is a shared no-op context otherwise, so the
ranges cost one flag check each when nobody profiles.  A range holds no
clock, buffer or exporter of its own: under `torch.profiler.profile` it
sits in the profiler's trace, and with CUDA activities the trace gives the
device time of the kernels launched inside it (each kernel counts toward
its innermost range).  No range named here encloses another, so the device
time under each is its layer's own.

The ranges:

- `ATTENTION_CORE` — attention from q, k and v (`models.layers.attn_apply`):
  the flash-attention kernel, or the plain attention over logits, whatever
  route computes it; the projections, RoPE and cache writes lie outside;
- `MLP` — the dense MLP's three projections and activation
  (`models.layers.mlp_apply`);
- `TRAIN_GRADS` — what the training step does to the gradients between
  autograd and the optimizer: each microbatch's bfloat16 cast, the
  accumulation and its 1/n scale, the float32 cast and global-norm clip
  (`runtime.steps`, `parallel.microbatch`);
- `OPTIM_UPDATE` — the learning-rate schedule and the optimizer's update
  (`runtime.steps.make_train_step`);
- `FLASH_ATTENTION_BACKWARD` — the flash attention's backward: its
  backward kernel on the tensor-core route, autograd through the attention
  oracle elsewhere;
- `SSD_DIAG_BACKWARD` — autograd through the SSD oracle in its kernel's
  backward.

Under remat, a layer's forward runs again in the backward, and so do its
`ATTENTION_CORE` and `MLP` ranges.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

__all__ = ["ATTENTION_CORE", "FLASH_ATTENTION_BACKWARD", "MLP", "OPTIM_UPDATE", "SSD_DIAG_BACKWARD",
           "TRAIN_GRADS", "span"]

ATTENTION_CORE = "attention.core"
MLP = "mlp"
TRAIN_GRADS = "train.grads"
OPTIM_UPDATE = "optim.update"
FLASH_ATTENTION_BACKWARD = "flash_attention.backward"
SSD_DIAG_BACKWARD = "ssd_diag.backward"

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range ``name`` while a profiler records, else a no-op.

    The flag is the profiler's process-wide one, so a range opened in
    autograd's device threads (a kernel's backward) is recorded too."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
