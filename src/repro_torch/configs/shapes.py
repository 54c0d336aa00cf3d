"""The assigned input-shape cells and abstract input specs per cell (port
of `repro/configs/shapes.py`).

Four cells (LM-family shapes are seq_len × global_batch):

  train_4k      4,096 × 256   — training step
  prefill_32k  32,768 × 32    — inference prefill (fills the decode cache)
  decode_32k   32,768 × 128   — one new token, KV/state cache at 32k
  long_500k   524,288 × 1     — long-context decode; sub-quadratic archs only

``decode_*`` / ``long_*`` run the serve step (one token against a cache of
seq_len), not the train step.  ``input_specs`` returns tensors on the
``meta`` device (shape and dtype, no allocation) for every model input,
the twin of the reference's `jax.ShapeDtypeStruct` stand-ins.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import cache_specs as model_cache_specs
from repro_torch.models.spec import abstract_tree

__all__ = ["ShapeCell", "CELLS", "cell_applicable", "input_specs", "cache_len"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


CELLS: Dict[str, ShapeCell] = {
    c.name: c
    for c in [
        ShapeCell("train_4k", 4_096, 256, "train"),
        ShapeCell("prefill_32k", 32_768, 32, "prefill"),
        ShapeCell("decode_32k", 32_768, 128, "decode"),
        ShapeCell("long_500k", 524_288, 1, "decode"),
    ]
}


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """(applicable, reason-if-not).  long_500k needs a sub-quadratic arch."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k-token cache is O(L²) — skipped"
    return True, ""


def cache_len(cell: ShapeCell) -> int:
    return cell.seq_len


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_batch(cfg: ModelConfig, batch: int, seq: int, *, for_train: bool) -> Dict[str, Any]:
    """Abstract batch dict for one forward/train step."""
    out: Dict[str, Any] = {}
    text_len = seq
    if cfg.family == "vlm" and cfg.num_patch_tokens:
        text_len = seq - cfg.num_patch_tokens
        out["patches"] = _meta((batch, cfg.num_patch_tokens, cfg.d_model), cfg.cdtype)
    if cfg.family == "encdec":
        out["frames"] = _meta((batch, cfg.encoder.source_len, cfg.d_model), cfg.cdtype)
    out["tokens"] = _meta((batch, text_len), torch.int32)
    if for_train:
        out["loss_mask"] = _meta((batch, text_len), torch.float32)
    return out


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    """Meta-device stand-ins for every input of the cell's step fn.

    train:   {"batch": {...}}                       → train_step(state, batch)
    prefill: {"batch": {...}, "cache": {...}}       → prefill_step
    decode:  {"tokens", "cache", "index"}           → serve_step
    """
    if cell.kind == "train":
        return {"batch": _token_batch(cfg, cell.global_batch, cell.seq_len, for_train=True)}
    cache = abstract_tree(model_cache_specs(cfg, cell.global_batch, cell.seq_len))
    if cell.kind == "prefill":
        return {"batch": _token_batch(cfg, cell.global_batch, cell.seq_len, for_train=False),
                "cache": cache}
    if cell.kind == "decode":
        return {"tokens": _meta((cell.global_batch, 1), torch.int32), "cache": cache,
                "index": _meta((), torch.int32)}
    raise ValueError(cell.kind)
