"""Deterministic synthetic token pipeline (port of `repro/data/pipeline.py`).

Batches are a pure function of (seed, step), drawn with numpy exactly as
the reference draws them, so both packages see the same tokens.  The
reference casts its float stubs (``patches``, ``frames``) to the compute
dtype in numpy, which needs `ml_dtypes` for bfloat16; here they stay
float32 (the same draws) and a caller casts them in torch.  `shard_batch`
places a host batch on the model's device, or, given the step's batch
shardings (`launch.build.BuiltCell.in_shardings`, placements over a mesh),
as DTensors over that mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.models.config import ModelConfig

__all__ = ["SyntheticDataset", "make_batch", "shard_batch"]


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int,
                 alpha: float = 1.1) -> np.ndarray:
    """Zipf-distributed token ids in [0, vocab) (heavy head, long tail)."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    return rng.choice(vocab, size=shape, p=probs).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SyntheticDataset:
    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The batch for a given step: deterministic, restart-stable."""
        return make_batch(self.cfg, self.global_batch, self.seq_len,
                          seed=self.seed, step=step)


def make_batch(cfg: ModelConfig, batch: int, seq_len: int, *, seed: int = 0,
               step: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    out: Dict[str, np.ndarray] = {}
    text_len = seq_len
    if cfg.family == "vlm" and cfg.num_patch_tokens:
        text_len = seq_len - cfg.num_patch_tokens
        out["patches"] = (rng.standard_normal((batch, cfg.num_patch_tokens, cfg.d_model))
                          * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        if cfg.encoder is None:
            raise ValueError("encdec family requires EncoderConfig")
        out["frames"] = (rng.standard_normal((batch, cfg.encoder.source_len, cfg.d_model))
                         * 0.02).astype(np.float32)
    # Cap the sampled vocab so Zipf tables stay small at 152k-vocab configs.
    vocab = min(cfg.vocab_size, 32_768)
    out["tokens"] = _zipf_tokens(rng, (batch, text_len), vocab)
    out["loss_mask"] = np.ones((batch, text_len), np.float32)
    return out


def shard_batch(batch: Dict[str, Any], device: Any,
                shardings: Optional[Dict[str, Any]] = None,
                mesh: Any = None) -> Dict[str, torch.Tensor]:
    """Place a host batch on ``device``, each array keeping its dtype; an
    array named in ``shardings`` becomes a DTensor of those placements over
    ``mesh`` (every rank holds the whole host batch, as each draws it from
    the same seed, and keeps its shard)."""
    out = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    if shardings is None:
        return out
    return {k: distribute_tensor(v, mesh, tuple(shardings[k])) if k in shardings else v
            for k, v in out.items()}
