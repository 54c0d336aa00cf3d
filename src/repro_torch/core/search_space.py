"""Resource-configuration search space and its memory-aware split (paper §III-D).

A configuration is anything with (a) a feature encoding for the GP surrogate
(CherryPick encodes each config "by its principal features like the number of
cores and the amount of memory"), (b) a total cluster memory, and (c) optional
metadata (node count, prices, mesh/remat details for the TPU tuner, ...).

``split_search_space`` implements the paper's priority-group construction:

  LINEAR  → configs with total memory ≥ the extrapolated requirement
            (+overhead+leeway); if *no* config qualifies, prioritize the
            extremes (very high and very low total memory).
  FLAT    → the 10–20 % of configs with the lowest total memory.
  UNCLEAR → no split (priority group = whole space → plain CherryPick).

``split_search_space`` is the host-side numpy copy of the reference module
(`repro/core/search_space.py`), bit-equal to it.  ``split_masks_device`` is
the same rule computed on a torch device over the space's static
per-config arrays, returning the (n,) priority mask directly: one
vectorized comparison and a stable sort instead of a Python loop over
10⁴-10⁵ configurations.  It runs in float64, so every comparison and the
stable order are those of the host rule, and the masks equal its lists
exactly; the fleet session (`repro_torch.fleet.session`) relies on that.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.memory_model import MemoryCategory, MemoryModel
from repro_torch.device import DeviceLike, resolve_device

__all__ = [
    "Configuration",
    "SearchSpace",
    "split_masks_device",
    "split_search_space",
]


@dataclasses.dataclass(frozen=True)
class Configuration:
    """One point in the discrete configuration search space."""

    name: str
    features: Tuple[float, ...]  # raw GP features (cores, mem/node, nodes, ...)
    total_memory: float  # bytes of total cluster memory
    num_nodes: int = 1
    meta: Any = None


@dataclasses.dataclass
class SearchSpace:
    configs: List[Configuration]

    def __post_init__(self) -> None:
        if not self.configs:
            raise ValueError("empty search space")
        feats = np.asarray([c.features for c in self.configs], np.float64)
        mean = feats.mean(axis=0)
        std = feats.std(axis=0)
        std = np.where(std > 1e-12, std, 1.0)
        self._encoded = (feats - mean) / std
        # Static per-config arrays, built once: the §III-D split (host or
        # device) reads these instead of looping over Configuration objects.
        self._memories = np.asarray(
            [c.total_memory for c in self.configs], np.float64
        )
        self._num_nodes = np.asarray(
            [c.num_nodes for c in self.configs], np.float64
        )

    def __len__(self) -> int:
        return len(self.configs)

    def encoded(self, indices: Optional[Sequence[int]] = None) -> np.ndarray:
        """Standardized feature matrix (whole space or a subset)."""
        if indices is None:
            return self._encoded
        return self._encoded[np.asarray(indices, np.int64)]

    def memories(self) -> np.ndarray:
        return self._memories

    def num_nodes(self) -> np.ndarray:
        return self._num_nodes


def split_search_space(
    space: SearchSpace,
    model: MemoryModel,
    input_size: float,
    *,
    per_node_overhead: float = 0.0,
    leeway: float = 0.10,
    flat_fraction: float = 1.0 / 7.0,
    extreme_fraction: float = 0.15,
) -> Tuple[List[int], List[int]]:
    """Return (priority_indices, remaining_indices) per the paper's §III-D.

    ``flat_fraction`` defaults to ~1/7 — the paper's evaluation placed the ten
    lowest-memory configs of 69 in the priority group.  ``extreme_fraction``
    controls the very-high/very-low fallback when no config satisfies a linear
    requirement.
    """
    n = len(space)
    all_idx = list(range(n))
    mems = space.memories()

    if model.category is MemoryCategory.UNCLEAR:
        return all_idx, []

    if model.category is MemoryCategory.FLAT:
        k = max(1, int(round(flat_fraction * n)))
        order = np.argsort(mems, kind="stable")
        prio = sorted(int(i) for i in order[:k])
        rest = sorted(set(all_idx) - set(prio))
        return prio, rest

    # LINEAR: require total cluster memory ≥ extrapolated requirement.
    req_base = model.estimate(input_size)
    prio = []
    for i, cfg in enumerate(space.configs):
        requirement = req_base * (1.0 + leeway) + per_node_overhead * cfg.num_nodes
        if cfg.total_memory >= requirement:
            prio.append(i)
    if not prio:
        # Requirement exceeds every config: prioritize the extremes — "some
        # jobs can make use of all memory they are given and others need
        # either enough or none" (paper §III-D).
        k = max(1, int(round(extreme_fraction * n)))
        order = np.argsort(mems, kind="stable")
        prio = sorted({int(i) for i in order[:k]} | {int(i) for i in order[-k:]})
    if len(prio) == n:
        # Requirement met by everything → no reduction (paper observed this
        # for PageRank/Spark "huge"); behave exactly like the baseline.
        return all_idx, []
    rest = sorted(set(all_idx) - set(prio))
    return prio, rest



def _flat_prio_mask(mems: torch.Tensor, k: int) -> torch.Tensor:
    """FLAT rule: True at the k lowest-memory configs (stable ties)."""
    order = torch.argsort(mems, stable=True)
    mask = torch.zeros(mems.shape[0], dtype=torch.bool, device=mems.device)
    mask[order[:k]] = True
    return mask


def _linear_prio_mask(
    mems: torch.Tensor, nodes: torch.Tensor, scaled_req: float, overhead: float, k: int
) -> torch.Tensor:
    """LINEAR rule: memory >= requirement, else the very-high/very-low extremes.

    ``scaled_req`` is ``req_base * (1.0 + leeway)``, rounded on the host as
    the host rule rounds it; the per-node term is a separate multiply and
    add (a fused multiply-add would round once and break the equality with
    `split_search_space`).
    """
    requirement = nodes * overhead
    requirement = requirement + scaled_req
    qualify = mems >= requirement
    order = torch.argsort(mems, stable=True)
    extremes = torch.zeros_like(qualify)
    extremes[order[:k]] = True
    extremes[order[-k:]] = True
    return torch.where(qualify.any(), qualify, extremes)


def split_masks_device(
    space: SearchSpace,
    model: MemoryModel,
    input_size: float,
    *,
    per_node_overhead: float = 0.0,
    leeway: float = 0.10,
    flat_fraction: float = 1.0 / 7.0,
    extreme_fraction: float = 0.15,
    device: DeviceLike = None,
) -> torch.Tensor:
    """The §III-D priority split on ``device``: the (n,) bool priority mask.

    Equal to `split_search_space`'s lists by construction: the requirement
    and the comparison run elementwise in float64, the FLAT and extremes
    selections use a stable argsort (the permutation of
    ``np.argsort(kind="stable")``), and the group sizes ``k`` are rounded on
    the host with the host rule's expressions.  The remaining mask is always
    the complement (``~prio``), the all-qualify LINEAR case included: the
    complement of an all-True mask is the host rule's empty remainder.
    UNCLEAR returns all-True.
    """
    dev = resolve_device(device)
    n = len(space)
    if model.category is MemoryCategory.UNCLEAR:
        return torch.ones(n, dtype=torch.bool, device=dev)
    mems = torch.from_numpy(space.memories()).to(dev)
    if model.category is MemoryCategory.FLAT:
        k = max(1, int(round(flat_fraction * n)))
        return _flat_prio_mask(mems, min(k, n))
    k = max(1, int(round(extreme_fraction * n)))
    return _linear_prio_mask(
        mems,
        torch.from_numpy(space.num_nodes()).to(dev),
        float(model.estimate(input_size)) * (1.0 + float(leeway)),
        float(per_node_overhead),
        min(k, n),
    )
