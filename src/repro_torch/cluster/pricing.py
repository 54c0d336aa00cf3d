"""Pricing catalogs over the 69-configuration grid (cost-aware tuning).

The paper's evaluation prices every configuration from ONE hard-coded book
— the c4/m4/r4 on-demand rates baked into `repro_torch.cluster.nodes.NODE_TYPES`
— so "cheapest" and "fastest-per-normalized-dollar" collapse into a single
objective.  Real fleets choose between *price books*: on-demand vs spot
(discounted, volatile) billing, and x86 vs arm/Graviton-style instance
families that trade a per-hour discount against a per-core perf offset.
This module makes the book a first-class axis:

  * `SpotSchedule` — a deterministic spot-price-volatility schedule.  The
    per-(node, epoch) discount comes from a sha256 hash of the schedule
    seed (the `fleet/retry.py` idiom — no live RNG), so a spot-priced
    search is a pure function of (catalog, seed, epoch) and spot ≤
    on-demand is a *structural* guarantee, not a sampled one.
  * `PriceCatalog` — one priced view of the grid: a billing model, an
    architecture, per-family price ratios against the committed x86
    on-demand book, and the arch's runtime offset (`perf_factor`; arm
    parts run the CPU-bound phases slower per core but bill cheaper per
    hour — the perf-per-dollar trade the paper's single book never had).
  * `default_catalogs()` / `CATALOGS` — the named books the benchmarks
    and the `pytest -m pricing` property suite sweep.

The catalogs deliberately do NOT mint new `ClusterConfig`s: every book
prices the *same* 69-config search space, so cost tables from different
catalogs stay index-aligned with each other, with the legacy
`job_cost_table`, and with every committed golden trace.  The identity
book (`on_demand()`) reproduces the legacy prices bit-for-bit.

The port's own numpy copy of the reference module `repro/cluster/pricing.py`:
the port never imports the JAX package, and the two stay bit-equal.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.cluster.nodes import (
    ClusterConfig,
    NodeType,
    enumerate_cluster_configs,
)

__all__ = [
    "CATALOGS",
    "PriceCatalog",
    "SpotSchedule",
    "default_catalogs",
    "family_indices",
]


def _hash_unit(*parts: str) -> float:
    """Deterministic uniform in [0, 1) from a string key (the
    `fleet/retry.py` idiom — sha256, never a live RNG, so spot volatility
    can never perturb the engines' scripted BO draws)."""
    h = hashlib.sha256("/".join(parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0**64


@dataclasses.dataclass(frozen=True)
class SpotSchedule:
    """Deterministic spot-discount schedule, hashed from ``seed``.

    The discount for (node, epoch) swings around ``base_discount`` by
    ±``volatility`` and is clamped to [``floor``, ``ceiling``] — with
    ``floor`` > 0 the spot price is *strictly* below on-demand at every
    point of the schedule, which is what the `pytest -m pricing` property
    suite asserts catalog-wide.
    """

    seed: int = 0
    base_discount: float = 0.62  # mean fraction knocked off on-demand
    volatility: float = 0.18  # half-width of the per-epoch swing
    floor: float = 0.05  # spot never closer than 5% to on-demand
    ceiling: float = 0.90  # … and never cheaper than 10% of it

    def __post_init__(self) -> None:
        if not (0.0 < self.floor <= self.ceiling < 1.0):
            raise ValueError(
                f"want 0 < floor <= ceiling < 1, got "
                f"floor={self.floor}, ceiling={self.ceiling}"
            )
        if self.volatility < 0.0:
            raise ValueError(f"volatility={self.volatility}: want >= 0")

    def discount(self, node_name: str, epoch: int = 0) -> float:
        """Fraction knocked off the on-demand price, in (0, 1)."""
        u = _hash_unit("spot", str(self.seed), node_name, str(int(epoch)))
        swing = self.volatility * (2.0 * u - 1.0)
        return float(
            min(max(self.base_discount + swing, self.floor), self.ceiling)
        )


@dataclasses.dataclass(frozen=True)
class PriceCatalog:
    """One priced view of the 69-config grid (see module docstring).

    ``family_price_ratio`` maps the node family ("c"/"m"/"r") to the
    catalog's per-hour price as a fraction of the x86 on-demand book;
    families not listed use ``price_ratio``.  ``perf_factor`` multiplies
    *runtime* (not price): > 1 means the arch runs the reference workload
    slower, so perf-per-dollar improves only when the price ratio drops
    faster than the perf factor rises.  ``spot`` must be present exactly
    for ``billing="spot"`` catalogs.
    """

    name: str
    arch: str = "x86"  # "x86" | "arm"
    billing: str = "ondemand"  # "ondemand" | "spot"
    price_ratio: float = 1.0
    family_price_ratio: Tuple[Tuple[str, float], ...] = ()
    perf_factor: float = 1.0
    spot: Optional[SpotSchedule] = None

    def __post_init__(self) -> None:
        if self.arch not in ("x86", "arm"):
            raise ValueError(f"unknown arch {self.arch!r}")
        if self.billing not in ("ondemand", "spot"):
            raise ValueError(f"unknown billing {self.billing!r}")
        if (self.spot is not None) != (self.billing == "spot"):
            raise ValueError(
                f"catalog {self.name!r}: a SpotSchedule is required for "
                f"billing='spot' and forbidden otherwise"
            )
        if self.price_ratio <= 0.0 or self.perf_factor <= 0.0:
            raise ValueError(
                f"catalog {self.name!r}: price_ratio and perf_factor "
                f"must be > 0"
            )
        for fam, ratio in self.family_price_ratio:
            if ratio <= 0.0:
                raise ValueError(
                    f"catalog {self.name!r}: family {fam!r} ratio {ratio}"
                    " must be > 0"
                )

    def _ratio(self, family: str) -> float:
        for fam, ratio in self.family_price_ratio:
            if fam == family:
                return ratio
        return self.price_ratio

    def node_price_per_hour(self, node: NodeType, epoch: int = 0) -> float:
        """USD/hour for one node under this book at ``epoch``."""
        p = node.price_per_hour * self._ratio(node.family)
        if self.spot is not None:
            p *= 1.0 - self.spot.discount(node.name, epoch)
        return p

    def price_per_hour(self, cfg: ClusterConfig, epoch: int = 0) -> float:
        """USD/hour for a whole cluster configuration at ``epoch``."""
        return self.node_price_per_hour(cfg.node, epoch) * cfg.scale_out

    def price_table(
        self,
        configs: Optional[Sequence[ClusterConfig]] = None,
        epoch: int = 0,
    ) -> np.ndarray:
        """(n,) float64 USD/hour, aligned with `enumerate_cluster_configs`."""
        if configs is None:
            configs = enumerate_cluster_configs()
        return np.asarray(
            [self.price_per_hour(c, epoch) for c in configs], np.float64
        )


def family_indices(
    families: Union[str, Sequence[str]],
    configs: Optional[Sequence[ClusterConfig]] = None,
) -> np.ndarray:
    """Indices (enumeration order) of the configs in the given families —
    the priority pool of a family-constrained search."""
    if isinstance(families, str):
        families = (families,)
    wanted = set(families)
    known = {"c", "m", "r"}
    if not wanted or not wanted <= known:
        raise ValueError(
            f"unknown families {sorted(wanted - known)}; want a subset of "
            f"{sorted(known)}"
        )
    if configs is None:
        configs = enumerate_cluster_configs()
    return np.asarray(
        [i for i, c in enumerate(configs) if c.node.family in wanted],
        np.int64,
    )


def on_demand() -> PriceCatalog:
    """The identity book: the committed x86 on-demand prices, bit-for-bit."""
    return PriceCatalog(name="ondemand")


def spot(seed: int = 0, **kw) -> PriceCatalog:
    """x86 spot billing under a deterministic volatility schedule."""
    return PriceCatalog(
        name=f"spot-s{seed}" if seed else "spot",
        billing="spot",
        spot=SpotSchedule(seed=seed, **kw),
    )


def graviton() -> PriceCatalog:
    """arm/Graviton-style on-demand book: per-family discounts vs the x86
    book (compute-heavy families discount deepest, memory-heavy least —
    the c6g/m6g/r6g pattern) against a uniform per-core runtime offset.
    The non-uniform family ratios are what lets the cost-optimal
    configuration cross families relative to the x86 book."""
    return PriceCatalog(
        name="graviton",
        arch="arm",
        family_price_ratio=(("c", 0.72), ("m", 0.78), ("r", 0.86)),
        perf_factor=1.08,
    )


def graviton_spot(seed: int = 0) -> PriceCatalog:
    """arm book under spot billing — both axes at once."""
    g = graviton()
    return dataclasses.replace(
        g,
        name=f"graviton-spot-s{seed}" if seed else "graviton-spot",
        billing="spot",
        spot=SpotSchedule(seed=seed),
    )


def default_catalogs(seed: int = 0) -> Dict[str, PriceCatalog]:
    """The named books the benchmarks and the property suite sweep."""
    cats = [on_demand(), spot(seed), graviton(), graviton_spot(seed)]
    return {c.name: c for c in cats}


CATALOGS: Mapping[str, PriceCatalog] = default_catalogs()
