"""AWS node types and the 69-configuration grid of the paper's evaluation.

Paper §IV-A: machine types of classes c, m and r in sizes large, xlarge and
2xlarge; scale-outs between 4 and 48 machines; 69 configurations total.
Specs and on-demand prices are the 4th-generation (c4/m4/r4, us-east-1)
values of the CherryPick/Arrow era.

The exact scale-out lists per size are not enumerated in the paper; we choose
them so the grid (a) spans 4–48, (b) totals exactly 69, and (c) reproduces a
structural property the paper's narrative depends on: the *maximum* total
cluster memory of any configuration is 732 GB, which is below the 754 GB
requirement determined for Naive Bayes/Spark/bigdata (Table I) — "none of the
available configurations have enough total memory".

The port's own numpy copy of the reference module `repro/cluster/nodes.py`:
the port never imports the JAX package, and the two stay bit-equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core.search_space import Configuration, SearchSpace

__all__ = [
    "NodeType",
    "ClusterConfig",
    "NODE_TYPES",
    "SCALE_OUTS",
    "enumerate_cluster_configs",
    "make_cluster_search_space",
]

GiB = 1024**3


@dataclasses.dataclass(frozen=True)
class NodeType:
    name: str
    family: str  # "c" | "m" | "r"
    size: str  # "large" | "xlarge" | "2xlarge"
    cores: int
    memory_gb: float
    price_per_hour: float  # USD, on-demand


NODE_TYPES: Dict[str, NodeType] = {
    nt.name: nt
    for nt in [
        NodeType("c4.large", "c", "large", 2, 3.75, 0.100),
        NodeType("c4.xlarge", "c", "xlarge", 4, 7.5, 0.199),
        NodeType("c4.2xlarge", "c", "2xlarge", 8, 15.0, 0.398),
        NodeType("m4.large", "m", "large", 2, 8.0, 0.100),
        NodeType("m4.xlarge", "m", "xlarge", 4, 16.0, 0.200),
        NodeType("m4.2xlarge", "m", "2xlarge", 8, 32.0, 0.400),
        NodeType("r4.large", "r", "large", 2, 15.25, 0.133),
        NodeType("r4.xlarge", "r", "xlarge", 4, 30.5, 0.266),
        NodeType("r4.2xlarge", "r", "2xlarge", 8, 61.0, 0.532),
    ]
}

# 10 + 8 + 5 = 23 scale-outs per family → 69 configurations.
SCALE_OUTS: Dict[str, Tuple[int, ...]] = {
    "large": (4, 6, 8, 10, 12, 16, 24, 32, 40, 48),
    "xlarge": (4, 6, 8, 10, 12, 16, 20, 24),
    "2xlarge": (4, 6, 8, 10, 12),
}


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    node: NodeType
    scale_out: int

    @property
    def name(self) -> str:
        return f"{self.node.name}x{self.scale_out}"

    @property
    def total_cores(self) -> int:
        return self.node.cores * self.scale_out

    @property
    def total_memory_gb(self) -> float:
        return self.node.memory_gb * self.scale_out

    @property
    def price_per_hour(self) -> float:
        return self.node.price_per_hour * self.scale_out


def enumerate_cluster_configs() -> List[ClusterConfig]:
    configs = []
    for nt in NODE_TYPES.values():
        for so in SCALE_OUTS[nt.size]:
            configs.append(ClusterConfig(node=nt, scale_out=so))
    configs.sort(key=lambda c: (c.node.family, c.node.cores, c.scale_out))
    return configs


def make_cluster_search_space() -> SearchSpace:
    """Encode each configuration "by its principal features like the number
    of cores and the amount of memory" (paper §III-E / CherryPick §4)."""
    configs = enumerate_cluster_configs()
    return SearchSpace(
        [
            Configuration(
                name=c.name,
                features=(
                    float(c.total_cores),
                    float(c.total_memory_gb),
                    float(c.scale_out),
                    float(c.node.memory_gb / c.node.cores),  # mem per core
                ),
                total_memory=c.total_memory_gb * GiB,
                num_nodes=c.scale_out,
                meta=c,
            )
            for c in configs
        ]
    )
