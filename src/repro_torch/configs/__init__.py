"""Architecture registry of the port (port of `repro/configs/__init__.py`).

The reference's ten architectures, in its order, as selectable configs
(``--arch <id>``), their smoke variants, and the shape cells
(`configs.shapes`).
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (
    arctic_480b,
    granite_34b,
    granite_8b,
    kimi_k2_1t_a32b,
    llava_next_mistral_7b,
    mamba2_370m,
    qwen15_32b,
    qwen3_8b,
    whisper_tiny,
    zamba2_1p2b,
)
from repro_torch.configs.base import ArchSpec, ExecConfig, smoke_variant
from repro_torch.configs.shapes import CELLS, ShapeCell, cell_applicable, input_specs

__all__ = ["ARCHS", "ArchSpec", "CELLS", "ExecConfig", "REGISTRY", "ShapeCell",
           "cell_applicable", "get", "input_specs", "smoke", "smoke_variant"]

_MODULES = [
    whisper_tiny,
    kimi_k2_1t_a32b,
    arctic_480b,
    zamba2_1p2b,
    granite_8b,
    granite_34b,
    qwen3_8b,
    qwen15_32b,
    mamba2_370m,
    llava_next_mistral_7b,
]

REGISTRY: Dict[str, ArchSpec] = {m.SPEC.name: m.SPEC for m in _MODULES}
ARCHS: List[str] = list(REGISTRY)


def get(arch: str) -> ArchSpec:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCHS}")
    return REGISTRY[arch]


def smoke(arch: str) -> ArchSpec:
    return smoke_variant(get(arch))
