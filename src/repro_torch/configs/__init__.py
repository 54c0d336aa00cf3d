"""Architecture registry of the port (port of `repro/configs/__init__.py`).

It holds the architectures ported so far; `get` of one of the reference's
other architectures raises `NotImplementedError` naming the ROADMAP item
that ports it.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import mamba2_370m, qwen3_8b
from repro_torch.configs.base import ArchSpec, ExecConfig, smoke_variant

__all__ = ["ARCHS", "ArchSpec", "ExecConfig", "REGISTRY", "get", "smoke", "smoke_variant"]

REGISTRY: Dict[str, ArchSpec] = {m.SPEC.name: m.SPEC for m in (qwen3_8b, mamba2_370m)}
ARCHS: List[str] = list(REGISTRY)

# The reference's other architectures, and the ROADMAP Queue 1 item that ports each.
NOT_YET_PORTED: Dict[str, str] = {
    "granite-8b": "item 11 (the other dense architectures)",
    "granite-34b": "item 11 (the other dense architectures)",
    "qwen1.5-32b": "item 11 (the other dense architectures)",
    "kimi-k2-1t-a32b": "item 11 (MoE family)",
    "arctic-480b": "item 11 (MoE family)",
    "zamba2-1.2b": "item 11 (hybrid family)",
    "whisper-tiny": "item 11 (encoder-decoder family)",
    "llava-next-mistral-7b": "item 11 (VLM family)",
}


def get(arch: str) -> ArchSpec:
    if arch in REGISTRY:
        return REGISTRY[arch]
    if arch in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: ROADMAP Queue 1 {NOT_YET_PORTED[arch]}"
        )
    raise KeyError(f"unknown arch {arch!r}; available: {ARCHS}")


def smoke(arch: str) -> ArchSpec:
    return smoke_variant(get(arch))
