"""Architecture configs: the JAX package's ten, field for field.

``get_config(arch_id)`` returns the exact published configuration and
``get_smoke_config(arch_id)`` the reduced same-family variant the CPU tests
use (<=2 layers, d_model<=512, <=4 experts).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ModelConfig

ARCH_IDS: List[str] = [
    "qwen3_0_6b",
    "stablelm_1_6b",
    "qwen3_1_7b",
    "starcoder2_15b",
    "recurrentgemma_9b",
    "mamba2_130m",
    "qwen3_moe_235b_a22b",
    "phi_3_vision_4_2b",
    "whisper_medium",
    "granite_moe_1b_a400m",
]

# accepted aliases: the published names, with dashes and dots
_ALIASES: Dict[str, str] = {
    "qwen3-0.6b": "qwen3_0_6b",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen3-1.7b": "qwen3_1_7b",
    "starcoder2-15b": "starcoder2_15b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-130m": "mamba2_130m",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "whisper-medium": "whisper_medium",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
}


def canonical(arch_id: str) -> str:
    return _ALIASES.get(arch_id, arch_id)


def _module(arch_id: str):
    name = canonical(arch_id)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    return importlib.import_module(f".{name}", __name__)


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


__all__ = ["ARCH_IDS", "ModelConfig", "canonical", "get_config",
           "get_smoke_config"]
