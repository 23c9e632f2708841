"""Architecture configs the port supports so far.

``get_config(arch_id)`` returns the exact published configuration and
``get_smoke_config(arch_id)`` the reduced same-family variant the CPU tests
use.  An architecture the JAX package has but the port has not reached yet
raises, naming the ROADMAP queue that ports it.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ModelConfig

ARCH_IDS: List[str] = ["qwen3_0_6b", "qwen3_moe_235b_a22b",
                       "granite_moe_1b_a400m", "mamba2_130m",
                       "recurrentgemma_9b"]

_ALIASES: Dict[str, str] = {
    "qwen3-0.6b": "qwen3_0_6b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "mamba2-130m": "mamba2_130m",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def canonical(arch_id: str) -> str:
    return _ALIASES.get(arch_id, arch_id)


def _module(arch_id: str):
    name = canonical(arch_id)
    if name not in ARCH_IDS:
        raise KeyError(
            f"arch {arch_id!r} is not ported yet (the port has {ARCH_IDS}); "
            f"the other architectures wait in ROADMAP.md queue A "
            f"(items A11-A12)")
    return importlib.import_module(f".{name}", __name__)


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


__all__ = ["ARCH_IDS", "ModelConfig", "canonical", "get_config",
           "get_smoke_config"]
