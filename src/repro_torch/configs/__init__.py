"""Architecture registry: ``get_config(arch)`` / ``get_smoke_config(arch)``.

Each module defines ``CONFIG`` (the published configuration) and
``smoke_config()`` (a reduced same-family configuration for CPU tests).
The port serves the dense family; of the reference's ten architectures it
registers SmolLM-360M so far (ROADMAP lists the others as still to port).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

ARCH_IDS: List[str] = ["smollm_360m"]

# canonical hyphenated ids → module names
ALIASES: Dict[str, str] = {"smollm-360m": "smollm_360m"}


def _module(arch: str):
    name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"{__name__}.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
