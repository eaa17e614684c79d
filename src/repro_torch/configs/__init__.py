"""Architecture registry of the port: only the configurations the port
runs.  Access via ``get_config(name)`` / ``list_configs()``; smoke
variants via ``get_smoke_config(name)``."""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig, reduced

_MODULES = {
    # the paper's primary evaluation model
    "qwen3-30b-a3b": "qwen3_30b_a3b",
}


def list_configs() -> List[str]:
    return list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG.validate()


def get_smoke_config(name: str) -> ModelConfig:
    return reduced(get_config(name))
