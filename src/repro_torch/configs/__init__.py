"""Architecture registry of the port: the configurations the port runs
(the paper's two evaluation models, the four dense GQA decoders, the two
large MoE models and the two recurrent models of the JAX registry).  Access via
``get_config(name)`` / ``list_configs()``; smoke variants via
``get_smoke_config(name)``."""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig, reduced

_MODULES = {
    # the paper's primary evaluation model
    "qwen3-30b-a3b": "qwen3_30b_a3b",
    # the paper's second evaluation model
    "gpt-oss-20b": "gpt_oss_20b",
    # dense GQA decoders of the JAX registry (layernorm and partial RoPE,
    # tied embeddings; group sizes 1, 3 and 7)
    "minicpm-2b": "minicpm_2b",
    "stablelm-1.6b": "stablelm_1_6b",
    "yi-34b": "yi_34b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    # the large MoE models: multi-head latent attention with shared experts
    # and a dense first block; GQA at group size 16
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    # the recurrent models: RG-LRU with local MQA (2:1), and xLSTM's
    # mLSTM/sLSTM (7:1); their per-slot state has no position axis
    "recurrentgemma-9b": "recurrentgemma_9b",
    "xlstm-1.3b": "xlstm_1_3b",
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
