"""Architecture registry: the 10 assigned configs + smoke twins."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (LM_SHAPES, ModelConfig, ShapeConfig,
                                active_param_count, param_count, shapes_for)

_MODULES = {
    "mixtral-8x22b": "mixtral_8x22b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "whisper-base": "whisper_base",
    "llama3-405b": "llama3_405b",
    "qwen2-7b": "qwen2_7b",
    "qwen1.5-4b": "qwen15_4b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "mamba2-370m": "mamba2_370m",
    "llava-next-34b": "llava_next_34b",
    "jamba-1.5-large-398b": "jamba15_large",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[:-len("-smoke")]).smoke()
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}


__all__ = ["ARCH_NAMES", "LM_SHAPES", "ModelConfig", "ShapeConfig",
           "active_param_count", "all_configs", "get_config", "param_count",
           "shapes_for"]
