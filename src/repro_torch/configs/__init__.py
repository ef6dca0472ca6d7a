"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``."""
from __future__ import annotations

from .base import ModelConfig, SHAPES, pad_vocab  # noqa: F401

_MODULES = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "starcoder2-15b": "starcoder2_15b",
    "stablelm-12b": "stablelm_12b",
    "smollm-135m": "smollm_135m",
    "hymba-1.5b": "hymba_1_5b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "whisper-tiny": "whisper_tiny",
    "xlstm-125m": "xlstm_125m",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    import dataclasses
    import importlib

    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return dataclasses.replace(mod.CONFIG)  # fresh copy

