"""Arch registry of the port: ``--arch <id>`` -> ModelConfig and its
reduced smoke config, for the architectures the port serves so far."""
from __future__ import annotations

import importlib

from .base import ModelConfig

_MODULES = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "yi-6b": "yi_6b",
}

ARCH_IDS = list(_MODULES)


def _mod(arch_id: str):
    try:
        return importlib.import_module(
            f"repro_torch.configs.{_MODULES[arch_id]}")
    except KeyError:
        raise ValueError(f"unknown arch {arch_id!r}; the port has "
                         f"{sorted(_MODULES)}")


def get_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).CONFIG


def reduced_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).REDUCED
