"""Arch registry of the port: ``--arch <id>`` -> ModelConfig and its
reduced smoke config, for the architectures the port serves so far."""
from __future__ import annotations

import importlib

from .base import ModelConfig

_MODULES = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "yi-6b": "yi_6b",
    "bert-base": "bert_base",
    "llama-3.2-vision-11b": "llama3_2_vision_11b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "qwen3-14b": "qwen3_14b",
    "minicpm3-4b": "minicpm3_4b",
    "whisper-base": "whisper_base",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
}

# the serving / training archs; bert-base (the paper's encoder) stays out,
# as in the reference's registry
ARCH_IDS = [k for k in _MODULES if k != "bert-base"]


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
