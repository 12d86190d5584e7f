"""Assigned architecture registry: ``get_config(arch_id)`` / ``--arch <id>``."""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "mamba2-780m",
    "deepseek-v3-671b",
    "deepseek-v2-236b",
    "qwen3-14b",
    "command-r-35b",
    "qwen2-1.5b",
    "internlm2-1.8b",
    "whisper-tiny",
    "recurrentgemma-2b",
    "pixtral-12b",
)

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str):
    if arch_id not in _MOD:
        raise KeyError(f"unknown arch {arch_id!r}; choices: {sorted(_MOD)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[arch_id]}")
    return mod.CONFIG


def get_smoke_config(arch_id: str):
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[arch_id]}")
    return mod.SMOKE_CONFIG
