"""Architecture registry: `get_config('<arch-id>')` for --arch flags."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

ARCHS = {
    "rwkv6-3b": "rwkv6_3b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "grok-1-314b": "grok1_314b",
    "stablelm-3b": "stablelm_3b",
    "smollm-135m": "smollm_135m",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "minitron-4b": "minitron_4b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "paligemma-3b": "paligemma_3b",
    "musicgen-medium": "musicgen_medium",
    "paper-lsq": "paper_lsq",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.CONFIG


def list_archs():
    return [a for a in ARCHS if a != "paper-lsq"]
