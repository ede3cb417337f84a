"""Architecture registry: get_config(name) / get_smoke(name) / ARCHS.

The ten configurations as dataclasses, no weights: a model starts from
random weights made from a seeded generator, or from weights carried
across (``repro_torch.models.transformer.params_from_numpy``)."""
from __future__ import annotations

import importlib

_MODULES = {
    "internvl2-76b": "internvl2_76b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen3-14b": "qwen3_14b",
    "nemotron-4-15b": "nemotron_4_15b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "zamba2-2.7b": "zamba2_2_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "xlstm-125m": "xlstm_125m",
    "dbrx-132b": "dbrx_132b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
}

ARCHS = tuple(_MODULES)


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _mod(name).CONFIG


def get_smoke(name: str):
    return _mod(name).SMOKE
