"""Configurations of the port, one for one with ``repro.configs``.

``amidst_pgm``   the paper's plate workloads
``base``         ``ModelConfig`` and the LM input shapes
``<arch>.py``    one ``ModelConfig`` per language-model architecture;
                 ``get_config(name)`` / ``--arch <id>`` resolve them
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

__all__ = ["ARCH_IDS", "INPUT_SHAPES", "InputShape", "ModelConfig",
           "get_config"]

_MODULES = {
    "granite-3-2b": "granite_3_2b",
    "chameleon-34b": "chameleon_34b",
    "glm4-9b": "glm4_9b",
    "gemma-2b": "gemma_2b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "zamba2-1.2b": "zamba2_1_2b",
    "mamba2-1.3b": "mamba2_1_3b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "mixtral-8x7b": "mixtral_8x7b",
    "whisper-medium": "whisper_medium",
}
ARCH_IDS = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[name]}").CONFIG
