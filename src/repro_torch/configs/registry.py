"""Architecture registry: ``--arch <id>`` resolution.

The port runs the dense GQA decoder family; :data:`ARCH_IDS` lists the
architectures it has, and :data:`UNPORTED_ARCH_IDS` the rest of the JAX
package's registry, which :func:`get_config` refuses by name.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

_MODULES = {
    "granite-3-8b": "granite_3_8b",
    "minitron-8b": "minitron_8b",
    "qwen3-14b": "qwen3_14b",
}

ARCH_IDS = list(_MODULES)

# in the JAX package's registry, not yet in the port (MoE, MLA, SSM,
# RWKV, hybrid, encoder-decoder and vision families)
UNPORTED_ARCH_IDS = ["pixtral-12b", "minicpm3-4b", "qwen2-moe-a2.7b",
                     "whisper-base", "qwen3-moe-235b-a22b", "zamba2-7b",
                     "rwkv6-7b"]


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in UNPORTED_ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not yet ported to repro_torch; ported: "
            f"{ARCH_IDS}; not yet ported: {UNPORTED_ARCH_IDS}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(ARCH_IDS)
