"""Config registry: ``get(name)`` / ``--arch <id>`` resolution.

A copy of ``repro.configs``: the same dataclasses (``base``), the ten
assigned architectures at their published widths and ``blest_bfs``'s
geometry constants, in pure Python."""
from __future__ import annotations

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, ShapeConfig, SHAPES, shape_applicable)

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    _ensure_loaded()
    return _REGISTRY[name]


def names() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    # every module's config, every time: repro returns early on a non-empty
    # registry, so importing one config module first (blest_bfs) hides the
    # others from its ``get``
    from repro_torch.configs import (
        stablelm_3b, stablelm_12b, qwen3_4b, tinyllama_1_1b, musicgen_large,
        mamba2_370m, zamba2_7b, qwen2_moe_a2_7b, llama4_maverick,
        internvl2_26b, blest_bfs,
    )
    for mod in (stablelm_3b, stablelm_12b, qwen3_4b, tinyllama_1_1b,
                musicgen_large, mamba2_370m, zamba2_7b, qwen2_moe_a2_7b,
                llama4_maverick, internvl2_26b, blest_bfs):
        _REGISTRY.setdefault(mod.CONFIG.name, mod.CONFIG)


ASSIGNED = [
    "stablelm-3b", "stablelm-12b", "qwen3-4b", "tinyllama-1.1b",
    "musicgen-large", "mamba2-370m", "zamba2-7b", "qwen2-moe-a2.7b",
    "llama4-maverick-400b-a17b", "internvl2-26b",
]
