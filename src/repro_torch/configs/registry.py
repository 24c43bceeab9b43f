"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

import importlib

from repro_torch.configs.shapes import SHAPES, SHAPE_ORDER, ShapeConfig  # noqa

ARCHS = {
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama32_vision_11b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
}

ARCH_ORDER = tuple(ARCHS)


def _module(arch: str):
    try:
        return importlib.import_module(ARCHS[arch])
    except KeyError:
        raise ValueError(
            f"unknown arch {arch!r}; one of {list(ARCHS)}") from None


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke(arch: str):
    return _module(arch).SMOKE


def skip_shapes(arch: str) -> set:
    return set(_module(arch).SKIP_SHAPES)


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells in canonical order."""
    out = []
    for a in ARCH_ORDER:
        skips = skip_shapes(a)
        for s in SHAPE_ORDER:
            if include_skipped or s not in skips:
                out.append((a, s))
    return out
