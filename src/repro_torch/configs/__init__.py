"""Architecture registry (port of ``repro.configs``): the ten assigned
archs of every family.

Each module defines FULL (the published config) and SMOKE (a reduced
same-family config that runs on the CPU).  ``get(name)`` /
``get_smoke(name)`` look them up; ``ALL_ARCHS`` lists the ten in the
reference's order, ``SHAPES`` and ``cells`` its (arch x shape) cells.
"""

from __future__ import annotations

import importlib

DENSE_ARCHS = ["yi_34b", "qwen15_32b", "gemma_2b", "deepseek_67b"]
VLM_ARCHS = ["qwen2_vl_2b"]
AUDIO_ARCHS = ["musicgen_large"]
MOE_ARCHS = ["granite_moe_3b", "qwen2_moe_a2_7b"]
SSM_ARCHS = ["falcon_mamba_7b"]
HYBRID_ARCHS = ["hymba_1_5b"]

ALL_ARCHS = [
    "musicgen_large", "qwen2_vl_2b", "yi_34b", "qwen15_32b", "gemma_2b",
    "deepseek_67b", "granite_moe_3b", "qwen2_moe_a2_7b", "hymba_1_5b",
    "falcon_mamba_7b",
]
PORTED_ARCHS = list(ALL_ARCHS)

# shape cells (assigned): name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def get(name: str):
    return importlib.import_module(f"repro_torch.configs.{name}").FULL


def get_smoke(name: str):
    return importlib.import_module(f"repro_torch.configs.{name}").SMOKE


def cells(arch_name: str):
    """The (arch x shape) cells this arch executes; long_500k only for
    sub-quadratic families."""
    cfg = get(arch_name)
    out = []
    for shape, (seq, gb, kind) in SHAPES.items():
        if shape == "long_500k" and not cfg.supports_long_context:
            continue
        out.append((shape, seq, gb, kind))
    return out
