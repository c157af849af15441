"""Architecture registry (port of ``repro.configs``: the dense, moe,
ssm and hybrid families).

Each module defines FULL (the published config) and SMOKE (a reduced
same-family config that runs on the CPU).  ``get(name)`` /
``get_smoke(name)`` look them up.  The vlm (qwen2-vl, M-RoPE) and audio
(musicgen, multi-codebook) configs wait for their transformer branches
(ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import importlib

DENSE_ARCHS = ["yi_34b", "qwen15_32b", "gemma_2b", "deepseek_67b"]
MOE_ARCHS = ["granite_moe_3b", "qwen2_moe_a2_7b"]
SSM_ARCHS = ["falcon_mamba_7b"]
HYBRID_ARCHS = ["hymba_1_5b"]
PORTED_ARCHS = DENSE_ARCHS + MOE_ARCHS + SSM_ARCHS + HYBRID_ARCHS


def get(name: str):
    return importlib.import_module(f"repro_torch.configs.{name}").FULL


def get_smoke(name: str):
    return importlib.import_module(f"repro_torch.configs.{name}").SMOKE
