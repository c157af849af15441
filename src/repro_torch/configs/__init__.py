"""Architecture registry (port of ``repro.configs``, the dense family).

Each module defines FULL (the published config) and SMOKE (a reduced
same-family config that runs on the CPU).  ``get(name)`` /
``get_smoke(name)`` look them up.  The other families' configs wait for
their models (ROADMAP Queue 1 item 3, with the vlm and audio branches).
"""

from __future__ import annotations

import importlib

DENSE_ARCHS = ["yi_34b", "qwen15_32b", "gemma_2b", "deepseek_67b"]


def get(name: str):
    return importlib.import_module(f"repro_torch.configs.{name}").FULL


def get_smoke(name: str):
    return importlib.import_module(f"repro_torch.configs.{name}").SMOKE
