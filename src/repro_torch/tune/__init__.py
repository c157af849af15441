"""Per-geometry launch plans of the port's kernels, tuned on the H100.

``repro_torch.tune.table`` holds the checked-in table the kernel wrappers
consult at call time; ``repro_torch.tune.autotune`` holds the search
(imported lazily: it pulls in the kernels, which import the table, so an
eager import here would be circular).

Check the table with ``python -m repro_torch.tune --check`` (anywhere);
regenerate it on the card with ``python -m repro_torch.tune``.
"""

from repro_torch.tune import table
from repro_torch.tune.table import (Plan, disabled, load_table, lookup,
                                    overrides, save_table)

__all__ = ["table", "Plan", "disabled", "load_table", "lookup",
           "overrides", "save_table", "autotune"]


def __getattr__(name):
    if name == "autotune":
        # importlib, not ``from repro_torch.tune import autotune``: the
        # from-import resolves the name through THIS __getattr__ first and
        # would recurse before ever importing the submodule
        import importlib
        return importlib.import_module("repro_torch.tune.autotune")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
