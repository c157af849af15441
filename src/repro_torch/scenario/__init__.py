"""Scenario multiplexing: many workloads over one resident ROM trunk
(port of ``repro.scenario``).

Switching a chip between datasets or tasks is a branch swap, not a model
reload: the ROM trunk never moves, only the small SRAM state changes.

  * :mod:`repro_torch.scenario.branch` — split a params tree into trunk
    and branch, validate a branch's geometry, fingerprint placement
    plans, and swap a branch over the resident trunk (the trunk tensors
    pass through as the same objects: not one ROM byte is copied).
  * :mod:`repro_torch.scenario.store`  — :class:`ScenarioStore`: named
    branch sources (in memory, bundles, branch checkpoints) with an LRU
    device cache.
"""

from repro_torch.scenario.branch import (BranchBundle,  # noqa: F401
                                         branch_template, extract, implant,
                                         plan_fingerprint, split_params,
                                         swap_params, validate_branch)
from repro_torch.scenario.store import ScenarioStore  # noqa: F401
