"""Pluggable CiM execution engines (port of ``repro.engine``): every
frozen-trunk conv dispatches through a named :class:`TrunkEngine`
resolved from ``ReBranchSpec.trunk_impl``.  Resolution is strict and
capability-gated."""

from repro_torch.engine.base import (  # noqa: F401
    ConvEpilogue, EngineCapabilities, TrunkEngine,
)
from repro_torch.engine.registry import (  # noqa: F401
    get, register, registered_names, resolve,
)
from repro_torch.engine import builtin as _builtin  # noqa: F401  registers
from repro_torch.engine import sharded as _sharded  # noqa: F401  'pallas_sharded'
