"""Serving runtime (port of ``repro.serve``, CNN part): a strict model
registry compiling one resident cell per id, and ``CNNServer``."""

from repro_torch.serve.registry import (ModelEntry, compile_entry,  # noqa: F401
                                        register, registered_ids, resolve)
from repro_torch.serve.server import CNNServer, load  # noqa: F401
