"""Serving runtime (port of ``repro.serve``): a strict model registry
compiling one resident cell per id, ``LMServer`` (continuous batching
over a dense or paged KV pool) and ``CNNServer``."""

from repro_torch.serve.registry import (ModelEntry, compile_entry,  # noqa: F401
                                        register, registered_ids, resolve)
from repro_torch.serve.pool import PagedPool, SlotPool  # noqa: F401
from repro_torch.serve.scheduler import (ContinuousBatcher,  # noqa: F401
                                         Request)
from repro_torch.serve.server import CNNServer, LMServer, load  # noqa: F401
