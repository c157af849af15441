"""Serving runtime (port of ``repro.serve``): a strict model registry
compiling one resident cell per id (LRU-capped, each with an optional
scenario store), ``LMServer`` (continuous batching over a dense or paged
KV pool, chunked prefill, speculative decode with the branch-only draft
and paged rollback, scenario swap barriers, an async ``generate``) and
``CNNServer``."""

from repro_torch.serve.registry import (ModelEntry, compile_entry,  # noqa: F401
                                        evict, has_scenarios, max_resident,
                                        register, registered_ids,
                                        resident_ids, resolve,
                                        scenario_store, set_max_resident)
from repro_torch.serve.pool import (PagedPool, SlotPool,  # noqa: F401
                                    suggest_paged, suggest_slots)
from repro_torch.serve.scheduler import (ContinuousBatcher,  # noqa: F401
                                         Request)
from repro_torch.serve.server import CNNServer, LMServer, load  # noqa: F401
