"""Model registry: model id -> (config, plan, engine, tune) -> one
resident cell (port of ``repro.serve.registry``: the CNN entries and the
smoke entries of every ported LM family).

Resolution is strict: an unknown id raises with the registered set.
``compile_entry`` compiles an id at most once per process and shares the
cell; an optional LRU cap (:func:`set_max_resident`) bounds how many
cells stay resident.  Each id may carry a
:class:`~repro_torch.scenario.ScenarioStore` (:func:`scenario_store`):
one resident cell then serves every registered scenario by branch
hot-swap.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable

from repro_torch import configs, deploy
from repro_torch import plan as plan_lib
from repro_torch.models import cnn


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    """Everything needed to deploy one model id.

    config: zero-arg factory returning the ``cnn.CNNConfig`` or
        ``ArchConfig``.
    plan: optional ``cfg -> PlacementPlan`` factory; ``None`` solves the
        minimum-area (all-ROM + branch) design point.
    engine: trunk engine of the solved plan's default spec.
    tune: the tuning-table policy, forwarded to ``deploy.compile_model``
        (``None``/``True``: the table's launch plans; ``False``: the shape
        rule's).
    scenarios: optional ((name, factory), ...) of branch scenarios; each
        factory is ``(model, plan) -> branch tree`` and seeds the id's
        store on its first :func:`scenario_store`.
    """
    model_id: str
    config: Callable[[], Any]
    plan: Callable[[Any], Any] | None = None
    engine: str | None = None
    tune: bool | None = None
    scenarios: tuple = ()


_REGISTRY: dict[str, ModelEntry] = {}
_COMPILED: dict[str, tuple] = {}          # id -> (CompiledModel, plan),
                                          # LRU-ordered: oldest first
_STORES: dict[str, Any] = {}              # id -> ScenarioStore
_LOCK = threading.Lock()
_MAX_RESIDENT: int | None = None          # None -> unbounded residency


def register(entry: ModelEntry, *, override: bool = False) -> ModelEntry:
    """Publish ``entry`` under its id; a duplicate id raises unless
    ``override=True``, which also drops the id's resident cell and its
    scenario store (branches validated against the old cell's geometry
    must never implant onto the new one)."""
    with _LOCK:
        if entry.model_id in _REGISTRY and not override:
            raise ValueError(
                f"model id {entry.model_id!r} already registered; pass "
                f"override=True to replace it")
        _REGISTRY[entry.model_id] = entry
        _drop(entry.model_id)
    return entry


def _drop(model_id: str) -> bool:
    """Drop one id's resident cell and scenario store (caller holds
    ``_LOCK``); the one eviction path.  Returns whether a cell was
    resident."""
    dropped = _COMPILED.pop(model_id, None) is not None
    _STORES.pop(model_id, None)
    return dropped


def evict(model_id: str) -> bool:
    """Drop the resident cell (and scenario store) of ``model_id``; the
    next ``compile_entry`` recompiles.  Returns whether one was resident."""
    with _LOCK:
        return _drop(model_id)


def set_max_resident(n: int | None) -> None:
    """Cap how many compiled cells stay resident (LRU): compiling or
    touching an id past the cap evicts the least recently used one, which
    recompiles on its next load.  ``None`` removes the cap (the default)."""
    global _MAX_RESIDENT
    if n is not None and n < 1:
        raise ValueError(f"max_resident must be >= 1 or None, got {n}")
    with _LOCK:
        _MAX_RESIDENT = n
        _evict_over_cap()


def max_resident() -> int | None:
    """The current residency cap (``None``: unbounded)."""
    return _MAX_RESIDENT


def resident_ids() -> list[str]:
    """Ids with a resident cell, least recently used first."""
    with _LOCK:
        return list(_COMPILED)


def _touch(model_id: str) -> None:
    """Move an id to the most recently used end (caller holds _LOCK)."""
    if model_id in _COMPILED:
        _COMPILED[model_id] = _COMPILED.pop(model_id)


def _evict_over_cap() -> None:
    """Evict LRU residents until under the cap (caller holds _LOCK)."""
    if _MAX_RESIDENT is None:
        return
    while len(_COMPILED) > _MAX_RESIDENT:
        _drop(next(iter(_COMPILED)))       # dict order: oldest first


def registered_ids() -> list[str]:
    return sorted(_REGISTRY)


def resolve(model_id: str) -> ModelEntry:
    try:
        return _REGISTRY[model_id]
    except KeyError:
        raise KeyError(
            f"unknown model id {model_id!r}; registered: "
            f"{registered_ids()}") from None


def compile_entry(model_id: str):
    """The resident cell for ``model_id``: (CompiledModel, plan).

    Compiles outside the lock; a cell whose entry was re-registered while
    it compiled is never published (it would serve the old config).
    """
    while True:
        with _LOCK:
            if model_id in _COMPILED:
                _touch(model_id)           # LRU: a hit is a use
                return _COMPILED[model_id]
        entry = resolve(model_id)
        cfg = entry.config()
        plan = (entry.plan(cfg) if entry.plan is not None
                else plan_lib.solve(cfg, None, engine=entry.engine))
        model = deploy.compile_model(cfg, plan=plan, tune=entry.tune)
        with _LOCK:
            if _REGISTRY.get(model_id) is not entry:
                continue          # re-registered mid-compile: stale cell
            cell = _COMPILED.setdefault(model_id, (model, plan))
            _touch(model_id)
            _evict_over_cap()
            return cell


def has_scenarios(model_id: str) -> bool:
    """True when the id has a live store or entry-declared scenarios."""
    if model_id in _STORES:
        return True
    entry = _REGISTRY.get(model_id)
    return bool(entry is not None and entry.scenarios)


def scenario_store(model_id: str, *, capacity: int = 4, device=None):
    """The id's ScenarioStore, bound to its resident cell: made (and
    seeded from ``ModelEntry.scenarios``) on first use, with its cache on
    ``device`` (default: the CUDA card); one per id per process, shared
    by every server of the id."""
    with _LOCK:
        store = _STORES.get(model_id)
    if store is not None:
        return store
    from repro_torch.scenario import ScenarioStore
    model, plan = compile_entry(model_id)
    store = ScenarioStore(model, plan, capacity=capacity, device=device)
    for name, factory in resolve(model_id).scenarios:
        store.register(name, branch=factory(model, plan))
    with _LOCK:
        return _STORES.setdefault(model_id, store)


for _arch in configs.PORTED_ARCHS:
    register(ModelEntry(
        model_id=_arch.replace("_", "-") + "-smoke",
        config=(lambda a=_arch: configs.get_smoke(a))))
for _name in ("vgg8", "resnet18", "darknet19", "tiny_yolo"):
    register(ModelEntry(
        model_id=_name.replace("_", "-") + "-32",
        config=(lambda n=_name: cnn.CNNConfig(name=n, input_size=32))))
del _arch, _name
