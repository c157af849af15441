"""Model registry: model id -> (config, plan, engine) -> one resident cell
(port of ``repro.serve.registry``: the CNN entries and the dense LM smoke
entries).

Resolution is strict: an unknown id raises with the registered set.
``compile_entry`` compiles an id at most once per process and shares the
cell.  The LRU residency cap, tuning policy and scenario stores wait for
later slices (ROADMAP Queue 1 items 10 and 14).
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
    """
    model_id: str
    config: Callable[[], Any]
    plan: Callable[[Any], Any] | None = None
    engine: str | None = None


_REGISTRY: dict[str, ModelEntry] = {}
_COMPILED: dict[str, tuple] = {}          # id -> (CompiledModel, plan)
_LOCK = threading.Lock()


def register(entry: ModelEntry, *, override: bool = False) -> ModelEntry:
    """Publish ``entry`` under its id; a duplicate id raises unless
    ``override=True``, which also drops the id's resident cell."""
    with _LOCK:
        if entry.model_id in _REGISTRY and not override:
            raise ValueError(
                f"model id {entry.model_id!r} already registered; pass "
                f"override=True to replace it")
        _REGISTRY[entry.model_id] = entry
        _COMPILED.pop(entry.model_id, None)
    return entry


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
    """The resident cell for ``model_id``: (CompiledModel, plan)."""
    with _LOCK:
        if model_id in _COMPILED:
            return _COMPILED[model_id]
        entry = resolve(model_id)
        cfg = entry.config()
        plan = (entry.plan(cfg) if entry.plan is not None
                else plan_lib.solve(cfg, None, engine=entry.engine))
        cell = (deploy.compile_model(cfg, plan=plan), plan)
        _COMPILED[model_id] = cell
        return cell


for _arch in configs.DENSE_ARCHS:
    register(ModelEntry(
        model_id=_arch.replace("_", "-") + "-smoke",
        config=(lambda a=_arch: configs.get_smoke(a))))
for _name in ("vgg8", "resnet18", "darknet19", "tiny_yolo"):
    register(ModelEntry(
        model_id=_name.replace("_", "-") + "-32",
        config=(lambda n=_name: cnn.CNNConfig(name=n, input_size=32))))
del _arch, _name
