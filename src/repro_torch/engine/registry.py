"""The TrunkEngine registry (port of ``repro.engine.registry``): named
backends, strict resolution — an unknown name raises with the registered
set, never falls through to a default."""

from __future__ import annotations

from repro_torch.engine.base import TrunkEngine

_REGISTRY: dict[str, TrunkEngine] = {}


def register(name: str, engine: TrunkEngine, *, override: bool = False):
    """Register ``engine`` under ``name``; re-registering needs
    ``override=True``.  Returns the engine."""
    if not isinstance(name, str) or not name:
        raise ValueError(f"engine name must be a non-empty str, got {name!r}")
    if name in _REGISTRY and not override:
        raise ValueError(
            f"engine {name!r} is already registered "
            f"({_REGISTRY[name]!r}); pass override=True to replace it")
    _REGISTRY[name] = engine
    return engine


def registered_names() -> list[str]:
    return sorted(_REGISTRY)


def get(name: str) -> TrunkEngine:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown trunk engine {name!r}: registered engines are "
            f"{registered_names()}") from None


def resolve(spec_or_name) -> TrunkEngine:
    """A ``ReBranchSpec`` (via ``.trunk_impl``, capability-checked) or a
    bare name -> its engine."""
    if isinstance(spec_or_name, str):
        return get(spec_or_name)
    engine = get(spec_or_name.trunk_impl)
    engine.check(spec_or_name)
    return engine
