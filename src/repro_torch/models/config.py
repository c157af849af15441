"""Per-site spec resolution (port of ``repro.models.config.spec_for`` and
``resolve_override``; the LM ``ArchConfig`` waits for the LM slice)."""

from __future__ import annotations


def spec_for(cfg, site: str):
    """The ReBranchSpec governing one named site: the LONGEST matching
    override in ``cfg.rebranch_overrides`` (exact site or ancestor
    prefix), else the config-wide ``cfg.rebranch``."""
    return resolve_override(getattr(cfg, "rebranch_overrides", ()),
                            site, cfg.rebranch)


def resolve_override(entries, site: str, default):
    """Longest-prefix resolution over ((address, spec), ...) entries — the
    one resolver both ``spec_for`` and ``PlacementPlan.spec`` call."""
    best, best_len = None, -1
    for s, spec in entries:
        if (s == site or site.startswith(s + ".")) and len(s) > best_len:
            best, best_len = spec, len(s)
    return default if best is None else best
