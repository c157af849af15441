"""PlacementPlan: the site -> (engine, spec, residency) mapping (port of
``repro.plan.placement``).

A spec with ``enabled=True`` is a ROM trunk, ``enabled=False`` a plain
SRAM-trainable layer.  ``PlanStats`` aggregates ROM / SRAM bits and MACs
over the site tree and feeds the solver.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core import cim as cim_lib
from repro_torch.core.rebranch import ReBranchSpec
from repro_torch.engine.base import TrunkEngine
from repro_torch.models.config import resolve_override
from repro_torch.plan import sites as sites_lib

OVERRIDE_KEYS = ("engine", "memory", "cim", "branch_enabled",
                 "d_ratio", "u_ratio")


def normalize_override(base: ReBranchSpec, site: str, ov) -> ReBranchSpec:
    """One override entry (dict or full spec) -> a concrete ReBranchSpec."""
    if isinstance(ov, ReBranchSpec):
        return ov
    if not isinstance(ov, dict):
        raise TypeError(
            f"override for {site!r} must be a dict or ReBranchSpec, "
            f"got {type(ov).__name__}")
    unknown = sorted(set(ov) - set(OVERRIDE_KEYS))
    if unknown:
        raise ValueError(
            f"override for {site!r}: unknown keys {unknown} "
            f"(valid: {list(OVERRIDE_KEYS)})")
    rep: dict[str, Any] = {}
    if "engine" in ov:
        rep["trunk_impl"] = (ov["engine"].name
                             if isinstance(ov["engine"], TrunkEngine)
                             else ov["engine"])
    if "memory" in ov:
        if ov["memory"] not in ("rom", "sram"):
            raise ValueError(
                f"override for {site!r}: memory must be 'rom' or "
                f"'sram', got {ov['memory']!r}")
        rep["enabled"] = ov["memory"] == "rom"
    if "cim" in ov:
        c = ov["cim"]
        rep["cim"] = (c if isinstance(c, cim_lib.CiMConfig)
                      else dataclasses.replace(base.cim, mode=c))
    for k in ("branch_enabled", "d_ratio", "u_ratio"):
        if k in ov:
            rep[k] = ov[k]
    return dataclasses.replace(base, **rep)


@dataclasses.dataclass(frozen=True)
class PlanStats:
    """Aggregates of a plan over its site tree, at the deployment width."""
    sites: int
    rom_sites: int
    sram_sites: int
    rom_bits: int               # frozen trunk + fixed C/U projections
    rom_trunk_bits: int         # frozen trunk weights only
    branch_bits: int            # trainable ReBranch cores (SRAM-CiM)
    sram_bits: int              # full weights of SRAM-resident sites
    rom_macs: int
    branch_macs: int
    sram_macs: int

    @property
    def total_bits(self) -> int:
        return self.rom_bits + self.branch_bits + self.sram_bits

    @property
    def weight_bits_total(self) -> int:
        """All trunk weights at deployment width (ROM- or SRAM-resident),
        branch structure excluded: the iso-capacity comparison basis."""
        return self.rom_trunk_bits + self.sram_bits

    @property
    def total_macs(self) -> int:
        return self.rom_macs + self.branch_macs + self.sram_macs


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """Frozen site -> ReBranchSpec mapping; ``entries`` hold only the
    sites (or prefixes) that deviate from ``default``, resolved by
    longest prefix like ``models.config.spec_for``."""
    model: str
    default: ReBranchSpec = dataclasses.field(default_factory=ReBranchSpec)
    entries: tuple = ()             # ((address, ReBranchSpec), ...) sorted

    def spec(self, site: str) -> ReBranchSpec:
        return resolve_override(self.entries, site, self.default)

    def residency(self, site: str) -> str:
        return "rom" if self.spec(site).enabled else "sram"

    def as_overrides(self) -> tuple:
        return self.entries

    @classmethod
    def build(cls, cfg, assignments=None, *,
              default: ReBranchSpec | None = None) -> "PlacementPlan":
        """Validated plan from an {address: override} map; addresses
        outside the site tree raise with the valid set."""
        default = cfg.rebranch if default is None else default
        pairs = (sorted(assignments.items())
                 if isinstance(assignments, dict)
                 else list(assignments or ()))
        seen = set()
        for addr, _ in pairs:
            if addr in seen:
                raise ValueError(f"duplicate placement for site {addr!r}")
            seen.add(addr)
        tree = sites_lib.try_site_tree(cfg)
        if tree is not None and pairs:
            valid = sites_lib.valid_addresses(tree)
            unknown = sorted(seen - valid)
            if unknown:
                raise ValueError(
                    f"placement sites {unknown} are not wired for "
                    f"{cfg.name!r}; valid sites: {sorted(valid)}")
        entries = tuple(sorted(
            (addr, normalize_override(default, addr, ov))
            for addr, ov in pairs))
        return cls(model=cfg.name, default=default, entries=entries)

    def stats(self, cfg, weight_bits: int = 8) -> PlanStats:
        """Aggregate ROM/SRAM bits and MACs over the config's site tree."""
        rom_b = rom_tb = branch_b = sram_b = 0
        rom_m = branch_m = sram_m = 0
        n_rom = n_sram = 0
        tree = sites_lib.site_tree(cfg)
        for site in tree:
            spec = self.spec(site.name)
            if not spec.enabled:
                n_sram += 1
                sram_b += site.total_weights * weight_bits
                sram_m += site.total_macs
                continue
            n_rom += 1
            rom_b += site.total_weights * weight_bits
            rom_tb += site.total_weights * weight_bits
            rom_m += site.total_macs
            if spec.branch_enabled:
                proj_w, core_w, bmacs = site.branch_costs(spec)
                rom_b += proj_w * site.count * weight_bits
                branch_b += core_w * site.count * weight_bits
                branch_m += bmacs * site.count
        return PlanStats(sites=len(tree), rom_sites=n_rom,
                         sram_sites=n_sram, rom_bits=rom_b,
                         rom_trunk_bits=rom_tb, branch_bits=branch_b,
                         sram_bits=sram_b, rom_macs=rom_m,
                         branch_macs=branch_m, sram_macs=sram_m)
