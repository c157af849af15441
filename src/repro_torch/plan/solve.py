"""Cost-driven ROM/SRAM placement, the Fig. 12 tradeoff as a greedy
solver (port of ``repro.plan.solve.solve``).

Every site starts ROM (the minimum-area YOLoC design point); sites then
flip to SRAM in ascending order of the extra area the flip costs until
the area budget is spent.  Area is priced with the Table-I densities of
``core.energy.CostModel``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.energy import DEFAULT_COST, CostModel
from repro_torch.plan import sites as sites_lib
from repro_torch.plan.placement import PlacementPlan


def _site_areas(site: sites_lib.Site, spec, cm: CostModel,
                weight_bits: int = 8):
    """(rom_area, sram_area) in mm^2 for one site under ``spec``."""
    w_bits = site.total_weights * weight_bits
    rom_bits, branch_bits = w_bits, 0
    if spec.branch_enabled:
        proj_w, core_w, _ = site.branch_costs(spec)
        rom_bits += proj_w * site.count * weight_bits
        branch_bits += core_w * site.count * weight_bits
    rom_area = (rom_bits / 1e6 / cm.rom_density_mb_mm2
                + branch_bits / 1e6 / cm.sram_density_mb_mm2)
    sram_area = w_bits / 1e6 / cm.sram_density_mb_mm2
    return rom_area, sram_area


def solve(cfg, budget_mm2: float | None = None, *,
          cm: CostModel = DEFAULT_COST, engine: str | None = None,
          weight_bits: int = 8) -> PlacementPlan:
    """Greedy ROM/SRAM residency under an area budget.

    budget_mm2: total chip area; ``None`` or anything at/below the
        all-ROM area gives the all-ROM plan.
    engine: optional trunk-engine name for the plan's default spec.
    """
    default = cfg.rebranch
    if engine is not None:
        default = dataclasses.replace(default, trunk_impl=engine)
    priced = []
    base_area = 0.0
    for site in sites_lib.site_tree(cfg):
        rom_a, sram_a = _site_areas(site, default, cm, weight_bits)
        base_area += rom_a
        priced.append((sram_a - rom_a, site))
    spend = (budget_mm2 - base_area) if budget_mm2 is not None else 0.0

    assignments = {}
    sram_spec = dataclasses.replace(default, enabled=False)
    for delta, site in sorted(priced, key=lambda p: (p[0], p[1].name)):
        if delta > spend:
            break
        spend -= delta
        assignments[site.name] = sram_spec
    return PlacementPlan.build(cfg, assignments, default=default)
