"""Cost-driven ROM/SRAM placement, the Fig. 12 tradeoff as a greedy
solver (port of ``repro.plan.solve``).

Every site starts ROM (the minimum-area YOLoC design point); sites then
flip to SRAM in ascending order of the extra area the flip costs until
the area budget is spent.  Area is priced with the Table-I densities of
``core.energy.CostModel``.  :func:`sweep` walks budgets from all-ROM to
all-SRAM and prices each point (the Fig. 12 area map as data); its
records equal the JAX package's, point for point.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.energy import DEFAULT_COST, CostModel
from repro_torch.plan import sites as sites_lib
from repro_torch.plan.placement import PlacementPlan, PlanStats


def plan_area_mm2(stats: PlanStats, cm: CostModel = DEFAULT_COST) -> float:
    """Chip area of a plan: ROM bits at ROM density, everything
    SRAM-resident (branch cores + SRAM trunks) at SRAM density."""
    return (stats.rom_bits / 1e6 / cm.rom_density_mb_mm2
            + (stats.branch_bits + stats.sram_bits) / 1e6
            / cm.sram_density_mb_mm2)


def plan_energy_mj(stats: PlanStats, cm: CostModel = DEFAULT_COST) -> float:
    """MAC energy per unit of work (inference for CNNs, token for LMs):
    ROM-resident MACs at ROM efficiency, branch + SRAM MACs at SRAM
    efficiency.  Activation-movement terms live in ``core.energy`` (they
    need the traced activation traffic, not the site tree)."""
    pj = (stats.rom_macs * cm.rom_pj_per_mac
          + (stats.branch_macs + stats.sram_macs) * cm.sram_pj_per_mac)
    return pj * 1e-9


def efficiency_vs_iso_sram(stats: PlanStats,
                           cm: CostModel = DEFAULT_COST,
                           reload_factor: float = 1.0) -> float:
    """Energy ratio of the iso-area all-SRAM-CiM chip over this plan
    (the Fig. 13(b)-style comparison, MAC + weight-reload terms).

    The baseline chip gets the plan's area in SRAM-CiM; trunk weights
    beyond its capacity stream from DRAM ``reload_factor`` times per
    unit of work.
    """
    area = plan_area_mm2(stats, cm)
    capacity_bits = area * cm.sram_density_mb_mm2 * 1e6
    reload_bits = max(0.0, stats.weight_bits_total - capacity_bits)
    base_pj = (stats.total_macs * cm.sram_pj_per_mac
               + reload_bits * reload_factor * cm.dram_pj_per_bit)
    ours_pj = plan_energy_mj(stats, cm) * 1e9
    return base_pj / max(ours_pj, 1e-30)


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


def sweep(cfg, n_points: int = 8, *, cm: CostModel = DEFAULT_COST,
          engine: str | None = None, reload_factor: float = 1.0) -> list:
    """Walk area budgets from all-ROM to all-SRAM; one record per point.

    Records carry the budget, the solved plan, its stats and the priced
    outputs (area, MAC energy, iso-area-SRAM efficiency ratio, SRAM site
    names) — the Fig. 12 area map as data.
    """
    all_rom = solve(cfg, None, cm=cm, engine=engine)
    lo = plan_area_mm2(all_rom.stats(cfg), cm)
    tree = sites_lib.site_tree(cfg)
    hi = sum(_site_areas(s, all_rom.default, cm)[1] for s in tree)
    out = []
    for i in range(n_points):
        budget = lo + (hi - lo) * i / max(1, n_points - 1)
        plan = solve(cfg, budget, cm=cm, engine=engine)
        stats = plan.stats(cfg)
        out.append({
            "model": cfg.name,
            "budget_mm2": round(budget, 3),
            "area_mm2": round(plan_area_mm2(stats, cm), 3),
            "energy_mj": plan_energy_mj(stats, cm),
            "efficiency_x": round(
                efficiency_vs_iso_sram(stats, cm, reload_factor), 3),
            "rom_sites": stats.rom_sites,
            "sram_sites": stats.sram_sites,
            "sram_site_names": [s for s, sp in plan.entries
                                if not sp.enabled],
            "plan": plan,
        })
    return out
