"""ROM/SRAM placement (port of ``repro.plan``): the site tree, the frozen
:class:`PlacementPlan`, the cost-driven :func:`solve` and the Fig. 12
:func:`sweep` with its pricing."""

from repro_torch.plan.placement import (PlacementPlan, PlanStats,  # noqa: F401
                                        normalize_override)
from repro_torch.plan.sites import (Site, site_tree,  # noqa: F401
                                    try_site_tree, valid_addresses)
from repro_torch.plan.solve import (efficiency_vs_iso_sram,  # noqa: F401
                                    plan_area_mm2, plan_energy_mj, solve,
                                    sweep)
