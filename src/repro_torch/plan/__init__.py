"""ROM/SRAM placement (port of ``repro.plan``): the site tree, the frozen
:class:`PlacementPlan` and the cost-driven :func:`solve`."""

from repro_torch.plan.placement import (PlacementPlan, PlanStats,  # noqa: F401
                                        normalize_override)
from repro_torch.plan.sites import (Site, site_tree,  # noqa: F401
                                    try_site_tree, valid_addresses)
from repro_torch.plan.solve import solve  # noqa: F401
