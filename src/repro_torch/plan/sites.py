"""The site protocol: a model's enumerable tree of trunk weight groups
(port of ``repro.plan.sites``, CNN part).

A *site* is a named group of trunk weights that one ``ReBranchSpec``
governs — the unit the paper maps onto ROM-CiM vs SRAM-CiM (Fig. 12).
Site names are dotted paths resolved by ``models.config.spec_for``
(longest prefix).  For the CNNs the sites are the convs enumerated by
``models.cnn.conv_site_shapes`` ('stem', 'convs.N', 'stages.S.B.convK',
'head.N').  The LM families' site trees wait for the LM slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Site:
    """One named trunk parameter group: trunk weights and MACs per
    inference per occurrence, ``count`` identical occurrences, and the
    representative weight shape (k, k, c_in, c_out)."""
    name: str
    kind: str                       # 'conv' (matmul sites: LM slice)
    weights: int
    macs: int
    count: int = 1
    shape: tuple = ()

    @property
    def total_weights(self) -> int:
        return self.weights * self.count

    @property
    def total_macs(self) -> int:
        return self.macs * self.count

    def branch_costs(self, spec) -> tuple:
        """(rom_proj_weights, core_weights, branch_macs) per occurrence:
        C/U projections are fixed (ROM), the core is the SRAM tensor."""
        k, _, c_in, c_out = self.shape
        c_c = max(1, c_in // spec.d_ratio)
        c_u = max(1, c_out // spec.u_ratio)
        reuse = self.macs / max(1, self.weights)   # spatial positions
        proj = c_in * c_c + c_u * c_out
        core = k * k * c_c * c_u
        return proj, core, int((proj + k * k * c_c * c_u) * reuse)


def site_tree(cfg) -> tuple:
    """The enumerated, ordered site tree of a CNN config."""
    from repro_torch.models import cnn
    if not isinstance(cfg, cnn.CNNConfig):
        raise NotImplementedError(
            f"site trees of the LM families are not ported yet (ROADMAP "
            f"Queue 1 item 12); got {type(cfg).__name__}")
    shapes = cnn.conv_site_shapes(cfg)
    if shapes is None:
        raise ValueError(
            f"cannot enumerate sites for CNN {cfg.name!r}: not in "
            f"models.cnn.MODEL_REGISTRY")
    return tuple(Site(name=site, kind="conv", weights=k * k * c_in * c_out,
                      macs=hw * hw * k * k * c_in * c_out,
                      shape=(k, k, c_in, c_out))
                 for site, k, c_in, c_out, hw, _stride in shapes)


def try_site_tree(cfg):
    """site_tree, or None when the config's sites cannot be enumerated."""
    try:
        return site_tree(cfg)
    except ValueError:
        return None


def valid_addresses(tree) -> set:
    """Leaf site names plus all their dotted ancestor prefixes."""
    out = set()
    for site in tree:
        parts = site.name.split(".")
        for i in range(1, len(parts) + 1):
            out.add(".".join(parts[:i]))
    return out
