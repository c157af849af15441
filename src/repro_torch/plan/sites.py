"""The site protocol: a model's enumerable tree of trunk weight groups
(port of ``repro.plan.sites``).

A *site* is a named group of trunk weights that one ``ReBranchSpec``
governs — the unit the paper maps onto ROM-CiM vs SRAM-CiM (Fig. 12).
Site names are dotted paths resolved by ``models.config.spec_for``
(longest prefix).  For the CNNs the sites are the convs enumerated by
``models.cnn.conv_site_shapes`` ('stem', 'convs.N', 'stages.S.B.convK',
'head.N'); for the transformer family (dense/vlm/audio) they are
``blocks.attn``, ``blocks.mlp`` and the untied readout (``lm_head`` or
``codebook_head``); moe: ``blocks.attn``, ``blocks.moe``, the readout;
ssm (mamba): ``blocks.{in,x,dt,out}_proj``, ``lm_head``; hybrid (hymba):
``blocks.attn``, ``blocks.ssm.{in,x,dt,out}_proj``, ``blocks.mlp``,
``lm_head``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Site:
    """One named trunk parameter group: trunk weights and MACs per unit of
    work (token for LMs, inference for CNNs) per occurrence, ``count``
    identical occurrences (stacked layers), the representative weight
    shape ((d_in, d_out) or (k, k, c_in, c_out)), and for composite
    matmul sites their ``members`` ((label, (d_in, d_out)), ...).

    ``branch_members`` ((d_in, d_out, core_rep, core_active), ...) is the
    ReBranch accounting per occurrence: ``core_rep`` replicas of the core
    share ONE fixed C/U pair (stacked MoE experts: rep = E), of which
    ``core_active`` run per token (top-k); ``None`` derives it from
    ``members`` with rep = active = 1."""
    name: str
    kind: str                       # 'matmul' | 'conv'
    weights: int
    macs: int
    count: int = 1
    shape: tuple = ()
    members: tuple = ()
    branch_members: tuple | None = None

    @property
    def total_weights(self) -> int:
        return self.weights * self.count

    @property
    def total_macs(self) -> int:
        return self.macs * self.count

    def branch_costs(self, spec) -> tuple:
        """(rom_proj_weights, core_weights, branch_macs) per occurrence:
        C/U projections are fixed (ROM), the core is the SRAM tensor
        (``core.rebranch.init_linear`` / ``models.cnn.init_conv`` /
        ``models.moe.init_expert_linear``)."""
        if self.kind == "conv":
            k, _, c_in, c_out = self.shape
            c_c = max(1, c_in // spec.d_ratio)
            c_u = max(1, c_out // spec.u_ratio)
            reuse = self.macs / max(1, self.weights)   # spatial positions
            proj = c_in * c_c + c_u * c_out
            core = k * k * c_c * c_u
            return proj, core, int((proj + k * k * c_c * c_u) * reuse)
        bm = self.branch_members
        if bm is None:
            bm = tuple((a, b, 1, 1)
                       for _, (a, b) in (self.members or
                                         (("w", self.shape),)))
        proj = core = bmacs = 0
        for d_in, d_out, rep, active in bm:
            d_c = max(1, d_in // spec.d_ratio)
            d_u = max(1, d_out // spec.u_ratio)
            proj += d_in * d_c + d_u * d_out
            core += d_c * d_u * rep
            bmacs += (d_in * d_c + d_c * d_u + d_u * d_out) * active
        return proj, core, bmacs


def _matmul_site(name: str, members, count: int = 1) -> Site:
    """Composite matmul site: members are (label, (d_in, d_out)) pairs;
    MACs per token = weight count."""
    members = tuple((lbl, tuple(shape)) for lbl, shape in members)
    w = sum(a * b for _, (a, b) in members)
    single = members[0][1] if len(members) == 1 else ()
    return Site(name=name, kind="matmul", weights=w, macs=w, count=count,
                shape=single, members=members)


def _attn_members(cfg):
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return [("q", (d, h * dh)), ("k", (d, kv * dh)),
            ("v", (d, kv * dh)), ("o", (h * dh, d))]


def _mlp_members(cfg, d_ff=None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        return [("gate", (d, ff)), ("up", (d, ff)), ("down", (ff, d))]
    return [("up", (d, ff)), ("down", (ff, d))]


def _head_sites(cfg):
    if cfg.num_codebooks:
        return [_matmul_site("codebook_head",
                             [("w", (cfg.d_model,
                                     cfg.num_codebooks * cfg.vocab_size))])]
    if cfg.tie_embeddings:
        return []                   # readout reuses the ROM embedding table
    return [_matmul_site("lm_head", [("w", (cfg.d_model, cfg.vocab_size))])]


def _moe_site(cfg) -> Site:
    """Stacked ReBranch experts: weights cover all E experts, MACs per
    token the top-k active ones (plus the always-on shared experts); the
    experts share one C/U pair per stack with a per-expert core
    (``models.moe.init_expert_linear``): (d_in, d_out, rep=E, active=k)."""
    d, ff, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts
    k = cfg.num_experts_per_tok
    members = [("gate", (d, ff)), ("up", (d, ff)), ("down", (ff, d))]
    w_expert = sum(a * b for _, (a, b) in members)
    weights, macs = e * w_expert, k * w_expert
    all_members = [(f"experts.{lbl}", (e * a, b)) for lbl, (a, b) in members]
    branch = [(a, b, e, k) for _, (a, b) in members]
    if cfg.num_shared_experts:
        shared = _mlp_members(cfg, d_ff=cfg.num_shared_experts * ff)
        w_shared = sum(a * b for _, (a, b) in shared)
        weights += w_shared
        macs += w_shared
        all_members += [(f"shared.{lbl}", shape) for lbl, shape in shared]
        branch += [(a, b, 1, 1) for _, (a, b) in shared]
    return Site(name="blocks.moe", kind="matmul", weights=weights,
                macs=macs, count=cfg.num_layers,
                members=tuple((lbl, tuple(s)) for lbl, s in all_members),
                branch_members=tuple(branch))


def _ssm_proj_sites(cfg, prefix: str) -> list:
    d, di, n, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    return [_matmul_site(f"{prefix}.{name}", [("w", shape)],
                         count=cfg.num_layers)
            for name, shape in (("in_proj", (d, 2 * di)),
                                ("x_proj", (di, dtr + 2 * n)),
                                ("dt_proj", (dtr, di)),
                                ("out_proj", (di, d)))]


def _arch_sites(cfg) -> list:
    fam = cfg.family
    attn = _matmul_site("blocks.attn", _attn_members(cfg),
                        count=cfg.num_layers)
    if fam in ("dense", "vlm", "audio"):
        return [attn, _matmul_site("blocks.mlp", _mlp_members(cfg),
                                   count=cfg.num_layers)] + _head_sites(cfg)
    if fam == "moe":
        return [attn, _moe_site(cfg)] + _head_sites(cfg)
    # ssm/hybrid always build a real lm_head (their families ignore
    # tie_embeddings/num_codebooks), so the site is unconditional
    lm_head = _matmul_site("lm_head", [("w", (cfg.d_model,
                                              cfg.vocab_size))])
    if fam == "ssm":
        return _ssm_proj_sites(cfg, "blocks") + [lm_head]
    if fam == "hybrid":
        return ([attn] + _ssm_proj_sites(cfg, "blocks.ssm")
                + [_matmul_site("blocks.mlp", _mlp_members(cfg),
                                count=cfg.num_layers), lm_head])
    raise ValueError(f"no site tree for model family {fam!r}")


def site_tree(cfg) -> tuple:
    """The enumerated, ordered site tree of ``cfg``."""
    from repro_torch.models import cnn
    if not isinstance(cfg, cnn.CNNConfig):
        return tuple(_arch_sites(cfg))
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
