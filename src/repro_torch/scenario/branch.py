"""Branch extraction and validation: the swappable half of a deployment
(port of ``repro.scenario.branch``).

A scenario is one trained branch tree over a fixed ROM trunk under a
fixed placement plan: the trainable side of ``rebranch.partition``
(ReBranch cores, BN statistics, biases, SRAM-resident sites, heads).

  * :func:`split_params`     — (branch, trunk) halves of a params tree.
  * :func:`branch_template`  — the shape/dtype skeleton a valid branch
    must match, as meta tensors (nothing allocated on any device).
  * :func:`validate_branch`  — a geometry-style structure check naming
    the expected vs found tree.
  * :func:`plan_fingerprint` — a stable hash of a PlacementPlan, equal to
    the JAX package's for the same plan.
  * :class:`BranchBundle` / :func:`extract` / :func:`implant` — a branch
    tagged with its model and plan fingerprint, and the checked way to
    put one back onto a resident trunk.
  * :func:`swap_params` — the swap the serving layer runs at step
    boundaries.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import torch

from repro_torch import bridge
from repro_torch.core import rebranch
from repro_torch.core.rom import dtype_name


# ---------------------------------------------------------------------------
# plan fingerprint
# ---------------------------------------------------------------------------

def _spec_token(spec) -> str:
    """Canonical, process-stable serialization of a ReBranchSpec: the JAX
    package's string, field for field (same Python types, so the same
    ``repr``; the dtype as numpy names it, ``float32``)."""
    cim = spec.cim
    return repr((
        spec.d_ratio, spec.u_ratio, spec.enabled, spec.trunk_impl,
        spec.branch_enabled, dtype_name(spec.param_dtype),
        (cim.mode, cim.rows_per_subarray, cim.adc_bits, cim.act_bits,
         cim.weight_bits, cim.act_group_bits, cim.adc_range_frac,
         cim.psum_range_frac)))


def plan_fingerprint(plan) -> str:
    """Stable hex digest of a PlacementPlan's full mapping (``None``, a
    family outside the placement subsystem, gets ``"no-plan"``)."""
    if plan is None:
        return "no-plan"
    h = hashlib.sha256()
    h.update(plan.model.encode())
    h.update(_spec_token(plan.default).encode())
    for addr, spec in plan.entries:
        h.update(addr.encode())
        h.update(_spec_token(spec).encode())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# split / template / validation
# ---------------------------------------------------------------------------

def split_params(params) -> tuple[Any, Any]:
    """(branch, trunk): the swappable SRAM tree and the frozen ROM tree,
    each with ``None`` at the other's positions, so
    ``rebranch.combine(branch, trunk)`` rebuilds ``params``."""
    return rebranch.partition(params)


def branch_template(model):
    """The branch skeleton (meta-tensor leaves) a valid branch for
    ``model`` must match.  ``model.init`` runs under a fake-tensor mode,
    so even full-width Gemma-2B allocates nothing."""
    shapes = bridge.abstract(lambda: model.init(0, device="cpu"))
    return rebranch.partition(shapes)[0]


def _preview(names, n=4) -> str:
    names = sorted(names)
    more = len(names) - n
    return ", ".join(names[:n]) + (f", ... ({more} more)" if more > 0 else "")


def validate_branch(branch, template, *, where: str = "branch") -> None:
    """Structure + shape/dtype check of a branch tree against a template,
    raising a geometry-style ValueError that names expected vs found."""
    got = bridge.flatten(branch)
    want = bridge.flatten(template)
    missing = set(want) - set(got)
    unexpected = set(got) - set(want)
    if missing or unexpected:
        parts = []
        if missing:
            parts.append(f"missing tensors {_preview(missing)}")
        if unexpected:
            parts.append(f"unexpected tensors {_preview(unexpected)}")
        raise ValueError(
            f"{where}: branch tree does not match the deployment's "
            f"branch structure ({'; '.join(parts)}; expected "
            f"{len(want)} swappable tensors, found {len(got)}) — was "
            f"this branch extracted under a different placement plan "
            f"or model config?")
    for name, leaf in want.items():
        g = got[name]
        if tuple(g.shape) != tuple(leaf.shape):
            raise ValueError(
                f"{where}: tensor {name} has shape {tuple(g.shape)} but the "
                f"deployment expects {tuple(leaf.shape)} — branch was "
                f"trained for a different geometry")
        if g.dtype != leaf.dtype:
            raise ValueError(
                f"{where}: tensor {name} has dtype {dtype_name(g.dtype)} "
                f"but the deployment expects {dtype_name(leaf.dtype)}")


# ---------------------------------------------------------------------------
# bundles: a branch tagged with its provenance
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BranchBundle:
    """One scenario's swappable state plus the keys that make it safe:
    the model name and the placement-plan fingerprint it was extracted
    under."""
    model: str
    plan_fp: str
    params: Any                          # branch tree (trunk slots None)


def extract(model, params, plan) -> BranchBundle:
    """The swappable branch of a full params tree, validated against
    ``model``'s template and tagged with ``plan``."""
    branch, _ = split_params(params)
    validate_branch(branch, branch_template(model), where="extract")
    return BranchBundle(model=model.cfg.name,
                        plan_fp=plan_fingerprint(plan), params=branch)


def implant(model, params, bundle: BranchBundle, plan, *,
            donate: bool = True):
    """A bundle's branch over ``params``'s resident trunk, after checking
    the model, the plan fingerprint and the tree's geometry."""
    if bundle.model != model.cfg.name:
        raise ValueError(
            f"implant: bundle was extracted from model "
            f"{bundle.model!r}, not {model.cfg.name!r}")
    fp = plan_fingerprint(plan)
    if bundle.plan_fp != fp:
        raise ValueError(
            f"implant: bundle was extracted under placement plan "
            f"{bundle.plan_fp} but this deployment runs plan {fp}; a "
            f"branch is only valid on the placement it was trained "
            f"against (a ROM<->SRAM flip changes which tensors exist)")
    validate_branch(bundle.params, branch_template(model), where="implant")
    return swap_params(params, bundle.params, donate=donate)


# ---------------------------------------------------------------------------
# the swap
# ---------------------------------------------------------------------------

def swap_params(params, branch, *, donate: bool = True):
    """``params`` with its branch half replaced by ``branch``.

    ``donate=True`` (the serving default): the returned tree holds the
    very same trunk tensor objects as ``params`` (not one ROM byte is
    copied) and ``branch``'s tensors themselves, moved to the trunk's
    device only where they lie elsewhere.  Nothing is written into either
    input; the caller drops ``params`` and with it its reference to the
    old branch.  ``donate=False`` copies every leaf instead, for callers
    that keep the original tree alive beside the new one.
    """
    _, trunk = rebranch.partition(params)
    dev = next(iter(bridge.flatten(params).values())).device
    if donate:
        branch = bridge.tree_map(branch, lambda t: t.to(dev))
        return rebranch.combine(branch, trunk)
    branch = bridge.tree_map(branch, lambda t: t.to(dev, copy=True))
    return rebranch.combine(branch, bridge.tree_map(trunk, torch.clone))
