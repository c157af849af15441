"""``compile_model``: the deployment entry point (port of
``repro.deploy``, CNN surface).

    from repro_torch import deploy, plan
    cfg = cnn.CNNConfig(name="darknet19", input_size=416)
    model = deploy.compile_model(cfg, plan=plan.solve(cfg, None,
                                                      engine="pallas_fused"))
    params = model.init(seed=0)             # on the CUDA card
    y = model.forward(params, images)       # NHWC images on the same device

It resolves the engine through the strict registry, folds the per-site
placement (a ``PlacementPlan`` or a ``layer_overrides`` map) into the
config's ``rebranch_overrides``, and returns a :class:`CompiledModel`.
The ``mesh=``/``tune=`` arguments and the LM surface wait for later
slices (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import bridge
from repro_torch import device as device_lib
from repro_torch import engine as engine_lib
from repro_torch import plan as plan_lib
from repro_torch.core.rebranch import ReBranchSpec
from repro_torch.engine.base import TrunkEngine
from repro_torch.models import cnn
from repro_torch.models.config import spec_for


def valid_sites(cfg) -> set | None:
    """The addresses ``layer_overrides`` / plan entries may use (leaf
    sites plus ancestor prefixes); ``None`` when unconstrained."""
    tree = plan_lib.try_site_tree(cfg)
    return None if tree is None else plan_lib.valid_addresses(tree)


class CompiledModel:
    """A CNN bound to its resolved engine(s) and per-site mapping."""

    def __init__(self, cfg, engine: TrunkEngine):
        self.cfg = cfg
        self.engine = engine
        self._init, self._apply = cnn.MODEL_REGISTRY[cfg.name]

    def layer_spec(self, site: str) -> ReBranchSpec:
        return spec_for(self.cfg, site)

    def init(self, seed: int = 0, *, device=None):
        """Parameters from ``seed`` (drawn on the CPU, so equal on every
        device), placed on ``device`` (default: the CUDA card)."""
        dev = device_lib.resolve(device)
        gen = torch.Generator().manual_seed(seed)
        return bridge.tree_map(self._init(gen, self.cfg), lambda t: t.to(dev))

    def forward(self, params, batch):
        """Head output for an NHWC image batch on the params' device."""
        return self._apply(params, batch, self.cfg)

    def __repr__(self):
        return (f"<CompiledModel {self.cfg.name!r} (cnn) engine="
                f"{self.engine.name!r} overrides="
                f"{len(self.cfg.rebranch_overrides)}>")


def compile_model(cfg, *, engine=None, layer_overrides=None,
                  plan=None) -> CompiledModel:
    """Resolve engines + per-site ROM/SRAM placement and bundle the model.

    engine: registry name or TrunkEngine instance overriding the
        config-wide (or the plan's) ``trunk_impl``.
    layer_overrides: {address: override} map (keys ``engine``,
        ``memory``, ``cim``, ``branch_enabled``, ``d_ratio``,
        ``u_ratio``, or a full ReBranchSpec); unknown addresses raise.
    plan: a :class:`~repro_torch.plan.PlacementPlan`; canonical — it
        replaces the config's mapping wholesale.  Mutually exclusive with
        ``layer_overrides``.
    """
    if not isinstance(cfg, cnn.CNNConfig):
        raise NotImplementedError(
            f"compile_model serves the CNN configs in this port; the LM "
            f"surface waits for ROADMAP Queue 1 item 13 (got "
            f"{type(cfg).__name__})")
    if plan is not None:
        if layer_overrides:
            raise ValueError(
                "pass either plan= or layer_overrides=, not both "
                "(a PlacementPlan already carries the whole mapping)")
        if plan.model != cfg.name:
            raise ValueError(
                f"plan was built for {plan.model!r}, not {cfg.name!r}")
        base = plan.default
    else:
        base = cfg.rebranch
    if engine is not None:
        name = engine.name if isinstance(engine, TrunkEngine) else engine
        if isinstance(engine, TrunkEngine):
            if name not in engine_lib.registered_names():
                engine_lib.register(name, engine)
            elif engine_lib.get(name) is not engine:
                raise ValueError(
                    f"engine instance named {name!r} conflicts with the "
                    f"already-registered engine of that name; register it "
                    f"with override=True or give it a distinct name")
        base = dataclasses.replace(base, trunk_impl=name)
    eng = engine_lib.resolve(base)          # strict + capability gate

    if plan is None:
        plan = plan_lib.PlacementPlan.build(cfg, layer_overrides,
                                            default=base)
        merged = dict(getattr(cfg, "rebranch_overrides", ()))
        merged.update(plan.as_overrides())
    else:
        merged = dict(plan.as_overrides())
    for spec in merged.values():
        if spec.enabled:
            engine_lib.resolve(spec)        # gate per-layer engines too
    cfg = dataclasses.replace(cfg, rebranch=base,
                              rebranch_overrides=tuple(sorted(merged.items())))
    return CompiledModel(cfg, eng)
