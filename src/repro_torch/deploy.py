"""``compile_model``: the deployment entry point (port of
``repro.deploy``).

    from repro_torch import deploy, plan
    cfg = cnn.CNNConfig(name="darknet19", input_size=416)
    model = deploy.compile_model(cfg, plan=plan.solve(cfg, None,
                                                      engine="pallas_fused"))
    params = model.init(seed=0)             # on the CUDA card
    y = model.forward(params, images)       # NHWC images on the same device

LM configs (``models.config.ArchConfig``: the dense, moe, ssm and hybrid
families) get the serve surface too: ``prefill``, ``decode_step``,
``init_cache`` and ``init_paged_cache``, with the reference's
cache-geometry errors (an attention-free cache has no horizon to check).

LM configs also get the speculative-decode surface: ``draft_cfg`` (the
branch-only draft, ``api.draft_config``), ``draft_prefill``,
``draft_decode_step`` and ``verify_step``.

It resolves the engine through the strict registry, folds the per-site
placement (a ``PlacementPlan`` or a ``layer_overrides`` map) into the
config's ``rebranch_overrides``, binds the tuning-table policy
(``tune=``) and a mesh (``mesh=``: a ``launch.mesh.Mesh``; a CNN then
runs H-sharded over its ranks on the 'pallas_sharded' engine, a dense LM
tensor-parallel over ``model`` and data-parallel over ``data``), and
returns a :class:`CompiledModel`.

An LM over a mesh (every rank runs the same calls)::

    mesh = launch.mesh.make_lm_mesh(1, 4, backend="gloo")
    model = deploy.compile_model(cfg, engine="pallas_fused", mesh=mesh)
    params = model.shard_params(model.init(seed=0))   # this rank's blocks
    prefill = launch.steps.make_prefill_step(cfg, 8, 256, model=model)
    logits, cache = prefill(params, {"tokens": tokens})   # whole batch
    step = launch.steps.make_serve_step(cfg, model=model)
    next_tok, cache = step(params, {"tokens": next_tok[:, None]}, cache)
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

from repro_torch import bridge
from repro_torch import device as device_lib
from repro_torch import engine as engine_lib
from repro_torch import plan as plan_lib
from repro_torch.core.rebranch import ReBranchSpec
from repro_torch.distributed import sharding as shd
from repro_torch.engine.base import TrunkEngine
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import api, cnn
from repro_torch.models.config import ArchConfig, spec_for
from repro_torch.tune import table as tune_table


def valid_sites(cfg) -> set | None:
    """The addresses ``layer_overrides`` / plan entries may use (leaf
    sites plus ancestor prefixes); ``None`` when unconstrained."""
    tree = plan_lib.try_site_tree(cfg)
    return None if tree is None else plan_lib.valid_addresses(tree)


def _scoped(method):
    """Run a model call under the model's mesh (``sharding.use_mesh``) and
    tuning policy: ``tune=False`` pins the shape rule's launch plans
    (``tune.disabled()``) for every kernel the call reaches; ``None`` and
    ``True`` use the table."""
    @functools.wraps(method)
    def call(self, *args, **kwargs):
        with contextlib.ExitStack() as stack:
            if self.mesh is not None:
                stack.enter_context(shd.use_mesh(self.mesh))
            if self.tune is False:
                stack.enter_context(tune_table.disabled())
            return method(self, *args, **kwargs)
    return call


class CompiledModel:
    """A model bound to its resolved engine(s), per-site mapping and
    tuning policy.  LM configs expose the serve surface; CNN configs
    init/forward only."""

    def __init__(self, cfg, engine: TrunkEngine, tune: bool | None = None,
                 mesh=None):
        self.cfg = cfg
        self.engine = engine
        self.tune = tune
        self.mesh = mesh
        self._is_cnn = isinstance(cfg, cnn.CNNConfig)
        self._draft_cfg = None          # lazy: see draft_cfg
        if self._is_cnn:
            self._init, self._apply = cnn.MODEL_REGISTRY[cfg.name]

    def layer_spec(self, site: str) -> ReBranchSpec:
        return spec_for(self.cfg, site)

    def init(self, seed: int = 0, *, device=None):
        """Parameters from ``seed`` on ``device`` (default: the CUDA card).

        CNNs draw on the CPU and move the tree, so a seed gives the same
        parameters on every device.  LMs draw on the target device's own
        generator (Gemma-2B at full width is ~6e9 normal draws, minutes on
        the CPU): a seed gives the same parameters on every device of one
        type, and other values on the CPU than on the card.
        """
        dev = device_lib.resolve(device)
        if self._is_cnn:
            gen = torch.Generator().manual_seed(seed)
            return bridge.tree_map(self._init(gen, self.cfg),
                                   lambda t: t.to(dev))
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            return api.init(gen, self.cfg)

    @_scoped
    def forward(self, params, batch):
        """CNNs: head output for an NHWC image batch.  LMs: logits for a
        ``{"tokens": [B, S]}`` batch.  On the params' device.

        Under a mesh every rank passes the whole batch, keeps its block of
        it (``sharding.shard``: its ``pod`` block of the images, its
        ``data`` slab of H) and returns the whole output, gathered over
        both (the heads gather H, then the batch is gathered over
        ``pod``), as the reference returns one global array.  The gathers
        are differentiable, so a loss on the output trains the branches."""
        if self._is_cnn:
            batch = shd.shard(batch, "cnn_batch", "cnn_h")
            return shd.gather_batch(self._apply(params, batch, self.cfg))
        return api.forward(params, batch, self.cfg)

    @_scoped
    def features(self, params, batch, **kw):
        self._lm_only("features")
        return api.features(params, batch, self.cfg, **kw)

    @_scoped
    def apply_head(self, params, x, **kw):
        self._lm_only("apply_head")
        return api.apply_head(params, x, self.cfg, **kw)

    @_scoped
    def prefill(self, params, batch, cache, **kw):
        """Prompt into ``cache`` (updated in place); last-position logits.
        Under a mesh: this rank's rows of the batch (``launch.steps.
        local_batch``), its block of the parameters and cache; the logits
        come back whole over the vocab, or with ``whole_logits=False`` as
        this rank's vocab columns."""
        self._lm_only("prefill")
        tokens = batch.get("tokens", batch.get("embeds"))
        if tokens is not None:
            self._check_cache("prefill", tokens, cache)
        return api.prefill(params, batch, self.cfg, cache, **kw)

    @_scoped
    def decode_step(self, params, tokens, cache, **kw):
        """One token per row against ``cache`` (updated in place); under a
        mesh as :meth:`prefill`."""
        self._lm_only("decode_step")
        self._check_cache("decode_step", tokens, cache)
        return api.decode_step(params, tokens, self.cfg, cache, **kw)

    @property
    def draft_cfg(self):
        """The branch-only draft config (``api.draft_config``), built once.
        It shares this cell's params tree: ``trunk_skip`` is control
        flow, not weights."""
        if self._draft_cfg is None:
            self._lm_only("draft_cfg")
            self._draft_cfg = api.draft_config(self.cfg)
        return self._draft_cfg

    @_scoped
    def verify_step(self, params, tokens, cache):
        """Speculative verify: one pass over a [B, k] token block through
        the FULL trunk+branch cell (``cache`` updated in place).  Raises
        for families that cannot speculate and on cache / block geometry
        mismatches."""
        self._lm_only("verify_step")
        self._check_cache("verify_step", tokens, cache)
        return api.verify_step(params, tokens, self.cfg, cache)

    @_scoped
    def draft_prefill(self, params, batch, cache):
        """``prefill`` through the branch-only draft cell (ROM trunks
        skipped): same params and cache geometry, another compute."""
        self._lm_only("draft_prefill")
        tokens = batch.get("tokens", batch.get("embeds"))
        if tokens is not None:
            self._check_cache("prefill", tokens, cache)
        return api.prefill(params, batch, self.draft_cfg, cache)

    @_scoped
    def draft_decode_step(self, params, tokens, cache):
        """``decode_step`` through the branch-only draft cell: the
        token-proposal loop of speculative decode."""
        self._lm_only("draft_decode_step")
        self._check_cache("decode_step", tokens, cache)
        return api.decode_step(params, tokens, self.draft_cfg, cache)

    def shard_params(self, params):
        """This rank's local tree of the whole tree ``params`` under the
        model's mesh: every leaf's block under ``param_shardings`` (GSPMD's
        even layout), the contracting rows of row-parallel ``w_q`` and
        ``C`` as whole k-blocks (``sharding.k_layout``), the attention's q
        and o on whole heads, the moe block's experts by their layout
        (``sharding.param_bounds``).  Without a mesh, or on one rank,
        ``params`` itself."""
        self._lm_only("shard_params")
        if self.mesh is None or self.mesh.size == 1:
            return params
        shardings = bridge.flatten(shd.param_shardings(params, self.mesh))
        rows_of, head_dim, experts = self._bounds_args()
        with torch.no_grad():
            return bridge.map_named(params, lambda path, leaf: shd.local_param(
                path, leaf, shardings[path], rows_of(path), head_dim,
                experts))

    def split_leaves(self, params, mesh) -> set:
        """The leaves of the whole tree ``params`` (shapes will do) that
        the ranks of ``mesh``'s model axis hold in blocks under
        :meth:`shard_params`' layout (``sharding.model_split_leaves``)."""
        self._lm_only("split_leaves")
        return shd.model_split_leaves(params, mesh, *self._bounds_args())

    def _bounds_args(self):
        """``sharding.param_bounds``' arguments beyond a leaf's: its rows
        per subarray by path, the head size, the moe block's (E, ff)."""
        cfg = self.cfg

        def rows_of(path: str) -> int:
            site = ("blocks.attn" if "['attn']" in path else "blocks.mlp"
                    if "['mlp']" in path else "blocks.moe"
                    if "['moe']" in path else "lm_head")
            return spec_for(cfg, site).cim.rows_per_subarray

        experts = (cfg.num_experts, cfg.moe_d_ff or cfg.d_ff) \
            if cfg.num_experts else None
        return rows_of, cfg.head_dim, experts

    @_scoped
    def init_cache(self, batch: int, max_len: int, dtype=None, device=None):
        """A zero cache; under a mesh this rank's block of it
        (``api.init_cache``)."""
        self._lm_only("init_cache")
        return api.init_cache(self.cfg, batch, max_len, dtype,
                              device_lib.resolve(device))

    def init_paged_cache(self, rows: int, n_blocks: int, block_size: int,
                         max_len: int, dtype=None, device=None):
        """A paged KV cache: ``n_blocks`` shared physical blocks of
        ``block_size`` positions plus per-row block tables (logical horizon
        ``max_len``).  Raises for families that cannot page and when
        ``block_size`` does not divide ``max_len``."""
        self._lm_only("init_paged_cache")
        return api.init_paged_cache(self.cfg, rows, n_blocks, block_size,
                                    max_len, dtype,
                                    device_lib.resolve(device))

    def _check_cache(self, what: str, tokens, cache):
        """Catch cache/batch geometry mismatches at the model surface,
        naming both geometries (the reference's error texts)."""
        n_batch, seq = tokens.shape[0], tokens.shape[1]
        cache_batch, horizon = api.cache_geometry(self.cfg, cache)
        first = api._first_layer(cache)
        paged = isinstance(first, dict) and "table" in first
        kind = "block-table rows" if paged else "cache rows"
        remedy = ("init_paged_cache(rows={n}, ...)" if paged
                   else "init_cache(batch={n}, max_len=...)").format(
                       n=n_batch)
        if paged and what == "prefill":
            raise ValueError(
                "prefill cannot run against a paged cache (physical "
                "blocks have no per-row horizon to fill); prefill into "
                "a dense init_cache(1, max_len) cache and adopt the row "
                "into the paged pool (serve.pool.PagedPool.adopt)")
        if cache_batch != n_batch:
            raise ValueError(
                f"{what}: cache was built for batch={cache_batch} but "
                f"tokens have batch={n_batch} (tokens {tuple(tokens.shape)} "
                f"vs {kind} {cache_batch}); build the cache with "
                f"{remedy} or slice the batch to match")
        if what == "decode_step" and seq != 1:
            raise ValueError(
                f"decode_step consumes ONE token per sequence, got "
                f"tokens {tuple(tokens.shape)} (seq={seq}); use prefill() "
                f"for multi-token inputs (or verify_step() for a "
                f"speculative k-token block)")
        if what == "verify_step" and horizon is not None and seq > horizon:
            raise ValueError(
                f"verify_step: speculative block width {seq} exceeds "
                f"the cache horizon {horizon} (every block entry needs "
                f"a cache position); shrink spec_k or grow max_len")
        if (what == "prefill" and horizon is not None
                and self.cfg.sliding_window == 0 and seq > horizon):
            raise ValueError(
                f"prefill: prompt length {seq} exceeds the cache horizon "
                f"{horizon} (full-attention cache holds max_len tokens); "
                f"build the cache with init_cache(batch, max_len>={seq})")

    def _lm_only(self, what: str):
        if self._is_cnn:
            raise NotImplementedError(
                f"{what}() is for autoregressive LMs; CNN configs "
                f"({self.cfg.name!r}) expose init/forward only")

    def __repr__(self):
        kind = "cnn" if self._is_cnn else self.cfg.family
        mesh = "" if self.mesh is None else \
            " mesh=" + "x".join(str(self.mesh.shape[a])
                                for a in self.mesh.axis_names)
        return (f"<CompiledModel {self.cfg.name!r} ({kind}) engine="
                f"{self.engine.name!r} overrides="
                f"{len(self.cfg.rebranch_overrides)} tune={self.tune}"
                f"{mesh}>")


def compile_model(cfg, *, engine=None, layer_overrides=None,
                  plan=None, tune: bool | None = None,
                  mesh=None) -> CompiledModel:
    """Resolve engines + per-site ROM/SRAM placement and bundle the model.

    engine: registry name or TrunkEngine instance overriding the
        config-wide (or the plan's) ``trunk_impl``.
    layer_overrides: {address: override} map (keys ``engine``,
        ``memory``, ``cim``, ``branch_enabled``, ``d_ratio``,
        ``u_ratio``, or a full ReBranchSpec); unknown addresses raise.
    plan: a :class:`~repro_torch.plan.PlacementPlan`; canonical — it
        replaces the config's mapping wholesale.  Mutually exclusive with
        ``layer_overrides``.
    tune: the launch-plan policy of every call of the model.  ``None``
        (default) and ``True`` take the kernels' plans from the tuning
        table (``True`` raises unless the engine's ``capabilities.tune``
        says its kernels read it); ``False`` pins the shape rule's plans
        (``tune.disabled()`` around every call).  No plan moves a bit.
    mesh: a ``launch.mesh.Mesh`` the model is deployed onto: every call
        runs under ``sharding.use_mesh(mesh)``.  A CNN's NHWC activations
        shard over H on the axis of the ``"cnn_h"`` rule and the image
        batch over the axis of the ``"cnn_batch"`` rule (``pod``, where
        the mesh has one); every ROM site's engine must run its conv
        sharded (``'conv' in capabilities.sharded_ops``:
        'pallas_sharded').  A dense LM runs tensor-parallel over
        ``model`` and data-parallel over ``data`` (``shard_params``, the
        steps of ``launch.steps``); the other LM families raise, naming
        ROADMAP item 5(d).
    """
    if not isinstance(cfg, (cnn.CNNConfig, ArchConfig)):
        raise TypeError(f"compile_model takes a cnn.CNNConfig or an "
                        f"ArchConfig, got {type(cfg).__name__}")
    if mesh is not None and not isinstance(mesh, mesh_lib.AbstractMesh):
        raise TypeError(f"mesh= takes a launch.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    if mesh is not None and isinstance(cfg, ArchConfig):
        api.check_mesh(cfg, mesh)
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
    if tune is True and not eng.capabilities.tune:
        raise ValueError(
            f"tune=True but engine {eng.name!r} has no tuned kernels "
            f"(capabilities.tune is False); deploy on a table-aware "
            f"engine ('pallas'/'pallas_fused') or drop the flag")

    if plan is None:
        plan = plan_lib.PlacementPlan.build(cfg, layer_overrides,
                                            default=base)
        merged = dict(getattr(cfg, "rebranch_overrides", ()))
        merged.update(plan.as_overrides())
    else:
        merged = dict(plan.as_overrides())
    for site, spec in [("(default)", base), *merged.items()]:
        if not spec.enabled:
            continue
        site_eng = engine_lib.resolve(spec)  # gate per-layer engines too
        if (mesh is not None and isinstance(cfg, cnn.CNNConfig)
                and "conv" not in site_eng.capabilities.sharded_ops):
            raise ValueError(
                f"mesh= needs every ROM site on an engine that runs its conv "
                f"sharded ('pallas_sharded'); site {site} is on "
                f"{site_eng.name!r}")
    cfg = dataclasses.replace(cfg, rebranch=base,
                              rebranch_overrides=tuple(sorted(merged.items())))
    return CompiledModel(cfg, eng, tune=tune, mesh=mesh)
