"""Family-dispatched LM API (port of ``repro.models.api``).

  init(gen, cfg)                          -> params
  forward(params, batch, cfg)             -> logits
  prefill(params, batch, cfg, cache)      -> (logits, cache)
  decode_step(params, tokens, cfg, cache) -> (logits, cache)
  init_cache(cfg, batch, max_len)         -> cache

  verify_step(params, tokens, cfg, cache) -> (logits, cache)
  draft_config(cfg)                       -> branch-only draft cfg

Every family is ported: dense, vlm, audio and moe (the transformer
module), ssm and hybrid.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import bridge
from repro_torch.distributed import sharding as shd
from repro_torch.launch import cost
from repro_torch.models import hybrid, ssm, transformer
from repro_torch.models.config import ArchConfig

_FAMILY = {
    "dense": transformer, "vlm": transformer, "audio": transformer,
    "moe": transformer,            # the moe block dispatches inside it
    "ssm": ssm,
    "hybrid": hybrid,
}


def _mod(cfg: ArchConfig):
    return _FAMILY[cfg.family]


def init(gen: torch.Generator, cfg: ArchConfig):
    return _mod(cfg).init(gen, cfg)


def forward(params, batch, cfg: ArchConfig):
    return _mod(cfg).forward(params, batch, cfg)


def features(params, batch, cfg: ArchConfig, **kw):
    return _mod(cfg).features(params, batch, cfg, **kw)


def apply_head(params, x, cfg: ArchConfig, **kw):
    return _mod(cfg).apply_head(params, x, cfg, **kw)


def prefill(params, batch, cfg: ArchConfig, cache, **kw):
    return _mod(cfg).prefill(params, batch, cfg, cache, **kw)


def decode_step(params, tokens, cfg: ArchConfig, cache, **kw):
    return _mod(cfg).decode_step(params, tokens, cfg, cache, **kw)


def check_mesh(cfg: ArchConfig, mesh=None):
    """Raise unless ``cfg`` can run over ``mesh`` (default: the bound
    one): the dense and moe families serve and train; the others wait
    for ROADMAP item 5(d)."""
    mesh = mesh or shd.current_mesh()
    if mesh is None or mesh.size == 1 or cfg.family in ("dense", "moe"):
        return
    raise NotImplementedError(
        f"{cfg.name!r} is a {cfg.family!r} config: over a mesh the port "
        f"serves and trains the dense and moe families; the others come "
        f"with {shd.LM_SLICE}")


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device=None):
    """A zero cache of ``batch`` x ``max_len``.  Under a bound mesh of more
    than one rank, this rank's block of it by ``sharding.cache_spec``
    (the batch over pod and data, the kv heads or, where they do not
    divide the model axis, the sequence over model, or, where neither
    does, the whole sequence on every rank); every rank's ``length``
    stays whole.  The layout is decided here, once: a cache whose K/V
    blocks split the sequence over the model axis says so by the key
    ``"seq_split"`` (value None: not a leaf, so tree maps, copies and
    byte counts keep or skip it like the layout they describe), because
    a rank's block of a split sequence and a whole cache can have one
    shape."""
    dtype = dtype or torch.bfloat16
    mesh = shd.current_mesh()
    if mesh is None or mesh.size == 1:
        return _mod(cfg).init_cache(cfg, batch, max_len, dtype, device)
    check_mesh(cfg, mesh)
    with cost.untracked():                  # shapes only
        whole = _mod(cfg).init_cache(cfg, batch, max_len, dtype, "meta")

    def block(path, leaf):
        spec = shd.cache_spec(path, leaf, mesh)
        for part in spec:
            if isinstance(part, tuple) and len(part) > 1 and part != (
                    "pod", "data"):
                raise NotImplementedError(
                    f"a batch-{batch} cache over {mesh!r} shards its "
                    f"sequence over every axis (kv_seq): that comes with "
                    f"{shd.LM_SLICE}")
        bounds = shd.block_bounds(leaf.shape,
                                  shd.NamedSharding(mesh, spec))
        return torch.zeros([hi - lo for lo, hi in bounds], dtype=leaf.dtype,
                           device=device)

    cache = bridge.map_named(whole, block)
    k = whole["layers"]["k"]                # the dense family's stack
    if shd.cache_spec("['layers']['k']", k, mesh)[-3] == "model":
        cache["layers"]["seq_split"] = None
    return cache


def supports_paging(cfg: ArchConfig) -> bool:
    """Whether the family can serve decode through a paged KV cache: every
    sequence-mixing layer must keep one uniform full-attention horizon
    (ssm state is O(1), nothing to page; hybrid mixes ssm state with SWA
    rings, which cannot share one block table)."""
    return _mod(cfg) is transformer and cfg.sliding_window == 0


def init_paged_cache(cfg: ArchConfig, rows: int, n_blocks: int,
                     block_size: int, max_len: int, dtype=None, device=None):
    """Paged KV cache (``transformer.init_paged_cache``); raises for
    families that cannot page."""
    if not supports_paging(cfg):
        raise ValueError(
            f"{cfg.name!r} (family {cfg.family!r}, sliding_window="
            f"{cfg.sliding_window}) cannot serve through a paged KV "
            f"cache; use init_cache + a dense SlotPool")
    return _mod(cfg).init_paged_cache(cfg, rows, n_blocks, block_size,
                                      max_len, dtype or torch.bfloat16,
                                      device)


def supports_speculation(cfg: ArchConfig) -> bool:
    """Whether the family can serve speculative (draft/verify) decode.

    Verify writes k KV entries per row and must be able to UNDO the
    rejected tail by truncating the row's length: every sequence-mixing
    layer must keep a full-horizon attention cache (an SWA ring can wrap
    within a k-block, and recurrent state cannot rewind)."""
    return _mod(cfg) is transformer and cfg.sliding_window == 0


def verify_step(params, tokens, cfg: ArchConfig, cache):
    """Speculative verify: a k-token block decode
    (``transformer.verify_step``); raises for families that cannot
    speculate (:func:`supports_speculation`)."""
    if not supports_speculation(cfg):
        raise ValueError(
            f"{cfg.name!r} (family {cfg.family!r}, sliding_window="
            f"{cfg.sliding_window}) cannot run speculative verify: "
            f"rolling back rejected drafts needs a full-horizon "
            f"attention cache (ssm/hybrid recurrent state cannot "
            f"rewind; SWA rings overwrite entries a rollback would "
            f"need)")
    return _mod(cfg).verify_step(params, tokens, cfg, cache)


def draft_config(cfg: ArchConfig) -> ArchConfig:
    """The branch-only DRAFT variant of ``cfg`` for speculative decode:
    every ReBranch-enabled site, overrides included, gets
    ``trunk_skip=True`` (its ROM trunk is skipped, only the SRAM branch
    runs).  SRAM-resident sites (``enabled=False``) run in full.  The
    draft shares the verify model's params tree verbatim: ``trunk_skip``
    is control flow, not weights."""
    def skip(spec):
        if not spec.enabled or spec.trunk_skip:
            return spec
        return dataclasses.replace(spec, trunk_skip=True)

    return dataclasses.replace(
        cfg, rebranch=skip(cfg.rebranch),
        rebranch_overrides=tuple(
            (site, skip(spec))
            for site, spec in getattr(cfg, "rebranch_overrides", ())))


def supports_chunked_prefill(cfg: ArchConfig) -> bool:
    """Whether prefill may be split into chunks across an existing cache:
    the attention layers attend over the cached prefix at the chunk's
    offset.  True for the attention-with-KV-cache family (ssm/hybrid
    prompts prefill whole)."""
    return _mod(cfg) is transformer


def cache_geometry(cfg: ArchConfig, cache) -> tuple[int, int | None]:
    """(batch, horizon) a serve cache was built for, from its shapes (and
    ``init_cache``'s ``"seq_split"`` mark).

    Leaves carry batch at axis 1 under stacked layers (axis 0 otherwise).
    The horizon is the largest K/V sequence axis (full-attention layers
    hold ``max_len``, SWA layers their window; under a bound mesh that
    splits the sequence over its model axis, the whole sequence),
    ``None`` for the attention-free (O(1) state) ssm family.  Paged caches
    report their LOGICAL geometry: the block-table row count and
    ``table_width * block_size``.
    """
    axis = 1 if cfg.scan_layers else 0
    first = _first_layer(cache)
    if isinstance(first, dict) and "table" in first:
        table, k = first["table"], first["k"]          # [(L,) B, NB]
        return table.shape[axis], table.shape[-1] * k.shape[axis + 1]
    leaves = list(bridge.flatten(cache).values())
    if not leaves:
        raise ValueError("empty cache tree")
    batch = leaves[0].shape[axis]
    if cfg.is_attention_free:
        return batch, None
    kv = [leaf for leaf in leaves if leaf.dim() == 4 + axis]
    horizon = max(leaf.shape[1 + axis] for leaf in kv)
    if isinstance(first, dict) and "seq_split" in first:
        # a rank's block of a cache split over its sequence: the horizon
        # is the whole sequence, as the reference's global cache has it
        horizon *= shd.current_mesh().shape["model"]
    return batch, horizon


def _first_layer(cache):
    """The first per-layer cache dict (the stacked dict under scan)."""
    if not isinstance(cache, dict):
        return None
    layers = cache.get("layers")
    if isinstance(layers, (list, tuple)):
        return layers[0] if layers else None
    return layers
