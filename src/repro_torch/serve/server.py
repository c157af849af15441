"""The front door: ``serve.load(model_id)`` -> a server with submit()
(port of ``repro.serve.server``).

* LM configs get :class:`LMServer`: the continuous batcher behind a
  synchronous ``submit``/``step``/``drain`` surface plus an async
  ``generate`` coroutine (concurrent callers share the batch: each waiter
  pumps the scheduler one tick per event-loop round), over a paged KV
  pool by default for families that support it, with chunked prefill and
  optional speculative decode.
* CNN configs get :class:`CNNServer`: submitted images run through the
  resident cell in ``n_slots``-row chunks; a short chunk is padded with
  zero images and the pad rows are sliced off the output (inference BN
  uses frozen statistics and every trunk row is quantised on its own, so
  padding never changes a real row).

With a :class:`~repro_torch.scenario.ScenarioStore` attached, one cell
serves N scenarios by swapping the SRAM branch over the resident ROM
trunk: no trunk tensor is copied and no model is rebuilt.
"""

from __future__ import annotations

import asyncio

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.models import api, cnn
from repro_torch.scenario import swap_params
from repro_torch.serve import registry
from repro_torch.serve.pool import (PagedPool, SlotPool,
                                    default_block_size, suggest_paged,
                                    suggest_slots)
from repro_torch.serve.scheduler import ContinuousBatcher


class LMServer:
    """Continuous-batching decode serving for one resident LM cell.

    The KV pool is PAGED by default for families that support it
    (``paged=None`` -> ``api.supports_paging``); ``paged=False`` gives the
    dense :class:`~repro_torch.serve.pool.SlotPool`, ``paged=True``
    demands paging.  ``n_blocks``/``block_size`` size the paged pool
    (defaults: dense-equivalent capacity in ``max_len // 8``-position
    blocks).  The KV cache lives on the params' device in ``dtype``.

    With a store attached, ``swap_scenario`` (or ``submit(...,
    scenario=...)``) queues a branch hot-swap behind the requests already
    submitted: every request decodes entirely under the scenario it was
    submitted with.

    A multi-codebook (audio) config is refused: the batcher's requests
    carry one token per position, and MusicGen decodes [B, 1, Q] tokens
    through ``launch.steps.make_serve_step``.  (The reference builds the
    server and fails at the first decode step.)

    ``prefill_chunk``, ``spec_k`` and ``draft_source`` go to the batcher:
    chunked prefill admission (default: 32 where the family supports it)
    and speculative decode (the branch-only draft, ROM trunks skipped, and
    one batched full-cell verify per round; tokens bit-identical to
    ``spec_k=0`` greedy decode).
    """

    def __init__(self, model, params, *, n_slots: int, max_len: int,
                 dtype=torch.float32, store=None, scenario=None,
                 paged: bool | None = None, n_blocks: int | None = None,
                 block_size: int | None = None,
                 prefill_chunk: int | None = None, spec_k: int = 0,
                 draft_source=None):
        if model.cfg.num_codebooks:
            raise ValueError(
                f"LMServer serves one token per position; {model.cfg.name!r} "
                f"decodes {model.cfg.num_codebooks} codebooks per position "
                f"([B, 1, Q] tokens, [B, 1, Q, V] logits).  Serve it at "
                f"model level: launch.steps.make_prefill_step / "
                f"make_serve_step")
        self.model = model
        self.store = store
        device = next(iter(bridge.flatten(params).values())).device
        if paged is None:
            paged = api.supports_paging(model.cfg)
        elif paged and not api.supports_paging(model.cfg):
            raise ValueError(
                f"paged=True but {model.cfg.name!r} (family "
                f"{model.cfg.family!r}, sliding_window="
                f"{model.cfg.sliding_window}) cannot page its KV cache; "
                f"pass paged=False for a dense SlotPool")
        if paged:
            if block_size is None:
                block_size = default_block_size(max_len)
            if n_blocks is None:
                # dense-equivalent byte budget: n_slots full horizons
                n_blocks = n_slots * (max_len // block_size)
            self.pool = PagedPool(model, n_slots, n_blocks, block_size,
                                  max_len, dtype=dtype, device=device)
        else:
            self.pool = SlotPool(model, n_slots, max_len, dtype=dtype,
                                 device=device)
        self.batcher = ContinuousBatcher(model, params, self.pool,
                                         scenario=scenario,
                                         prefill_chunk=prefill_chunk,
                                         spec_k=spec_k,
                                         draft_source=draft_source)

    @property
    def params(self):
        """The live params tree (the batcher owns it; a swap replaces it)."""
        return self.batcher.params

    @property
    def scenario(self):
        return self.batcher.scenario

    def swap_scenario(self, name: str):
        """Queue a hot-swap to a registered scenario's branch; it applies
        at a decode-step boundary once the requests before it retired."""
        _need_store(self.store, "LMServer")
        self.batcher.swap(name, self.store.get(name))

    def submit(self, prompt, max_new_tokens: int, eos_id=None,
               scenario=None):
        if scenario is not None and \
                scenario != self.batcher.pending_scenario():
            self.swap_scenario(scenario)
        return self.batcher.submit(prompt, max_new_tokens, eos_id=eos_id,
                                   scenario=scenario)

    def step(self) -> bool:
        return self.batcher.step()

    def drain(self, max_steps: int | None = None) -> int:
        return self.batcher.drain(max_steps)

    async def generate(self, prompt, max_new_tokens: int, eos_id=None,
                       scenario=None) -> list[int]:
        """Submit and await one request; concurrent callers batch.  Each
        waiter advances the shared scheduler one tick per event-loop
        round, so N concurrent ``generate`` calls decode as one batch."""
        req = self.submit(prompt, max_new_tokens, eos_id=eos_id,
                          scenario=scenario)
        while not req.done:
            self.batcher.step()
            await asyncio.sleep(0)
        return list(req.tokens)


def _need_store(store, server: str):
    if store is None:
        raise ValueError(
            f"no ScenarioStore attached to this server; serve.load"
            f"(model_id, scenario=...) or pass store= to {server}")


class CNNServer:
    """Forward-only serving of one resident CNN cell in fixed-size chunks."""

    def __init__(self, model, params, *, n_slots: int, store=None,
                 scenario=None):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.model = model
        self.params = params
        self.store = store
        self.scenario = scenario
        self.n_slots = int(n_slots)
        self.device = next(iter(bridge.flatten(params).values())).device

    def swap_scenario(self, name: str):
        """Hot-swap to a registered scenario's branch.  Forward serving is
        synchronous, so the swap applies at once; the model is reused and
        the trunk tensors stay the same objects."""
        _need_store(self.store, "CNNServer")
        self.params = swap_params(self.params, self.store.get(name))
        self.scenario = name

    def submit(self, images) -> np.ndarray:
        """images: [B, H, W, C] (numpy or tensor) -> outputs for all B rows."""
        x = torch.as_tensor(np.asarray(images, dtype=np.float32))
        if x.dim() == 3:
            x = x[None]
        outs = []
        for lo in range(0, x.shape[0], self.n_slots):
            chunk = x[lo:lo + self.n_slots].to(self.device)
            real = chunk.shape[0]
            if real < self.n_slots:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (self.n_slots - real, *chunk.shape[1:]))])
            with torch.no_grad():
                out = self.model.forward(self.params, chunk)
            outs.append(out[:real].cpu().numpy())
        return np.concatenate(outs, 0)

    async def generate(self, image) -> np.ndarray:
        """Async single-image front door: [H, W, C] (or [1, H, W, C]) ->
        that image's output."""
        await asyncio.sleep(0)
        return self.submit(image[None] if np.asarray(image).ndim == 3
                           else image)[0]


def load(model_id: str, *, params=None, seed: int = 0, n_slots=None,
         device=None, max_len: int = 128, dtype=torch.float32,
         sram_capacity_bytes: int = 64 << 20, scenario: str | None = None,
         paged: bool | None = None, n_blocks: int | None = None,
         block_size: int | None = None, prefill_chunk: int | None = None,
         spec_k: int = 0, draft_source=None):
    """One front door for LM decode and CNN forward serving.

    Resolves ``model_id`` through the registry (compiled at most once per
    process), initialises params from ``seed`` on ``device`` (default:
    the CUDA card) unless given, and — for LMs without a forced
    ``n_slots`` — sizes the KV pool from the entry's placement plan:
    paged pools via :func:`~repro_torch.serve.pool.suggest_paged`, dense
    ones via :func:`~repro_torch.serve.pool.suggest_slots`.  ``paged``,
    ``n_blocks``, ``block_size``, ``prefill_chunk``, ``spec_k`` and
    ``draft_source`` go to :class:`LMServer`; the LM keywords are ignored
    for CNN configs.

    scenario: start on a registered scenario's branch (see
    ``registry.scenario_store``), swapped over the trunk before serving;
    the server carries the id's store, so it can swap to the others.
    """
    model, plan = registry.compile_entry(model_id)
    if params is None:
        params = model.init(seed, device=device)
    store = None
    if scenario is not None or registry.has_scenarios(model_id):
        store = registry.scenario_store(
            model_id, device=next(iter(bridge.flatten(params).values())).device)
    if scenario is not None:
        params = swap_params(params, store.get(scenario))
    if isinstance(model.cfg, cnn.CNNConfig):
        return CNNServer(model, params, n_slots=n_slots or 8, store=store,
                         scenario=scenario)
    if paged is None:
        paged = api.supports_paging(model.cfg)
    if n_slots is None:
        if paged:
            n_slots, nb, block_size = suggest_paged(
                model, plan, max_len, dtype=dtype,
                sram_capacity_bytes=sram_capacity_bytes,
                block_size=block_size)
            n_blocks = n_blocks if n_blocks is not None else nb
        else:
            n_slots = suggest_slots(
                model, plan, max_len, dtype=dtype,
                sram_capacity_bytes=sram_capacity_bytes)
    return LMServer(model, params, n_slots=n_slots, max_len=max_len,
                    dtype=dtype, store=store, scenario=scenario, paged=paged,
                    n_blocks=n_blocks, block_size=block_size,
                    prefill_chunk=prefill_chunk, spec_k=spec_k,
                    draft_source=draft_source)
