"""Continuous batching: interleave prefill and decode over one cell (port
of ``repro.serve.scheduler``).

Life of a request:

  submit -> admission queue (FIFO) -> [pool.try_admit: a row, and —
  paged — blocks for the whole request] solo prefill (batch=1, the
  standalone path; prompts longer than ``prefill_chunk`` run one chunk
  per tick, interleaved with decode) -> KV adopted into the pool (dense
  row copy or paged block scatter) -> joins the batched ``decode_step``
  at the next step boundary -> retires when done (max_new_tokens or EOS)
  -> capacity freed, the rest of the batch keeps decoding.

Invariants (``tests/test_torch_lm_serve.py``,
``tests/test_torch_chunked_prefill.py``, ``tests/test_torch_spec.py``):
occupancy never exceeds the pool; admission is FIFO and work-conserving;
in-flight decodes advance on every tick a prefill chunk runs; each
request's tokens equal a solo ``prefill`` + ``decode_step`` run of the
same prompt, because the per-row cache makes batched decode
row-independent.  That last one needs every op to compute a row with the
same bits whatever the batch: the port's kernels do by construction, and
the GEMMs and reductions that would not (cuBLAS picks its kernel by shape
on the card) run on bucketed rows (``core.rows``).  Decoding is greedy
(argmax).

Speculative decode (``spec_k > 0``): each round a DRAFT model — the SRAM
ReBranch branch with the ROM trunk skipped
(``CompiledModel.draft_decode_step``), or an injected ``draft_source`` —
proposes up to k tokens per row; ONE batched ``verify_step`` over the
[N, k] block runs the full trunk+branch cell, and greedy
accept-longest-prefix keeps the drafted prefix that matches the verify
argmaxes plus the first mismatch's correction.  The accepted tokens are
plain greedy decode's, bit for bit, whatever the draft quality: query i
of the verify sees exactly the cache plain decode would (drafted future
entries are masked per query, ``layers._verify_attention``).  A fully
accepted block's bonus token is not claimed, so the verify cache and the
draft cache both hold KV through the sequence's second-last token and
every round starts with one width-1 draft feed.  Rejected tails roll back
through ``pool.rollback``, so speculation never leaks blocks.

Scenario hot-swap (``repro_torch.scenario``): a swap is a BARRIER in the
same FIFO queue requests ride.  It applies at a decode-step boundary once
every request admitted before it has retired and no chunked prefill is in
flight, so a request decodes entirely under the scenario it was submitted
with — bit-identical to a fresh single-scenario cell — while requests
behind the barrier wait.  The swap itself is ``scenario.swap_params``:
the trunk tensors pass through as the same objects, not one ROM byte is
copied, and draft and verify see the new branch at once (they share the
params tree).
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.models import api
from repro_torch.scenario import swap_params
from repro_torch.serve.pool import SlotPool


@dataclasses.dataclass
class _Swap:
    """A scenario-swap barrier in the admission queue."""
    scenario: str
    branch: object                        # the new branch tree


@dataclasses.dataclass
class Request:
    """One user request plus its scheduling trace."""
    rid: int
    prompt: np.ndarray                    # [S] int32 token ids
    max_new_tokens: int
    eos_id: int | None = None
    scenario: str | None = None           # branch the request runs under
    # filled in by the scheduler:
    tokens: list = dataclasses.field(default_factory=list)
    slot: int | None = None
    submit_step: int = -1                 # scheduler tick at submit
    admit_step: int = -1                  # tick the prefill ran
    finish_step: int = -1                 # tick the last token landed
    submit_s: float = 0.0                 # wall clock, for latency stats
    finish_s: float = 0.0
    drafted: int = 0                      # draft tokens verified for this row
    matched: int = 0                      # of those, accepted (mismatch
                                          # corrections not counted)

    @property
    def done(self) -> bool:
        return self.finish_step >= 0

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.submit_s


class ContinuousBatcher:
    """Admission queue + decode loop over one model and one KV pool (dense
    :class:`~repro_torch.serve.pool.SlotPool` or paged
    :class:`~repro_torch.serve.pool.PagedPool`).

    ``prefill_chunk``: a prompt longer than the chunk is prefilled one
    chunk per tick, interleaved with the batched decode steps, against the
    same solo (batch=1, dense) cache at its absolute offset, so the
    adopted row equals a whole-prompt solo prefill bit for bit.  ``None``
    -> 32 for families that support it (``api.supports_chunked_prefill``);
    ``0`` -> whole-prompt admission.

    ``spec_k``: speculative decode with up to ``spec_k`` drafted tokens per
    row per round (see the module docstring).  ``draft_source`` replaces
    the branch-only draft model with a callable ``(active: {slot:
    Request}, last_tok: [n_slots, 1] int32, k) -> [n_slots, k] int32``;
    ``None`` drafts through ``model.draft_decode_step`` over a dense draft
    cache that shadows the pool row for row.
    """

    def __init__(self, model, params, pool, *, scenario: str | None = None,
                 prefill_chunk: int | None = None, spec_k: int = 0,
                 draft_source=None):
        self.model = model
        self.params = params
        self.pool = pool
        self.scenario = scenario            # live branch label
        self.swap_count = 0                 # swaps applied so far
        self.device = next(iter(bridge.flatten(pool.cache).values())).device
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k and not api.supports_speculation(model.cfg):
            raise ValueError(
                f"spec_k={spec_k} but {model.cfg.name!r} (family "
                f"{model.cfg.family!r}, sliding_window="
                f"{model.cfg.sliding_window}) cannot speculate: "
                f"rollback needs a full-horizon attention cache "
                f"(api.supports_speculation); pass spec_k=0")
        self.spec_k = int(spec_k)
        self.draft_source = draft_source
        self.spec_rounds = 0                # verify passes so far
        self.drafted_total = 0              # draft tokens verified
        self.matched_total = 0              # of those, accepted
        self._draft_pool = None
        if self.spec_k and draft_source is None:
            # the draft model's own KV state: one dense row per pool slot,
            # indexed by the same slot ids (its free list is unused)
            self._draft_pool = SlotPool(model, pool.n_slots, pool.max_len,
                                        dtype=pool.dtype,
                                        device=self.device)
        if prefill_chunk is None:
            prefill_chunk = 32 if api.supports_chunked_prefill(model.cfg) \
                else 0
        elif prefill_chunk and not api.supports_chunked_prefill(model.cfg):
            raise ValueError(
                f"prefill_chunk={prefill_chunk} but {model.cfg.name!r} "
                f"(family {model.cfg.family!r}) cannot chunk prefill — "
                f"ssm/hybrid recurrent state is rebuilt from position 0 "
                f"each prefill call; pass prefill_chunk=0")
        self.prefill_chunk = int(prefill_chunk)
        self._queue: collections.deque = collections.deque()
        self._active: dict[int, Request] = {}       # slot -> request
        # in-flight chunked prefill: (req, slot, solo_cache, pos) or None
        self._prefilling: tuple | None = None
        # the token column fed to decode_step: one row per slot; free rows
        # carry 0 (their output is never read)
        self._tok = np.zeros((pool.n_slots, 1), np.int32)
        self._next_rid = 0
        self.step_count = 0

    def pending_scenario(self) -> str | None:
        """The branch label after every queued swap barrier applies: what
        a request submitted now is admitted under."""
        for item in reversed(self._queue):
            if isinstance(item, _Swap):
                return item.scenario
        return self.scenario

    def swap(self, scenario: str | None, branch) -> None:
        """Queue a branch hot-swap, FIFO with requests: everything
        submitted before it decodes under the old branch, everything after
        under the new one."""
        self._queue.append(_Swap(scenario=scenario, branch=branch))

    def submit(self, prompt, max_new_tokens: int,
               eos_id: int | None = None,
               scenario: str | None = None) -> Request:
        """Queue one request; returns its live :class:`Request` handle.
        Raises at the front door for requests that could never run, and
        for a scenario label other than the queue tail's (swap first;
        ``LMServer.submit`` does)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        total = prompt.size + max_new_tokens
        if total > self.pool.max_len:
            raise ValueError(
                f"request needs {total} cache slots "
                f"(prompt {prompt.size} + {max_new_tokens} new) but the "
                f"pool was sized for max_len={self.pool.max_len}")
        tail = self.pending_scenario()
        if scenario is not None and scenario != tail:
            raise ValueError(
                f"submit(scenario={scenario!r}) but the queue tail runs "
                f"scenario {tail!r}; call swap({scenario!r}, branch) "
                f"first (LMServer.submit(..., scenario=...) does this "
                f"through the scenario store)")
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      scenario=tail)
        req.submit_step = self.step_count
        req.submit_s = time.perf_counter()
        self._next_rid += 1
        self._queue.append(req)
        return req

    @property
    def queued(self) -> int:
        return sum(1 for x in self._queue if isinstance(x, Request))

    @property
    def active(self) -> int:
        return len(self._active)

    @property
    def prefilling(self) -> bool:
        """Whether a chunked prefill is in flight (its request holds a
        pool row but has not joined the decode batch)."""
        return self._prefilling is not None

    @property
    def idle(self) -> bool:
        return (not self._queue and not self._active
                and self._prefilling is None)

    @property
    def acceptance_rate(self) -> float:
        """Accepted / verified draft tokens over the batcher's lifetime
        (mismatch corrections count in neither term)."""
        return (self.matched_total / self.drafted_total
                if self.drafted_total else 0.0)

    def _finish(self, req: Request) -> None:
        req.finish_step = self.step_count
        req.finish_s = time.perf_counter()
        self.pool.release(req.slot)
        del self._active[req.slot]

    def _maybe_retire(self, req: Request) -> None:
        hit_eos = (req.eos_id is not None and req.tokens
                   and req.tokens[-1] == req.eos_id)
        if len(req.tokens) >= req.max_new_tokens or hit_eos:
            self._finish(req)

    def _apply_swap(self, sw: _Swap) -> None:
        """The branch replaced over the same trunk tensors; the model and
        the pool are reused as they are."""
        self.params = swap_params(self.params, sw.branch)
        self.scenario = sw.scenario
        self.swap_count += 1

    def _tokens(self, array) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(array),
                               device=self.device)

    def _activate(self, req: Request, slot: int, solo, logits) -> None:
        """Adopt a finished solo prefill into the pool and put the request
        into the decode batch (its first token comes from the prefill
        logits, as on the standalone path)."""
        self.pool.adopt(slot, solo)
        if self._draft_pool is not None:
            # shadow the row in the draft cache: one whole-prompt
            # branch-only prefill, so the draft cache, like the verify
            # cache, starts every round one token behind the tail
            d_solo = self._draft_pool.solo_cache()
            with torch.no_grad():
                _, d_solo = self.model.draft_prefill(
                    self.params, {"tokens": self._tokens(req.prompt[None])},
                    d_solo)
            self._draft_pool.adopt(slot, d_solo)
        first = int(torch.argmax(logits[0, -1]))
        req.slot = slot
        req.admit_step = self.step_count
        req.tokens.append(first)
        self._tok[slot, 0] = first
        self._active[slot] = req
        self._maybe_retire(req)           # 1-token requests finish here

    def _advance_prefill(self) -> None:
        """Run ONE chunk of the in-flight prefill against its solo cache at
        the chunk's absolute offset; the last chunk's logits give the first
        token and the row activates."""
        req, slot, solo, pos = self._prefilling
        end = min(pos + self.prefill_chunk, req.prompt.size)
        with torch.no_grad():
            logits, solo = self.model.prefill(
                self.params, {"tokens": self._tokens(req.prompt[None,
                                                                pos:end])},
                solo)
        if end < req.prompt.size:
            self._prefilling = (req, slot, solo, end)
        else:
            self._prefilling = None
            self._activate(req, slot, solo, logits)

    def _admit(self) -> None:
        """FIFO admission: the head request admits only when the pool can
        guarantee it, and is prefilled solo — whole, or one chunk per tick
        when longer than ``prefill_chunk`` (one such prefill in flight at
        a time, decode running between chunks).  A swap barrier at the
        head applies only once the active requests have retired and no
        chunked prefill is in flight (it finishes under the params it
        started with)."""
        if self._prefilling is not None:
            self._advance_prefill()
            if self._prefilling is not None:
                return            # still mid-prompt; FIFO order holds
        while self._queue:
            head = self._queue[0]
            if isinstance(head, _Swap):
                if self._active or self._prefilling is not None:
                    return        # in-flight work finishes on its branch
                self._apply_swap(self._queue.popleft())
                continue
            slot = self.pool.try_admit(head.prompt.size
                                       + head.max_new_tokens)
            if slot is None:
                return            # work-conserving: wait for capacity
            req = self._queue.popleft()
            solo = self.pool.solo_cache()
            if self.prefill_chunk and req.prompt.size > self.prefill_chunk:
                self._prefilling = (req, slot, solo, 0)
                self._advance_prefill()       # the first chunk, this tick
                if self._prefilling is not None:
                    return
                continue
            with torch.no_grad():
                logits, solo = self.model.prefill(
                    self.params, {"tokens": self._tokens(req.prompt[None])},
                    solo)
            self._activate(req, slot, solo, logits)

    def step(self) -> bool:
        """One scheduler tick: admit at the boundary (one prefill chunk at
        most), then one batched decode step — or, speculating, one
        draft+verify round.  Returns False once idle."""
        self._admit()
        if not self._active:
            return not self.idle
        if self.spec_k:
            return self._spec_step()
        self.pool.prepare_step()      # paged pools grant next blocks here
        with torch.no_grad():
            logits, cache = self.model.decode_step(
                self.params, self._tokens(self._tok), self.pool.cache)
        self.pool.cache = cache
        nxt = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
        self.step_count += 1
        for slot, req in list(self._active.items()):
            req.tokens.append(int(nxt[slot]))
            self._tok[slot, 0] = nxt[slot]
            self._maybe_retire(req)
        return not self.idle

    def _draft(self, k: int) -> np.ndarray:
        """[n_slots, k] drafted tokens: from ``draft_source``, or k width-1
        feeds of the branch-only draft model over its shadow cache."""
        n = self.pool.n_slots
        if self.draft_source is not None:
            return np.asarray(
                self.draft_source(dict(self._active), self._tok.copy(), k),
                np.int32).reshape(n, k)
        drafts = np.zeros((n, k), np.int32)
        tok = self._tok
        for j in range(k):
            with torch.no_grad():
                d_logits, d_cache = self.model.draft_decode_step(
                    self.params, self._tokens(tok), self._draft_pool.cache)
            self._draft_pool.cache = d_cache
            drafts[:, j] = torch.argmax(d_logits[:, -1, :],
                                        dim=-1).cpu().numpy()
            tok = drafts[:, j:j + 1]
        return drafts

    def _spec_step(self) -> bool:
        """One draft+verify round over the active batch.

        k is clamped to the smallest remaining token budget of the active
        rows, so no verify write outruns a row's admission reservation.
        k width-1 draft feeds propose d[0..k-1]; verify runs the [N, k]
        block [last_token, d[0..k-2]] through the full cell; per row, the
        longest drafted prefix matching the verify argmaxes is accepted
        plus the first mismatch's correction (1..k tokens a round; a k = 1
        round IS a plain decode step, bit for bit).  The rejected tails
        roll back in the verify cache and the draft cache.
        """
        k = min(self.spec_k,
                min(r.max_new_tokens - len(r.tokens)
                    for r in self._active.values()))
        drafts = self._draft(k)
        block = np.concatenate([self._tok, drafts[:, :k - 1]], axis=1)
        self.pool.prepare_tokens(k)
        with torch.no_grad():
            logits, cache = self.model.verify_step(
                self.params, self._tokens(block), self.pool.cache)
        self.pool.cache = cache
        truth = torch.argmax(logits, dim=-1).cpu().numpy()     # [N, k]
        self.step_count += 1
        self.spec_rounds += 1
        roll: dict[int, int] = {}
        for slot, req in list(self._active.items()):
            d, c = drafts[slot], truth[slot]
            miss = d != c
            j = int(np.argmax(miss)) if miss.any() else k
            req.drafted += k
            req.matched += j
            self.drafted_total += k
            self.matched_total += j
            old_len = req.prompt.size + len(req.tokens) - 1
            for t in c[:min(j + 1, k)]:
                req.tokens.append(int(t))
                if req.eos_id is not None and int(t) == req.eos_id:
                    break                 # EOS mid-block: drop the rest
            self._tok[slot, 0] = req.tokens[-1]
            new_len = req.prompt.size + len(req.tokens) - 1
            self._maybe_retire(req)       # retirement releases the row;
            if slot in self._active and new_len != old_len + k:
                roll[slot] = new_len      # survivors truncate the tail
        self.pool.rollback(roll)
        if self._draft_pool is not None:
            self._draft_pool.rollback(roll)
        return not self.idle

    def drain(self, max_steps: int | None = None) -> int:
        """Run until every submitted request finished; returns the number
        of decode steps taken.  ``max_steps`` raises instead of spinning."""
        start = self.step_count
        while not self.idle:
            if max_steps is not None and \
                    self.step_count - start >= max_steps:
                raise RuntimeError(
                    f"drain() exceeded {max_steps} steps with "
                    f"{self.queued} queued / {self.active} active — "
                    f"scheduler stuck?")
            self.step()
        return self.step_count - start
