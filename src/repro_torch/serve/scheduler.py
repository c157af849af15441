"""Continuous batching: interleave prefill and decode over one cell (port
of ``repro.serve.scheduler``).

Life of a request:

  submit -> admission queue (FIFO) -> [pool.try_admit: a row, and —
  paged — blocks for the whole request] solo prefill (batch=1, the
  standalone path) -> KV adopted into the pool (dense row copy or paged
  block scatter) -> joins the batched ``decode_step`` at the next step
  boundary -> retires when done (max_new_tokens or EOS) -> capacity freed,
  the rest of the batch keeps decoding.

Invariants (``tests/test_torch_lm_serve.py``): occupancy never exceeds the
pool; admission is FIFO and work-conserving; each request's tokens equal
a solo ``prefill`` + ``decode_step`` run of the same prompt, because the
per-row cache makes batched decode row-independent.  That last one needs
every op to compute a row with the same bits whatever the batch: the
port's kernels do by construction, and the GEMMs and reductions that
would not (cuBLAS picks its kernel by shape on the card) run on bucketed
rows (``core.rows``).  Decoding is greedy (argmax).

Scenario hot-swap (``repro_torch.scenario``): a swap is a BARRIER in the
same FIFO queue requests ride.  It applies at a decode-step boundary once
every request admitted before it has retired, so a request decodes
entirely under the scenario it was submitted with — bit-identical to a
fresh single-scenario cell — while requests behind the barrier wait.
The swap itself is ``scenario.swap_params``: the trunk tensors pass
through as the same objects, not one ROM byte is copied.

Waiting for a later slice (ROADMAP Queue 1 item 2): speculative decode
(``spec_k > 0``) and chunked prefill (``prefill_chunk``); prompts are
prefilled whole.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.scenario import swap_params


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

    @property
    def done(self) -> bool:
        return self.finish_step >= 0

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.submit_s


class ContinuousBatcher:
    """Admission queue + decode loop over one model and one KV pool (dense
    :class:`~repro_torch.serve.pool.SlotPool` or paged
    :class:`~repro_torch.serve.pool.PagedPool`)."""

    def __init__(self, model, params, pool, *, scenario: str | None = None,
                 prefill_chunk: int = 0, spec_k: int = 0):
        if spec_k:
            raise NotImplementedError(
                f"spec_k={spec_k}: speculative decode is not ported yet "
                f"(ROADMAP Queue 1 item 2); pass spec_k=0")
        if prefill_chunk:
            raise NotImplementedError(
                f"prefill_chunk={prefill_chunk}: chunked prefill is not "
                f"ported yet (ROADMAP Queue 1 item 2); pass "
                f"prefill_chunk=0 (whole-prompt admission)")
        self.model = model
        self.params = params
        self.pool = pool
        self.scenario = scenario            # live branch label
        self.swap_count = 0                 # swaps applied so far
        self.device = pool.cache["layers"]["k"].device
        self._queue: collections.deque = collections.deque()
        self._active: dict[int, Request] = {}       # slot -> request
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
    def idle(self) -> bool:
        return not self._queue and not self._active

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

    def _admit(self) -> None:
        """FIFO admission: the head request admits only when the pool can
        guarantee it; it is prefilled solo, adopted, and its first token
        comes from the prefill logits.  A swap barrier at the head applies
        only once the active requests have retired."""
        while self._queue:
            head = self._queue[0]
            if isinstance(head, _Swap):
                if self._active:
                    return        # in-flight requests finish on their branch
                self._apply_swap(self._queue.popleft())
                continue
            slot = self.pool.try_admit(head.prompt.size
                                       + head.max_new_tokens)
            if slot is None:
                return            # work-conserving: wait for capacity
            req = self._queue.popleft()
            solo = self.pool.solo_cache()
            tokens = torch.as_tensor(req.prompt[None], device=self.device)
            with torch.no_grad():
                logits, solo = self.model.prefill(
                    self.params, {"tokens": tokens}, solo)
            self.pool.adopt(slot, solo)
            first = int(torch.argmax(logits[0, -1]))
            req.slot = slot
            req.admit_step = self.step_count
            req.tokens.append(first)
            self._tok[slot, 0] = first
            self._active[slot] = req
            self._maybe_retire(req)           # 1-token requests finish here

    def step(self) -> bool:
        """One scheduler tick: admit at the boundary, then one batched
        decode step.  Returns False once idle."""
        self._admit()
        if not self._active:
            return not self.idle
        self.pool.prepare_step()      # paged pools grant next blocks here
        tok = torch.as_tensor(self._tok, device=self.device)
        with torch.no_grad():
            logits, cache = self.model.decode_step(self.params, tok,
                                                   self.pool.cache)
        self.pool.cache = cache
        nxt = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
        self.step_count += 1
        for slot, req in list(self._active.items()):
            req.tokens.append(int(nxt[slot]))
            self._tok[slot, 0] = nxt[slot]
            self._maybe_retire(req)
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
