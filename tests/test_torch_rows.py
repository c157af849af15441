"""Batch-invariant row slices (``repro_torch/core/rows.py``) on the CPU.

Batched decode equals solo decode bit for bit on the card only if every
batch-variant op (a cuBLAS GEMM, a reduction) sees the same shape for a
row whatever the pool's size.  ``rows.rowwise`` runs such an op on
consecutive ``ROW_BUCKET``-row slices, the last one zero-padded.  Here a
recording op sees only 16-row inputs at every pool size, the sliced
result equals the unsliced one, and one decode step of the Gemma-2B smoke
model with 40 rows runs every ``rowwise`` op of the step on 16-row slices.
The card's bitwise check is ``test_torch_gpu.py``'s pool test.
"""

import pytest
import torch

from repro_torch.core import rows
from repro_torch.serve import registry


@pytest.mark.parametrize("m", (0, 1, 16, 17, 40, 64))
def test_rowwise_hands_the_op_only_bucket_rows(m):
    gen = torch.Generator().manual_seed(m)
    a = torch.randn((m, 5), generator=gen)
    b = torch.randn((m, 3, 2), generator=gen)
    seen = []

    def op(x, y):
        seen.append((x.shape[0], y.shape[0]))
        return x * 3.0 + y.sum(dim=(1, 2))[:, None]

    got = rows.rowwise(op, a, b)
    assert seen == [(rows.ROW_BUCKET, rows.ROW_BUCKET)] * max(1, -(-m // 16))
    assert got.shape == (m, 5)
    assert torch.equal(got, a * 3.0 + b.sum(dim=(1, 2))[:, None])


def test_decode_step_runs_every_rowwise_op_on_bucket_rows(monkeypatch):
    model, _ = registry.compile_entry("gemma-2b-smoke")
    params = model.init(seed=0, device="cpu")
    batch, max_len = 40, 16
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, model.cfg.vocab_size, (batch, 4),
                           generator=gen)
    cache = model.init_cache(batch, max_len, dtype=torch.float32,
                             device="cpu")
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens}, cache)
    nxt = logits[:, -1].argmax(-1, keepdim=True)
    direct = {k: v.clone() for k, v in cache["layers"].items()}

    sliced = rows.rowwise
    seen = []

    def recording(fn, *args):
        seen.append([a.shape[0] for a in args])
        return sliced(lambda *r: (seen.append([t.shape[0] for t in r])
                                  or fn(*r)), *args)

    monkeypatch.setattr(rows, "rowwise", recording)
    with torch.no_grad():
        got, _ = model.decode_step(params, nxt, cache)
    calls = [s for s in seen if s[0] == batch]
    inner = [s for s in seen if s[0] != batch]
    assert calls, "the decode step ran no rowwise op"
    assert len(inner) == 3 * len(calls)                # 16 + 16 + 8 rows
    assert all(set(s) == {rows.ROW_BUCKET} for s in inner)

    # the same step with the ops on all 40 rows at once: the same values
    monkeypatch.setattr(rows, "rowwise", lambda fn, *args: fn(*args))
    cache["layers"].update({k: v.clone() for k, v in direct.items()})
    with torch.no_grad():
        want, _ = model.decode_step(params, nxt, cache)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
