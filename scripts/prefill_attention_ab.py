#!/usr/bin/env python3
"""Chunked vs whole-prompt prefill attention at Gemma-2B's geometry, on
the card.

    python3 scripts/prefill_attention_ab.py

A prompt prefilled in chunks must adopt the bits of a whole-prompt
prefill.  Both attend over the same ``max_len`` cache view, but with
another number of queries per call (a chunk's 32 against the prompt's
length), and cuBLAS and PyTorch's reductions pick their order from the
shape.  For prompts of 40-200 tokens at Gemma-2B's attention (8 query
heads, one KV head, head_dim 256, ``max_len`` 256, ``attn_chunk`` 1024),
random bf16 q/k/v, this holds each chunk's output rows against the same
rows of the whole-prompt call, for the queries run all at once
(``layers._chunked_causal_attention``) and on fixed 16-query slices
(``layers._prefill_attention``, what the port runs), and times both.

A model-level prefill of B prompts must also give each row the bits of
its solo prefill.  For 8 rows of random bf16 q/k/v at the attention
geometries of Gemma-2B, Qwen2-VL-2B (12 query heads, 2 KV heads,
head_dim 128) and MusicGen-large (32 and 32, head_dim 64, ``max_len``
128: phase 26 of ``chip_smoke.py``), this holds each row of one call
over all 8 rows (``layers._prefill_attention``, what the port runs)
against the same row run alone, and times the batched call against 8
one-row calls.

Prints one line per prompt and mode; exits 1 if the sliced mode differs
from the whole prompt.  The servers prefill one row per call, so the
batched lines are a measurement, not a check: phase 26 holds MusicGen's
model-level batched prefill to its solo runs.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

H, KV, DH, MAX_LEN, ATTN_CHUNK, CHUNK = 8, 1, 256, 256, 1024, 32
PROMPTS = (40, 97, 200)
ROWS = 8
# (model, query heads, KV heads, head_dim, max_len, prompt lengths)
BATCH_GEOMS = (("gemma-2b", 8, 1, 256, 256, (32, 97)),
               ("qwen2-vl-2b", 12, 2, 128, 256, (32, 97)),
               ("musicgen-large", 32, 32, 64, 128, (8, 32)))


def events_ms(fn, reps: int = 10) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def batched_vs_solo(gen, dev):
    from repro_torch.models import layers
    for name, h, kv, dh, max_len, prompts in BATCH_GEOMS:
        for s in prompts:
            q = torch.randn((ROWS, s, h, dh), generator=gen, device=dev
                            ).to(torch.bfloat16)
            k, v = (torch.randn((ROWS, max_len, kv, dh), generator=gen,
                                device=dev).to(torch.bfloat16)
                    for _ in range(2))
            k[:, s:] = 0
            v[:, s:] = 0

            def batched():
                return layers._prefill_attention(q, k, v, ATTN_CHUNK, 0, 0)

            def solo():
                return torch.cat([layers._prefill_attention(
                    q[i:i + 1], k[i:i + 1], v[i:i + 1], ATTN_CHUNK, 0, 0)
                    for i in range(ROWS)])
            got, want = batched(), solo()
            rows = [i for i in range(ROWS) if not torch.equal(got[i],
                                                               want[i])]
            diff = (got - want).abs().max().item()
            print(f"{name} attention ({h} q / {kv} kv heads, head_dim {dh}, "
                  f"max_len {max_len}), {ROWS} rows x {s}-token prompts: "
                  f"batched == solo {not rows} (max abs diff {diff:.3e}, "
                  f"rows differing {rows}); one call "
                  f"{events_ms(batched):.3f} ms, {ROWS} one-row calls "
                  f"{events_ms(solo):.3f} ms (CUDA events)")


def main() -> int:
    from repro_torch.models import layers
    if not torch.cuda.is_available():
        print("prefill_attention_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    modes = {
        "all queries at once": lambda q, k, v, off: (
            layers._chunked_causal_attention(q, k, v, ATTN_CHUNK,
                                             kv_offset=off)),
        "16-query slices": lambda q, k, v, off: layers._prefill_attention(
            q, k, v, ATTN_CHUNK, 0, off)}
    ok = True
    for s in PROMPTS:
        # bf16, as Gemma-2B's activations reach the attention
        q, k, v = (torch.randn(shape, generator=gen, device=dev
                               ).to(torch.bfloat16)
                   for shape in ((1, s, H, DH), (1, MAX_LEN, KV, DH),
                                 (1, MAX_LEN, KV, DH)))
        # the cache view of the prompt: positions past it are zero, as in
        # a fresh solo cache (masked either way)
        k[:, s:] = 0
        v[:, s:] = 0
        for name, fn in modes.items():
            whole = fn(q, k, v, 0)
            parts = torch.cat([fn(q[:, lo:lo + CHUNK], k, v, lo)
                               for lo in range(0, s, CHUNK)], dim=1)
            same = torch.equal(whole, parts)
            diff = (whole - parts).abs().max().item()
            rows = int((whole != parts).any(-1).any(-1).sum())
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            fn(q, k, v, 0)
            start.record()
            for _ in range(10):
                fn(q, k, v, 0)
            end.record()
            end.synchronize()
            print(f"prompt {s}, chunks of {CHUNK}, {name}: chunked == whole "
                  f"{same} (max abs diff {diff:.3e}, {rows} of {s} query "
                  f"rows differ); whole-prompt call "
                  f"{start.elapsed_time(end) / 10:.3f} ms (CUDA events)")
            ok &= same or name != "16-query slices"
    batched_vs_solo(gen, dev)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
