#!/usr/bin/env python3
"""Time the bitserial macro's binary counts both ways on one CUDA card.

    python3 scripts/bitcount_ab.py

Builds ``scripts/bitcount_ab.cu`` with nvcc into ``build/``, checks the
fragment layout of ``mma.m16n8k128 .b1 .and.popc`` against numpy
popcounts, then times six loops, each of 512 counts per warp and
iteration (a count is popc(lo & w) + 2 popc(hi & w) over 128 rows): the
counts from the binary tensor cores (8 MMAs) or from AND + ``__popc``
(128 of each), alone, with the uint8 code-table ADC, or with the IEEE
division ADC of the earlier tile.  Prints the card's name and power
limit, and per loop the counts per second and, for the MMA loops, the
binary multiply-accumulates per second (16 x 8 x 128 per MMA).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("popc", "mma", "popc+table", "mma+table", "popc+division",
         "mma+division")


def build() -> ctypes.CDLL:
    out = os.path.join(ROOT, "build", "bitcount_ab.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
                    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
                    out, os.path.join(ROOT, "scripts", "bitcount_ab.cu")],
                   check=True)
    lib = ctypes.CDLL(out)
    lib.run_layout.argtypes = [ctypes.c_void_p] * 3
    lib.run_bench.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    lib = build()
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, (16, 4), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (8, 4), dtype=np.uint64).astype(np.uint32)
    want = np.array([[sum(bin(int(a[r, w]) & int(b[c, w])).count("1")
                          for w in range(4)) for c in range(8)]
                     for r in range(16)])
    dev = torch.device("cuda")
    ta = torch.from_numpy(a.view(np.int32)).to(dev)
    tb = torch.from_numpy(b.view(np.int32)).to(dev)
    td = torch.zeros((16, 8), dtype=torch.int32, device=dev)
    assert lib.run_layout(ta.data_ptr(), tb.data_ptr(), td.data_ptr()) == 0
    torch.cuda.synchronize()
    ok = np.array_equal(td.cpu().numpy(), want)
    print(f"layout check: {'ok' if ok else 'WRONG'}")

    seed = torch.from_numpy(rng.integers(-2**31, 2**31, 512, dtype=np.int64)
                            .astype(np.int32)).to(dev)
    table = torch.randint(0, 32, (129 * 385,), dtype=torch.uint8, device=dev)
    blocks, iters = 132 * 8, 2048
    out = torch.empty(blocks * 256, dtype=torch.float32, device=dev)
    counts = blocks * 8 * 512 * iters
    for variant, name in enumerate(NAMES):
        def run():
            rc = lib.run_bench(variant, seed.data_ptr(), table.data_ptr(),
                               out.data_ptr(), blocks, iters)
            assert rc == 0, rc
        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            run()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 5
        rate = counts / ms * 1e3
        extra = ""
        if "mma" in name:
            macs = counts * 256 / ms * 1e3   # 16 x 8 x 128 per 64 counts
            extra = f" binary_MAC/s {macs:.4e}"
        print(f"{name}: {ms:.4f} ms counts/s {rate:.4e}{extra}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
