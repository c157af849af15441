#!/usr/bin/env python3
"""Serve DarkNet-19 from several checkouts in turns on one card: phase 3
of each checkout's ``chip_smoke.py`` (``darknet19-416`` through
``CNNServer``: the requests, the launch counts, pad rows, three sustained
runs of 256 images, the chunk's device forward).

    python3 scripts/serve_ab.py DIR_A DIR_B DIR_B DIR_A

Each DIR is a checkout of this repository (for example a ``git archive``
of another commit, unpacked into a git-ignored directory).  Each run is a
process of its own, so each checkout builds and imports its own kernels
and package; the runs go in the order given, on the same card, so that a
host-bound measure (images/s) is compared within one machine.  Prints each
run's log, then one line per run with its sustained images/s (mean, min,
max) and device forward, and exits non-zero if a run failed.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

RUN = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import chip_smoke as cs
from repro_torch import device
from repro_torch.models import cnn
device.resolve()
cs.phase_build()
cs.phase_serve(cnn.CNNConfig(name="darknet19", input_size=cs.SIZE))
"""


def run(tree: str) -> tuple[int, str]:
    root = os.path.abspath(tree)
    code = RUN.format(root=root, src=os.path.join(root, "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True)
    return proc.returncode, proc.stdout + proc.stderr


def main(trees: list[str]) -> int:
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    rows, failed = [], False
    for i, tree in enumerate(trees):
        rc, log = run(tree)
        print(f"=== run {i}: {tree} (exit {rc})\n{log}", flush=True)
        rate = re.search(r"sustained images/s: mean ([\d.]+), min ([\d.]+), "
                         r"max ([\d.]+)", log)
        fwd = re.search(r"device forward ([\d.]+) ms", log)
        failed |= rc != 0 or rate is None
        rows.append((i, tree, rate.groups() if rate else None,
                     fwd.group(1) if fwd else None))
    print("run tree sustained_images_per_s(mean min max) chunk_forward_ms")
    for i, tree, rate, fwd in rows:
        print(f"{i} {tree} {' '.join(rate) if rate else 'failed'} {fwd}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
