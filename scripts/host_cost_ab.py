#!/usr/bin/env python3
"""The host cost of one LM kernel-wrapper call, for several checkouts in
turns on one card: this checkout's ``chip_smoke.lm_host_costs`` (phase 5's
host us of ``rebranch_trunk_sketch``, ``cim_matmul`` and their pieces at
8 rows, 2048 x 2048) run against each checkout's ``repro_torch``.

    python3 scripts/host_cost_ab.py DIR_A DIR_B DIR_B DIR_A

Each DIR is a checkout of this repository (for example a ``git archive``
of another commit, unpacked into a git-ignored directory); each run is a
process of its own that builds and imports DIR's kernels and package and
measures three times.  Host times move between processes and machines, so
compare checkouts only within one call.  Prints each run's lines, then per
checkout the median of each piece over its runs, and exits non-zero if a
run failed.
"""

from __future__ import annotations

import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 3
RUN = """
import sys
sys.path[:0] = [{here!r}, {src!r}]
import chip_smoke as cs
from repro_torch import device
from repro_torch.kernels import _build
_build.build()
dev = device.resolve()
for _ in range({reps}):
    cs.lm_host_costs(dev)
"""


def run(tree: str) -> tuple[int, str]:
    root = os.path.abspath(tree)
    code = RUN.format(here=HERE, src=os.path.join(root, "src"), reps=REPS)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True)
    return proc.returncode, proc.stdout + proc.stderr


def pieces(log: str) -> list[dict]:
    """{piece: us} of each ``host us per call`` line of a run's log."""
    out = []
    for line in log.splitlines():
        if line.startswith("host us per call"):
            body = line.split("): ", 1)[1]
            out.append({m.group(1): float(m.group(2)) for m in re.finditer(
                r"(.+?) ([\d.]+)(?:; |$)", body)})
    return out


def main(trees: list[str]) -> int:
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    samples: dict[str, list[dict]] = {}
    failed = False
    for i, tree in enumerate(trees):
        rc, log = run(tree)
        print(f"=== run {i}: {tree} (exit {rc})\n{log}", flush=True)
        got = pieces(log)
        failed |= rc != 0 or len(got) != REPS
        samples.setdefault(tree, []).extend(got)
    for tree, runs in samples.items():
        if not runs:
            continue
        medians = "; ".join(
            f"{name} {statistics.median(r[name] for r in runs):.2f}"
            for name in runs[0])
        print(f"{tree}: median host us over {len(runs)} measures: "
              f"{medians}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
