"""(Re)generate or check the checked-in table of Hopper launch plans.

Generate on a CUDA card (times every legal plan per conv-site geometry,
checks each one bitwise against the shape rule's, writes the winners as
deterministic JSON to ``repro_torch/tune/hopper_table.json``):

    PYTHONPATH=src python -m repro_torch.tune \
        [--models darknet19 resnet18 tiny_yolo] [--sizes 32] \
        [--modes ideal] [--kernels trunk_conv cim_matmul] \
        [--batches 1 8] [--repeat 3] [--full-sweep] [--out PATH]

Check (static consistency of the table against the CURRENT site
enumeration and the plans the kernels compile; exits nonzero on drift;
runs anywhere, the CPU included):

    PYTHONPATH=src python -m repro_torch.tune --check

Without ``--check`` it refuses to run without a card: on the CPU the
wrappers run their plain versions, which take no plan.
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.tune import autotune, table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", nargs="+",
                    default=["darknet19", "resnet18", "tiny_yolo"],
                    help="model families whose conv sites seed the table")
    ap.add_argument("--sizes", nargs="+", type=int, default=[32],
                    help="input resolutions to enumerate sites at")
    ap.add_argument("--modes", nargs="+", default=["ideal"],
                    choices=["ideal", "per_subarray", "bitserial"],
                    help="CiM fidelity modes to tune")
    ap.add_argument("--kernels", nargs="+",
                    default=["trunk_conv", "cim_matmul"],
                    choices=sorted(autotune.KERNEL_DEFAULTS),
                    help="kernels to tune per site geometry")
    ap.add_argument("--batches", nargs="+", type=int, default=[1, 8],
                    help="serving batch sizes to enumerate (the patch "
                         "GEMM's M axis is batch*OH*OW; 8 is the "
                         "CNNServer micro-batch default)")
    ap.add_argument("--repeat", type=int, default=3,
                    help="timed graph replays per candidate (best-of-k)")
    ap.add_argument("--full-sweep", action="store_true",
                    help="the fused matmul's whole (trunk x sketch) plan "
                         "product (default: each axis at the rule's other)")
    ap.add_argument("--out", default=None,
                    help="output path (default: the checked-in table)")
    ap.add_argument("--check", action="store_true",
                    help="verify the table against the current site shapes "
                         "instead of regenerating it")
    args = ap.parse_args(argv)

    if args.check:
        return 0 if autotune.check_table(args.out) else 1
    if not torch.cuda.is_available():
        print("python -m repro_torch.tune times the CUDA kernels and needs a "
              "card (use --check to check the table)", file=sys.stderr)
        return 2

    entries, meta = autotune.tune_table_for(
        tuple(args.models), tuple(args.sizes), tuple(args.modes),
        tuple(args.kernels), batches=tuple(args.batches),
        repeat=args.repeat, fast=not args.full_sweep,
        log=lambda line: print(line, flush=True))
    out = args.out or table._DEFAULT_PATH
    table.save_table(entries, out, meta=meta)
    table.invalidate_cache()
    print(f"wrote {len(entries)} entries to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
