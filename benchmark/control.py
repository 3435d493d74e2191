"""Readings that set the limits of a training cell's comparison; the
benchmark's own runs never run this.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13

For each seed, on the cell's own corpus, weights and first batches (those
the program's loader gives), the fp32 reference is held against what the
check would read if the reference stood in the program's place (each
driver's ``control_readings``):

  control    the reference with fp8 (e4m3) products, one precision below
             the configuration's bf16;
  half       half of each batch's rows left out, the mean over the rest;
  unchanged  a step that leaves the state unchanged (learning rate 0);
  altered    (lattice cells) one link's pdf altered in each utterance's
             lattice, where the search produces it.

Prints one JSON line a seed with each reading of each number.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    import torch

    import run

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    bench = run.load_bench(os.path.dirname(HERE))
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = run.Context(bench, args.workload, seed, 10.0, False, dev, time.perf_counter())
        driver = importlib.import_module("drivers." + ctx.mix["driver"])
        tmp = tempfile.mkdtemp(prefix="pk2ctl-")
        try:
            print(json.dumps({"seed": seed, **driver.control_readings(ctx, tmp)}), flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
