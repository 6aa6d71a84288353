"""Readings for a cell's limits: the program's on many seeds and the
control's (the plain reference computed in a lower precision, put in
the program's place) on some, in one process that sets the cell up once.

    python3 bhbench/control.py --workload bench_fwdbwd_rk4 \
        --seeds 1,2,3 --control-seeds 1,2,3 --seconds 5 [--dtype bfloat16]

Prints one JSON line per reading.  The benchmark's own runs never run
the control.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bhbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bhbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.manifest()
    cell, config, traffic = harness.cell_of(bench, args.workload)
    driver = importlib.import_module("bhbench.drivers." + traffic["driver"])
    dev = torch.device("cuda")

    def new_run(seed):
        return harness.Run(cell["name"], config, traffic, seed, args.seconds,
                           False, dev, time.time())

    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    t = time.perf_counter()
    c = driver.Cell(new_run(seeds[0]))
    print(json.dumps({"setup_s": time.perf_counter() - t}), flush=True)
    for seed in seeds:
        c.r = new_run(seed)
        c._refs = {}
        c.window()
        t = time.perf_counter()
        c.check()
        line = {"seed": seed, "kind": "program",
                "readings": {n: v for n, v, _ in c.r.checks},
                "e2e": c.r.e2e, "attempted": c.r.attempted,
                "failed": c.r.failed, "check_s": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        if seed in controls:
            t = time.perf_counter()
            got = c.control(getattr(torch, args.dtype))
            print(json.dumps({"seed": seed, "kind": "control",
                              "dtype": args.dtype, "readings": got,
                              "control_s": time.perf_counter() - t}),
                  flush=True)
    if hasattr(c, "close"):
        c.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
