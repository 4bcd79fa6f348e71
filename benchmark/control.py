"""The readings that the check's limits are set from, at a cell's own size:
the program's numbers over many seeds, and the control's, in one process.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 --seconds 2

For each seed it prints one JSON line: the program's numbers from a run of
the cell (`run.run_cell`, a short window at the cell's own load), and the
control's: the plain reference computed with TF32 operands in every product
(float32 with TF32 off is what the configuration states), put in the
program's place for every chunk the check compares (and, in a solve mix,
for the ARE), judged against the float64 reference by the same gaps.  With
--fault the program runs with that fault of `faults.py` planted, and its
numbers are the fault's readings.  The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json

import torch

from benchmark import faults, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        run.log("[control] needs a CUDA card")
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(args.workload, seed, args.seconds, False, device,
                           faults=faults.FAULTS.get(args.fault), control=args.fault is None)
        torch.cuda.empty_cache()
        prog = {k: v["value"] for k, v in res["checks"].items()}
        ctl = res.get("control")
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "correct": res["correct"],
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                          "program": prog, "control": ctl}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
