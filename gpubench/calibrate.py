"""The readings a cell's limits are set from, at the cell's own size:

    python3 -m gpubench.calibrate --workload <cell> --program-seeds 1,2,... \\
        --control-seeds 7,8,9 [--out chiprun_out/<file>.jsonl]

For each program seed, the numbers a sound run of the program gives
(set-up and the checked chunk; a training cell needs no window).  For
each control seed, the numbers of the control (the reference computed in
fp8 where the program computes in bf16, put in the program's place) and
of the faults a run can have, planted in the reference put in the
program's place.  One JSON line each.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from gpubench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.pin_caches()
    spec = harness.cell_spec(args.workload)
    driver = importlib.import_module(f"gpubench.drivers.{spec['traffic']['driver']}")
    if not torch.cuda.is_available():
        print("gpubench.calibrate: the readings are the card's; torch sees no CUDA device",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    try:
        for kind, seeds, fn in (("program", args.program_seeds, driver.program_numbers),
                                ("control", args.control_seeds, driver.control_numbers)):
            for s in filter(None, seeds.split(",")):
                line = json.dumps({"workload": args.workload, "kind": kind, "seed": int(s),
                                   "numbers": fn(spec, int(s), device)})
                print(line, flush=True)
                if out is not None:
                    print(line, file=out, flush=True)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
