"""The readings the correctness limits are set from, on the card at the
cell's own size (the benchmark's own runs do not run this):

- the program's numbers on each of `--seeds` (sound runs), with the
  control's beside them: the plain reference in TF32 in the program's place,
  on the same inputs;
- the program's numbers with each fault of `portbench/faults.py` planted,
  on each of `--fault-seeds`.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--fault-seeds 4,5,6] \
        [--seconds 2] [--out <file.jsonl>]

One JSON line per run, on standard output and appended to `--out`. A fault
that makes the run raise is recorded with its error: it has failed.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.harness import Cell, run_cell  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default="", help="the faults to plant (default: every one the loop can have)")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = Cell(args.workload)
    FAULTS = cell.loop().FAULTS
    # the recorded iteration is the first of the warm-up: one is enough here
    cell.traffic["warmup_iterations"] = 1
    out = open(args.out, "a") if args.out else None
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    faults = [f for f in args.faults.split(",") if f] or list(FAULTS)
    runs += [(int(s), f) for s in args.fault_seeds.split(",") if s for f in faults]
    for seed, fault in runs:
        t = time.perf_counter()
        try:
            res = run_cell(cell, seed, args.seconds, False, "cuda",
                           plant=FAULTS[fault] if fault else None, control=fault is None)
            line = {"workload": cell.name, "seed": seed, "fault": fault, "correct": res["correct"],
                    "program": {k: c["value"] for k, c in res["checks"].items()},
                    "control": res.get("control"), "attempted": res["attempted"],
                    "metrics": {k: m["value"] for k, m in res["metrics"].items()}}
        except Exception as e:  # a planted fault may break the run: it has failed
            if fault is None:
                raise
            line = {"workload": cell.name, "seed": seed, "fault": fault, "correct": False, "error": repr(e)}
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    if out:
        out.close()


if __name__ == "__main__":
    main()
