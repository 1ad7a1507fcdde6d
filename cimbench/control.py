"""The control of the check, and the lower readings beside it.

For each seed, one run of the cell (set-up, a window of ``--seconds``,
the check) in one process; it prints, per seed, the numbers compared for
the program (the lower readings) and for the control: the reference
computed in float32, one precision below the configuration's float64
pricing, put in the program's place.  The control has to fail.

    python3 cimbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 10

The benchmark's own runs never run it.
"""
import argparse
import json
import sys

import run as _run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    _run._env()
    from cimbench import check
    from cimbench.bench import run_cell
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(args.workload, seed, args.seconds, False,
                       device="cuda", control=True)
        program = {k: v["value"] for k, v in out["checks"].items()}
        rows.append({"seed": seed, "correct": out["correct"],
                     "program": program, "control": out["control"],
                     "control_fails": not check.verdict(out["control"])})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "program_correct": all(r["correct"] for r in rows),
                      "control_fails": all(r["control_fails"]
                                           for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
