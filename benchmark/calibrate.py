"""Readings that the limits of a cell's comparison are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 2 [--out readings.jsonl]

in one process: a short window of the cell at its own load for each seed,
its judged outputs compared with the reference, then the same with the
control (the reference computed in TensorFloat-32, one precision below the
configurations' float32) in the program's place.  Each line printed is one
run's numbers compared; the largest of the program's and the smallest of
the control's are printed last.  ``--device cpu`` runs the program's plain
tier instead of the card, for a copy of the benchmark cut to a tiny size.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    bench = harness.Bench()
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    runs += [(int(s), "tf32") for s in args.control_seeds.split(",") if s]
    lines = []
    for seed, control in runs:
        r = harness.run_cell(bench, args.workload, seed, args.seconds, False,
                             device=args.device, control=control)
        line = {"workload": args.workload, "seed": seed,
                "side": control or "program", "correct": r["correct"],
                "attempted": r["attempted"], "failed": r["failed"],
                "checks": {k: v["value"] for k, v in r["checks"].items()},
                "frames_per_s": r["metrics"].get("frames_per_s", {}).get("value"),
                "kind": r["device"]["kind"]}
        print(json.dumps(line), flush=True)
        lines.append(line)
    for side, pick in (("program", max), ("tf32", min)):
        got = [ln["checks"] for ln in lines if ln["side"] == side]
        if got:
            print(json.dumps({"side": side, pick.__name__: {
                k: pick(g[k] for g in got) for k in got[0]}}), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for ln in lines:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
