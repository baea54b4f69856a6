"""Run one cell of the benchmark of ``simd_dct_tpu_torch`` on this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result; the numbers compared with the reference are the last lines of
standard error.  It needs the cards the cell asks for, and exits with
another code than 0, printing no result, when they are missing, when the
program is missing, or when ``jax``, ``jaxlib``, ``flax`` or
``simd_dct_tpu`` has been loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

STAGES = [("python and the harness", time.perf_counter())]


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = harness.Bench()
    chips = bench.cell(args.workload)["chips"]
    import torch
    STAGES.append(("import torch", time.perf_counter()))
    torch.set_num_threads(1)    # the host's work is the program's launches
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA card(s); "
                    f"torch.cuda.is_available() is "
                    f"{torch.cuda.is_available()}, device_count() "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    STAGES.append(("the CUDA driver", time.perf_counter()))
    try:
        __import__(harness.PROGRAM)
    except ImportError as e:
        harness.log(f"cannot import the program {harness.PROGRAM}: {e}")
        return 3
    STAGES.append(("the program", time.perf_counter()))
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), t0=T0, stages=STAGES)
    loaded = harness.forbidden_modules()
    if loaded:
        harness.log(f"forbidden modules were loaded: {', '.join(loaded)}")
        return 4
    for name, c in result["checks"].items():
        harness.log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
