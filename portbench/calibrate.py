"""The readings that a cell's limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 [--control] [--out FILE]

For each seed, in one process: the cell's set-up from that seed (weights,
inputs, the program, its warm-up), ``calibrate_calls`` calls of the program
at the cell's own sizes (``check_calls`` where the traffic sets none), and
the numbers that the harness compares over the calls it would sample, of
the program against the plain reference (the lower readings). With
``--control``, also the reference computed in the precision below the
configuration's (portbench/reference/: float8 operands in every linear and
convolution) put in the program's place, against the reference (the upper
readings). One JSON line a seed goes to standard output and to ``--out``.
The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = next(c for c in bench["workloads"] if c["name"] == args.workload)
    pb = ROOT / "portbench"
    cfg = harness.load_json(pb / "configs" / f"{cell['config']}.json")
    traffic = harness.load_json(pb / "traffic" / f"{cell['traffic']}.json")
    driver = harness.load_module(pb / "drivers" / f"{traffic['driver']}.py")
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        state = driver.setup(cfg, traffic, seed, "cuda")
        calls = traffic.get("calibrate_calls", traffic["check_calls"])
        records = [driver.call(state, i) for i in range(calls)]
        driver.release(state)
        row = {"cell": args.workload, "seed": seed, "program": driver.judge(state, records, seed)}
        if args.control:
            row["control"] = driver.control(state, records, driver.picks_of(records, traffic["check_calls"], seed))
        row["seconds"] = time.perf_counter() - t0
        del state
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
