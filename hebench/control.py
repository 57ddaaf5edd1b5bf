"""The control: the plain reference put in the program's place, at the
precision below the configuration's, through a whole run of the harness.

    python3 hebench/control.py --workload <cell> --seeds 1,2,3 [--seconds 2] [--exact]

For each seed it runs the cell as run.py does, with the kind's `control`
(hebench/kinds/<kind>.py) in place of the program's calls in set-up and
window: every modular product rounded to float64 in the key-switching
cells, the codec in float32 in the codec cell; with --exact the reference
at full precision, which has to come out correct. The run's own judgement
decides; one JSON line a seed gives `correct` and each number beside its
limit. Not part of a benchmark run: it sets the upper reading of each
limit (PERF.md) and is kept as a test at a tiny ring
(tests/test_hebench_control.py).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--exact", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from hebench import harness

    torch.set_num_threads(1)
    control = "exact" if args.exact else "below"
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run(args.workload, seed, args.seconds, False, t0, device=args.device,
                          control=control)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": control,
                          "seconds": time.perf_counter() - t0, "correct": res["correct"],
                          "failed": res["failed"], "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
