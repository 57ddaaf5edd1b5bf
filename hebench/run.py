"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 hebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON object on the last line of standard output,
and the numbers compared with their limits as the last lines of standard
error. Exits non-zero, printing no result, without the CUDA devices the
cell asks for, without the program, or when the run loaded JAX or the JAX
package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    # one host thread: the program's host work is serial, and a pool of
    # threads on a shared host made set-up 2.6 times longer on the card's
    # machine (5.1 s against 13.4 s for std128.ks_b64)
    torch.set_num_threads(1)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next(w["chips"] for w in spec["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hebench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    try:
        import hehub_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"hebench: the program is not here: {err}", file=sys.stderr)
        return 2
    from hebench import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    except harness.ForbiddenModules as err:
        print(f"hebench: {err}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
