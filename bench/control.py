"""Readings that set the limits of `correct`: for each seed, a short window
of the program and its answers against the reference, then the control
(the reference put in the program's place at TF32, the nearest precision
below the configuration's fp32) against the same reference, in one
process.

    python3 bench/control.py --workload <name> --seeds 1,2,3 --seconds 5

One JSON line a seed: {"seed", "<mode>": {numbers}, ...}; `--modes`
adds the planted faults of a training cell.
The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--modes", default="program,control",
                    help="program, control, and for training the planted "
                         "faults unchanged, half, altered")
    args = ap.parse_args()
    import torch

    from bench import harness
    _, config, traffic = harness.cell_parts(harness.load_spec(),
                                            args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        system = harness.make(config, traffic, seed, "cuda")
        rec = system.window(args.seconds)
        system.stop()
        line = {"seed": seed, "setup_and_window_s": time.perf_counter() - t0}
        line.update(system.check(rec, modes=tuple(args.modes.split(","))))
        print(json.dumps(line), flush=True)
        del system, rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
