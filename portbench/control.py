"""The control and the program's readings of the comparison, on many seeds
in one process (set-up once), for setting the limits.

    python3 -m portbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed: one run of the cell as ``portbench.run`` makes it (a window
of ``--seconds``), the program's numbers against the reference, and the
control's: the reference computed with bfloat16 between its stages, put
in the program's place and judged the same way.  One JSON line a seed.
The benchmark's own runs do not run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import cells, harness
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    cell = cells.load_cell(Path.cwd(), args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = harness.execute(cell, seed, args.seconds, False, "cuda:0", t0,
                            log=lambda m: print(m, file=sys.stderr, flush=True),
                            control=True)
        ctl = r["_control"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": {k: v["value"] for k, v in r["check"].items()},
                          "program_numbers": r["_control"]["program"],
                          "correct": r["correct"],
                          "control": ctl["numbers"], "control_correct": ctl["correct"],
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
