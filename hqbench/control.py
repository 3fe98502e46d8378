"""The control and the planted faults of a cell: runs whose `correct`
must come out false.

    python3 hqbench/control.py --workload <cell> --seconds <s> \
        --seeds 11 12 13 [--faults none control unchanged half altered]

Each fault is planted under the model's solve, on the timed path, and the
rest of the run (set-up, window, reference check) is the benchmark's own:

- control: the solve counts each task at half its request (rounded up)
  and each worker at twice its free task slots, so a worker takes up to
  twice what it holds, which breaks the configurations' guarantee that a
  node never runs more than its resources and task slots hold;
- unchanged: the solve launches its kernel and returns no placement (the
  tick leaves the state as it was);
- half: half of each batch's placements are left out (the counts on
  every second worker);
- altered: one task of the solve's answer is moved to the next worker.

`none` plants nothing: the program's own runs, read in the same process.
The benchmark's own runs never run this. One line of JSON per run:
{"fault", "seed", "correct", "checks", "metrics", "info"}. The tests run
the same faults at a size a test run holds
(hqbench/tests/test_hqbench_cells.py).
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _wrap(fault):
    def hook(base):
        solve = base.solve

        def planted(**kw):
            if fault == "control":
                kw = dict(kw)
                needs = np.asarray(kw["needs"])
                kw["needs"] = np.ascontiguousarray(
                    np.where(needs > 0, (needs + 1) // 2, 0),
                    dtype=needs.dtype)
                kw["nt_free"] = np.ascontiguousarray(
                    2 * np.asarray(kw["nt_free"]))
                return np.array(solve(**kw))
            counts = np.array(solve(**kw))
            if fault == "unchanged":
                counts[:] = 0
            elif fault == "half":
                counts[:, :, 1::2] = 0
            elif fault == "altered":
                nz = np.argwhere(counts > 0)
                if len(nz):
                    b, v, w = nz[0]
                    counts[b, v, w] -= 1
                    counts[b, v, (w + 1) % counts.shape[2]] += 1
            return counts

        base.solve = planted
        return base

    return hook


FAULTS = ("control", "unchanged", "half", "altered")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="control and fault runs")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", nargs="+", default=list(FAULTS),
                   choices=("none",) + FAULTS)
    args = p.parse_args(argv)
    from hqbench.harness.main import run_cell

    for fault in args.faults:
        for seed in args.seeds:
            hook = None if fault == "none" else _wrap(fault)
            result, info = run_cell(args.workload, seed, args.seconds, False,
                                    model_hook=hook)
            print(json.dumps({"fault": fault, "seed": seed,
                              "correct": result["correct"],
                              "checks": {k: v["value"] for k, v in
                                         result["checks"].items()},
                              "metrics": {k: v["value"] for k, v in
                                          result["metrics"].items()},
                              "info": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
