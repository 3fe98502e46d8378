"""The benchmark of hyperqueue_tpu_torch's server tick, one cell a run.

    python3 hqbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs on the CUDA device of the machine it is started on and fails
without one. Prints, as the last line of standard output, one JSON object
(correct, attempted, failed, metrics, device, with --trace 1 breakdown,
and last the numbers compared with their limits); the numbers compared
are also the last lines of standard error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# a library that can load JAX by itself must not
os.environ.setdefault("USE_FLAX", "0")


def pin_to_start_core():
    """Keeps this process, and every thread it starts, on the core it
    started on, before any import touches memory: the server's loop is
    one thread, and where it moves between cores, away from the memory it
    first touched, its speed differs from run to run. Returns the core,
    or None where the host does not say."""
    try:
        with open("/proc/self/stat") as f:
            cpu = int(f.read().rsplit(")", 1)[1].split()[36])
        if cpu not in os.sched_getaffinity(0):
            return None
        os.sched_setaffinity(0, {cpu})
        return cpu
    except (OSError, ValueError, IndexError, AttributeError):
        return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    core = pin_to_start_core()

    from hqbench.harness import main as harness
    from hqbench.harness.cell import find_workload, load_bench

    bench = load_bench()
    chips = find_workload(bench, args.workload)["chips"]
    import torch

    # one process with few threads: the tick is host code, and idle
    # intra-op threads only add noise beside it
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hqbench: needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    t_process = T0 - harness.process_age_s()
    result, info = harness.run_cell(args.workload, args.seed, args.seconds,
                                    bool(args.trace), t_process=t_process,
                                    bench=bench)
    barred = harness.barred_modules()
    if barred:
        print(f"hqbench: the run loaded {barred}", file=sys.stderr)
        return 3
    info["core"] = core
    print(json.dumps({"info": info}), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} <= {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
