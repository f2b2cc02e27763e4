"""Run one cell of the benchmark and print its result as the last line.

    python3 -m ecbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds BENCHMARK.json and the program
(``ceph_tpu_torch``).  With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a profiler
trace of the window.  Exit codes: 0 a result was printed (``correct`` says
whether the answers matched the reference), 2 bad arguments or benchmark
files, 3 no CUDA device (or fewer than the cell asks for), 4 a forbidden
module was loaded, 5 the program cannot be imported.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m ecbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from ecbench import harness, spec

    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=T_START)
    except spec.SpecError as e:
        print(f"ecbench: {e}", file=sys.stderr)
        return 2
    except harness.NoDevice as e:
        print(f"ecbench: {e}", file=sys.stderr)
        return 3
    except harness.Forbidden as e:
        print(f"ecbench: {e}", file=sys.stderr)
        return 4
    except harness.ProgramMissing as e:
        print(f"ecbench: {e}", file=sys.stderr)
        return 5
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
