#!/usr/bin/env python3
"""Run one cell of the benchmark of ``fraytracer_tpu_torch``::

    python benchmark/run.py --workload tori1000.frame --seed 7 \
        --seconds 15 --trace 0

from the root of a checkout holding the port.  The last line of standard
output is the result object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last the
numbers compared with the reference beside their limits); everything else
goes to standard error.  Exits 2, printing no result, where the machine
lacks the cards the cell asks for, and 1 on any other failure.
"""
import time

T_START = time.perf_counter()   # set-up is timed from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmark import harness
    out, sys.stdout = sys.stdout, sys.stderr
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), T_START)
    except Exception as e:  # noqa: BLE001 - the run's boundary
        traceback.print_exc()
        print(f"no result: {type(e).__name__}: {e}", file=sys.stderr)
        return 2 if isinstance(e, harness.NoCard) else 1
    finally:
        sys.stdout = out
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
