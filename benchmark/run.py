"""Run one cell of the benchmark: ``python3 benchmark/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout.

Prints the result as the last line of standard output and the numbers that
decide ``correct``, each beside its limit, as the last lines of standard
error (:mod:`benchmark.harness`).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
