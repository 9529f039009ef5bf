"""Runs one cell of the benchmark of kanzi_tpu_torch once, on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the checks on standard error, then one JSON line, the result, last
on standard output.  Exits non-zero, printing no result, without a CUDA
card, without the program, or when JAX's side is loaded."""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from portbench.lib.harness import main
    sys.exit(main(sys.argv[1:]))
