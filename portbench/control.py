"""Runs cells with the control or a planted fault (``faults.py``) on the
card, at the cells' own sizes, several seeds in one process; prints one
JSON line a run with its checks.  Not part of a benchmark run.

    python3 portbench/control.py --workload l5_archive --seconds 5 \\
        --modes none,control --seeds 11,12,13

``none`` runs the program as it is (a sound run).  ``--corpus-seeds``
makes the mix's corpus from other seeds than its ``base_seed``, one
corpus after another, to show ``correct`` on other data."""

import argparse
import json
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import contextlib

    from portbench import faults
    from portbench.lib.harness import load_cell, run_cell

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--modes", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--corpus-seeds", default="")
    a = p.parse_args()
    corpus = load_cell(a.workload)[3]["corpus"]
    bases = [int(c) for c in a.corpus_seeds.split(",") if c] or [corpus["base_seed"]]
    for base in bases:
        override = {"corpus": {**corpus, "base_seed": base}}
        for mode in a.modes.split(","):
            for seed in [int(s) for s in a.seeds.split(",")]:
                ctx = contextlib.nullcontext() if mode == "none" else faults.planted(mode)
                head = {"mode": mode, "seed": seed, "corpus_seed": base}
                with ctx:
                    try:
                        result, checks = run_cell(a.workload, seed, a.seconds, False,
                                                  mix_override=override)
                    except Exception as e:      # a run that crashes is a failed run
                        print(json.dumps({**head, "crashed": repr(e)}), flush=True)
                        continue
                print(json.dumps({**head, "correct": result["correct"],
                                  "attempted": result["attempted"], "checks": checks,
                                  "metrics": {k: v["value"]
                                              for k, v in result["metrics"].items()}}),
                      flush=True)
