"""A run without a CUDA card, or without the program, fails and prints no
result; it never falls back to the CPU."""

import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def run(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "l3_chunks",
                           "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = run(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA card" in p.stderr


def test_benchmark_files_alone_are_not_a_run(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
