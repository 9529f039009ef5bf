"""The benchmark's own tests.  ``card`` marks a test that needs a CUDA
card; it decides inside a fixture and skips without one.  Run them all
with ``python -m pytest portbench/tests`` from the repository's root (on
the card: ``python -m pytest portbench/tests -m card``)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "portbench")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CONFIG = {"name": "tiny_l5", "transform": "TEXT+UTF+BWT+RANK+ZRLT", "entropy": "ANS0",
               "block_size": 262144, "jobs": 2, "skip_blocks": False, "env": {}}
TINY_MIX = {"corpus": {"kind": "mixed", "bytes": 1 << 20, "base_seed": 3, "extent": 1 << 18},
            "requests": {"kind": "chunks", "min": 131072, "mean_extra": 131072,
                         "max": 1 << 20, "set": 4},
            "warmup": {"kind": "requests", "count": 1}, "check": {"ref_blocks": 2}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return "cuda"


class BenchCopy:
    """``BENCHMARK.json`` and ``portbench/`` copied into a directory, to
    which a test adds a small cell, ``tiny_cell``, as new files."""

    def __init__(self, root) -> None:
        self.root = root
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
        shutil.copytree(BENCH, root / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__"))

    def files(self) -> dict:
        out = {}
        for base, _, names in os.walk(self.root / "portbench"):
            for n in names:
                if "__pycache__" not in base:
                    p = os.path.join(base, n)
                    with open(p, "rb") as f:
                        out[os.path.relpath(p, self.root)] = f.read()
        return out

    def add_tiny_cell(self, metric: dict, reader: str, group: str) -> None:
        """The cell, its configuration and mix, and one metric with its
        reader under ``group`` ("end_to_end" or "per_layer")."""
        (self.root / "portbench/configs/tiny_l5.json").write_text(json.dumps(TINY_CONFIG))
        (self.root / "portbench/traffic/tiny_chunks.json").write_text(json.dumps(TINY_MIX))
        (self.root / "portbench/metrics" / (metric["name"] + ".py")).write_text(reader)
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        bench["configs"].append({"name": "tiny_l5", "source": "https://github.com/flanglet/kanzi",
                                 "file": "portbench/configs/tiny_l5.json", "reduced": [],
                                 "why": "a test's configuration"})
        bench["workloads"].append({"name": "tiny_cell", "config": "tiny_l5",
                                   "traffic": "tiny_chunks", "chips": 1, "why": "a test's cell"})
        bench[group].append(metric)
        (self.root / "BENCHMARK.json").write_text(json.dumps(bench))

    def python(self, code: str) -> subprocess.CompletedProcess:
        """Runs ``code`` in a fresh interpreter with the copy first on the
        path (the program from this checkout behind it), from the copy."""
        head = "import sys; sys.path[:0] = [%r, %r]\n" % (str(self.root), ROOT)
        return subprocess.run([sys.executable, "-c", head + code], capture_output=True,
                              text=True, timeout=600, cwd=self.root)


@pytest.fixture
def bench_copy(tmp_path):
    return BenchCopy(tmp_path)
