"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program.  Names are compared whole by
their top level: ``kanzi_tpu_torch`` begins with ``kanzi_tpu``."""

import ast
import os
import subprocess
import sys

from portbench.lib.harness import FORBIDDEN

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources(sub=""):
    for base, _, names in os.walk(os.path.join(BENCH, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(base, n)


def test_names_compare_whole():
    top = {m.split(".")[0] for m in ["kanzi_tpu_torch.io.stream", "kanzi_tpu_torchx"]}
    assert not top & set(FORBIDDEN)
    assert {"kanzi_tpu.io".split(".")[0]} <= set(FORBIDDEN)
    assert {m.split(".")[0] for m in ["jax.numpy", "jaxlib"]} <= set(FORBIDDEN)


def test_no_file_imports_jax_or_the_jax_package():
    for path in sources():
        bad = set(top_level_imports(path)) & set(FORBIDDEN)
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        names = set(top_level_imports(path))
        assert not names & (set(FORBIDDEN) | {"kanzi_tpu_torch", "torch"}), path


def test_loading_the_reference_loads_none_of_them():
    code = ("import sys, importlib, os; sys.path.insert(0, %r)\n"
            "from portbench.reference import stream\n"
            "for f in os.listdir(%r):\n"
            "    if f.endswith('.py') and f != '__init__.py':\n"
            "        importlib.import_module('portbench.reference.stages.' + f[:-3])\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'kanzi_tpu', 'kanzi_tpu_torch', 'torch'}))"
            ) % (ROOT, os.path.join(BENCH, "reference", "stages"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True).stdout.strip()
    assert out == "[]"


FAKE_FLAX_READER = '''"""A reader that loads a module of the JAX side (a test's metric)."""
import sys
import types

sys.modules["flax"] = types.ModuleType("flax")


def read(run):
    return 1.0
'''


def test_a_module_loaded_after_the_window_refuses_the_run(bench_copy):
    # the readers and the reference run after the window; whatever they
    # load is caught all the same
    bench_copy.add_tiny_cell({"name": "loads_flax", "unit": "1", "better": "higher",
                              "source": "program_counter", "layer": "io.stream",
                              "moves": "compress_MBps", "workloads": ["tiny_cell"]},
                             FAKE_FLAX_READER, "per_layer")
    p = bench_copy.python(
        "import functools\n"
        "from portbench.lib import harness\n"
        "harness.run_cell = functools.partial(harness.run_cell, device='cpu',"
        " require_card=False)\n"
        "sys.exit(harness.main(['--workload', 'tiny_cell', '--seed', '5', '--seconds', '0.5',"
        " '--trace', '1']))")
    assert p.returncode == 2, p.stderr[-3000:]
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert "flax" in p.stderr.splitlines()[-1]
