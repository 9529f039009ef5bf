"""A configuration, a traffic mix and a per-layer metric are added as new
files and BENCHMARK.json entries, no file that is there edited, and run
traced."""

import json

READER = '''"""Entropy spans a compressed block (a test's metric): read from the
listener's spans, so only a traced run has it."""


def read(run):
    blocks = {(s.call, s.block) for s in run.spans if s.direction == "compress"}
    n = sum(1 for s in run.spans if s.direction == "compress" and s.kind == "entropy")
    return n / len(blocks) if blocks else None
'''
METRIC = {"name": "entropy_spans_per_block.compress", "unit": "1", "better": "higher",
          "source": "program_span", "layer": "entropy and ops glue",
          "moves": "compress_MBps", "workloads": ["tiny_cell"]}


def test_add_config_mix_and_metric_as_files(bench_copy):
    before = bench_copy.files()
    bench_copy.add_tiny_cell(METRIC, READER, "per_layer")
    after = bench_copy.files()
    assert all(after[k] == v for k, v in before.items())      # nothing edited
    p = bench_copy.python(
        "import json\n"
        "from portbench.lib import harness\n"
        "assert harness.ROOT == %r\n"
        "r, c = harness.run_cell('tiny_cell', 2**31 + 77, 1.0, True, device='cpu',"
        " require_card=False)\n"
        "print(json.dumps(r))" % str(bench_copy.root))
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert set(res["metrics"]) == {METRIC["name"]}
    assert res["metrics"][METRIC["name"]]["value"] == 1.0
    assert {"busy_s", "window_s"} <= set(res["device"])
