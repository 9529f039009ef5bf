"""The glue split (lib/glue.py, glue_split.py) on hand-made runs and on a
small run on the CPU; the stage spans, the ten readers of BENCHMARK.json
and the breakdown read the same with the glue events present."""

import json

import pytest

from portbench.lib import glue, harness, layers
from portbench.lib.harness import Call, Run
from portbench.lib.spans import spans
from portbench.lib.trace import DeviceOp

MS = 1_000_000
PER_LAYER = ["stream_self_ms_per_MB", "transform_ms_per_MB", "entropy_ms_per_MB",
             "entropy_kernels_roofline", "device_idle_share"]


def ev(name, block, t_ms, size=0):
    return (name, block, size, int(t_ms * MS))


def pair_events(kind, block, t0, t1, size=0):
    return [ev("BEFORE_" + kind, block, t0, size), ev("AFTER_" + kind, block, t1, size)]


# two blocks of one compress call, [0, 100] ms, 2 MB: block 2 waits 9 ms
# for the lock that block 1 holds; card work inside each hold
BLOCK1 = (pair_events("TRANSFORM", 1, 1, 10) + [ev("BEFORE_ENTROPY", 1, 10, 60)]
          + pair_events("GLUE_WAIT", 1, 10, 12) + [ev("BEFORE_GLUE_HOLD", 1, 12)]
          + pair_events("COPY_IN", 1, 13, 14, 1000) + pair_events("CARD_WAIT", 1, 15, 18)
          + pair_events("COPY_OUT", 1, 18, 19, 500) + [ev("AFTER_GLUE_HOLD", 1, 20)]
          + [ev("AFTER_ENTROPY", 1, 22, 30)])
BLOCK2 = (pair_events("TRANSFORM", 2, 2, 11) + [ev("BEFORE_ENTROPY", 2, 11, 70)]
          + pair_events("GLUE_WAIT", 2, 11, 20) + [ev("BEFORE_GLUE_HOLD", 2, 20)]
          + pair_events("COPY_IN", 2, 21, 23, 2000) + pair_events("CARD_WAIT", 2, 23, 24)
          + pair_events("COPY_OUT", 2, 24, 26, 1500) + [ev("AFTER_GLUE_HOLD", 2, 30)]
          + [ev("AFTER_ENTROPY", 2, 31, 35)])
EVENTS = sorted(BLOCK1 + BLOCK2, key=lambda e: e[3])
STAGES = [e for e in EVENTS if e[0].partition("_")[2] in ("TRANSFORM", "ENTROPY")]
OPS = [DeviceOp("Memcpy HtoD", "memcpy", 13 * MS, 14 * MS),
       DeviceOp("k", "kernel", 16 * MS, 17 * MS),
       DeviceOp("Memcpy DtoH", "memcpy", 50 * MS, 51 * MS),
       DeviceOp("k", "kernel", 120 * MS, 121 * MS)]


def make_run(events):
    run = Run({"name": "t"}, {}, {}, 1, 1.0)
    run.calls = [Call("compress", 0, 0, 100 * MS, 2_000_000, 800_000),
                 Call("decompress", 0, 100 * MS, 150 * MS, 2_000_000, 800_000)]
    run.spans = spans("compress", 0, events)
    run.device_ops = list(OPS)
    run.window = (0, 150 * MS)
    return run


def test_glue_events_leave_the_stage_spans_readers_and_breakdown_alone():
    bare, with_glue = make_run(STAGES), make_run(EVENTS)
    assert with_glue.spans == bare.spans and len(bare.spans) == 4
    for base in PER_LAYER:
        for d in ("compress", "decompress"):
            name = f"{base}.{d}"
            assert harness.load_reader(name)(with_glue) == harness.load_reader(name)(bare)
    assert layers.device_summary(with_glue) == layers.device_summary(bare)


def test_glue_spans_pair_the_new_kinds_alone():
    gl = glue.glue_spans("compress", 0, EVENTS)
    assert sorted({s.kind for s in gl}) == sorted(k.lower() for k in glue.KINDS)
    assert len(gl) == 10
    assert [(s.t0, s.t1, s.size_in) for s in gl if s.block == 2 and s.kind == "copy_out"] \
        == [(24 * MS, 26 * MS, 1500)]
    assert glue.glue_spans("compress", 0, STAGES) == []


def test_the_split_adds_up_to_the_entropy_spans():
    run = make_run(EVENTS)
    gl = glue.glue_spans("compress", 0, EVENTS)
    wait = glue.lock_wait_ms_per_MB(run, gl, "compress")
    card = glue.card_ms_per_MB(run, gl, "compress")
    host = glue.host_glue_ms_per_MB(run, gl, "compress")
    assert (wait, card, host) == pytest.approx((11 / 2, 10 / 2, 11 / 2))
    assert wait + card + host == pytest.approx(layers.layer_ms_per_MB(run, "compress", "entropy"))
    assert glue.copy_bytes_per_byte(run, gl, "compress") == pytest.approx(5000 / 2e6)
    assert glue.hold_over_wall(run, gl, "compress") == pytest.approx(18 / 100)
    for fn in (glue.lock_wait_ms_per_MB, glue.card_ms_per_MB, glue.host_glue_ms_per_MB,
               glue.copy_bytes_per_byte, glue.hold_over_wall):
        assert fn(run, gl, "decompress") is None          # no glue span there
        assert fn(run, [], "compress") is None            # a program without them


def test_idle_by_what_the_lock_holder_was_in():
    run = make_run(EVENTS)
    gl = glue.glue_spans("compress", 0, EVENTS)
    got = glue.idle_by_glue_state(run, gl)
    want = {"compress:glue": 8, "compress:copy_in": 2, "compress:card_wait": 3,
            "compress:copy_out": 3, "compress:none": 81, "decompress:glue": 0,
            "decompress:copy_in": 0, "decompress:card_wait": 0, "decompress:copy_out": 0,
            "decompress:none": 49}
    assert got == pytest.approx({k: v / 1e3 for k, v in want.items()})
    assert glue.idle_by_glue_state(run, []) is None
    run.device_ops = None
    assert glue.idle_by_glue_state(run, gl) is None


def test_busy_time_inside_the_holds():
    run = make_run(EVENTS)
    gl = glue.glue_spans("compress", 0, EVENTS)
    assert glue.busy_in_holds(run, gl) == pytest.approx(2 / 4)     # two of four ms, both calls
    run.device_ops = OPS[:2] + [DeviceOp("k", "kernel", 30 * MS + 100_000, 30 * MS + 300_000)]
    assert glue.busy_in_holds(run, gl) == pytest.approx(2.1 / 2.2)   # widened by 0.2 ms
    assert glue.busy_in_holds(run, gl, widen_ns=0) == pytest.approx(2 / 2.2)


def test_the_operations_outside_every_hold():
    run = make_run(EVENTS)
    gl = glue.glue_spans("compress", 0, EVENTS)
    assert glue.outside_holds(run, gl) == [
        ["Memcpy DtoH", 0.05, MS, 20 * MS, "compress", 2],
        ["k", 0.12, MS, 90 * MS, "compress", 2]]
    assert glue.outside_holds(run, []) == []


def test_copies_against_their_spans():
    run = make_run(EVENTS)
    gl = glue.glue_spans("compress", 0, EVENTS)
    # HtoD at 13-14 ms inside block 1's COPY_IN; DtoH at 50-51 ms, ending
    # 25 ms after block 2's COPY_OUT
    assert glue.copy_skew(run, gl) == [[0.0, 2, 0, 25 * MS]]
    run.device_ops = [DeviceOp("Memcpy HtoD", "memcpy", 12 * MS + 700_000, 13 * MS + 500_000),
                      DeviceOp("Memcpy DtoH", "memcpy", 24 * MS, 25 * MS)]
    assert glue.copy_skew(run, gl) == [[0.0, 2, -300_000, 0]]
    assert glue.copy_skew(run, gl, slice_s=0.01) == [[0.01, 1, -300_000, -300_000],
                                                     [0.02, 1, 0, 0]]
    assert glue.copy_skew(run, []) == []


def test_nesting_faults():
    run = make_run(EVENTS)
    assert glue.nesting_faults(run, glue.glue_spans("compress", 0, EVENTS)) == []
    moved = [(n, b, s, t + 15 * MS if (b, n[-7:]) == (1, "COPY_IN") else t)
             for n, b, s, t in EVENTS]                     # block 1's copy at 28-29 ms
    faults = glue.nesting_faults(run, glue.glue_spans("compress", 0, moved))
    assert len(faults) == 1 and "copy_in" in faults[0] and "hold" in faults[0]
    overlap = [(n, b, s, t - 2 * MS if (b, n) == (2, "BEFORE_GLUE_HOLD") else t)
               for n, b, s, t in EVENTS]                   # block 2 holds from 18 ms
    faults = glue.nesting_faults(run, glue.glue_spans("compress", 0, overlap))
    assert faults == [f"holds overlap: {(12 * MS, 20 * MS)} and {(18 * MS, 30 * MS)}"]


def test_split_gives_each_event_its_call():
    calls = [Call("compress", 0, 0, 100 * MS, 1, 1), Call("decompress", 0, 100 * MS + 1, 200 * MS, 1, 1)]
    later = [(n, b, s, t + 110 * MS) for n, b, s, t in BLOCK1]
    stray = [ev("BEFORE_COPY_IN", 1, 300, 5), ev("AFTER_COPY_IN", 1, 301, 5)]
    gl = glue.split(calls, EVENTS + later + stray)
    assert len([s for s in gl if s.direction == "compress"]) == 10
    assert len([s for s in gl if s.direction == "decompress"]) == 5
    assert all(s.call == 0 for s in gl)


READER = '''"""Entropy spans a compressed block (a test's metric)."""


def read(run):
    blocks = {(s.call, s.block) for s in run.spans if s.direction == "compress"}
    return len(blocks) or None
'''
METRIC = {"name": "entropy_blocks.compress", "unit": "1", "better": "higher",
          "source": "program_span", "layer": "entropy and ops glue",
          "moves": "compress_MBps", "workloads": ["tiny_cell"]}


def test_the_tool_splits_a_run_on_the_cpu(bench_copy):
    bench_copy.add_tiny_cell(METRIC, READER, "per_layer")
    p = bench_copy.python(
        "import json\n"
        "from portbench.glue_split import run_with_events, split_line\n"
        "from portbench.lib import layers\n"
        "r, run, gl = run_with_events('tiny_cell', 2**31 + 79, 1.0, True, device='cpu',"
        " require_card=False)\n"
        "line = split_line(run, gl)\n"
        "line['correct'] = r['correct']\n"
        "line['entropy'] = {d: layers.layer_ms_per_MB(run, d, 'entropy')"
        " for d in ('compress', 'decompress')}\n"
        "print(json.dumps(line))")
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["glue_spans"] > 0 and line["nesting_faults"] == 0, line["nesting_fault_lines"]
    for d in ("compress", "decompress"):
        parts = [line[f"entropy_{k}_ms_per_MB.{d}"] for k in ("lock_wait", "card", "host_glue")]
        assert sum(parts) == pytest.approx(line["entropy"][d])
        assert line[f"card_copy_bytes_per_byte.{d}"] > 0
        assert 0 < line[f"glue_hold_over_wall.{d}"] <= 1
    assert line["idle_by_glue_state"] is None and line["busy_in_holds"] is None   # no card
