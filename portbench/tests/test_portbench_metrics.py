"""The metric arithmetic, on hand-made runs."""

import json
import os
import statistics

import pytest

from portbench.lib import harness, peaks
from portbench.lib.harness import Call, Run
from portbench.lib.spans import Span, covered, gaps, spans, union
from portbench.lib.trace import DeviceOp

MS = 1_000_000


def read(name, run):
    return harness.load_reader(name)(run)


def make_run():
    run = Run({"name": "t"}, {}, {}, 1, 12.5)
    # two requests: 2 MB in 100 ms and 1 MB in 100 ms to compress;
    # decompress 50 ms each
    run.calls = [Call("compress", 0, 0, 100 * MS, 2_000_000, 800_000),
                 Call("decompress", 0, 100 * MS, 150 * MS, 2_000_000, 800_000),
                 Call("compress", 1, 200 * MS, 300 * MS, 1_000_000, 500_000),
                 Call("decompress", 1, 300 * MS, 350 * MS, 1_000_000, 500_000)]
    return run


def test_rates_are_over_whole_calls():
    run = make_run()
    assert read("compress_MBps", run) == pytest.approx(3.0 / 0.2)
    assert read("decompress_MBps", run) == pytest.approx(3.0 / 0.1)
    assert read("size_ratio", run) == pytest.approx(1.3 / 3.0)
    assert read("setup_s", run) == 12.5


def test_self_time_is_the_call_minus_the_union_of_its_spans():
    run = make_run()
    # call 0: two blocks' spans overlap (10-60 and 40-90 ms): union 80 ms
    # of the 100 ms call; call 1: one span of 30 ms, another outside it
    run.spans = [Span("compress", 0, 1, "transform", 10 * MS, 60 * MS, 0, 0),
                 Span("compress", 0, 2, "entropy", 40 * MS, 90 * MS, 1000, 500),
                 Span("compress", 1, 1, "entropy", 210 * MS, 240 * MS, 2000, 1000),
                 Span("compress", 1, 1, "transform", 290 * MS, 400 * MS, 0, 0)]
    own_ms = (100 - 80) + (100 - 30 - 10)
    assert read("stream_self_ms_per_MB.compress", run) == pytest.approx(own_ms / 3.0)
    assert read("entropy_ms_per_MB.compress", run) == pytest.approx((50 + 30) / 3.0)
    assert read("transform_ms_per_MB.compress", run) == pytest.approx((50 + 110) / 3.0)
    assert read("entropy_ms_per_MB.decompress", run) is None


def test_p95_over_every_request(capsys):
    run = Run({}, {}, {}, 1, 0.0)
    lat = list(range(1, 201))                     # 200 requests, 1..200 ms
    run.calls = [Call("compress", i, 0, v * MS, 1, 1) for i, v in enumerate(lat)]
    want = statistics.quantiles(lat, n=100, method="inclusive")[94]
    assert read("compress_p95_ms", run) == pytest.approx(want)
    assert want == pytest.approx(190.05)
    assert "200 requests" in capsys.readouterr().err


def test_roofline_from_the_counted_bytes():
    run = make_run()
    run.spans = [Span("compress", 0, 1, "entropy", 0, 10, 3_350_000, 1_675_000)]
    # bytes once at the peak: 5,025,000 B / 3.35e12 B/s = 1.5 us
    run.device_ops = [DeviceOp("k", "kernel", 10 * MS, 10 * MS + 100_000),
                      DeviceOp("Memcpy HtoD", "memcpy", 20 * MS, 30 * MS)]
    bound_ns = 5_025_000 / peaks.HBM_BYTES_PER_S * 1e9
    assert bound_ns == pytest.approx(1500)
    assert read("entropy_kernels_roofline.compress", run) == pytest.approx(100 * 1500 / 100_000)
    assert read("entropy_kernels_roofline.decompress", run) is None


def test_idle_share_counts_kernels_and_copies_once():
    run = make_run()
    run.device_ops = [DeviceOp("k", "kernel", 10 * MS, 30 * MS),
                      DeviceOp("m", "memcpy", 20 * MS, 40 * MS),     # overlaps
                      DeviceOp("k", "kernel", 250 * MS, 260 * MS),
                      DeviceOp("k", "kernel", 120 * MS, 130 * MS)]   # decompress
    assert read("device_idle_share.compress", run) == pytest.approx(100 * (1 - 40 / 200))
    assert read("device_idle_share.decompress", run) == pytest.approx(100 * (1 - 10 / 100))


def test_no_trace_no_device_metric():
    run = make_run()
    assert read("device_idle_share.compress", run) is None
    run.device_ops = []
    assert read("entropy_kernels_roofline.compress", run) is None


def test_interval_helpers():
    assert union([(5, 7), (1, 3), (2, 4), (7, 8)]) == [(1, 4), (5, 8)]
    assert covered([(0, 10), (5, 20)], 8, 12) == 4
    assert gaps([(2, 3), (5, 6)], 0, 8) == [(0, 2), (3, 5), (6, 8)]


def test_spans_pair_the_listener_events():
    ev = [("BEFORE_TRANSFORM", 1, 100, 1), ("BEFORE_TRANSFORM", 2, 100, 2),
          ("AFTER_TRANSFORM", 1, 60, 5), ("BEFORE_ENTROPY", 1, 60, 6),
          ("AFTER_ENTROPY", 1, 30, 9), ("AFTER_TRANSFORM", 2, 70, 10)]
    got = spans("compress", 3, ev)
    assert [(s.block, s.kind, s.t0, s.t1, s.size_in, s.size_out) for s in got] == [
        (1, "transform", 1, 5, 100, 60), (1, "entropy", 6, 9, 60, 30),
        (2, "transform", 2, 10, 100, 70)]


def test_every_metric_of_benchmark_json_has_a_reader():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_reader(m["name"])), m["name"]


class _Stream:
    def __init__(self, n):
        self.blocks = list(range(n))


def test_reference_blocks_cover_every_slot_in_flight():
    from portbench.lib.check import _pick
    records = [(b"x" * 51, b""), (b"x" * 51, b"")]
    parsed = [(0, _Stream(51)), (1, _Stream(51))]
    for seed in (1, 2**31 + 5):
        picks = _pick(records, parsed, seed, 8, 8)
        assert (picks[0][0], picks[0][2]) == (0, 0)
        assert sorted(b % 8 for _, _, b in picks) == list(range(8))
        assert len({(i, b) for i, _, b in picks}) == 8
    assert _pick(records, parsed, 1, 8, 8) != _pick(records, parsed, 2, 8, 8)


def test_reference_blocks_of_one_block_streams():
    from portbench.lib.check import _pick
    records = [(b"x" * (10 + i), b"") for i in range(20)]
    parsed = [(i, _Stream(1)) for i in range(20)]
    picks = _pick(records, parsed, 7, 8, 8)
    assert picks[0][0] == 19                       # the longest request first
    assert len({i for i, _, _ in picks}) == 8
