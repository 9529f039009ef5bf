"""The benchmark's level-1 configuration on the CPU: the reference
(portbench/reference, its NONE stage included) decodes every block of the
port's level-1 stream with the LZX parse through the device engine; the
harness runs the cells l1_devlz_archive and l3_archive at a small corpus,
correct, and traced the first reports the two LZ metrics, the second
neither, and the control and each planted fault fail the first; the
readers and portbench/lib/lz.py give known values on a hand-made run."""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench.lib import harness, peaks, trace
from portbench.lib import lz as bench_lz
from portbench.lib.corpus import mixed_corpus
from portbench.lib.harness import Call, Run
from portbench.lib.trace import DeviceOp
from portbench.reference import stream as ref
from portbench.reference.bits import Bits
from portbench.reference.stages import NONE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = 1_000_000
LZ_METRICS = {"lz_card_ms_per_MB.compress", "lz_kernels_roofline.compress"}
SMALL = {"corpus": {"kind": "mixed", "bytes": 600_000, "base_seed": 12, "extent": 1 << 18},
         "warmup": {"kind": "requests", "count": 1}}


def test_none_stage_reads_bytes_at_any_bit():
    payload = np.arange(7, 207, dtype=np.uint8)
    for shift in (0, 3):
        bits = int.from_bytes(payload.tobytes(), "big") << (8 - shift) % 8
        raw = bits.to_bytes(payload.size + (shift > 0), "big")
        b = Bits(raw, shift)
        assert np.array_equal(NONE.decode(b, payload.size), payload)
        assert b.pos == shift + 8 * payload.size


def test_reference_decodes_every_block_of_the_device_parse(monkeypatch):
    from kanzi_tpu_torch.app.block_compressor import BlockCompressor
    monkeypatch.setenv("KANZI_TPU_DEVICE_LZ", "1")
    block = 1 << 16
    noise = np.random.default_rng(3).integers(0, 256, block, dtype=np.uint8)
    data = (mixed_corpus(3 * block, 2**31 + 29).tobytes() + noise.tobytes()
            + mixed_corpus(20, 5).tobytes())                 # a tail the engine skips
    dst = io.BytesIO()
    BlockCompressor("LZX", "NONE", block, jobs=8, device="cpu") \
        .compress_stream(io.BytesIO(data), dst, len(data))
    st = ref.parse(dst.getvalue(), {"transform": "LZX", "entropy": "NONE",
                                    "block_size": block, "size": len(data)})
    assert len(st.blocks) == 5
    got = [ref.decode_block(st, b).tobytes() for b in st.blocks]
    assert b"".join(got) == data
    skipped = [b.skip_flags & 0x80 != 0 for b in st.blocks]
    assert skipped[:3] == [False] * 3 and skipped[3]    # LZX on the corpus, not the noise


def cell_result(cell: str) -> dict:
    """The cell run by the harness on the CPU in a fresh interpreter (the
    harness refuses a process that has loaded the JAX side, as this one
    may have), untraced and then traced with the profiler's device
    operations replaced by one kernel over the whole window."""
    code = f"""
import json
from portbench.lib import harness, trace

def ops(self):
    return [trace.DeviceOp("a_kernel", "kernel", self.t0, self.t1)]

trace.Profiler.ops = ops
out = {{}}
for traced in (False, True):
    r, c = harness.run_cell({cell!r}, 2**31 + 1009, 0.5, traced, device="cpu",
                            require_card=False, mix_override={SMALL!r})
    out[str(traced)] = r
print(json.dumps(out))
"""
    env = {k: v for k, v in os.environ.items() if k != "KANZI_TPU_DEVICE_LZ"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=ROOT, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["l1_devlz_archive", "l3_archive"])
def test_cell_runs_correct_and_reports_its_metrics(cell):
    res = cell_result(cell)
    for r in res.values():
        assert r["correct"] is True, r["checks"]
        assert r["attempted"] >= 1
        assert all(v["value"] == 0 for v in r["checks"].values())
    assert {"compress_MBps", "decompress_MBps", "size_ratio", "setup_s"} <= \
        set(res["False"]["metrics"])
    traced = set(res["True"]["metrics"])
    if cell == "l1_devlz_archive":
        assert traced == LZ_METRICS
        assert 0 < res["True"]["metrics"]["lz_kernels_roofline.compress"]["value"] <= 100
    else:
        assert not traced & LZ_METRICS
        assert "device_idle_share.compress" in traced


@pytest.fixture(scope="module")
def planted():
    """The checks of l1_devlz_archive's run under each planted fault
    (portbench/faults.py) and the control, in a fresh interpreter."""
    code = f"""
import json
from portbench import faults
from portbench.lib import harness
out = {{}}
for mode in faults.MODES:
    with faults.planted(mode):
        r, c = harness.run_cell("l1_devlz_archive", 2**31 + 1013, 0.5, False, device="cpu",
                                require_card=False, mix_override={SMALL!r},
                                log=lambda m: None)
    out[mode] = [r["correct"], c]
print(json.dumps(out))
"""
    env = {k: v for k, v in os.environ.items() if k != "KANZI_TPU_DEVICE_LZ"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=ROOT, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", ["control", "token", "answer", "state", "half"])
def test_level_1_faults_are_caught(planted, mode):
    correct, checks = planted[mode]
    assert correct is False
    caught = {k for k, v in checks.items() if v > 0}
    if mode == "control":       # the port reads it back; only the reference refuses it
        assert caught == {"block_bad"}
    if mode == "half":
        assert "frame_bad" in caught
    if mode == "answer":
        assert "roundtrip_bad" in caught and not caught & {"frame_bad", "block_bad"}


def test_the_cells_are_in_the_benchmark():
    bench, wl, config, mix = harness.load_cell("l1_devlz_archive")
    assert (config["transform"], config["entropy"], config["block_size"], config["jobs"]) == \
        ("LZX", "NONE", 4 << 20, 8)
    assert config["env"] == {"KANZI_TPU_DEVICE_LZ": "1"}
    assert mix["corpus"]["bytes"] == 211_957_760 and wl["chips"] == 1
    names = {m["name"] for m in harness.metric_names(bench, wl, True)}
    assert names == LZ_METRICS
    _, wl3, config3, _ = harness.load_cell("l3_archive")
    assert config3["entropy"] == "HUFFMAN" and wl3["traffic"] == "archive"
    assert not {m["name"] for m in harness.metric_names(bench, wl3, True)} & LZ_METRICS


def lz_run() -> Run:
    run = Run({"name": "t"}, {}, {}, 1, 3.0)
    # two compress calls of 2 MB (stream 1 MB) and 1.35 MB (stream 0.65 MB)
    run.calls = [Call("compress", 0, 0, 100 * MS, 2_000_000, 1_000_000),
                 Call("decompress", 0, 100 * MS, 150 * MS, 2_000_000, 1_000_000),
                 Call("compress", 1, 200 * MS, 300 * MS, 1_350_000, 650_000),
                 Call("decompress", 1, 300 * MS, 350 * MS, 1_350_000, 650_000)]
    return run


def test_readers_on_a_hand_made_run():
    run = lz_run()
    assert bench_lz.parse_bytes(run, "compress") == 5_000_000
    read = {m: harness.load_reader(m) for m in sorted(LZ_METRICS)}
    assert all(f(run) is None for f in read.values())         # untraced
    run.device_ops = [DeviceOp("k", "kernel", 10 * MS, 20 * MS),
                      DeviceOp("Memcpy HtoD", "memcpy", 15 * MS, 25 * MS),   # overlaps
                      DeviceOp("Memset", "memset", 210 * MS, 211 * MS),
                      DeviceOp("k", "kernel", 290 * MS, 310 * MS),          # half inside
                      DeviceOp("k", "kernel", 120 * MS, 130 * MS)]          # decompress
    # union inside the compress calls: 15 + 1 + 10 ms over 3.35 MB
    assert read["lz_card_ms_per_MB.compress"](run) == pytest.approx(26 / 3.35)
    # 5 MB once at the peak over 10 + 10 ms of kernels
    bound_ns = 5_000_000 / peaks.HBM_BYTES_PER_S * 1e9
    assert read["lz_kernels_roofline.compress"](run) == pytest.approx(100 * bound_ns / 20e6)
    # the decompress calls: 10 ms, and the other half of the straddling kernel
    assert bench_lz.kernels_roofline_percent(run, "decompress") == pytest.approx(
        100 * bound_ns / 20e6)
    run.device_ops = [DeviceOp("Memcpy HtoD", "memcpy", 10 * MS, 20 * MS)]
    assert read["lz_kernels_roofline.compress"](run) is None  # no kernel
    assert read["lz_card_ms_per_MB.compress"](run) == pytest.approx(10 / 3.35)


def test_the_window_mark_is_no_card_work():
    # the profiler reports the harness's mark over the whole window on the
    # card's timeline where PyTorch's kernels ran; lib/trace.py calls it a kernel
    run = lz_run()
    run.device_ops = [DeviceOp(trace.MARK, "kernel", 0, 350 * MS),
                      DeviceOp("k", "kernel", 10 * MS, 20 * MS)]
    assert harness.load_reader("lz_card_ms_per_MB.compress")(run) == pytest.approx(10 / 3.35)
    bound_ns = 5_000_000 / peaks.HBM_BYTES_PER_S * 1e9
    assert harness.load_reader("lz_kernels_roofline.compress")(run) == pytest.approx(
        100 * bound_ns / 10e6)
    run.device_ops = [DeviceOp(trace.MARK, "kernel", 0, 350 * MS)]
    assert bench_lz.card_ms_per_MB(run, "compress") is None
    assert bench_lz.kernels_roofline_percent(run, "compress") is None
