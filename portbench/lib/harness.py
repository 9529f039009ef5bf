"""One run of one cell: set-up, the measured window, the checks, the
result line.  Everything particular to a cell comes from files found by
name: ``BENCHMARK.json`` (the cell, its metrics), ``configs/<config>.json``
(what the program runs), ``traffic/<mix>.json`` (what is sent, read by
``lib/traffic.py``), ``metrics/<metric>.py`` (one reader a metric).

The program under test is ``kanzi_tpu_torch``, driven through its
library entry points, ``BlockCompressor.compress_stream`` and
``BlockDecompressor.decompress_stream``, fed in the CLI's 1 MiB reads.
"""

from __future__ import annotations

import gc
import importlib.util
import io
import json
import os
import sys
import time
from dataclasses import dataclass, field

from . import check, spans, traffic

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "kanzi_tpu")
_T_IMPORT = time.monotonic()


class NoCard(RuntimeError):
    pass


@dataclass
class Call:
    direction: str
    request: int
    t0: int
    t1: int
    size: int           # the request's bytes (the decompressed size)
    stream: int         # its compressed size


@dataclass
class Run:
    """What a metric's reader reads."""
    workload: dict
    config: dict
    mix: dict
    seed: int
    setup_s: float
    calls: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    device_ops: list | None = None      # lib/trace.DeviceOp, when traced
    window: tuple = (0, 0)


def process_seconds() -> float:
    """Seconds since this process started (/proc), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return time.monotonic() - _T_IMPORT


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> tuple[dict, dict, dict, dict]:
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    wl = {w["name"]: w for w in bench["workloads"]}.get(name)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = _json(os.path.join(ROOT, conf["file"]))
    mix = _json(os.path.join(BENCH_DIR, "traffic", wl["traffic"] + ".json"))
    return bench, wl, config, mix


def metric_names(bench: dict, wl: dict, trace: bool) -> list[dict]:
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or wl["name"] in m["workloads"]]


def load_reader(name: str):
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", require_card: bool = True,
             mix_override: dict | None = None, log=None) -> tuple[dict, dict]:
    """Runs the cell once; returns (result line, checks).  Tests pass
    ``device="cpu"``, ``require_card=False`` and a smaller corpus."""
    def say(msg: str) -> None:
        (log or (lambda m: print(m, file=sys.stderr, flush=True)))(msg)

    bench, wl, config, mix = load_cell(workload)
    if mix_override:
        mix = {**mix, **mix_override}
    import torch
    if require_card:
        if not torch.cuda.is_available():
            raise NoCard("no CUDA card: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < int(wl["chips"]):
            raise NoCard(f"{torch.cuda.device_count()} CUDA cards, the cell needs {wl['chips']}")
    for k, v in config.get("env", {}).items():
        os.environ[k] = str(v)
    from kanzi_tpu_torch.app.block_compressor import BlockCompressor
    from kanzi_tpu_torch.app.block_decompressor import BlockDecompressor

    on_card = device.startswith("cuda")

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    gen = traffic.Traffic(mix, seed)
    comp = BlockCompressor(config["transform"], config["entropy"],
                           int(config["block_size"]), jobs=int(config["jobs"]),
                           skip_blocks=bool(config.get("skip_blocks", False)),
                           device=device)
    decomp = BlockDecompressor(jobs=int(config["jobs"]), device=device)

    def roundtrip(data: bytes):
        dst = io.BytesIO()
        t0 = time.monotonic_ns()
        comp.compress_stream(io.BytesIO(data), dst, len(data))
        sync()
        t1 = time.monotonic_ns()
        stream = dst.getvalue()
        out = io.BytesIO()
        t2 = time.monotonic_ns()
        decomp.decompress_stream(io.BytesIO(stream), out)
        sync()
        t3 = time.monotonic_ns()
        return stream, out.getvalue(), (t0, t1, t2, t3)

    warmup_bad = 0
    for data in gen.warmup(config):
        try:
            _, back, _ = roundtrip(data)
        except Exception as e:                   # counted against correct
            back = None
            say(f"warm-up raised {type(e).__name__}: {e}")
        if back != data:
            warmup_bad += 1
            say("warm-up: the round trip does not give the input back")
    setup_s = process_seconds()
    run = Run(wl, config, mix, seed, setup_s)
    recorder = spans.Recorder() if trace else None
    if recorder is not None:
        comp.listeners.append(recorder)
        decomp.listeners.append(recorder)
    counts = {"failed": 0, "roundtrip_bad": 0}
    records = []                                 # (request bytes, stream)
    requests = gen.requests()
    prof = None
    if trace:
        from .trace import Profiler
        prof = Profiler().__enter__()
    w0 = time.monotonic_ns()
    deadline = w0 + int(seconds * 1e9)
    attempted = 0
    while time.monotonic_ns() < deadline:
        _, data = next(requests)
        attempted += 1
        try:
            stream, back, (t0, t1, t2, t3) = roundtrip(data)
        except Exception as e:                   # a failed request is counted
            counts["failed"] += 1
            records.append((data, None))
            say(f"request {attempted - 1} raised {type(e).__name__}: {e}")
            if recorder is not None:
                recorder.take()
            continue
        i = len(run.calls) // 2
        run.calls.append(Call("compress", i, t0, t1, len(data), len(stream)))
        run.calls.append(Call("decompress", i, t2, t3, len(data), len(stream)))
        if recorder is not None:
            events = recorder.take()
            cut = [e for e in events if e[3] <= t1]
            run.spans += spans.spans("compress", i, cut)
            run.spans += spans.spans("decompress", i, [e for e in events if e[3] > t1])
        if back != data:
            counts["roundtrip_bad"] += 1
            say(f"request {attempted - 1}: {len(back)} B back for {len(data)} B sent")
        records.append((data, stream))
    if prof is not None:
        prof.__exit__(None, None, None)
        t = time.monotonic()
        run.device_ops = prof.ops()
        run.window = (prof.t0, prof.t1)
        say(f"trace: {len(run.device_ops)} device operations, read in "
            f"{time.monotonic() - t:.2f} s")
    else:
        sync()
        run.window = (w0, time.monotonic_ns())
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    del comp, decomp
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    ref = check.reference_checks(records, config, gen.seed,
                                 int(mix.get("check", {}).get("ref_blocks", 2)), say)
    checks = {"warmup_bad": warmup_bad, "failed": counts["failed"],
              "roundtrip_bad": counts["roundtrip_bad"],
              "frame_bad": ref["frame_bad"], "block_bad": ref["block_bad"]}
    correct = attempted > 0 and all(checks[k] <= check.LIMITS[k] for k in checks)

    metrics = {}
    for m in metric_names(bench, wl, trace):
        try:
            value = load_reader(m["name"])(run)
        except Exception as e:          # a reader that fails reports nothing
            say(f"metric {m['name']}: {type(e).__name__}: {e}")
            value = None
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": counts["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                         "count": int(wl["chips"]), "memory_peak_bytes": peak}}
    if trace and run.device_ops is not None:
        from . import layers
        busy, window_s, breakdown = layers.device_summary(run)
        result["device"]["busy_s"] = busy
        result["device"]["window_s"] = window_s
        result["breakdown"] = breakdown
        say(f"card power limit: {_power_limit()}")
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in checks.items()}
    # last, once the reference and every reader have loaded what they load
    found = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if found:
        raise ImportError(f"modules of the JAX side loaded: {', '.join(found)}")
    return result, checks


def _power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv: list[str]) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        result, checks = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except (NoCard, ImportError, KeyError, FileNotFoundError) as e:
        print(f"portbench: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        return 2
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
