"""Benchmark sweep harness (K/app/Benchmark.java:38-484 equivalent).

Sweeps level presets, block sizes and transform x entropy combos over a data
sample, running round-trips and reporting encode/decode throughput + ratio.
Usable as a library (``device`` as the streams take it: a torch device, or
None for the host coders) or as

    python -m kanzi_tpu_torch.app.benchmark <file> [levels...|--sweep[=depth]]
        [--device cuda|cpu|none]

whose device is the CLI's: ``cuda`` unless asked otherwise.  Nothing is
skipped: a configuration that fails (a round trip that differs, a kernel
that raises) fails the sweep, which kanzi_tpu's harness prints as a skip.
"""

from __future__ import annotations

import hashlib
import sys
import time
from dataclasses import dataclass

from ..utils.device import check_device
from .block_compressor import LEVELS, BlockCompressor
from .block_decompressor import BlockDecompressor


@dataclass
class Result:
    config: str
    in_size: int
    out_size: int
    enc_mbps: float
    dec_mbps: float
    digest: str = ""        # sha256 of the compressed stream

    @property
    def ratio(self) -> float:
        return self.out_size / self.in_size if self.in_size else 0.0

    def __str__(self) -> str:
        return (f"{self.config:36s} {self.out_size:10d} ({self.ratio:6.4f}) "
                f"enc {self.enc_mbps:8.1f} MB/s  dec {self.dec_mbps:8.1f} MB/s")


def run_config(data: bytes, transform: str, entropy: str, block_size: int,
               jobs: int = 4, *, device, checksum: int = 0) -> Result:
    bc = BlockCompressor(transform=transform, entropy=entropy,
                         block_size=block_size, jobs=jobs, checksum=checksum,
                         device=device)
    t0 = time.perf_counter()
    blob = bc.compress_bytes(data)
    t1 = time.perf_counter()
    out = BlockDecompressor(jobs=jobs, device=device).decompress_bytes(blob)
    t2 = time.perf_counter()
    if out != data:
        raise RuntimeError(f"round-trip failed for {transform}+{entropy}")
    n = len(data)
    return Result(f"{transform}+{entropy} b={block_size >> 20}M", n, len(blob),
                  n / 1e6 / max(t1 - t0, 1e-9), n / 1e6 / max(t2 - t1, 1e-9),
                  hashlib.sha256(blob).hexdigest())


def run_levels(data: bytes, levels=None, jobs: int = 4, *,
               device) -> list[Result]:
    results = []
    for lvl in (levels or range(10)):
        t, e, b = LEVELS[lvl]
        r = run_config(data, t, e, b, jobs, device=device)
        r.config = f"-l {lvl} ({t}+{e})"
        results.append(r)
        print(r, flush=True)
    return results


def run_block_size_sweep(data: bytes, transform: str = "LZX",
                         entropy: str = "HUFFMAN", jobs: int = 4, *,
                         device) -> list[Result]:
    results = []
    for b in (1 << 20, 4 << 20, 16 << 20):
        r = run_config(data, transform, entropy, b, jobs, device=device)
        results.append(r)
        print(r, flush=True)
    return results


# the combinatorial sweep universe (Benchmark.java:38-484 equivalent):
# every 1..depth-deep transform chain crossed with every entropy codec
SWEEP_TRANSFORMS = ["NONE", "LZ", "LZX", "LZP", "ROLZ", "ROLZX", "BWT",
                    "BWTS", "RLT", "ZRLT", "MTFT", "RANK", "SRT", "TEXT",
                    "UTF", "EXE", "PACK", "DNA", "MM"]
SWEEP_ENTROPIES = ["NONE", "HUFFMAN", "ANS0", "ANS1", "RANGE", "FPAQ",
                   "CM", "TPAQ"]


def _chains(depth: int):
    """All 1..depth transform chains (no immediate repeats, like the
    reference sweep's combination generator)."""
    import itertools
    for d in range(1, depth + 1):
        for combo in itertools.product(SWEEP_TRANSFORMS, repeat=d):
            if any(combo[i] == combo[i + 1] for i in range(d - 1)):
                continue
            yield "+".join(combo)


class SweepFailed(RuntimeError):
    """Configurations of a sweep failed.  ``failures`` holds each one's
    (config, exception), ``results`` the configurations that ran."""

    def __init__(self, failures: list, results: list) -> None:
        self.failures = failures
        self.results = results
        super().__init__(f"{len(failures)} sweep configuration(s) failed: " + "; ".join(
            f"{c} ({type(ex).__name__}: {ex})" for c, ex in failures))


def run_sweep(data: bytes, depth: int = 1, entropies=None, jobs: int = 4,
              workers: int = 0, block_size: int = 4 << 20,
              quiet: bool = False, *, device) -> list[Result]:
    """Full combinatorial sweep: every 1..depth transform chain x every
    entropy codec, executed in parallel on a thread pool, with a ranked
    analysis of the best configs by size / encode speed / decode speed.

    No configuration is skipped.  Any exception of a configuration (its
    round trip differing, a kernel raising) is printed as ``[failed:
    <type>]`` while the others run on; then the analysis of those that ran,
    and SweepFailed is raised."""
    import concurrent.futures as cf
    import os

    entropies = entropies or SWEEP_ENTROPIES
    combos = [(t, e) for t in _chains(depth) for e in entropies]
    workers = workers or min(os.cpu_count() or 2, 8)
    results: list[Result] = []
    failures: list = []

    def one(te):
        t, e = te
        try:
            return run_config(data, t, e, block_size, jobs=1, device=device)
        except Exception as ex:
            return ex

    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        for (t, e), r in zip(combos, pool.map(one, combos)):
            if isinstance(r, Exception):
                failures.append((f"{t}+{e}", r))
                print(f"{t}+{e} [failed: {type(r).__name__}: {r}]", flush=True)
                continue
            results.append(r)
            if not quiet:
                print(r, flush=True)
    analyze(results)
    if failures:
        raise SweepFailed(failures, results)
    return results


def analyze(results: list[Result], top: int = 10) -> None:
    """Result analysis: rank by compressed size, encode and decode speed."""
    if not results:
        print("no successful configs")
        return
    print(f"\n--- best ratio (top {top}) ---")
    for r in sorted(results, key=lambda r: r.out_size)[:top]:
        print(r)
    print(f"--- fastest encode (top {top}) ---")
    for r in sorted(results, key=lambda r: -r.enc_mbps)[:top]:
        print(r)
    print(f"--- fastest decode (top {top}) ---")
    for r in sorted(results, key=lambda r: -r.dec_mbps)[:top]:
        print(r)


def _device_arg(args: list) -> tuple[list, str]:
    """Take ``--device X`` or ``--device=X`` out of ``args``; the default is
    the CLI's, ``cuda``."""
    rest, device = [], "cuda"
    it = iter(args)
    for a in it:
        if a == "--device":
            device = next(it, "")
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    if device not in ("cuda", "cpu", "none"):
        raise ValueError(f"--device must be cuda, cpu or none, not {device!r}")
    return rest, device


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    usage = ("usage: python -m kanzi_tpu_torch.app.benchmark <file> "
             "[levels...|--sweep[=depth]] [--device cuda|cpu|none]")
    try:
        args, device = _device_arg(args)
    except ValueError as e:
        print(f"{e}\n{usage}", file=sys.stderr)
        return 1
    if not args:
        print(usage, file=sys.stderr)
        return 1
    device = None if device == "none" else device
    if device is not None:
        check_device(device)            # raises without a card: no fallback
    with open(args[0], "rb") as fh:
        data = fh.read()
    sweep = [a for a in args[1:] if a.startswith("--sweep")]
    if sweep:
        depth = int(sweep[0].split("=")[1]) if "=" in sweep[0] else 1
        print(f"Sweeping {args[0]} ({len(data)} bytes), chains to depth {depth}")
        try:
            run_sweep(data, depth, device=device)
        except SweepFailed as e:
            print(e, file=sys.stderr)
            return 1
        return 0
    levels = [int(x) for x in args[1:]] or None
    print(f"Benchmarking {args[0]} ({len(data)} bytes)")
    run_levels(data, levels, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
