#!/usr/bin/env python3
"""Drive kanzi_tpu_torch's main path once on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--quick]

Phases, one line each; any failure raises and the exit code is not 0:
  0  the card and its power limit, torch/CUDA versions, and whether
     kanzi_tpu's native host library (stage 1 of level 5) loaded
  1  build the CUDA kernels from kanzi_tpu_torch/csrc
  2  each kernel against its plain PyTorch version on the card, bit for bit,
     on 256 chunks cut from mixed_corpus(16 MiB, seed=7) plus edge rows,
     with both times (CUDA events, warm, median of 5) at 256 x 16 KiB
  3  ANS0 alone (transform NONE), 64 MiB of mixed_corpus(seed=12), 4 MiB
     blocks, jobs=8: the port's stream equals kanzi_tpu's host stream, the
     port decodes it on the card, kanzi_tpu's host reader decodes it too
  4  level 5 (TEXT+UTF+BWT+RANK+ZRLT + ANS0) on the same 64 MiB, same checks
Then the card line, one JSON line of the kernels, and the result line.
``--quick`` stops after phase 2 and prints no result line, for the first
call after a kernel changes.  Without a card the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import time

CHUNK = 16384
SRC = "kanzi_tpu_torch/csrc/ans0.cu"
REPLACES = {
    "ans0_hist_norm": ("kanzi_tpu/ops/ans_pallas.py:342", ["kanzi_tpu/ops/ans_pallas.py:278"]),
    "ans0_encode_scan": ("kanzi_tpu/ops/ans_pallas.py:156", []),
    "ans0_compact": ("kanzi_tpu/ops/ans_pallas.py:487", []),
    "ans0_decode": ("kanzi_tpu/ops/ans_pallas.py:661", ["kanzi_tpu/ops/ans_pallas.py:47"]),
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` warm runs, CUDA events around each."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    """Largest |got - want| over tensors compared as integers."""
    import torch
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               if g.numel() else 0 for g, w in zip(got, want))


def edge_rows():
    """The test suite's edge rows: one byte (freq 4096, capped to 4095), all
    256 bytes, one dominant byte (freq 4095 beside a freq-1 byte), skewed."""
    import numpy as np
    rng = np.random.default_rng(5)
    dominant = np.full(CHUNK, 9, np.uint8)
    dominant[1234] = 10
    return np.stack([np.zeros(CHUNK, np.uint8),
                     rng.permutation(np.repeat(np.arange(256, dtype=np.uint8), 64)),
                     dominant,
                     (rng.zipf(1.4, CHUNK) % 230).astype(np.uint8)])


def phase2_kernels(dev) -> dict:
    import numpy as np
    import torch

    from kanzi_tpu.entropy.utils import normalize_frequencies_batch
    from kanzi_tpu.utils.corpus import mixed_corpus
    from kanzi_tpu_torch.ops import ans_cuda as A

    rows = mixed_corpus(16 << 20, seed=7).reshape(-1, CHUNK)[::4]      # 256
    chunks = np.concatenate([rows, edge_rows()])
    x = torch.from_numpy(chunks).to(dev)
    n = x.shape[0]
    rec = {}

    freq = A.hist_norm(x)
    freq_r = A.hist_norm_ref(x)
    hist = np.stack([np.bincount(r, minlength=256) for r in chunks])
    host = normalize_frequencies_batch(hist, CHUNK, 4096)
    check(torch.equal(freq, freq_r), "hist_norm differs from its plain version")
    check(np.array_equal(freq.cpu().numpy(), host), "hist_norm differs from the host")
    rec["ans0_hist_norm"] = {"max_abs_err": max_abs_err([freq], [freq_r])}

    cum, tables = A.make_tables(freq)
    enc = A.encode_scan(x, tables)
    enc_r = A.encode_scan_ref(x, tables)
    check(all(torch.equal(a, b) for a, b in zip(enc, enc_r)),
          "encode_scan differs from its plain version")
    rec["ans0_encode_scan"] = {"max_abs_err": max_abs_err(enc, enc_r)}

    words, flags, states = enc
    cmp_ = A.compact(words, flags)
    cmp_r = A.compact_ref(words, flags)
    check(all(torch.equal(a, b) for a, b in zip(cmp_, cmp_r)),
          "compact differs from its plain version")
    rec["ans0_compact"] = {"max_abs_err": max_abs_err(cmp_, cmp_r)}

    payload, n_emit = cmp_
    w = payload.to(torch.int32) & 0xFFFF
    pay = torch.stack([w >> 8, w & 0xFF], dim=2).reshape(n, 2 * CHUNK).to(torch.uint8)
    lengths = (2 * n_emit).to(torch.int32)
    st64 = states.to(torch.int64)
    dec = A.decode(pay, lengths, st64, freq, cum)
    dec_r = A.decode_ref(pay, lengths, st64, freq, cum)
    check(all(torch.equal(a, b) for a, b in zip(dec, dec_r)),
          "decode differs from its plain version")
    check(torch.equal(dec[0], x), "decode does not invert encode")
    check(torch.equal(dec[1], lengths), "decode consumed count differs")
    rec["ans0_decode"] = {"max_abs_err": max_abs_err(dec, dec_r)}

    # times at the main path's shape: one 4 MiB block = 256 chunks
    m = 256
    xm, fm, cm, tm = x[:m], freq[:m], cum[:m], tables[:m]
    wm, flm, sm = words[:m], flags[:m], states[:m].to(torch.int64)
    pm, lm = pay[:m], lengths[:m]
    cases = {
        "ans0_hist_norm": (lambda: A.hist_norm(xm), lambda: A.hist_norm_ref(xm)),
        "ans0_encode_scan": (lambda: A.encode_scan(xm, tm),
                             lambda: A.encode_scan_ref(xm, tm)),
        "ans0_compact": (lambda: A.compact(wm, flm), lambda: A.compact_ref(wm, flm)),
        "ans0_decode": (lambda: A.decode(pm, lm, sm, fm, cm),
                        lambda: A.decode_ref(pm, lm, sm, fm, cm)),
    }
    for name, (kern, plain) in cases.items():
        rec[name]["ms"] = time_ms(kern)
        rec[name]["plain_ms"] = time_ms(plain)
    return rec


def _compress(cls, data: bytes, ctx: dict, **kw) -> bytes:
    out = io.BytesIO()
    with cls(out, ctx, **kw) as cos:
        cos.write(data)
    return out.getvalue()


def _decompress(cls, blob: bytes, jobs: int, **kw) -> bytes:
    with cls(io.BytesIO(blob), {"jobs": jobs}, **kw) as cis:
        return cis.read(-1)


def stream_phase(label: str, data: bytes, transform: str, dev, kern: dict) -> dict:
    """One cell: the port and the host each compress and decompress ``data``.
    ``device_share`` is an estimate, launches x the phase-2 kernel time at
    256 chunks per launch over the port's wall time, an upper bound where
    blocks hold fewer chunks."""
    import torch

    from kanzi_tpu.io import stream as host
    from kanzi_tpu_torch.io import stream as port
    from kanzi_tpu_torch.ops import ans_cuda as A

    ctx = {"transform": transform, "entropy": "ANS0", "blockSize": 4 << 20, "jobs": 8}
    mb = len(data) / 1e6
    before = dict(A.launches)
    t = time.perf_counter()
    blob = _compress(port.CompressedOutputStream, data, ctx, device=dev)
    torch.cuda.synchronize()
    port_c = time.perf_counter() - t
    t = time.perf_counter()
    out = _decompress(port.CompressedInputStream, blob, 8, device=dev)
    torch.cuda.synchronize()
    port_d = time.perf_counter() - t
    launches = {k: A.launches[k] - before[k] for k in A.launches}
    check(out == data, f"{label}: the port's decode differs from the input")
    t = time.perf_counter()
    ref = _compress(host.CompressedOutputStream, data, ctx)
    host_c = time.perf_counter() - t
    check(blob == ref, f"{label}: the port's stream differs from the host stream")
    t = time.perf_counter()
    out = _decompress(host.CompressedInputStream, blob, 8)
    host_d = time.perf_counter() - t
    check(out == data, f"{label}: the host's decode of the port's stream differs")
    check(all(v > 0 for v in launches.values()), f"{label}: a kernel never ran: {launches}")
    enc_ms = sum(launches[k] * kern[k]["ms"]
                 for k in ("ans0_hist_norm", "ans0_encode_scan", "ans0_compact"))
    dec_ms = launches["ans0_decode"] * kern["ans0_decode"]["ms"]
    return {"bytes_in": len(data), "bytes_out": len(blob),
            "device_share": {"compress": enc_ms / 1e3 / port_c,
                             "decompress": dec_ms / 1e3 / port_d},
            "compress_mb_s": {"port": mb / port_c, "host": mb / host_c},
            "decompress_mb_s": {"port": mb / port_d, "host": mb / host_d},
            "launches": launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="stop after phase 2")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kanzi_tpu.utils import native
    from kanzi_tpu.utils.corpus import mixed_corpus
    from kanzi_tpu_torch.ops import ans_cuda as A
    from kanzi_tpu_torch.utils import cuda_build

    dev = torch.device("cuda")
    card = card_line()
    print(f"phase 0: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {torch.cuda.device_count()} device(s)")
    if native.get_lib() is None:
        raise RuntimeError("kanzi_tpu's native host library did not load (g++ missing?)")
    print("phase 0: kanzi_tpu native host library loaded")

    cuda_build.load()
    print(f"phase 1: kernels built and loaded in {cuda_build.build_seconds:.2f} s")
    for line in cuda_build.build_log.splitlines():
        if "Function properties" in line or "registers" in line or "entry function" in line:
            print("phase 1:   " + line.strip())

    t = time.perf_counter()
    kern = phase2_kernels(dev)
    for name, r in kern.items():
        print(f"phase 2: {name}: bit-equal to its plain version; "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms at 256 x 16 KiB")
    print(f"phase 2: done in {time.perf_counter() - t:.1f} s")
    if args.quick:
        return 0

    t = time.perf_counter()
    data = mixed_corpus(64 << 20, seed=12).tobytes()
    print(f"phase 3: corpus of {len(data)} B made in {time.perf_counter() - t:.1f} s")
    A.reset_launches()
    for label, transform in (("phase 3: ANS0 alone", "NONE"),
                             ("phase 4: level 5", "TEXT+UTF+BWT+RANK+ZRLT")):
        r = stream_phase(label, data, transform, dev, kern)
        print(f"{label}: {r['bytes_in']} B -> {r['bytes_out']} B, identical to the host "
              f"stream; compress MB/s port {r['compress_mb_s']['port']:.2f} host "
              f"{r['compress_mb_s']['host']:.2f}; decompress MB/s port "
              f"{r['decompress_mb_s']['port']:.2f} host {r['decompress_mb_s']['host']:.2f}; "
              f"kernel share of the port's wall time (estimate) compress "
              f"{r['device_share']['compress']:.4f} decompress "
              f"{r['device_share']['decompress']:.4f}; launches {r['launches']}")
    launches = dict(A.launches)
    check(all(v > 0 for v in launches.values()), f"launches {launches}")

    kernels = []
    for name in A.KERNELS:
        rep, also = REPLACES[name]
        k = {"name": name, "route": "cuda", "source": SRC, "replaces": rep,
             "launches": launches[name], "max_abs_err": kern[name]["max_abs_err"],
             "ms": kern[name]["ms"], "plain_ms": kern[name]["plain_ms"]}
        if also:
            k["also_replaces"] = also
        kernels.append(k)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
