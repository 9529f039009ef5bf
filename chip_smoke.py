#!/usr/bin/env python3
"""Drive kanzi_tpu_torch's main path once on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--quick]

Phases, one line each; any failure raises and the exit code is not 0:
  0  the card and its power limit, torch/CUDA versions, and whether
     kanzi_tpu's native host library (stage 1 of level 5) loaded
  1  build the CUDA kernels from kanzi_tpu_torch/csrc (ans0.cu, huffman.cu)
  2  each kernel against its plain PyTorch version on the card, bit for bit,
     on 256 chunks cut from mixed_corpus(16 MiB, seed=7) plus edge rows,
     with both times (CUDA events, warm, median of 5) at 256 x 16 KiB
  3  ANS0 alone (transform NONE), 64 MiB of mixed_corpus(seed=12), 4 MiB
     blocks, jobs=8: the port's stream equals kanzi_tpu's host stream, the
     port decodes it on the card, kanzi_tpu's host reader decodes it too
  4  level 5 (TEXT+UTF+BWT+RANK+ZRLT + ANS0) on the same 64 MiB, same checks
  5  Huffman alone (transform NONE) on the same 64 MiB, same checks
  6  level 3 (TEXT+UTF+PACK+MM+LZX + HUFFMAN) on the same 64 MiB, same checks
The launch counts are set to 0 just before each of phases 3-6 and read just
after it.  Then the card line, one JSON line of the kernels, and the result
line.
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
ANS0_SRC = "kanzi_tpu_torch/csrc/ans0.cu"
HUFFMAN_SRC = "kanzi_tpu_torch/csrc/huffman.cu"
# kernel -> (source, the TPU kernel it replaces, the others it also replaces)
REPLACES = {
    "ans0_hist_norm": (ANS0_SRC, "kanzi_tpu/ops/ans_pallas.py:342",
                       ["kanzi_tpu/ops/ans_pallas.py:278"]),
    "ans0_encode_scan": (ANS0_SRC, "kanzi_tpu/ops/ans_pallas.py:156", []),
    "ans0_compact": (ANS0_SRC, "kanzi_tpu/ops/ans_pallas.py:487", []),
    "ans0_decode": (ANS0_SRC, "kanzi_tpu/ops/ans_pallas.py:661",
                    ["kanzi_tpu/ops/ans_pallas.py:47"]),
    "huffman_hist": (HUFFMAN_SRC, "kanzi_tpu/ops/ans_pallas.py:278", []),
    "huffman_encode": (HUFFMAN_SRC, "kanzi_tpu/ops/huffman_pallas.py:37",
                       ["kanzi_tpu/ops/ans_pallas.py:480"]),
    "huffman_decode": (HUFFMAN_SRC, "kanzi_tpu/ops/huffman_decode_pallas.py:50",
                       ["kanzi_tpu/ops/ans_pallas.py:47"]),
}
ANS0_KERNELS = ("ans0_hist_norm", "ans0_encode_scan", "ans0_compact", "ans0_decode")
HUFFMAN_KERNELS = ("huffman_hist", "huffman_encode", "huffman_decode")


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


def phase2_ans0(dev, rows) -> dict:
    import numpy as np
    import torch

    from kanzi_tpu.entropy.utils import normalize_frequencies_batch
    from kanzi_tpu_torch.ops import ans_cuda as A

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


def huffman_edge_rows():
    """One symbol; all 256 symbols; Fibonacci-distributed frequencies, whose
    code lengths hit the 12-bit limit."""
    import numpy as np
    rng = np.random.default_rng(6)
    fib = [1, 1]
    while len(fib) < 19:
        fib.append(fib[-1] + fib[-2])
    fib.append(CHUNK - sum(fib))
    return np.stack([np.full(CHUNK, 77, np.uint8),
                     rng.permutation(np.repeat(np.arange(256, dtype=np.uint8), 64)),
                     rng.permutation(np.repeat(np.arange(40, 60, dtype=np.uint8), fib))])


def phase2_huffman(dev, rows) -> dict:
    """hist, encode, decode against their plain versions; decode inverts
    encode and uses exactly the encoded bits, except on the one row whose
    stream was corrupted, where kernel and plain version agree all the same."""
    import numpy as np
    import torch

    from kanzi_tpu.entropy.huffman import build_tables_batch
    from kanzi_tpu_torch.ops import huffman_block as HB
    from kanzi_tpu_torch.ops import huffman_cuda as H

    chunks = np.concatenate([rows, huffman_edge_rows()])
    x = torch.from_numpy(chunks).to(dev)
    n = x.shape[0]
    rec = {}

    hist = H.hist(x)
    hist_r = H.hist_ref(x)
    check(torch.equal(hist, hist_r), "huffman_hist differs from its plain version")
    hists = np.stack([np.bincount(r, minlength=256) for r in chunks]).astype(np.int64)
    check(np.array_equal(hist.cpu().numpy(), hists), "huffman_hist differs from bincount")
    rec["huffman_hist"] = {"max_abs_err": max_abs_err([hist], [hist_r])}

    sizes, codes, nsym = build_tables_batch(hists)
    check(sizes[-1].max() == 12 and nsym[-3] == 1 and nsym[-2] == 256,
          "the Huffman edge rows miss their edges")
    tbl = torch.from_numpy(((sizes << 12) | codes).astype(np.uint16).view(np.int32)).to(dev)
    enc = H.encode_streams(x, tbl)
    enc_r = H.encode_streams_ref(x, tbl)
    check(all(torch.equal(a, b) for a, b in zip(enc, enc_r)),
          "huffman_encode differs from its plain version")
    rec["huffman_encode"] = {"max_abs_err": max_abs_err(enc, enc_r)}

    # the wire's byte-aligned streams at 6,656-byte strides; one corrupt row
    words, n_words, acc, nbits = enc
    w = (words.to(torch.int64) & 0xFFFF).contiguous()
    w.scatter_(1, n_words.long()[:, None], (acc.long() << (16 - nbits.long()))[:, None])
    seg = torch.stack([w >> 8, w & 0xFF], dim=2).reshape(4 * n, 2 * H.STREAM)
    pay = seg[:, :H.PAY_STRIDE].to(torch.uint8).reshape(n, H.PAY_WIDTH)
    pay = torch.cat([pay, pay[:1].clone()])
    pay[-1, 2 * H.PAY_STRIDE + 100:2 * H.PAY_STRIDE + 164] = 0xA5
    alphabets = [np.flatnonzero(h) for h in hists]
    tabs = HB.build_decode_tables(list(sizes) + [sizes[0]], alphabets + [alphabets[0]])
    bnd, adj, perm = (torch.from_numpy(t).to(dev) for t in tabs)
    dec = H.decode_chunks(pay, bnd, adj, perm)
    dec_r = H.decode_chunks_ref(pay, bnd, adj, perm)
    check(all(torch.equal(a, b) for a, b in zip(dec, dec_r)),
          "huffman_decode differs from its plain version")
    check(torch.equal(dec[0][:n], x), "huffman_decode does not invert huffman_encode")
    declared = (16 * n_words + nbits).reshape(n, 4)
    check(torch.equal(dec[1][:n], declared), "huffman_decode used != 16 * n_words + nbits")
    check(int(dec[1][n, 2]) != int(declared[0, 2]), "the corrupt stream went unnoticed")
    rec["huffman_decode"] = {"max_abs_err": max_abs_err(dec, dec_r)}

    m = 256
    xm, tm = x[:m], tbl[:m]
    pm, bm, am, qm = pay[:m], bnd[:m], adj[:m], perm[:m]
    cases = {
        "huffman_hist": (lambda: H.hist(xm), lambda: H.hist_ref(xm)),
        "huffman_encode": (lambda: H.encode_streams(xm, tm),
                           lambda: H.encode_streams_ref(xm, tm)),
        "huffman_decode": (lambda: H.decode_chunks(pm, bm, am, qm),
                           lambda: H.decode_chunks_ref(pm, bm, am, qm)),
    }
    for name, (kern, plain) in cases.items():
        rec[name]["ms"] = time_ms(kern)
        rec[name]["plain_ms"] = time_ms(plain)
    return rec


def phase2_kernels(dev) -> dict:
    from kanzi_tpu.utils.corpus import mixed_corpus
    rows = mixed_corpus(16 << 20, seed=7).reshape(-1, CHUNK)[::4]      # 256
    return {**phase2_ans0(dev, rows), **phase2_huffman(dev, rows)}


def _compress(cls, data: bytes, ctx: dict, **kw) -> bytes:
    out = io.BytesIO()
    with cls(out, ctx, **kw) as cos:
        cos.write(data)
    return out.getvalue()


def _decompress(cls, blob: bytes, jobs: int, **kw) -> bytes:
    with cls(io.BytesIO(blob), {"jobs": jobs}, **kw) as cis:
        return cis.read(-1)


def stream_phase(label: str, data: bytes, transform: str, entropy: str, dev,
                 kern: dict, names: tuple) -> dict:
    """One cell: the port and the host each compress and decompress ``data``.
    The launch counts are set to 0 just before the port's run and read just
    after it; every kernel of ``names`` must have run.  ``device_share`` is
    an estimate, launches x the phase-2 kernel time at 256 chunks per launch
    over the port's wall time, an upper bound where blocks hold fewer
    chunks."""
    import torch

    from kanzi_tpu.io import stream as host
    from kanzi_tpu_torch.io import stream as port
    from kanzi_tpu_torch.ops import launch

    ctx = {"transform": transform, "entropy": entropy, "blockSize": 4 << 20, "jobs": 8}
    mb = len(data) / 1e6
    launch.reset_launches()
    t = time.perf_counter()
    blob = _compress(port.CompressedOutputStream, data, ctx, device=dev)
    torch.cuda.synchronize()
    port_c = time.perf_counter() - t
    t = time.perf_counter()
    out = _decompress(port.CompressedInputStream, blob, 8, device=dev)
    torch.cuda.synchronize()
    port_d = time.perf_counter() - t
    launches = {k: launch.launches[k] for k in names}
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
    dec = names[-1]                         # each family's decode kernel is last
    enc_ms = sum(launches[k] * kern[k]["ms"] for k in names if k != dec)
    dec_ms = launches[dec] * kern[dec]["ms"]
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
    from kanzi_tpu_torch.utils import cuda_build

    dev = torch.device("cuda")
    card = card_line()
    print(f"phase 0: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {torch.cuda.device_count()} device(s)")
    if native.get_lib() is None:
        raise RuntimeError("kanzi_tpu's native host library did not load (g++ missing?)")
    print("phase 0: kanzi_tpu native host library loaded")

    cuda_build.load()
    srcs = sorted(f for f in os.listdir(cuda_build.SRC_DIR) if f.endswith((".cu", ".cuh")))
    print(f"phase 1: kernels built from {', '.join(srcs)} and loaded in "
          f"{cuda_build.build_seconds:.2f} s")
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
    launches = dict.fromkeys(REPLACES, 0)
    for label, transform, entropy, names in (
            ("phase 3: ANS0 alone", "NONE", "ANS0", ANS0_KERNELS),
            ("phase 4: level 5", "TEXT+UTF+BWT+RANK+ZRLT", "ANS0", ANS0_KERNELS),
            ("phase 5: Huffman alone", "NONE", "HUFFMAN", HUFFMAN_KERNELS),
            ("phase 6: level 3", "TEXT+UTF+PACK+MM+LZX", "HUFFMAN", HUFFMAN_KERNELS)):
        t = time.perf_counter()
        r = stream_phase(label, data, transform, entropy, dev, kern, names)
        for k, v in r["launches"].items():
            launches[k] += v
        print(f"{label}: {r['bytes_in']} B -> {r['bytes_out']} B, identical to the host "
              f"stream; compress MB/s port {r['compress_mb_s']['port']:.2f} host "
              f"{r['compress_mb_s']['host']:.2f}; decompress MB/s port "
              f"{r['decompress_mb_s']['port']:.2f} host {r['decompress_mb_s']['host']:.2f}; "
              f"kernel share of the port's wall time (estimate) compress "
              f"{r['device_share']['compress']:.4f} decompress "
              f"{r['device_share']['decompress']:.4f}; launches {r['launches']}; "
              f"{time.perf_counter() - t:.1f} s")
    check(all(v > 0 for v in launches.values()), f"launches {launches}")

    kernels = []
    for name, (src, rep, also) in REPLACES.items():
        k = {"name": name, "route": "cuda", "source": src, "replaces": rep,
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
