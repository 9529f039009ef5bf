#!/usr/bin/env python3
"""Drive kanzi_tpu_torch's main path once on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--quick]

Phases, one line each; any failure raises and the exit code is not 0:
  0  the card and its power limit, torch/CUDA versions, and whether the
     port's native host library (kanzi_tpu_torch/_build, from native/) loaded
  1  build the CUDA kernels from kanzi_tpu_torch/csrc (ans0.cu, ans1.cu,
     huffman.cu, ksort.cu, lz_words.cu, with the headers compact.cuh,
     hist.cuh, rans.cuh, stage.cuh), one nvcc per source, in parallel; the
     16-byte loads that the two histogram kernels' SASS places before their
     first shared atomic (cuobjdump -sass)
  2  the floor of the card-alone times (an empty kernel, queued and timed
     as the kernels are); each kernel against its plain PyTorch version on
     the card, bit for bit:
     the order-0 and Huffman kernels on 256 chunks cut from
     mixed_corpus(16 MiB, seed=7) plus edge rows (the CPU tests' rows of
     the normalisation's edges among them: a tied max, a delta past
     err_thr of each sign, two symbols), timed at 256 x 16 KiB, both
     histograms also on 256 chunks of one byte;
     ans0_encode_scan also on the CPU tests' division-edge tables (f = 4095
     against states near 2^31, f = 0 for absent symbols) at widths 4,096
     and 4,076, with the reciprocal of csrc/rans.cuh against exact division
     for every f < 4096 and every state x < 2^31 (0 mismatches or the run
     fails); ans0_decode also on the CPU tests' corrupt cases (tables no
     valid stream holds, cut lengths, states >= 2^31, an odd pitch);
     huffman_decode also on the CPU tests' incomplete code, on random and
     on all-ones payload bytes (every stream then ends at bit 53,248);
     huffman_encode also on a random 16-bit table (code lengths 0-15, codes
     wider than their length) and on an all-15-bit table (every stream
     3,840 words); ans0_compact also with every position flagged and none
     flagged, at width 4,076 (its scalar path) and at 40,000 (three tiles,
     the count carried from tile to tile); the
     three chains' cycles a step (ms x the maximum SM clock / 4,096);
     lz_words on 8 x 4 MiB rows of mixed_corpus(64 MiB, seed=12) (one flat
     dispatch of level 1), the last row's last 1 KiB repeating the KiB
     before it, so the tail rule shows; the order-1 kernels on 4 x 4 MiB
     chunks of that corpus plus two edge chunks (one repeated byte; uniform
     random), ans1_scan (the order-1 lookup and the scan, fused) at the main
     path's full 2^20 steps of their real lanes (its plain version run and
     timed once, ~100 s), ans1_compact on its words and on tiles cut from
     them at nb 1, 2, 64 and 128, M 1 and 256, with every word flagged and
     none, then ans1_scan timed for one chunk and for 32 in one launch,
     beside the floor of its chain alone (csrc/ans1.cu scan_chain_kernel, SM
     cycles by clock64); the scan's reciprocal against exact division for
     every f < 2048 and every state x < 2^31 (csrc/ans1.cu
     recip_check_kernel, 0 mismatches or the run fails); ksort at (8, 2^22) x 2 and
     (512, 2^16) x 5 operands, 2 keys, the last an iota, with its schedule's
     pass count and each kind of pass timed alone (and, untimed, at eight
     small shapes of 1-8 operands that take the launcher's other paths);
     all times by CUDA
     events around the wrapper, warm, median of 5, at one main-path launch's
     shape (ans1_scan at the six chunks of its plain run), and each kernel's
     time on the card alone (its launches queued behind a spin kernel, so
     that the wrapper's host time hides; the mean of 10)
  3  ANS0 alone (transform NONE), 64 MiB of mixed_corpus(seed=12), 4 MiB
     blocks, jobs=8: the port's stream on the card equals its host-coder
     stream (device=None), the port decodes it on the card, the host coders
     decode it too
  4  level 5 (TEXT+UTF+BWT+RANK+ZRLT + ANS0) on the same 64 MiB, same checks
  5  Huffman alone (transform NONE) on the same 64 MiB, same checks
  6  level 3 (TEXT+UTF+PACK+MM+LZX + HUFFMAN) on the same 64 MiB, same checks
  7  level 1 (LZX + NONE) on the same 64 MiB under KANZI_TPU_DEVICE_LZ=1:
     the LZX parse runs on the card (ops/lz_sort.py); the stream decodes on
     the card and with the host coders, its first two blocks equal the
     port's CPU engine (device="cpu") on them, and it is at most 1.05 x the
     size of the host parse's stream
  8  ANS1 alone (transform NONE, entropy ANS1) on the same 64 MiB, the
     checks of phase 3; order 1 decodes on the host (as in kanzi_tpu), so
     the port's decode runs no kernel; one launch of each order-1 kernel
     (ans1_scan, ans1_compact) per 4 MiB block
  9  ksort_rows, the row sort's own entry point (no codec path calls it),
     at the two shapes of phase 2 on fresh operands: rows sorted, operands
     permuted alike
The launch counts are set to 0 just before each of phases 3-9 and read just
after it.  Then the card line, one JSON line of the kernels (each with its
bound: the larger of its bytes over 3.35 TB/s and its integer operations
over 67 T/s), and the result line.
``--quick`` stops after phase 2 and prints no result line, for the first
call after a kernel changes; ``--phase2 ans0,huffman`` (any of floor, ans0,
huffman, lz_words, ans1, ksort, and ans1_compact: the compaction's part of
ans1 alone, on the scan kernel's words) runs only those groups of phase 2,
then stops the same way.  ``--profile`` runs phases 0-1, then one
level-1 compress of 32 MiB with the LZX parse on the card under
torch.profiler (device time by kernel family, the card's busy share) and
once more with each engine stage timed on the host clock around a
synchronize; it prints one JSON line and no result line.  Without a card
the script exits non-zero and prints no result.
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
BLOCK = 4 << 20
ANS0_SRC = "kanzi_tpu_torch/csrc/ans0.cu"
HUFFMAN_SRC = "kanzi_tpu_torch/csrc/huffman.cu"
LZ_WORDS_SRC = "kanzi_tpu_torch/csrc/lz_words.cu"
ANS1_SRC = "kanzi_tpu_torch/csrc/ans1.cu"
KSORT_SRC = "kanzi_tpu_torch/csrc/ksort.cu"
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
    "lz_words": (LZ_WORDS_SRC, "kanzi_tpu/ops/lz_sort.py:107", []),
    "ans1_scan": (ANS1_SRC, "kanzi_tpu/ops/ans_pallas.py:80",
                  ["kanzi_tpu/ops/ans_pallas.py:885"]),
    "ans1_compact": (ANS1_SRC, "kanzi_tpu/ops/ans_pallas.py:480", []),
    "ksort": (KSORT_SRC, "kanzi_tpu/ops/ksort_pallas.py:104",
              ["kanzi_tpu/ops/ksort_pallas.py:123"]),
}
ANS0_KERNELS = ("ans0_hist_norm", "ans0_encode_scan", "ans0_compact", "ans0_decode")
HUFFMAN_KERNELS = ("huffman_hist", "huffman_encode", "huffman_decode")
LZ_KERNELS = ("lz_words",)
ANS1_KERNELS = ("ans1_scan", "ans1_compact")
KSORT_SHAPES = ((8, 1 << 22, 2), (512, 1 << 16, 5))      # (B, N, operands), 2 keys
# the shape of the phase-2 times: one main-path launch
TIMED_AT = {"lz_words": "8 x 4 MiB", "ans1_scan": "6 x 4 MiB", "ans1_compact": "1 x 4 MiB",
            "ksort": "(8, 2^22) x 2 operands"}
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM bytes per second, and
# the non-tensor 32-bit rate, taken for the kernels' integer operations
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# integer operations per element of each kernel's main input, an estimate
# from its inner loop (bytes bound every one of them by a wide margin)
OPS_PER_ELEMENT = {"ans0_hist_norm": 4, "ans0_encode_scan": 24, "ans0_compact": 6,
                   "ans0_decode": 24, "huffman_hist": 4, "huffman_encode": 12,
                   "huffman_decode": 16, "lz_words": 24, "ans1_scan": 16,
                   "ans1_compact": 6}
# ksort's operations are counted per call: a comparison sort's least
# compares, B * N * log2(N), each over the key operands


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


def device_ms(fn, reps: int = 10) -> float:
    """The card's time of ``fn`` with the host's share hidden: a spin kernel
    (torch.cuda._sleep) holds the stream while ``reps`` runs are queued
    behind it, and CUDA events around those runs give their time on the
    card, a run's mean.  Unlike time_ms, the host's time in the wrapper
    before each launch does not count; the gaps between queued launches
    do.  The spin is doubled until the queue is full before the card
    reaches the first event."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin_s = 2 * reps * (time.perf_counter() - t) + 2e-3
    for _ in range(6):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * 2e9))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued = not a.query()
        b.synchronize()
        if queued:
            return a.elapsed_time(b) / reps
        spin_s *= 2
    raise RuntimeError("chip_smoke check failed: the launches never queued behind the spin")


def nbytes(*ts) -> int:
    """Bytes of the tensors in ``ts`` (nested lists and tuples flattened)."""
    total = 0
    for t in ts:
        if isinstance(t, (list, tuple)):
            total += nbytes(*t)
        else:
            total += t.numel() * t.element_size()
    return total


def bound(inputs, outputs, ops: float) -> dict:
    """The least time the card could take: each input read once and each
    output written once at PEAK_BYTES_S, or the integer operations at
    PEAK_OPS_S, whichever is longer."""
    bytes_ms = nbytes(inputs, outputs) / PEAK_BYTES_S * 1e3
    ops_ms = ops / PEAK_OPS_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def timed(rec: dict, name: str, kern, plain, inputs, elements: int,
          library=None, ops: float | None = None) -> dict:
    """Times of the kernel (around its wrapper, and on the card alone), its
    plain version and (where one PyTorch call computes the same function)
    that call, and the kernel's bound; ``ops`` overrides
    OPS_PER_ELEMENT[name] * elements."""
    out = kern()
    if ops is None:
        ops = OPS_PER_ELEMENT[name] * elements
    rec.setdefault(name, {}).update(
        ms=time_ms(kern), device_ms=device_ms(kern), plain_ms=time_ms(plain),
        library_ms=time_ms(library) if library else None, **bound(inputs, out, ops))
    return rec[name]


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


def norm_edge_rows():
    """The normalisation's edge rows of tests/test_torch_ans_ops.py, made
    into 16 KiB chunks: a max tied at four bins (the lowest takes the
    correction); a delta past err_thr of each sign (one left nonzero after
    the five rounds); exactly two symbols."""
    import numpy as np
    tie = np.zeros(256, np.int64)
    tie[[5, 17, 40, 200, 201]] = [1, 4095, 4096, 4096, 4096]
    pos = np.zeros(256, np.int64)
    pos[:250] = 6
    pos[250:253] = [4961, 4961, 4962]
    neg = np.zeros(256, np.int64)
    neg[:200] = 5
    neg[200:] = (CHUNK - 1000) // 56
    neg[200:200 + (CHUNK - 1000) % 56] += 1
    two = np.zeros(256, np.int64)
    two[[3, 250]] = [5002, 11382]
    rng = np.random.default_rng(4)
    return np.stack([rng.permutation(np.repeat(np.arange(256, dtype=np.uint8), h))
                     for h in (tie, pos, neg, two)])


def one_byte_times(rec: dict, name: str, fn, dev) -> None:
    """``fn`` (a histogram wrapper) on 256 chunks of one byte value, where
    every lane of a warp counts into one bin: checked bit-equal to its
    plain version, then timed around the wrapper and on the card alone."""
    import torch
    ones = torch.full((256, CHUNK), 0x41, dtype=torch.uint8, device=dev)
    check(torch.equal(fn(ones), fn(ones.cpu()).to(dev)),
          f"{name} differs from its plain version on the all-one-byte chunks")
    rec[name].update(one_byte_ms=time_ms(lambda: fn(ones)),
                     one_byte_device_ms=device_ms(lambda: fn(ones)))


def phase2_ans0(dev, rows) -> dict:
    import numpy as np
    import torch

    from kanzi_tpu_torch.entropy.utils import normalize_frequencies_batch
    from kanzi_tpu_torch.ops import ans_cuda as A

    chunks = np.concatenate([rows, edge_rows(), norm_edge_rows()])
    x = torch.from_numpy(chunks).to(dev)
    n = x.shape[0]
    rec = {}

    freq = A.hist_norm(x)
    freq_r = A.hist_norm_ref(x)
    hist = np.stack([np.bincount(r, minlength=256) for r in chunks])
    host = normalize_frequencies_batch(hist, CHUNK, 4096)
    check(torch.equal(freq, freq_r), "hist_norm differs from its plain version")
    check(np.array_equal(freq.cpu().numpy(), host), "hist_norm differs from the host")
    rec["ans0_hist_norm"] = {"max_abs_err": max_abs_err([freq], [freq_r]),
                             "edge_cases": ["edge_rows", "norm_edge_rows"]}

    cum, tables = A.make_tables(freq)
    check(bool((freq == 0).any()), "no phase-2 table has an f = 0 entry (an absent symbol)")
    enc = A.encode_scan(x, tables)
    enc_r = A.encode_scan_ref(x, tables)
    check(all(torch.equal(a, b) for a, b in zip(enc, enc_r)),
          "encode_scan differs from its plain version")
    rec["ans0_encode_scan"] = {"max_abs_err": max_abs_err(enc, enc_r)}
    for label, args in scan_edge_cases(dev).items():
        got, want = A.encode_scan(*args), A.encode_scan_ref(*args)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"encode_scan differs from its plain version on {label}")
        rec["ans0_encode_scan"]["max_abs_err"] = max(rec["ans0_encode_scan"]["max_abs_err"],
                                                     max_abs_err(got, want))
        rec["ans0_encode_scan"].setdefault("edge_cases", []).append(label)
    rec["ans0_encode_scan"]["recip"] = recip_check(dev, A.LOG_RANGE)

    words, flags, states = enc
    cmp_ = A.compact(words, flags)
    cmp_r = A.compact_ref(words, flags)
    check(all(torch.equal(a, b) for a, b in zip(cmp_, cmp_r)),
          "compact differs from its plain version")
    rec["ans0_compact"] = {"max_abs_err": max_abs_err(cmp_, cmp_r)}
    for label, args in compact_edge_cases(words, flags).items():
        got, want = A.compact(*args), A.compact_ref(*args)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"compact differs from its plain version on {label}")
        rec["ans0_compact"]["max_abs_err"] = max(rec["ans0_compact"]["max_abs_err"],
                                                 max_abs_err(got, want))
        rec["ans0_compact"].setdefault("edge_cases", []).append(label)

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
    for label, args in corrupt_decode_cases(pay, lengths, states.to(torch.int64), freq,
                                            cum).items():
        got, want = A.decode(*args), A.decode_ref(*args)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"decode differs from its plain version on {label}")
        rec["ans0_decode"]["max_abs_err"] = max(rec["ans0_decode"]["max_abs_err"],
                                                max_abs_err(got, want))
        rec["ans0_decode"].setdefault("corrupt_cases", []).append(label)

    # times at the main path's shape: one 4 MiB block = 256 chunks
    m = 256
    xm, fm, cm, tm = x[:m], freq[:m], cum[:m], tables[:m]
    wm, flm, sm = words[:m], flags[:m], states[:m].to(torch.int64)
    pm, lm = pay[:m], lengths[:m]
    e = xm.numel()
    timed(rec, "ans0_hist_norm", lambda: A.hist_norm(xm), lambda: A.hist_norm_ref(xm),
          xm, e)
    one_byte_times(rec, "ans0_hist_norm", A.hist_norm, dev)
    r = timed(rec, "ans0_encode_scan", lambda: A.encode_scan(xm, tm),
              lambda: A.encode_scan_ref(xm, tm), (xm, tm), e)
    per_step(r, lambda: A.encode_scan(xm, tm))
    r.update(scan0_chain(dev, tm))
    r["floor_ms"] = (CHUNK // 4) * r["chain_cycles_per_step"] / (r["sm_clock_max_mhz"] * 1e3)
    flb = flm.bool()
    timed(rec, "ans0_compact", lambda: A.compact(wm, flm), lambda: A.compact_ref(wm, flm),
          (wm, flm), wm.numel(),
          library=lambda: (torch.masked_select(wm, flb), flb.sum(1)))
    r = timed(rec, "ans0_decode", lambda: A.decode(pm, lm, sm, fm, cm),
              lambda: A.decode_ref(pm, lm, sm, fm, cm), (pm, lm, sm, fm, cm), e)
    per_step(r, lambda: A.decode(pm, lm, sm, fm, cm))
    return rec


def per_step(r: dict, fn) -> None:
    """A launch's cycles a step at 256 x 16 KiB: its ms x the maximum SM
    clock / the 4,096 steps of each chain (the chains run side by side),
    the same of its time on the card alone, and the first at the SM clock
    read while ``fn`` runs back to back."""
    r["sm_clock_max_mhz"] = sm_clock_mhz()
    r["cycles_per_step"] = r["ms"] * 1e-3 * r["sm_clock_max_mhz"] * 1e6 / (CHUNK // 4)
    r["cycles_per_step_card"] = (r["device_ms"] * 1e-3 * r["sm_clock_max_mhz"] * 1e6
                                 / (CHUNK // 4))
    r["sm_clock_load_mhz"] = sm_clock_under_load(fn)
    r["cycles_per_step_load_clock"] = r["ms"] * 1e-3 * r["sm_clock_load_mhz"] * 1e6 / (CHUNK // 4)


def scan_edge_cases(dev) -> dict:
    """The encode scan's cases of the CPU tests: the division-edge tables of
    tests/test_torch_ans_ops.py (f = 4095 beside f = 1, 3, 37, 700 and
    f = 0 for the 251 absent symbols, cum 1 under the 4095, which drives
    the states divided by 4095 to within 2^21 of 2^31) on 30 rows of 4,096
    bytes, and the same rows cut to 4,076 bytes (a width that is no
    multiple of 64, so the kernel runs its top steps one by one).  Each:
    the scan's two arguments."""
    import numpy as np
    import torch
    n, c = 30, 4096
    freq = np.zeros((n, 256), np.int64)
    cum = np.zeros((n, 256), np.int64)
    freq[:, :5] = [4095, 1, 3, 37, 700]
    cum[:, 0] = 1
    chunks = np.stack([np.random.default_rng(s).choice(
        5, c, p=[0.5, 0.1, 0.1, 0.15, 0.15]).astype(np.uint8) for s in range(n)])
    tables = torch.from_numpy((np.minimum(freq, 4095) | (cum << 12)).astype(np.int32)).to(dev)
    x = torch.from_numpy(chunks).to(dev)
    return {"division edge, f = 0 absent": (x, tables),
            "width 4,076": (x[:, :4076].contiguous(), tables)}


def compact_edge_cases(words, flags) -> dict:
    """The compaction's other paths, on phase 2's encode-scan words: every
    position flagged and none flagged at 16,384; the rows cut to 4,076 (a
    width that is no multiple of 16 takes the scalar partition); and the
    words and flags of eight rows laid out as rows of 40,000 (three tiles,
    the running count carried twice).  Each: the compaction's two
    arguments."""
    import torch
    n = 8 * 40000 // CHUNK + 1
    return {"all flagged": (words, torch.ones_like(flags)),
            "none flagged": (words, torch.zeros_like(flags)),
            "width 4,076": (words[:, :4076].contiguous(), flags[:, :4076].contiguous()),
            "width 40,000": (words[:n].reshape(-1)[:8 * 40000].reshape(8, 40000),
                             flags[:n].reshape(-1)[:8 * 40000].reshape(8, 40000))}


def corrupt_decode_cases(pay, lengths, states, freq, cum) -> dict:
    """The decode cases of the CPU tests, on four rows of phase 2's encode:
    tables no valid stream holds (bounds not monotone; a sum over 4,096;
    a zero-frequency symbol holding slots; one symbol of frequency 4,096),
    lengths cut by 6 bytes, states >= 2^31, and a pitch that is no multiple
    of 16 with every length past it.  Each: the decode's five arguments."""
    import torch
    p, ln, st, f, c = pay[:4], lengths[:4], states[:4], freq[:4].clone(), cum[:4].clone()
    c[0] = c[0].flip(0)
    f[1] = f[1] * 2
    c[1] = torch.cumsum(f[1], 0) - f[1]
    k = int(torch.nonzero(f[2])[0])
    f[2, k], c[2, k] = 0, 5000
    f[3], c[3] = 0, 0
    f[3, 9] = 4096
    high = st.clone()
    high[:, 0], high[:, 2] = 0xFFFFFFFF, (1 << 31) + 12345
    w = int(ln.min()) - 3
    return {"corrupt tables": (p, ln, st, f, c),
            "lengths cut by 6": (p, ln - 6, st, freq[:4], cum[:4]),
            "states >= 2^31": (p, ln, high, freq[:4], cum[:4]),
            "pitch of odd width under the lengths": (p[:, :w].contiguous(), ln, st, freq[:4],
                                                     cum[:4])}


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

    from kanzi_tpu_torch.entropy.huffman import build_tables_batch
    from kanzi_tpu_torch.ops import huffman_block as HB
    from kanzi_tpu_torch.ops import huffman_cuda as H

    chunks = np.concatenate([rows, norm_edge_rows(), huffman_edge_rows()])
    x = torch.from_numpy(chunks).to(dev)
    n = x.shape[0]
    rec = {}

    hist = H.hist(x)
    hist_r = H.hist_ref(x)
    check(torch.equal(hist, hist_r), "huffman_hist differs from its plain version")
    hists = np.stack([np.bincount(r, minlength=256) for r in chunks]).astype(np.int64)
    check(np.array_equal(hist.cpu().numpy(), hists), "huffman_hist differs from bincount")
    rec["huffman_hist"] = {"max_abs_err": max_abs_err([hist], [hist_r]),
                           "edge_cases": ["norm_edge_rows", "huffman_edge_rows"]}

    sizes, codes, nsym = build_tables_batch(hists)
    check(sizes[-1].max() == 12 and nsym[-3] == 1 and nsym[-2] == 256,
          "the Huffman edge rows miss their edges")
    tbl = torch.from_numpy(((sizes << 12) | codes).astype(np.uint16).view(np.int32)).to(dev)
    enc = H.encode_streams(x, tbl)
    enc_r = H.encode_streams_ref(x, tbl)
    check(all(torch.equal(a, b) for a, b in zip(enc, enc_r)),
          "huffman_encode differs from its plain version")
    rec["huffman_encode"] = {"max_abs_err": max_abs_err(enc, enc_r)}
    for label, t16 in huffman_encode_tables(n).items():
        tb = torch.from_numpy(t16.view(np.int32)).to(dev)
        got, want = H.encode_streams(x, tb), H.encode_streams_ref(x, tb)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"huffman_encode differs from its plain version on {label}")
        if label == "all-15-bit table":
            check(bool((got[1] == 3840).all()), "all-15-bit table: a stream is not 3,840 words")
        rec["huffman_encode"]["max_abs_err"] = max(rec["huffman_encode"]["max_abs_err"],
                                                   max_abs_err(got, want))
        rec["huffman_encode"].setdefault("edge_cases", []).append(label)

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
    for label, args in huffman_incomplete_cases(dev).items():
        got, want = H.decode_chunks(*args), H.decode_chunks_ref(*args)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"huffman_decode differs from its plain version on {label}")
        rec["huffman_decode"]["max_abs_err"] = max(rec["huffman_decode"]["max_abs_err"],
                                                   max_abs_err(got, want))
        rec["huffman_decode"].setdefault("edge_cases", []).append(label)
        if label == "all-ones payload":
            check(bool((got[1] == 13 * H.STREAM).all()),
                  "all-ones payload: a stream did not end at bit 53,248")

    m = 256
    xm, tm = x[:m], tbl[:m]
    pm, bm, am, qm = pay[:m], bnd[:m], adj[:m], perm[:m]
    e = xm.numel()
    idx = xm.long()
    ones = torch.ones_like(idx)
    counts = torch.zeros((m, 256), dtype=torch.int64, device=dev)
    timed(rec, "huffman_hist", lambda: H.hist(xm), lambda: H.hist_ref(xm), xm, e,
          library=lambda: counts.zero_().scatter_add_(1, idx, ones))
    one_byte_times(rec, "huffman_hist", H.hist, dev)
    timed(rec, "huffman_encode", lambda: H.encode_streams(xm, tm),
          lambda: H.encode_streams_ref(xm, tm), (xm, tm), e)
    r = timed(rec, "huffman_decode", lambda: H.decode_chunks(pm, bm, am, qm),
              lambda: H.decode_chunks_ref(pm, bm, am, qm), (pm, bm, am, qm), e)
    per_step(r, lambda: H.decode_chunks(pm, bm, am, qm))
    return rec


def huffman_encode_tables(n: int) -> dict:
    """Tables no valid stream holds, one a chunk (N, 256) u16, as
    tests/test_torch_huffman_ops.py runs them: random 16-bit entries
    (lengths 0-15, codes wider than their length) and all lengths 15 (every
    stream 3,840 words, the most a kernel row holds)."""
    import numpy as np
    rng = np.random.default_rng(9)
    code = rng.integers(0, 1 << 12, (n, 256))
    return {"random 16-bit table": rng.integers(0, 1 << 16, (n, 256)).astype(np.uint16),
            "all-15-bit table": ((15 << 12) | code).astype(np.uint16)}


def huffman_incomplete_cases(dev) -> dict:
    """The incomplete code of tests/test_torch_huffman_ops.py (one 12-bit
    code, symbol 200; every window but the first is past the last code, so
    decodes to 0 and advances 13 bits) on random payload bytes, whose
    streams end near their segment's end, and on all-ones bytes, whose
    windows all advance 13 bits, so that every stream ends exactly at the
    segment's end, bit 53,248.  Each: the decode's four arguments."""
    import numpy as np
    import torch

    from kanzi_tpu_torch.ops import huffman_block as HB
    from kanzi_tpu_torch.ops import huffman_cuda as H
    sizes = np.full(256, 8, np.int64)
    sizes[200] = 12
    tabs = [torch.from_numpy(t).to(dev)
            for t in HB.build_decode_tables([sizes], [np.array([200])])]
    rng = np.random.default_rng(8)
    rand = torch.from_numpy(rng.integers(0, 256, (1, H.PAY_WIDTH), dtype=np.uint8)).to(dev)
    ones = torch.full((1, H.PAY_WIDTH), 255, dtype=torch.uint8, device=dev)
    return {"incomplete code": (rand, *tabs), "all-ones payload": (ones, *tabs)}


def phase2_lz_words(dev, data: bytes) -> dict:
    """lz_words against its plain version on the card at one flat dispatch
    of level 1: 8 rows of 4 MiB.  The last row's last 1 KiB repeats the KiB
    before it, so its tail words (bytes past the row's end are the bytes
    1,024 before them) must equal the words 1,024 positions earlier."""
    import numpy as np
    import torch

    from kanzi_tpu_torch.ops import lz_words_cuda as L

    rows = np.frombuffer(data[:8 * BLOCK], np.uint8).reshape(8, BLOCK).copy()
    rows[7, BLOCK - 1024:] = rows[7, BLOCK - 2048:BLOCK - 1024]
    x = torch.from_numpy(rows).to(dev)
    got = L.lz_words(x)
    want = L.lz_words_ref(x)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "lz_words differs from its plain version")
    check(all(torch.equal(g[7, -15:], g[7, -1039:-1024]) for g in got),
          "lz_words: the tail rule does not hold on the repeated last KiB")
    rec = {"lz_words": {"max_abs_err": max_abs_err(got, want)}}
    timed(rec, "lz_words", lambda: L.lz_words(x), lambda: L.lz_words_ref(x), x, x.numel())
    return rec


def sm_clock_mhz(query: str = "clocks.max.sm") -> float:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(res.stdout.strip().splitlines()[0])


def sm_clock_under_load(fn, seconds: float = 0.5) -> float:
    """The SM clock (MHz) that nvidia-smi reads while the card runs ``fn``
    back to back: about ``seconds`` of launches are queued first, then the
    clock is read, then the queue drains."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    n = max(1, int(seconds / max(time.perf_counter() - t, 1e-5)))
    for _ in range(n):
        fn()
    mhz = sm_clock_mhz("clocks.sm")
    torch.cuda.synchronize()
    return mhz


def chain_floor(dev, ent, steps: int, lr: int):
    """The floor of a reciprocal rANS chain (csrc/rans.cuh ans_step):
    csrc/ans1.cu scan_chain_kernel runs ``steps`` steps on one thread over
    the 16 packed entries ``ent`` (f | cm << lr; step t takes ent[t % 16]),
    their operands in registers, no load or store in its loop, and counts
    the SM cycles by clock64.  Returns (cycles a step, its final state).
    Not a codec kernel: no launch count."""
    import torch

    from kanzi_tpu_torch.utils import cuda_build

    out = torch.zeros(4, dtype=torch.int32, device=dev)
    cyc = torch.zeros(2, dtype=torch.int64, device=dev)
    err = cuda_build.load().kz_ans1_scan_chain(
        ent.data_ptr(), out.data_ptr(), cyc.data_ptr(), steps, lr,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err == 0, f"scan_chain: kernel launch failed, cudaError {err}")
    return int(cyc[0]) / steps, out[0]


def scan_chain(dev, ent, steps: int) -> dict:
    """The floor of ans1_scan's chain, from chain_floor.  Its final state
    must equal ans1_scan's on a chunk whose four quarters show it those
    entries repeated: byte p % 16 + 1 at quarter position p, and a table
    holding ent[15 - j] at each of the byte pairs (context, symbol) of
    p % 16 == j."""
    import torch

    from kanzi_tpu_torch.ops import ans1_cuda as A1

    cyc, out = chain_floor(dev, ent, steps, A1.LOG_RANGE1)
    sym = torch.arange(steps, device=dev) % 16 + 1
    chunk = sym.repeat(4).to(torch.uint8).view(1, 4 * steps)
    packed = torch.zeros((1, 65536), dtype=torch.int32, device=dev)
    j = torch.arange(16, device=dev)
    packed[0, ((j - 1) % 16 + 1) * 256 + j + 1] = ent.flip(0)
    packed[0, 1] = ent[15]                    # quarter start: context 0
    _, st = A1.scan_chunks(chunk, packed)
    check(bool((st == out).all()), "scan_chain's state differs from ans1_scan's")
    return {"chain_cycles_per_step": cyc}


def scan0_chain(dev, tables) -> dict:
    """The floor of ans0_encode_scan's chain, from chain_floor at logRange
    12 over 16 entries of a phase-2 table (symbols present in its chunk).
    Its final state must equal the kernel's on a 16 KiB chunk whose word k
    holds byte (4095 - k) % 16 four times, with a table holding the 16
    entries at bytes 0-15: each lane then codes entry t % 16 at step t."""
    import torch

    from kanzi_tpu_torch.ops import ans_cuda as A

    steps = CHUNK // 4
    ent = tables[0][(tables[0] & (A.SCALE - 1)) > 0][:16].contiguous()
    check(ent.numel() == 16, "the chain floor needs 16 symbols present in a phase-2 chunk")
    cyc, out = chain_floor(dev, ent, steps, A.LOG_RANGE)
    k = torch.arange(steps, device=dev)
    chunk = ((steps - 1 - k) % 16).repeat_interleave(4).to(torch.uint8).view(1, CHUNK)
    tbl = torch.zeros((1, 256), dtype=torch.int32, device=dev)
    tbl[0, :16] = ent
    _, _, st = A.encode_scan(chunk, tbl)
    check(bool((st == out).all()), "scan_chain's state differs from ans0_encode_scan's")
    return {"chain_cycles_per_step": cyc}


def recip_check(dev, lr: int) -> dict:
    """csrc/ans1.cu recip_check_kernel: the reciprocal of csrc/rans.cuh
    against exact division for every f in [1, 2^lr - 1] and every state
    x < 2^31 (a superset of the renormalised states x < f << (31 - lr) that
    a scan divides), lr 11 for the order-1 scan and 12 for the order-0 one.
    Fails unless it counts 0 mismatches over all the pairs.  Not a codec
    kernel: no launch count."""
    import torch

    from kanzi_tpu_torch.utils import cuda_build

    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    err = cuda_build.load().kz_ans1_recip_check(counts.data_ptr(), lr,
                                                torch.cuda.current_stream(dev).cuda_stream)
    check(err == 0, f"recip_check: kernel launch failed, cudaError {err}")
    bad, pairs = (int(v) for v in counts.cpu())
    seconds = time.perf_counter() - t
    want = ((1 << lr) - 1) << 31
    check(pairs == want, f"recip_check at lr {lr} compared {pairs} pairs, not {want}")
    check(bad == 0, f"recip_check at lr {lr}: {bad} mismatches of the reciprocal against x / f")
    return {"recip_pairs": pairs, "recip_mismatches": bad, "recip_check_s": seconds}


def phase2_ans1(dev, data: bytes) -> dict:
    """The fused ans1_scan (lookup and scan) and compact against their plain
    versions on 4 x 4 MiB chunks of the corpus and two edge chunks (one
    repeated byte: every context holds one symbol, freq 2048 capped to 2047;
    uniform random).  The scan is held to scan_chunks_ref(lookup1_ref(...))
    at full length, the main path's 2^20 steps of the 24 real lanes; the
    plain version takes ~8 tensor ops a step, ~100 s for those steps on the
    card, so it runs, and is timed, once.  Then the reciprocal's exhaustive
    check and the chain's floor, from scan_chain."""
    import numpy as np
    import torch

    from kanzi_tpu_torch.ops import ans1_cuda as A1
    from kanzi_tpu_torch.ops.ans_block import order1_tables

    rng = np.random.default_rng(8)
    chunks = np.concatenate([np.frombuffer(data[:4 * BLOCK], np.uint8).reshape(4, BLOCK),
                             np.full((1, BLOCK), 200, np.uint8),
                             rng.integers(0, 256, (1, BLOCK), dtype=np.uint8)])
    freq, cum = order1_tables(chunks)
    x = torch.from_numpy(chunks).to(dev)
    packed = A1.pack_tables(torch.from_numpy(freq).to(dev), torch.from_numpy(cum).to(dev))
    n, q = x.shape[0], BLOCK // 4
    rec = {}

    lk_r = A1.lookup1_ref(x, packed)
    check(bool((lk_r[4] & 2047 == 2047).all()), "the repeated byte's 2048 is not capped")
    sc = A1.scan_chunks(x, packed)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    sc_r = A1.scan_chunks_ref(A1.lookup1_ref(x, packed))
    b.record()
    b.synchronize()
    check(all(torch.equal(u, v) for u, v in zip(sc, sc_r)),
          "ans1_scan differs from its plain version")
    rec["ans1_scan"] = {"max_abs_err": max_abs_err(sc, sc_r), "plain_ms": a.elapsed_time(b),
                        **recip_check(dev, A1.LOG_RANGE1)}
    del sc_r

    rec.update(phase2_ans1_compact(sc[0].view(n * (BLOCK // CHUNK), 128, 128)))

    # times at one main-path launch: the scan's at the six chunks of its one
    # plain run (a launch of one chunk takes as long)
    x1, p1 = x[:1], packed[:1]
    r = rec["ans1_scan"]
    r.update(ms=time_ms(lambda: A1.scan_chunks(x, packed)),
             device_ms=device_ms(lambda: A1.scan_chunks(x, packed), reps=3), library_ms=None,
             **bound((x, packed), sc, OPS_PER_ELEMENT["ans1_scan"] * x.numel()))
    x32, p32 = x1.expand(32, BLOCK).contiguous(), p1.expand(32, 65536).contiguous()
    e32, s32 = A1.scan_chunks(x32, p32)
    check(bool((e32 == sc[0][:1]).all() and (s32 == sc[1][:1]).all()),
          "ans1_scan: 32 copies of a chunk in one launch differ from its checked output")
    del e32
    clock = sm_clock_mhz()
    r.update(steps=q, ms_1_chunk=time_ms(lambda: A1.scan_chunks(x1, p1)),
             ms_32_chunks=time_ms(lambda: A1.scan_chunks(x32, p32)), sm_clock_max_mhz=clock,
             **scan_chain(dev, lk_r[0, :16].contiguous(), q))
    r["cycles_per_step"] = r["ms_1_chunk"] * 1e-3 * clock * 1e6 / q
    r["floor_ms"] = q * r["chain_cycles_per_step"] / (clock * 1e3)
    return rec


def phase2_ans1_compact(e) -> dict:
    """ans1_compact against its plain version on ``e`` (T, 128, 128), the
    order-1 scan's words of T / 256 chunks; then on the edge inputs, cut
    from ``e``: nb 1, 2, 64 and 128 at M = 1 and 256 tiles, each with the
    scan's flags, every word flagged and none; timed at one main-path
    launch, one 4 MiB chunk (256 tiles of nb = 128)."""
    import torch

    from kanzi_tpu_torch.ops import ans1_cuda as A1

    cp = A1.compact(e)
    cp_r = A1.compact_ref(e)
    check(all(torch.equal(u, v) for u, v in zip(cp, cp_r)),
          "ans1_compact differs from its plain version")
    rec = {"max_abs_err": max_abs_err(cp, cp_r), "edge_cases": []}
    flat = e.reshape(-1)
    for nb in (1, 2, 64, 128):
        for m in (1, 256):
            base = flat[:m * nb * 128].view(m, nb, 128)
            for label, ee in (("the scan's flags", base), ("all flagged", base | (1 << 16)),
                              ("none flagged", base & 0xFFFF)):
                got, want = A1.compact(ee), A1.compact_ref(ee)
                check(all(torch.equal(u, v) for u, v in zip(got, want)),
                      f"ans1_compact differs from its plain version at nb {nb}, M {m}, {label}")
                rec["max_abs_err"] = max(rec["max_abs_err"], max_abs_err(got, want))
            rec["edge_cases"].append(f"nb {nb} M {m}")
    e1 = e[:BLOCK // CHUNK]
    out = {"ans1_compact": rec}
    timed(out, "ans1_compact", lambda: A1.compact(e1), lambda: A1.compact_ref(e1),
          e1, e1.numel(), library=lambda: (torch.masked_select(e1 & 0xFFFF, e1 >= 1 << 16),
                                           (e1 >> 16).sum(2)))
    return out


def phase2_ans1_compact_alone(dev, data: bytes) -> dict:
    """phase2_ans1_compact on the scan kernel's words of two 4 MiB chunks of
    the corpus, without the plain order-1 scan's ~100 s (the "ans1" group
    holds the scan to it)."""
    import numpy as np
    import torch

    from kanzi_tpu_torch.ops import ans1_cuda as A1
    from kanzi_tpu_torch.ops.ans_block import order1_tables

    chunks = np.frombuffer(data[:2 * BLOCK], np.uint8).reshape(2, BLOCK)
    freq, cum = order1_tables(chunks)
    packed = A1.pack_tables(torch.from_numpy(freq).to(dev), torch.from_numpy(cum).to(dev))
    emit, _ = A1.scan_chunks(torch.from_numpy(chunks).to(dev), packed)
    return phase2_ans1_compact(emit.view(-1, 128, 128))


def card_floor(dev) -> dict:
    """The floor of the card-alone times: an empty kernel (csrc/ans1.cu
    empty_kernel, on no codec path, no launch count) queued and timed by
    device_ms as every kernel is, at 256 CTAs of 256 threads (the
    histograms' grid) and of 512 (the compactions')."""
    import torch

    from kanzi_tpu_torch.utils import cuda_build

    lib = cuda_build.load()
    s = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for threads in (256, 512):
        def run():
            err = lib.kz_empty(256, threads, s)
            check(err == 0, f"empty kernel: launch failed, cudaError {err}")
        out[f"256 x {threads}"] = device_ms(run)
    return out


def sass_loads_before_atomics(names=("hist_norm_kernel", "huffman_hist_kernel")) -> dict:
    """For each kernel of ``names``, the 16-byte global loads (LDG ... 128)
    that its SASS, as cuobjdump -sass prints the built library, places
    before its first shared-memory atomic (ATOMS): chunk_hist's four loads
    all in flight show as 4."""
    import glob
    import re
    import shutil

    from kanzi_tpu_torch.utils import cuda_build

    so = max(glob.glob(os.path.join(cuda_build.BUILD_DIR, "libkanzi_torch_*.so")),
             key=os.path.getmtime)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    out, fn, seen = {}, None, True
    for line in sass.splitlines():
        if "Function :" in line:
            fn = next((k for k in names if k in line), None)
            seen = fn is None
            if fn:
                out[fn] = 0
        elif not seen:
            if re.search(r"\bATOMS\b", line):
                seen = True
            elif "LDG" in line and ".128" in line:
                out[fn] += 1
    check(set(out) == set(names), f"cuobjdump -sass shows {sorted(out)}, not {list(names)}")
    return out


def ksort_operands(dev, b: int, n: int, nops: int, seed: int) -> list:
    """A key with many ties (2^21 values), the position iota that makes the
    order total, and nops - 2 payload operands, made on the card."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda lo, hi: torch.randint(lo, hi, (b, n), generator=g, device=dev,  # noqa: E731
                                        dtype=torch.int32)
    iota = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n).contiguous()
    return [rand(-(1 << 20), 1 << 20), iota] + [rand(-(1 << 31), (1 << 31) - 1)
                                               for _ in range(nops - 2)]


def ksort_library(ops: list):
    """One PyTorch sort of a packed int64 key (the key's sign kept in the
    high word, the iota below it), then a gather of every operand."""
    import torch
    _, order = torch.sort((ops[0].long() << 32) | ops[1].long(), dim=1)
    return [a.gather(1, order) for a in ops]


def ksort_pass_ms(ops: list, nk: int) -> dict:
    """The time of each kind of pass of ksort's schedule: each row launched
    alone through kz_ksort on a stack of the operands (median of 3, CUDA
    events; not a codec launch, no launch count), summed by kind."""
    import numpy as np
    import torch

    from kanzi_tpu_torch.ops import ksort as K
    from kanzi_tpu_torch.utils import cuda_build

    buf = torch.stack(ops)
    nops, b, n = buf.shape
    lib = cuda_build.load()
    s = torch.cuda.current_stream(buf.device).cuda_stream
    out = {"first span": 0.0, "later spans": 0.0, "cross": 0.0}
    for i, row in enumerate(K.ksort_schedule(n, nops, nk=nk)):
        one = np.asarray([row], np.int32)

        def run():
            err = lib.kz_ksort(buf.data_ptr(), nops, nk, b, n, one.ctypes.data, 1, s)
            check(err == 0, f"ksort pass {row}: kernel launch failed, cudaError {err}")
        kind = "cross" if row[0] == K.CROSS else "first span" if i == 0 else "later spans"
        out[kind] += time_ms(run, reps=3)
    return out


# small shapes that take the launcher's other paths: a span of 2, spans
# below and at the register presort's width, 1 and 3-8 operands
KSORT_EDGE_SHAPES = ((3, 2, 2), (2, 8, 2), (2, 16, 3), (4, 1 << 10, 1), (2, 1 << 12, 6),
                     (2, 1 << 15, 7), (1, 1 << 16, 8), (5, 1 << 13, 4))


def phase2_ksort(dev) -> dict:
    import math

    import torch

    from kanzi_tpu_torch.ops import ksort as K

    rec = {"ksort": {"max_abs_err": 0, "at": {}}}
    for i, (b, n, nops) in enumerate(KSORT_EDGE_SHAPES):
        g = torch.Generator(device=dev).manual_seed(40 + i)
        if nops == 1:
            ops = [torch.argsort(torch.rand((b, n), generator=g, device=dev), dim=1).int()]
        else:
            ops = ksort_operands(dev, b, n, nops, seed=40 + i)
        got = K.ksort_rows(ops, min(nops, 2))
        want = K.ksort_rows_ref(ops, min(nops, 2))
        check(all(x.equal(y) for x, y in zip(got, want)),
              f"ksort differs from its plain version at ({b}, {n}) x {nops}")
    for i, (b, n, nops) in enumerate(KSORT_SHAPES):
        ops = ksort_operands(dev, b, n, nops, seed=20 + i)
        got = K.ksort_rows(ops, 2)
        want = K.ksort_rows_ref(ops, 2)
        check(all(g.equal(w) for g, w in zip(got, want)),
              f"ksort differs from its plain version at ({b}, {n}) x {nops}")
        check(all(g.equal(w) for g, w in zip(got, ksort_library(ops))),
              "ksort differs from the packed-key library sort")
        rec["ksort"]["max_abs_err"] = max(rec["ksort"]["max_abs_err"], max_abs_err(got, want))
        at = {}
        timed({"ksort": at}, "ksort", lambda: K.ksort_rows(ops, 2),
              lambda: K.ksort_rows_ref(ops, 2), ops, b * n,
              library=lambda: ksort_library(ops), ops=2 * b * n * math.log2(n))
        at["passes"] = len(K.ksort_schedule(n, nops, nk=2))
        at["pass_ms"] = ksort_pass_ms(ops, 2)
        rec["ksort"]["at"][f"({b}, {n}) x {nops}"] = at
        if i == 0:
            rec["ksort"].update(at)
    return rec


PHASE2_GROUPS = ("floor", "ans0", "huffman", "lz_words", "ans1", "ksort")
# groups that --phase2 may also name: a part of another group
PHASE2_PARTS = ("ans1_compact",)


def phase2_kernels(dev, data: bytes, groups=PHASE2_GROUPS) -> dict:
    from kanzi_tpu_torch.utils.corpus import mixed_corpus
    rows = mixed_corpus(16 << 20, seed=7).reshape(-1, CHUNK)[::4]      # 256
    run = {"ans0": lambda: phase2_ans0(dev, rows), "huffman": lambda: phase2_huffman(dev, rows),
           "lz_words": lambda: phase2_lz_words(dev, data), "ans1": lambda: phase2_ans1(dev, data),
           "ksort": lambda: phase2_ksort(dev),
           "ans1_compact": lambda: phase2_ans1_compact_alone(dev, data)}
    out = {}
    for g in groups:
        if g != "floor":
            out.update(run[g]())
    return out


def _compress(cls, data: bytes, ctx: dict, **kw) -> bytes:
    out = io.BytesIO()
    with cls(out, ctx, **kw) as cos:
        cos.write(data)
    return out.getvalue()


def _decompress(cls, blob: bytes, jobs: int, **kw) -> bytes:
    with cls(io.BytesIO(blob), {"jobs": jobs}, **kw) as cis:
        return cis.read(-1)


def stream_phase(label: str, data: bytes, transform: str, entropy: str, dev,
                 kern: dict, names: tuple, dec: str | None) -> dict:
    """One cell: the port and the host each compress and decompress ``data``.
    The launch counts are set to 0 just before the port's run and read just
    after it; every kernel of ``names`` must have run.  ``dec`` is the
    family's decode kernel (None: the port decodes on the host).
    ``device_share`` is an estimate, launches x the phase-2 kernel time at
    one main-path launch's shape over the port's wall time, an upper bound
    where blocks hold fewer chunks."""
    import torch

    from kanzi_tpu_torch.io import stream as port
    from kanzi_tpu_torch.ops import launch

    ctx = {"transform": transform, "entropy": entropy, "blockSize": BLOCK, "jobs": 8}
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
    ref = _compress(port.CompressedOutputStream, data, ctx, device=None)
    host_c = time.perf_counter() - t
    check(blob == ref, f"{label}: the port's stream differs from the host stream")
    t = time.perf_counter()
    out = _decompress(port.CompressedInputStream, blob, 8, device=None)
    host_d = time.perf_counter() - t
    check(out == data, f"{label}: the host's decode of the port's stream differs")
    check(all(v > 0 for v in launches.values()), f"{label}: a kernel never ran: {launches}")
    enc_ms = sum(launches[k] * kern[k]["ms"] for k in names if k != dec)
    dec_ms = launches[dec] * kern[dec]["ms"] if dec else 0.0
    return {"bytes_in": len(data), "bytes_out": len(blob),
            "device_share": {"compress": enc_ms / 1e3 / port_c,
                             "decompress": dec_ms / 1e3 / port_d},
            "compress_mb_s": {"port": mb / port_c, "host": mb / host_c},
            "decompress_mb_s": {"port": mb / port_d, "host": mb / host_d},
            "launches": launches}


def phase9_ksort(dev) -> dict:
    """ksort_rows through its own entry point at the two shapes of phase 2,
    on fresh operands; the launch count is set to 0 just before and read
    just after.  Each row must come out ordered by (key, iota), and every
    operand permuted as the iota was."""
    import torch

    from kanzi_tpu_torch.ops import ksort as K
    from kanzi_tpu_torch.ops import launch

    inputs = [ksort_operands(dev, b, n, nops, seed=30 + i)
              for i, (b, n, nops) in enumerate(KSORT_SHAPES)]
    launch.reset_launches()
    t = time.perf_counter()
    outs = [K.ksort_rows(ops, 2) for ops in inputs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"ksort": launch.launches["ksort"]}
    for ops, out in zip(inputs, outs):
        key, perm = out[0], out[1]
        dk = key[:, 1:].long() - key[:, :-1].long()
        check(bool(((dk > 0) | ((dk == 0) & (perm[:, 1:] > perm[:, :-1]))).all()),
              "ksort_rows: rows are not in (key, iota) order")
        check(all(o.equal(a.gather(1, perm.long())) for o, a in zip(out, ops)),
              "ksort_rows: the operands were not permuted alike")
    return {"wall_ms": wall * 1e3, "launches": launches}


def first_frames(blob: bytes, k: int) -> list:
    """The first ``k`` block frames of a stream: (block id, bit count,
    payload bytes); a level-1 payload is the block header and its LZX
    section bytes."""
    from kanzi_tpu_torch.io import stream as port
    with port.CompressedInputStream(io.BytesIO(blob), {}, device=None) as cis:
        frames = [cis._frame_next() for _ in range(k)]
    return [(bid, nbits, payload.tobytes()) for bid, payload, nbits in frames]


def phase7_level1(data: bytes, dev, kern: dict) -> dict:
    """Level 1 (LZX + NONE) with the LZX parse on the card under
    KANZI_TPU_DEVICE_LZ=1, against the host parse (device=None, which
    ignores the variable).  The launch counts are set to 0 just before the
    port's compress and read just after it."""
    import torch

    from kanzi_tpu_torch.io import stream as port
    from kanzi_tpu_torch.ops import launch

    ctx = {"transform": "LZX", "entropy": "NONE", "blockSize": BLOCK, "jobs": 8}
    mb = len(data) / 1e6
    os.environ["KANZI_TPU_DEVICE_LZ"] = "1"
    try:
        launch.reset_launches()
        t = time.perf_counter()
        blob = _compress(port.CompressedOutputStream, data, ctx, device=dev)
        torch.cuda.synchronize()
        port_c = time.perf_counter() - t
        launches = {k: launch.launches[k] for k in LZ_KERNELS}
        t = time.perf_counter()
        head = _compress(port.CompressedOutputStream, data[:2 * BLOCK], ctx, device="cpu")
        cpu_s = time.perf_counter() - t
    finally:
        del os.environ["KANZI_TPU_DEVICE_LZ"]
    check(all(v > 0 for v in launches.values()), f"level 1: lz_words never ran: {launches}")
    check(first_frames(blob, 2) == first_frames(head, 2),
          "level 1: the first two blocks differ from the port's CPU engine")
    t = time.perf_counter()
    out = _decompress(port.CompressedInputStream, blob, 8, device=dev)
    torch.cuda.synchronize()
    port_d = time.perf_counter() - t
    check(out == data, "level 1: the port's decode on the card differs from the input")
    t = time.perf_counter()
    out = _decompress(port.CompressedInputStream, blob, 8, device=None)
    host_d = time.perf_counter() - t
    check(out == data, "level 1: the host coders' decode differs from the input")
    t = time.perf_counter()
    ref = _compress(port.CompressedOutputStream, data, ctx, device=None)
    host_c = time.perf_counter() - t
    check(len(blob) <= 1.05 * len(ref),
          f"level 1: {len(blob)} B is more than 1.05 x the host parse's {len(ref)} B")
    return {"bytes_in": len(data), "bytes_out": len(blob), "host_bytes_out": len(ref),
            "device_share": {"compress": launches["lz_words"] * kern["lz_words"]["ms"]
                             / 1e3 / port_c},
            "compress_mb_s": {"port": mb / port_c, "host": mb / host_c},
            "decompress_mb_s": {"port": mb / port_d, "host": mb / host_d},
            "cpu_engine_s": cpu_s, "launches": launches}


def _family(name: str) -> str:
    """Kernel family of a device event, for the level-1 profile."""
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "copies"
    if "lz_words" in low:
        return "lz_words"
    if "sort" in low:
        return "sorts"
    if "gather" in low or "scatter" in low or "index" in low:
        return "gathers and scatters"
    return "elementwise and reductions"


def profile_level1(data: bytes, dev) -> dict:
    """One level-1 compress of ``data`` with the LZX parse on the card,
    under torch.profiler; then a second run with the engine's stages timed
    on the host clock, each between two synchronizes (which removes their
    overlap, so the stage times are an upper bound of each)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kanzi_tpu_torch.io import stream as port
    from kanzi_tpu_torch.ops import lz_sort as T

    ctx = {"transform": "LZX", "entropy": "NONE", "blockSize": BLOCK, "jobs": 8}
    stages = {"match (lz_words, sorts, probes)": "_match_flat",
              "parse (two 64-step walks, scan, compaction)": "_parse_stage",
              "token fetch to the host": "_fetch_tokens",
              "emission (host C++, 2 threads)": "_emit_block"}
    saved = {f: getattr(T, f) for f in stages.values()}
    os.environ["KANZI_TPU_DEVICE_LZ"] = "1"
    try:
        _compress(port.CompressedOutputStream, data, ctx, device=dev)     # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            _compress(port.CompressedOutputStream, data, ctx, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        fam: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                k = _family(e.name)
                fam[k] = fam.get(k, 0.0) + e.time_range.elapsed_us() / 1e3
        spent = dict.fromkeys(stages, 0.0)

        def timed_stage(label, fn):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn(*a, **kw)
                torch.cuda.synchronize()
                spent[label] += time.perf_counter() - t0
                return res
            return run

        for label, f in stages.items():
            setattr(T, f, timed_stage(label, saved[f]))
        t = time.perf_counter()
        _compress(port.CompressedOutputStream, data, ctx, device=dev)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t
    finally:
        for f, fn in saved.items():
            setattr(T, f, fn)
        del os.environ["KANZI_TPU_DEVICE_LZ"]
    return {"bytes_in": len(data), "wall_ms": wall * 1e3,
            "device_ms": sum(fam.values()), "busy_share": sum(fam.values()) / (wall * 1e3),
            "device_ms_by_family": dict(sorted(fam.items(), key=lambda kv: -kv[1])),
            "staged_wall_ms": wall2 * 1e3,
            "staged_ms": {k: v * 1e3 for k, v in spent.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="stop after phase 2")
    ap.add_argument("--profile", action="store_true",
                    help="profile one level-1 compress after phase 1, then stop")
    ap.add_argument("--phase2", metavar="GROUPS",
                    help="run only these comma-separated phase-2 groups (of "
                         f"{', '.join(PHASE2_GROUPS)}), then stop")
    args = ap.parse_args()
    groups = PHASE2_GROUPS if args.phase2 is None else tuple(args.phase2.split(","))
    if not set(groups) <= set(PHASE2_GROUPS + PHASE2_PARTS):
        ap.error(f"--phase2: groups are {', '.join(PHASE2_GROUPS + PHASE2_PARTS)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kanzi_tpu_torch.utils import cuda_build, native
    from kanzi_tpu_torch.utils.corpus import mixed_corpus

    dev = torch.device("cuda")
    card = card_line()
    print(f"phase 0: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {torch.cuda.device_count()} device(s)")
    if native.get_lib() is None:
        raise RuntimeError("the port's native host library did not load (g++ missing?)")
    print("phase 0: the port's native host library loaded")

    cuda_build.load()
    srcs = sorted(f for f in os.listdir(cuda_build.SRC_DIR) if f.endswith((".cu", ".cuh")))
    print(f"phase 1: kernels built from {', '.join(srcs)} and loaded in "
          f"{cuda_build.build_seconds:.2f} s")
    for line in cuda_build.build_log.splitlines():
        if "Function properties" in line or "registers" in line or "entry function" in line:
            print("phase 1:   " + line.strip())
    for name, n in sass_loads_before_atomics().items():
        print(f"phase 1: {name}: {n} 16-byte global loads before its first shared atomic "
              f"(cuobjdump -sass)")

    t = time.perf_counter()
    data = mixed_corpus(64 << 20, seed=12).tobytes()
    print(f"phase 2: corpus of {len(data)} B made in {time.perf_counter() - t:.1f} s")
    if args.profile:
        print(card_line())
        print(json.dumps({"level1_profile": profile_level1(data[:32 << 20], dev)}))
        return 0
    t = time.perf_counter()
    if "floor" in groups:
        print("phase 2: the floor of the card-alone times, an empty kernel queued as the "
              "kernels are: " + ", ".join(f"{v:.4f} ms at {k} threads"
                                          for k, v in card_floor(dev).items()))
    kern = phase2_kernels(dev, data, groups)
    for name, r in kern.items():
        lib = "" if r["library_ms"] is None else f", library call {r['library_ms']:.4f} ms"
        once = " (one run)" if name == "ans1_scan" else ""
        print(f"phase 2: {name}: bit-equal to its plain version; kernel {r['ms']:.4f} ms "
              f"({r['device_ms']:.4f} on the card alone), plain {r['plain_ms']:.4f} ms{once}"
              f"{lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) at "
              f"{TIMED_AT.get(name, '256 x 16 KiB')}")
    if "ans1_scan" in kern:
        r = kern["ans1_scan"]
        print(f"phase 2: ans1_scan: one chunk {r['ms_1_chunk']:.4f} ms, 32 chunks in one launch "
              f"{r['ms_32_chunks']:.4f} ms; measured {r['cycles_per_step']:.1f} cycles a step at "
              f"the {r['sm_clock_max_mhz']:.0f} MHz maximum SM clock; the chain alone "
              f"(scan_chain, clock64) {r['chain_cycles_per_step']:.1f} cycles a step, a floor of "
              f"{r['steps']} x {r['chain_cycles_per_step']:.1f} cycles = {r['floor_ms']:.4f} ms, "
              f"one chunk at {r['ms_1_chunk'] / r['floor_ms']:.3f} x the floor; reciprocal "
              f"at lr 11 against x / f: {r['recip_mismatches']} mismatches in "
              f"{r['recip_pairs']} pairs ({r['recip_check_s']:.2f} s)")
    for name, cases in (("ans0_encode_scan", "edge_cases"), ("ans0_decode", "corrupt_cases"),
                        ("huffman_decode", "edge_cases")):
        if name in kern:
            r = kern[name]
            print(f"phase 2: {name}: {r['cycles_per_step']:.1f} cycles a step at the "
                  f"{r['sm_clock_max_mhz']:.0f} MHz maximum SM clock "
                  f"({r['cycles_per_step_card']:.1f} on the card alone), "
                  f"{r['cycles_per_step_load_clock']:.1f} at the {r['sm_clock_load_mhz']:.0f} "
                  f"MHz read under its load; bit-equal to its plain version on "
                  f"{', '.join(r[cases])}")
    for name in ("huffman_encode", "ans0_compact", "ans1_compact", "ans0_hist_norm",
                 "huffman_hist"):
        if name in kern:
            print(f"phase 2: {name}: bit-equal to its plain version also on "
                  f"{', '.join(kern[name]['edge_cases'])}")
    for name in ("ans0_hist_norm", "huffman_hist"):
        if name in kern:
            r = kern[name]
            print(f"phase 2: {name} on 256 chunks of one byte: {r['one_byte_ms']:.4f} ms "
                  f"({r['one_byte_device_ms']:.4f} on the card alone), against the corpus's "
                  f"{r['ms']:.4f} ({r['device_ms']:.4f})")
    if "ans0_encode_scan" in kern:
        r = kern["ans0_encode_scan"]
        print(f"phase 2: ans0_encode_scan: the chain alone (scan_chain, clock64) "
              f"{r['chain_cycles_per_step']:.1f} cycles a step, a floor of {r['floor_ms']:.4f} "
              f"ms, the kernel at {r['ms'] / r['floor_ms']:.3f} x the floor; reciprocal at lr 12 "
              f"against x / f: {r['recip']['recip_mismatches']} mismatches in "
              f"{r['recip']['recip_pairs']} pairs ({r['recip']['recip_check_s']:.2f} s)")
    for shape, a in kern.get("ksort", {}).get("at", {}).items():
        print(f"phase 2: ksort at {shape}: kernel {a['ms']:.4f} ms, plain {a['plain_ms']:.4f} "
              f"ms, library call {a['library_ms']:.4f} ms, bound {a['bound_ms']:.4f} ms "
              f"({a['bound_by']}); {a['passes']} passes, alone: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in a["pass_ms"].items()))
    print(f"phase 2: done in {time.perf_counter() - t:.1f} s")
    if args.quick or args.phase2 is not None:
        return 0

    launches = dict.fromkeys(REPLACES, 0)
    for label, transform, entropy, names, dec in (
            ("phase 3: ANS0 alone", "NONE", "ANS0", ANS0_KERNELS, "ans0_decode"),
            ("phase 4: level 5", "TEXT+UTF+BWT+RANK+ZRLT", "ANS0", ANS0_KERNELS, "ans0_decode"),
            ("phase 5: Huffman alone", "NONE", "HUFFMAN", HUFFMAN_KERNELS, "huffman_decode"),
            ("phase 6: level 3", "TEXT+UTF+PACK+MM+LZX", "HUFFMAN", HUFFMAN_KERNELS,
             "huffman_decode")):
        t = time.perf_counter()
        r = stream_phase(label, data, transform, entropy, dev, kern, names, dec)
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
    t = time.perf_counter()
    r = phase7_level1(data, dev, kern)
    launches.update(r["launches"])
    print(f"phase 7: level 1: {r['bytes_in']} B -> {r['bytes_out']} B with the LZX parse on "
          f"the card, host parse {r['host_bytes_out']} B; first two blocks equal the CPU "
          f"engine's ({r['cpu_engine_s']:.1f} s); compress MB/s port "
          f"{r['compress_mb_s']['port']:.2f} host parse {r['compress_mb_s']['host']:.2f}; "
          f"decompress MB/s port {r['decompress_mb_s']['port']:.2f} host "
          f"{r['decompress_mb_s']['host']:.2f}; lz_words share of the port's compress "
          f"(estimate) {r['device_share']['compress']:.4f}; launches {r['launches']}; "
          f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    r = stream_phase("phase 8: ANS1 alone", data, "NONE", "ANS1", dev, kern, ANS1_KERNELS, None)
    launches.update(r["launches"])
    blocks = -(-len(data) // BLOCK)
    check(all(v == blocks for v in r["launches"].values()),
          f"phase 8: not one launch of each order-1 kernel per block: {r['launches']}")
    print(f"phase 8: ANS1 alone: {r['bytes_in']} B -> {r['bytes_out']} B, identical to the host "
          f"stream, decoded by the port (on the host, as in the reference) and the host "
          f"coders; compress MB/s port {r['compress_mb_s']['port']:.2f} host "
          f"{r['compress_mb_s']['host']:.2f}; decompress MB/s port "
          f"{r['decompress_mb_s']['port']:.2f} host {r['decompress_mb_s']['host']:.2f}; "
          f"kernel share of the port's compress (estimate) "
          f"{r['device_share']['compress']:.4f}; launches {r['launches']}; "
          f"{time.perf_counter() - t:.1f} s")
    r = phase9_ksort(dev)
    launches.update(r["launches"])
    print(f"phase 9: ksort_rows at {', '.join(f'({b}, {n}) x {k}' for b, n, k in KSORT_SHAPES)}: "
          f"rows ordered, operands permuted alike; {r['wall_ms']:.2f} ms; launches "
          f"{r['launches']}")
    check(all(v > 0 for v in launches.values()), f"launches {launches}")

    kernels = []
    for name, (src, rep, also) in REPLACES.items():
        k = {"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[name],
             **{key: kern[name][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                  "bound_by", "library_ms")},
             "timed_at": TIMED_AT.get(name, "256 x 16 KiB")}
        for key in ("device_ms", "ms_1_chunk", "ms_32_chunks", "cycles_per_step",
                    "cycles_per_step_card", "chain_cycles_per_step",
                    "floor_ms", "recip_pairs", "recip_mismatches", "recip", "sm_clock_load_mhz",
                    "one_byte_ms", "one_byte_device_ms",
                    "cycles_per_step_load_clock", "corrupt_cases",
                    "edge_cases", "passes", "pass_ms", "at"):
            if key in kern[name]:
                k[key] = kern[name][key]
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
