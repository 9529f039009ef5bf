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
     timed once, ~100 s, in a thread while phase 1 builds the kernels and
     the card is idle, joined before phase 2 times anything), ans1_compact
     on its words and on tiles cut from
     them at nb 1, 2, 64 and 128, M 1 and 256, with every word flagged and
     none, then ans1_scan timed for one chunk and for 32 in one launch,
     beside the floor of its chain alone (csrc/ans1.cu scan_chain_kernel, SM
     cycles by clock64); the scan's reciprocal against exact division for
     every f < 2048 and every state x < 2^31 (csrc/ans1.cu
     recip_check_kernel, 0 mismatches or the run fails); ksort at (8, 2^22) x 2 and
     (512, 2^16) x 5 operands, 2 keys, the last an iota, with its schedule's
     pass count, its time on the card alone at each shape and each kind of
     pass timed alone (and, untimed, at eight small shapes of 1-8 operands
     that take the launcher's other paths);
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
 10  the device suffix array (ops/bwt_device.py: sorts, cumsum and
     scatter, no kernel of its own, so no row of the kernels line) against
     the port's native SA-IS on the six input classes of
     tests/test_bwt_tpu.py, the corpus's first 4 MiB block and 4 MiB of
     zeros (the worst case, log2 n rounds); for the two 4 MiB inputs its
     rounds, its card ms (CUDA events, warm) for the whole call and for the
     doubling alone, a sort's ms, one reading of the card's room (the
     admission's mem_get_info), and the host's SA-IS, BWT assembly and
     native BWT forward ms; eight 4 MiB blocks one after another and in
     eight threads at once (as jobs 8 calls it), twice, with the peak
     allocation
 11  the CLI at level 5, ``python -m kanzi_tpu_torch.app -c -l 5 -j 8``
     (run by runpy in a subprocess, which then prints its launch counts), on
     the same 64 MiB written to a temporary file: ``--device none``,
     ``--device cuda``, and ``--device cuda`` under KANZI_TPU_DEVICE_BWT=1
     write identical .knz files; ``-d --device cuda`` and ``-d --device
     none`` give back the input; ``-y`` prints the header; each run's MB/s
     by the CLI's own clock (a card run's start-up timed apart, before it)
     and each process's wall time;
     the gated run takes one device SA and one launch of each ANS0 encode
     kernel a block, the ungated card run no device SA, the host run
     nothing on the card
 12  the multi-GPU engine (kanzi_tpu_torch/parallel/engine.py) on the same
     64 MiB: a world of one rank over NCCL (NCCL_SOCKET_IFNAME=lo, no
     network), where mesh_ans0_compress of the first 4 MiB block equals the
     host encoder in a fresh writer and decodes back by
     mesh_ans0_decompress (a flipped payload byte raises); mesh_l5_compress
     (4 MiB blocks, jobs 8) decodes through the host reader and
     mesh_decompress, is at most the host stream + 4 bytes a block, its
     first two blocks equal a gloo world of one rank on the CPU (the plain
     versions), and takes one device SA and one launch of each ANS0 encode
     kernel a block, one ans0_decode a block on the mesh decode;
     mesh_l1_compress decodes on the host, is at most 1.05 x the host
     parse, its first two blocks equal the CPU world's, and launches
     lz_words; then two spawned ranks share the card over gloo (the
     collectives staged through the host) and write the NCCL world's
     level-5 stream.  Prints the MB/s beside phases 4 and 7, level 5's
     passes A-C, and each gather's ms a call (the lengths and the payloads
     apart, a host clock around a synchronize), with the card's name and
     power limit
 13  the v1 device LZX engine (ops/lz_tpu.py: tensor code, no kernel of its
     own, so no row of the kernels line; counted as lz_v1) under
     KANZI_TPU_DEVICE_LZ=legacy: on each 4 MiB block of the same 64 MiB,
     its sections on the card equal the port's device="cpu" run for the
     first block and every section decodes through the host inverse;
     one block's card ms by stage (hash ladder, extension, parse, token
     fetch; CUDA events, warm, median of 3), its host emission and the
     peak allocation; level 3 at jobs 8 (the engine a block), decoded on
     the card and by the host coders, its first block equal to a CPU
     run, its MB/s and bytes beside phase 6's; level 1, which keeps the
     writer's v3 batch and writes phase 7's bytes; and real_corpus(64
     MiB), its sha256 and sections, through level 3 under legacy against
     the host coders, round-tripped
 14  the device LZ paths beside phase 7, on the same 64 MiB under
     KANZI_TPU_DEVICE_LZ=1, each stream decoded on the card and by the host
     coders, beside the host parse: level 1 at 32 MiB blocks (the windowed
     256 KiB-row engine: its first group of 24 rows on the card equal to
     the CPU's, lz_words at (24, 262144) against its plain version and
     timed, one lz_words a group, 15 groups) and at 16 MiB (MAX_FLAT: one
     flat dispatch of (4, 2^24), its first block equal to a CPU run);
     levels 2 (DNA+LZ) and 3 at 4 MiB blocks, jobs 8 (the codec's dispatch,
     one call a block from the pool's threads: one lz_words a block that
     reached the engine, the first two blocks equal to a CPU run, the
     stream equal to the card's at jobs 1); level 1 at 4 MiB blocks
     beside them (phase 7's path and bytes, the comparator timed in this
     phase); MB/s, bytes and peak allocation of each, and for the level-1
     streams three compresses, each with the allocator's bytes, cudaMalloc
     calls and retries, and the host seconds of each dispatch and flat
     analysis
 15  the configuration space the CLI accepts, each stream written at cuda
     and at None (byte for byte equal, decoded both ways) with its launch
     counts equal to what the device gates give, none where they say host:
     a. tests/golden/l0..l9.knz rewritten at cuda from the CPU test's data
     (mixed_corpus(256 KiB, seed=1234)), levels 2, 3 and 5 launching their
     entropy kernels once, the others none; b. levels 1-5 through
     app/benchmark.py run_config on mixed_corpus(8 MiB + 12,345 B) at jobs
     8 (level 1 under KANZI_TPU_DEVICE_LZ=1, at most 1.05 x the host
     parse's bytes; level 5 also under KANZI_TPU_DEVICE_BWT=1 and at -x 64,
     jobs 16); c. transform NONE with ANS0, HUFFMAN and ANS1 at blocks of 64
     KiB - 16, 64 KiB, 1 MiB and 4 MiB + 16 KiB (ANS1 also 6 and 8 MiB),
     two full blocks and a short one of mixed_corpus, uniform random bytes,
     one repeated byte and two symbols at 999:1; d. ``python -m
     kanzi_tpu_torch.app.benchmark <file> --sweep --device cuda`` on
     mixed_corpus(1 MiB + 12,345 B) (a subprocess started first, beside
     parts a-c and e; exit 0, 152 configurations, none failed),
     run_sweep over 4 MiB + 12,345 B with NONE, HUFFMAN, ANS0 and ANS1 at
     cuda and at None (each configuration's stream equal), and main(file,
     levels 0-9, --device cuda) against run_levels at None; e. one
     multihost worker (parallel/multihost.py) through dryrun_multihost(1,
     "cuda"), NCCL on the loopback: OK p0, its own launch counts
 16  the sizes kanzi's users run, on S = mixed_corpus(211,957,760, seed=12)
     (silesia.tar's size) and G = S tiled to 1 GiB + 12,345 B; each stream
     written at cuda and at None, decoded both ways, its launch counts
     equal to what the gates give, its MB/s, seconds and peak bytes on the
     card (allocated and reserved, reset per stream):
     a. level 5 (ANS0) and level 3 (Huffman) on S at 4 MiB blocks, jobs 8
     (51 blocks, the last of 2,242,560 B), equal to the host's stream;
     b. ``python -m kanzi_tpu_torch.app -c -l 5 -b auto -j 8`` on S in a
     file under KANZI_TPU_DEVICE_BWT=1, at --device cuda and none (the
     two files equal; eight blocks of 26,494,720 B, a device SA and the
     ANS0 encode kernels a block at cuda, nothing at none), then ``-d`` at
     cuda (equal to S, ans0_decode a block), these three processes run
     beside the other parts; in process, level 1 under
     KANZI_TPU_DEVICE_LZ=1 at the same block size (the windowed engine);
     c. transform NONE with ANS0 and HUFFMAN at 256 MiB blocks on S (one
     block of 12,936 full chunks and a 14,336 B tail) and ANS1 at 64 MiB
     on S's first 64 MiB + 12,345 B (16 order-1 chunks in one launch),
     equal to the host's stream; d. level 1 under KANZI_TPU_DEVICE_LZ=1 at
     1 GiB blocks, jobs 2, on G (one 1 GiB block through the windowed
     engine, then 12,345 B); level 1 (b and d) has no byte gate against
     the host parse: its first windowed group equals a CPU run of it, it
     decodes both ways, and prints its ratio to the host parse;
     e. the device suffix array (ops/bwt_device.py) alone at n = 2^30
     (kanzi's BWT limit) and 2^30 - 16 of G, at S and at S's first 64, 32
     and 4 MiB (the last two seeded with eight bytes and sorted by
     torch.sort):
     each admitted by the card's byte budget on an emptied cache, its
     reserved peak within what it is admitted by (sa_bytes), checked on
     the card by the linear check (check_suffix_array), those of 64 MiB
     also against SA-IS, with its rounds, card ms, peak bytes and bytes a
     position; then L = S tiled to 1.875 GiB: seven 256 MiB calls (L's
     first 1.75 GiB) from seven threads through suffix_array_device and
     the budget, each checked, and the BWT alone at -b 1g, jobs 2, on L
     under KANZI_TPU_DEVICE_BWT=1 (two SAs of 2^30 and 0.875 x 2^30
     positions at once from the writer's pool, admitted one at a time;
     decoded at None, equal to L, its first block 2^30 + 33 B after the
     BWT)
 17  level 1 (LZX + NONE) under KANZI_TPU_DEVICE_LZ=1 on the archive of the
     benchmark's l1_devlz_archive cell (portbench/lib/corpus.py
     mixed_corpus(211,957,760, seed=12), its extents in their base order),
     through BlockCompressor at 4 MiB blocks, jobs 8 (51 blocks, parsed in
     seven batches): at most 1.05 x
     the host parse's bytes, all 51 blocks decoded by portbench/reference,
     the stream by the port's reader at cuda and None, lz_words and
     lz_dispatch one a batch, lz_emit_native one a block emitted (the C++
     emitter, the only one); then the same compress with a listener, the
     device LZ parse's spans (LZ_BATCH, LZ_CARD, LZ_FETCH, LZ_EMIT) in ms per MB
     beside the wall and the stream's self time outside LZ_BATCH
The launch counts are set to 0 just before each of phases 3-9, each step
of phase 12 and each stream of phases 13-17 and read just after it;
the counts of phases 12-17 join the kernels line's.  Then the card line,
one JSON line of the kernels (each with its bound: the larger of its bytes
over 3.35 TB/s and its integer operations over 67 T/s), and the result
line.
``--mesh`` runs phases 0-1 and 12 only and prints no result line;
``--phase14`` and ``--phase15`` run phases 0-1 and 14, or 15, the same way;
``--phase16`` phases 0-1 and 16 (``--phase16 e`` only the parts named, of
abcde); ``--phase17`` phases 0-1 and 17; ``--phase10`` phases 0 and 10
(no kernel is built).
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
import contextlib
import functools
import hashlib
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
# the ANS0 decode's compiled header parse (ops/ans_block.py parse_ans0_wire):
# one count a block that the decode gate sends to the card; the encode's
# compiled record writer (encode_ans0_wire): one count a block with a full
# chunk that the encode gate sends there
ANS0_GLUE = ("ans0_wire_native", "ans0_wire_write_native")
HUFFMAN_KERNELS = ("huffman_hist", "huffman_encode", "huffman_decode")
LZ_KERNELS = ("lz_words",)
# the device LZX parse's counters (ops/lz_sort.py): a dispatch, and a block
# the C++ emitter turned into the wire
LZ_GLUE = ("lz_dispatch", "lz_emit_native")
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


def start_plain_ans1(dev, data: bytes) -> dict:
    """The inputs of phase2_ans1, 4 x 4 MiB chunks of the corpus and two
    edge chunks (one repeated byte: every context holds one symbol, freq
    2048 capped to 2047; uniform random), on the card, and their plain
    order-1 scan, scan_chunks_ref(lookup1_ref(...)) at full length (the
    main path's 2^20 steps of the 24 real lanes), started in a thread.  The
    plain version takes ~8 tensor ops a step, ~100 s on the card, none a
    kernel of the port, so it runs, timed once by CUDA events, while the
    kernels build and the card is idle; main joins it before phase 2 times
    anything."""
    import threading

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
    res = {"x": x, "packed": packed}

    def run():
        try:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = A1.scan_chunks_ref(A1.lookup1_ref(x, packed))
            b.record()
            b.synchronize()
            res.update(out=out, ms=a.elapsed_time(b))
        except Exception as e:          # re-raised by join_plain_ans1
            res["error"] = e

    res["thread"] = threading.Thread(target=run, daemon=True)
    res["thread"].start()
    return res


def join_plain_ans1(plain: dict) -> dict:
    plain["thread"].join()
    if "error" in plain:
        raise plain["error"]
    return plain


def phase2_ans1(dev, plain: dict) -> dict:
    """The fused ans1_scan (lookup and scan) and compact against their plain
    versions on start_plain_ans1's chunks, the scan against its plain run
    there.  Then the reciprocal's exhaustive check and the chain's floor,
    from scan_chain."""
    import torch

    from kanzi_tpu_torch.ops import ans1_cuda as A1

    x, packed = plain["x"], plain["packed"]
    n, q = x.shape[0], BLOCK // 4
    rec = {}

    lk_r = A1.lookup1_ref(x, packed)
    check(bool((lk_r[4] & 2047 == 2047).all()), "the repeated byte's 2048 is not capped")
    sc = A1.scan_chunks(x, packed)
    sc_r = join_plain_ans1(plain).pop("out")
    check(all(torch.equal(u, v) for u, v in zip(sc, sc_r)),
          "ans1_scan differs from its plain version")
    rec["ans1_scan"] = {"max_abs_err": max_abs_err(sc, sc_r), "plain_ms": plain["ms"],
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


def phase2_kernels(dev, data: bytes, groups=PHASE2_GROUPS, plain: dict | None = None) -> dict:
    from kanzi_tpu_torch.utils.corpus import mixed_corpus
    rows = mixed_corpus(16 << 20, seed=7).reshape(-1, CHUNK)[::4]      # 256
    run = {"ans0": lambda: phase2_ans0(dev, rows), "huffman": lambda: phase2_huffman(dev, rows),
           "lz_words": lambda: phase2_lz_words(dev, data), "ans1": lambda: phase2_ans1(dev, plain),
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
            "sha256": hashlib.sha256(blob).hexdigest(),
            "device_share": {"compress": launches["lz_words"] * kern["lz_words"]["ms"]
                             / 1e3 / port_c},
            "compress_mb_s": {"port": mb / port_c, "host": mb / host_c},
            "decompress_mb_s": {"port": mb / port_d, "host": mb / host_d},
            "cpu_engine_s": cpu_s, "launches": launches}


def sa_inputs(data: bytes) -> dict:
    """Phase 10's inputs: the six classes of tests/test_bwt_tpu.py, the
    corpus's first 4 MiB block and 4 MiB of zeros (log2 n rounds)."""
    import numpy as np

    from kanzi_tpu_torch.utils.corpus import dna_like, text_like
    rng = np.random.default_rng(3)
    return {"text": text_like(80_000), "zeros": np.zeros(4096, np.uint8),
            "dna": dna_like(50_000),
            "random": rng.integers(0, 256, 65537).astype(np.uint8),
            "periodic": np.tile(np.frombuffer(b"abcab", np.uint8), 10_000),
            "tiny": np.frombuffer(b"banana", np.uint8),
            "corpus 4 MiB": np.frombuffer(data[:BLOCK], np.uint8),
            "zeros 4 MiB": np.zeros(BLOCK, np.uint8)}


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of ``fn`` over ``reps`` runs, after one warm run."""
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def phase10_sa(data: bytes, dev) -> dict:
    """The device suffix array (ops/bwt_device.py, sorts + cumsum +
    scatter, no kernel of its own) against the port's native SA-IS on every
    input of sa_inputs; for the two 4 MiB inputs its rounds, its card time
    (CUDA events, warm, median of 3) around the whole call and around the
    doubling alone on a buffer already on the card, the host ms of one
    reading of the card's room (the budget's admission), SA-IS's host time, the
    host's assembly of the BWT from an SA (what the gated BWT adds to the
    device SA) and the native BWT forward (SA-IS and assembly, what the gate
    replaces).  Then eight 4 MiB blocks of the corpus, as the writer's eight
    pool threads hand them over at jobs 8: one after another, then twice in
    eight threads at once, each result against SA-IS."""
    import concurrent.futures as cf

    import numpy as np
    import torch

    from kanzi_tpu_torch.ops import bwt_device as B
    from kanzi_tpu_torch.transforms.bwt import BWT
    from kanzi_tpu_torch.utils.native_transforms import bwt_forward_native, suffix_array_native

    inputs = sa_inputs(data)
    res = {"inputs": list(inputs)}
    for name, x in inputs.items():
        sa = suffix_array_native(x)
        check(np.array_equal(B.suffix_array_device(x, device=dev), sa),
              f"phase 10: the device SA of {name} differs from SA-IS")
        sa = sa.astype(np.int64)
        if x.size < BLOCK:
            continue
        text = torch.from_numpy(x.copy()).to(dev)
        _, rounds = B.prefix_doubling(text, x.size)
        doubling = time_ms(lambda: B.prefix_doubling(text, x.size), reps=3)
        res[name] = {"n": int(x.size), "rounds": rounds,
                     "card_ms": time_ms(lambda: B.suffix_array_device(x, device=dev), reps=3),
                     "doubling_ms": doubling, "ms_per_sort": doubling / (rounds + 1),
                     "sais_ms": host_ms(lambda: suffix_array_native(x)),
                     "room_ms": host_ms(B.device_budget(dev).room),
                     "assemble_ms": host_ms(lambda: BWT()._assemble_forward(x, sa, 8)),
                     "native_bwt_ms": host_ms(lambda: bwt_forward_native(x, 8))}
    blocks = [np.frombuffer(data[i * BLOCK:(i + 1) * BLOCK], np.uint8) for i in range(8)]
    want = [suffix_array_native(b) for b in blocks]
    t = time.perf_counter()
    serial = [B.suffix_array_device(b, device=dev) for b in blocks]
    serial_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    with cf.ThreadPoolExecutor(8) as pool:
        threads_ms = []
        for _ in range(2):      # the first pass grows the caching allocator
            t = time.perf_counter()
            threaded = list(pool.map(lambda b: B.suffix_array_device(b, device=dev), blocks))
            threads_ms.append((time.perf_counter() - t) * 1e3)
            check(all(np.array_equal(a, w) for a, w in zip(threaded, want)),
                  "phase 10: a device SA of the eight blocks in threads differs from SA-IS")
        peak = torch.cuda.max_memory_allocated()
        t = time.perf_counter()
        list(pool.map(suffix_array_native, blocks))
        sais_threaded_s = time.perf_counter() - t
    check(all(np.array_equal(a, w) for a, w in zip(serial, want)),
          "phase 10: a device SA of the eight blocks differs from SA-IS")
    res["eight_blocks"] = {"serial_ms": serial_s * 1e3, "threads_ms": threads_ms,
                           "threads_peak_bytes": peak, "sais_threads_ms": sais_threaded_s * 1e3}
    return res


def print_phase10(r: dict, t: float) -> None:
    print(f"phase 10: the device suffix array equals SA-IS on {', '.join(r['inputs'])}")
    for name in ("corpus 4 MiB", "zeros 4 MiB"):
        a = r[name]
        print(f"phase 10: {name} (n {a['n']}): {a['rounds']} rounds after the seed; "
              f"card {a['card_ms']:.4f} ms the whole call, {a['doubling_ms']:.4f} ms the "
              f"doubling on the card, {a['ms_per_sort']:.4f} ms a sort (seed and rounds), "
              f"{a['room_ms']:.4f} ms a reading of the card's room (host); "
              f"host SA-IS {a['sais_ms']:.4f} ms; the BWT from an SA on the host "
              f"(_assemble_forward) {a['assemble_ms']:.4f} ms; the native BWT forward "
              f"(SA-IS and assembly in C++, one thread) {a['native_bwt_ms']:.4f} ms")
    a = r["eight_blocks"]
    print(f"phase 10: eight 4 MiB blocks of the corpus: one after another "
          f"{a['serial_ms']:.4f} ms, in eight threads "
          f"{', then '.join(f'{v:.4f}' for v in a['threads_ms'])} ms (peak "
          f"{a['threads_peak_bytes']} B allocated on the card); host SA-IS in eight threads "
          f"{a['sais_threads_ms']:.4f} ms; {time.perf_counter() - t:.1f} s")


# phases 11 and 15 run a module as ``python -m <module>`` does (runpy), then
# print the run's launch counts and device-SA calls on a line of their own;
# with "warm" first, it starts the card and loads the kernels' library before
# the module runs, and times that start-up
_CLI_RUN = """
import json, runpy, sys, time
warm, module, sys.argv = sys.argv[1] == "warm", sys.argv[2], [sys.argv[2]] + sys.argv[3:]
startup_ms = None
if warm:
    import torch
    from kanzi_tpu_torch.utils import cuda_build
    t = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    cuda_build.load()
    startup_ms = (time.perf_counter() - t) * 1e3
code = 0
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code or 0
from kanzi_tpu_torch.ops import launch
print("COUNTS " + json.dumps({"launches": launch.launches, "startup_ms": startup_ms}))
sys.exit(code)
"""


def start_cli(flags: list, device_bwt: str = "0",
              module: str = "kanzi_tpu_torch.app") -> dict:
    """Start one process of ``python -m module`` from the repo root, warm
    when it runs on the card, its output to temporary files; finish_cli
    waits for it."""
    import tempfile
    env = dict(os.environ, KANZI_TPU_DEVICE_BWT=device_bwt)
    warm = "warm" if flags[-2:] == ["--device", "cuda"] else "cold"
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", _CLI_RUN, warm, module, *flags],
                            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                            stdout=out, stderr=err, text=True)
    return {"proc": proc, "out": out, "err": err, "t0": time.perf_counter(),
            "what": f"python -m {module} {flags}"}


def stop_cli(run: dict) -> None:
    """Kill a process of start_cli that still runs."""
    if run["proc"].poll() is None:
        run["proc"].kill()
        run["proc"].wait()


def finish_cli(run: dict, timeout: float = 600) -> tuple[str, dict]:
    """Wait for a process of start_cli, at most ``timeout`` seconds from its
    start (then kill it); returns its output and counts, with the process's
    wall ms."""
    try:
        run["proc"].wait(timeout=max(timeout - (time.perf_counter() - run["t0"]), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        stop_cli(run)
    wall_ms = (time.perf_counter() - run["t0"]) * 1e3
    run["out"].seek(0)
    run["err"].seek(0)
    stdout, stderr = run["out"].read(), run["err"].read()
    check(run["proc"].returncode == 0, f"{run['what']} failed: {stderr[-2000:]}")
    lines = stdout.splitlines()
    return "\n".join(lines[:-1]), dict(json.loads(lines[-1][len("COUNTS "):]),
                                       wall_ms=wall_ms)


def run_cli(flags: list, device_bwt: str = "0") -> tuple[str, dict]:
    """One CLI process (phase 11): start_cli, then finish_cli."""
    return finish_cli(start_cli(flags, device_bwt))


def cli_ms(out: str) -> float:
    """The ms that the CLI's -v 1 line reports for its one file."""
    import re
    m = re.search(r" in (\d+) ms \[", out)
    check(m is not None, f"phase 11: no time in the CLI's output: {out!r}")
    return float(m.group(1))


def phase11_cli(data: bytes) -> dict:
    """``python -m kanzi_tpu_torch.app -c -l 5 -j 8`` on ``data`` in a file,
    three ways (--device none; cuda; cuda with KANZI_TPU_DEVICE_BWT=1): the
    three .knz files are byte-identical, ``-d`` on the card and on the host
    gives back the input, ``-y`` prints the header.  The rates are the CLI's
    own times for its file; a run on the card starts the card and loads the
    kernels before the CLI's clock starts, and that start-up is timed apart.
    Each process's counts are its own: the gated run must take one device SA
    and one launch of each ANS0 encode kernel a block, the run on the card
    without the gate no device SA."""
    import shutil
    import tempfile

    blocks = -(-len(data) // BLOCK)
    mb = len(data) / 1e6
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        src = os.path.join(tmp, "corpus.bin")
        with open(src, "wb") as fh:
            fh.write(data)
        runs, blobs = {}, {}
        for name, device, gate in (("none", "none", "0"), ("cuda", "cuda", "0"),
                                   ("cuda_device_bwt", "cuda", "1")):
            dst = os.path.join(tmp, name + ".knz")
            out, counts = run_cli(["-c", "-l", "5", "-j", "8", "-f", "-i", src, "-o", dst,
                                   "--device", device], gate)
            with open(dst, "rb") as fh:
                blobs[name] = fh.read()
            runs[name] = {"compress_mb_s": mb / (cli_ms(out) / 1e3),
                          "compress_startup_ms": counts["startup_ms"],
                          "compress_wall_ms": counts["wall_ms"],
                          "sa_calls": counts["launches"].get("suffix_array", 0),
                          "launches": {k: counts["launches"].get(k, 0) for k in ANS0_KERNELS}}
        check(blobs["none"] == blobs["cuda"] == blobs["cuda_device_bwt"],
              "phase 11: the three level-5 .knz files differ")
        for name, device in (("cuda_device_bwt", "cuda"), ("none", "none")):
            dst = os.path.join(tmp, name + ".out")
            out, counts = run_cli(["-d", "-j", "8", "-f", "-i",
                                   os.path.join(tmp, "cuda_device_bwt.knz"), "-o", dst,
                                   "--device", device])
            with open(dst, "rb") as fh:
                check(fh.read() == data, f"phase 11: -d --device {device} differs from the input")
            runs[name]["decompress_mb_s"] = mb / (cli_ms(out) / 1e3)
            runs[name]["decompress_startup_ms"] = counts["startup_ms"]
            runs[name]["decompress_wall_ms"] = counts["wall_ms"]
            runs[name]["decode_launches"] = counts["launches"].get("ans0_decode", 0)
        info, _ = run_cli(["-y", "-i", os.path.join(tmp, "cuda_device_bwt.knz")])
        for want in ("Entropy codec: ANS0", "Transforms: TEXT+UTF+BWT+RANK+ZRLT",
                     f"Original size: {len(data)} bytes"):
            check(want in info, f"phase 11: -y does not print {want!r}: {info!r}")
    finally:
        shutil.rmtree(tmp)
    enc = ANS0_KERNELS[:3]
    gated, card, host = runs["cuda_device_bwt"], runs["cuda"], runs["none"]
    check(gated["sa_calls"] == blocks and all(gated["launches"][k] == blocks for k in enc),
          f"phase 11: the gated run is not one device SA and one launch of each ANS0 encode "
          f"kernel a block: {gated}")
    check(card["sa_calls"] == 0 and all(card["launches"][k] == blocks for k in enc),
          f"phase 11: the run on the card without the gate: {card}")
    check(host["sa_calls"] == 0 and not any(host["launches"].values()),
          f"phase 11: the host run reached the device: {host}")
    check(gated["decode_launches"] == blocks and host["decode_launches"] == 0,
          f"phase 11: ans0_decode launches {gated['decode_launches']}, host "
          f"{host['decode_launches']}")
    return {"bytes_in": len(data), "bytes_out": len(blobs["none"]), "blocks": blocks,
            "runs": runs}


MESH_L5_RANK_TIMEOUT = 300


def mesh_l5_rank(mesh, size: int, seed: int, jobs: int) -> dict:
    """One rank of phase 12's step 4 (run by kanzi_tpu_torch.parallel.dryrun
    in its own process): level 5 of mixed_corpus(size, seed) over the mesh,
    timed on the rank's host clock around a synchronize; rank 0's stream,
    and each rank's launch counts."""
    import torch

    from kanzi_tpu_torch.ops import launch
    from kanzi_tpu_torch.parallel import engine as E
    from kanzi_tpu_torch.utils.corpus import mixed_corpus

    data = mixed_corpus(size, seed=seed) if mesh.rank == 0 else None
    launch.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    wire = E.mesh_l5_compress(mesh, data, block_size=BLOCK, jobs=jobs)
    torch.cuda.synchronize()
    return {"wire": wire, "seconds": time.perf_counter() - t, "device": str(mesh.device),
            "backend": mesh.backend, "launches": dict(launch.launches),
            "stats": mesh.stats}


def gathers(stats: dict) -> dict:
    """ms a call and bytes a call of each gather in a mesh's stats."""
    return {k: {"calls": v[1], "ms_per_call": v[0] / v[1] * 1e3,
                "bytes_per_call": v[2] / v[1]}
            for k, v in stats.items() if k.endswith(("lengths", "payloads"))}


def phase12_mesh(data: bytes) -> dict:
    """The multi-GPU engine (kanzi_tpu_torch/parallel/engine.py) on the card:
    a world of one rank over NCCL, a world of one rank over gloo on the CPU
    (the plain versions) to hold the first two blocks against, and two
    spawned ranks sharing the card over gloo.  The launch counts are set to
    0 just before each step's main-path run and read just after it."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from kanzi_tpu_torch.core.bits import BitWriter
    from kanzi_tpu_torch.core.errors import BitStreamError
    from kanzi_tpu_torch.entropy.ans import ANSRangeEncoder
    from kanzi_tpu_torch.io import stream as port
    from kanzi_tpu_torch.ops import launch
    from kanzi_tpu_torch.parallel import dryrun
    from kanzi_tpu_torch.parallel import engine as E

    # no network on the card's machine: the bootstrap rides the loopback
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    t = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{dryrun.free_port()}",
                            world_size=1, rank=0)
    mesh = E.make_mesh(1, device="cuda")
    cpu_mesh = E.make_mesh(1, device="cpu", group=dist.new_group([0], backend="gloo"))
    out: dict = {"init_s": time.perf_counter() - t, "mesh": repr(mesh)}
    mb = len(data) / 1e6
    blocks = -(-len(data) // BLOCK)
    arr = np.frombuffer(data, dtype=np.uint8)
    counts: dict = {}

    def run(name, fn):
        launch.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        counts[name] = {k: v for k, v in launch.launches.items() if v}
        return res, time.perf_counter() - t0

    try:
        # step 1: the ANS0 stage on the first block
        block = arr[:BLOCK]
        wire, _ = run("ans0_compress", lambda: E.mesh_ans0_compress(mesh, block))
        bw = BitWriter()
        ANSRangeEncoder(bw, 0).encode(block)
        check(wire == bw.getvalue(),
              "phase 12: mesh_ans0_compress differs from the host encoder in a fresh writer")
        got, _ = run("ans0_decompress", lambda: E.mesh_ans0_decompress(mesh, wire, BLOCK))
        check(np.array_equal(got, block), "phase 12: mesh_ans0_decompress differs from the block")
        bad = bytearray(wire)
        bad[len(bad) // 2] ^= 0xFF
        try:
            E.mesh_ans0_decompress(mesh, bytes(bad), BLOCK)
            raised = None
        except BitStreamError as e:
            raised = type(e).__name__
        check(raised == "BitStreamError", "phase 12: a flipped payload byte did not raise")
        out["ans0"] = {"bytes_in": BLOCK, "bytes_out": len(wire)}

        # step 2: level 5 over the mesh
        mesh.stats.clear()
        w5, c5 = run("l5", lambda: E.mesh_l5_compress(mesh, arr, block_size=BLOCK, jobs=8))
        out["l5_passes_s"] = {k[-1]: v[0] for k, v in mesh.stats.items() if k.startswith("l5")}
        out["l5_gathers"] = gathers(mesh.stats)
        lc = counts["l5"]
        check(all(lc.get(k, 0) == blocks for k in
                  ("ans0_hist_norm", "ans0_encode_scan", "ans0_compact", "suffix_array")),
              f"phase 12: level 5 is not one SA and one launch of each ANS0 encode kernel "
              f"a block: {lc}")
        t0 = time.perf_counter()
        got = _decompress(port.CompressedInputStream, w5, 8, device=None)
        host_d = time.perf_counter() - t0
        check(got == data, "phase 12: the host reader's decode of the level-5 mesh stream differs")
        mesh.stats.clear()
        got, d5 = run("l5_decompress", lambda: E.mesh_decompress(mesh, w5, jobs=8))
        check(got == data, "phase 12: mesh_decompress differs from the input")
        check(counts["l5_decompress"].get("ans0_decode", 0) == blocks,
              f"phase 12: the mesh decode is not one ans0_decode a block: "
              f"{counts['l5_decompress']}")
        out["l5_decode_gathers"] = gathers(mesh.stats)
        ref = _compress(port.CompressedOutputStream, data,
                        {"transform": "TEXT+UTF+BWT+RANK+ZRLT", "entropy": "ANS0",
                         "blockSize": BLOCK, "jobs": 8}, device=None)
        check(len(w5) <= len(ref) + 4 * blocks,
              f"phase 12: level 5 {len(w5)} B is more than the host stream's {len(ref)} B "
              f"+ 4 a block")
        t0 = time.perf_counter()
        head = E.mesh_l5_compress(cpu_mesh, arr[:2 * BLOCK], block_size=BLOCK, jobs=8)
        cpu5_s = time.perf_counter() - t0
        check(first_frames(w5, 2) == first_frames(head, 2),
              "phase 12: level 5's first two blocks differ from the CPU world's")
        out["l5"] = {"bytes_out": len(w5), "host_bytes_out": len(ref),
                     "compress_mb_s": mb / c5, "mesh_decompress_mb_s": mb / d5,
                     "host_decompress_mb_s": mb / host_d, "cpu_world_s": cpu5_s}

        # step 3: level 1 over the mesh
        mesh.stats.clear()
        w1, c1 = run("l1", lambda: E.mesh_l1_compress(mesh, arr, block_size=BLOCK, jobs=8))
        check(counts["l1"].get("lz_words", 0) > 0, f"phase 12: lz_words never ran: {counts['l1']}")
        out["l1_gathers"] = gathers(mesh.stats)
        t0 = time.perf_counter()
        got = _decompress(port.CompressedInputStream, w1, 8, device=None)
        host1_d = time.perf_counter() - t0
        check(got == data, "phase 12: the host reader's decode of the level-1 mesh stream differs")
        ref1 = _compress(port.CompressedOutputStream, data,
                         {"transform": "LZX", "entropy": "NONE", "blockSize": BLOCK,
                          "jobs": 8}, device=None)
        check(len(w1) <= 1.05 * len(ref1),
              f"phase 12: level 1 {len(w1)} B is more than 1.05 x the host parse's {len(ref1)} B")
        t0 = time.perf_counter()
        head = E.mesh_l1_compress(cpu_mesh, arr[:2 * BLOCK], block_size=BLOCK, jobs=8)
        cpu1_s = time.perf_counter() - t0
        check(first_frames(w1, 2) == first_frames(head, 2),
              "phase 12: level 1's first two blocks differ from the CPU world's")
        out["l1"] = {"bytes_out": len(w1), "host_bytes_out": len(ref1),
                     "compress_mb_s": mb / c1, "host_decompress_mb_s": mb / host1_d,
                     "cpu_world_s": cpu1_s}
    finally:
        dist.destroy_process_group()
    out["launches"] = counts

    # step 4: two ranks on the one card, the collectives through gloo
    t0 = time.perf_counter()
    ranks = dryrun.spawn("chip_smoke:mesh_l5_rank", 2, "cuda", (len(data), 12, 8),
                         backend="gloo", timeout=MESH_L5_RANK_TIMEOUT)
    wall = time.perf_counter() - t0
    check(ranks[0]["wire"] == w5,
          "phase 12: the two gloo ranks on the card wrote another level-5 stream")
    # each rank runs one row of every SA dispatch (pass B pads each bucket's
    # last group) and its rows of every block's ANS0 encode
    sa = [res["launches"]["suffix_array"] for res in ranks]
    for r, res in enumerate(ranks):
        lc = res["launches"]
        check(res["device"] == "cuda:0" and lc["ans0_encode_scan"] == blocks
              and sa[r] == sa[0] and 2 * sa[r] >= blocks,
              f"phase 12: gloo rank {r} on {res['device']} did not run its share on the "
              f"card: {lc}")
    out["gloo2"] = {"compress_mb_s": mb / ranks[0]["seconds"], "wall_s": wall,
                    "gathers": gathers(ranks[0]["stats"]),
                    "passes_s": {k[-1]: v[0] for k, v in ranks[0]["stats"].items()
                                 if k.startswith("l5")},
                    "launches": [{k: v for k, v in res["launches"].items() if v}
                                 for res in ranks]}
    return out


def print_phase12(r: dict, prior: dict) -> None:
    card = card_line()
    p4, p7 = prior.get("phase 4"), prior.get("phase 7")

    def was(p, key):
        return "not run" if p is None else f"{p[key]['port']:.2f}"

    print(f"phase 12: {r['mesh']}; NCCL up in {r['init_s']:.2f} s (NCCL_SOCKET_IFNAME="
          f"{os.environ.get('NCCL_SOCKET_IFNAME')}); card {card}")
    print(f"phase 12: mesh_ans0_compress of the first 4 MiB block: {r['ans0']['bytes_out']} B, "
          f"equal to the host encoder's in a fresh writer; mesh_ans0_decompress gives it "
          f"back; a flipped payload byte raises BitStreamError")
    a = r["l5"]
    print(f"phase 12: level 5 over the NCCL world of 1: {a['bytes_out']} B (host stream "
          f"{a['host_bytes_out']} B); compress MB/s {a['compress_mb_s']:.2f} (phase 4 "
          f"{was(p4, 'compress_mb_s')}), mesh decompress MB/s {a['mesh_decompress_mb_s']:.2f} "
          f"(phase 4 {was(p4, 'decompress_mb_s')}), host reader {a['host_decompress_mb_s']:.2f}; "
          f"passes A {r['l5_passes_s']['A']:.3f} s, B {r['l5_passes_s']['B']:.3f} s, "
          f"C {r['l5_passes_s']['C']:.3f} s; first two blocks equal the CPU gloo world's "
          f"({a['cpu_world_s']:.1f} s); card {card}")
    b = r["l1"]
    print(f"phase 12: level 1 over the NCCL world of 1: {b['bytes_out']} B (host parse "
          f"{b['host_bytes_out']} B); compress MB/s {b['compress_mb_s']:.2f} (phase 7 "
          f"{was(p7, 'compress_mb_s')}), host reader MB/s {b['host_decompress_mb_s']:.2f}; "
          f"first two blocks equal the CPU gloo world's ({b['cpu_world_s']:.1f} s); card {card}")
    g = r["gloo2"]
    print(f"phase 12: two gloo ranks on cuda:0: the level-5 stream of the NCCL world; "
          f"compress MB/s {g['compress_mb_s']:.2f} (rank 0's clock; {g['wall_s']:.1f} s with "
          f"the processes' start), passes "
          + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(g["passes_s"].items()))
          + f"; launches {g['launches']}; card {card}")
    for label, gs in (("level 5", r["l5_gathers"]), ("level-5 mesh decode", r["l5_decode_gathers"]),
                      ("level 1", r["l1_gathers"]), ("two gloo ranks, level 5", g["gathers"])):
        print(f"phase 12: gathers of {label}: "
              + "; ".join(f"{k} {v['ms_per_call']:.4f} ms a call x {v['calls']} "
                          f"({v['bytes_per_call']:.0f} B)" for k, v in gs.items())
              + f"; card {card}")
    print(f"phase 12: launches {r['launches']}")


# phase 13: the v1 device LZX engine (ops/lz_tpu.py, tensor code, no kernel
# of its own) under KANZI_TPU_DEVICE_LZ=legacy
LEVEL3 = ("TEXT+UTF+PACK+MM+LZX", "HUFFMAN")


def v1_stage_ms(block: bytes, dev, reps: int = 3) -> dict:
    """The v1 engine on one block, by stage: CUDA events around the hash
    ladder, the extension, the parse (its token count's sync included) and
    the token fetch, the host clock around the emission; each the median of
    ``reps`` runs after a warm one.  Also the whole call on the host clock
    and the peak allocation on the card of one analysis."""
    import numpy as np
    import torch

    from kanzi_tpu_torch.ops import lz_tpu as V
    from kanzi_tpu_torch.ops.lz_emit import _emit

    src = np.frombuffer(block, np.uint8)
    count = src.size
    src_end = count - 18
    max_dist = V.MAX_DISTANCE1 if src_end < 4 * V.MAX_DISTANCE1 else V.MAX_DISTANCE2
    pad = np.zeros(V._pad_bucket(count), np.uint8)
    pad[:count] = src
    x = torch.from_numpy(pad).to(dev)
    names = ("ladder", "extension", "parse", "fetch", "emission")

    def run() -> list:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        w = V._words(x)
        cand = V._ladder(w, 4, max_dist)
        ev[1].record()
        mlen, dist = V._extend(w, cand, src_end, 4)
        ev[2].record()
        *toks, k = V._parse(mlen, dist, 4)
        ev[3].record()
        pos, ln, d = V._fetch(*toks, k)
        ev[4].record()
        ev[4].synchronize()
        t = time.perf_counter()
        _emit(src, count, 4, max_dist, pos, ln, d)
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)] \
            + [(time.perf_counter() - t) * 1e3]

    run()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    runs = [run() for _ in range(reps)]
    peak = torch.cuda.max_memory_allocated() - base
    res = {n: statistics.median(r[i] for r in runs) for i, n in enumerate(names)}
    res["call_ms"] = host_ms(lambda: V.lzx_forward_device(src, True, 4, device=dev), reps)
    res["peak_bytes"] = peak
    return res


# blocks of phase 13's streams held to a CPU run of the v1 engine (~13 s a
# block there): one, so that the script keeps its time with phase 16 added
V1_CPU_BLOCKS = 1


def phase13_v1(data: bytes, dev, prior: dict) -> dict:
    """The v1 engine alone on every 4 MiB block of ``data`` (its first
    V1_CPU_BLOCKS blocks' sections equal the port's device="cpu" run, every section
    decodes through the host inverse), its stages on one block; then, under
    KANZI_TPU_DEVICE_LZ=legacy, level 3 (the engine a block, at jobs 8)
    against phase 6 and its first V1_CPU_BLOCKS blocks against a CPU run, level 1
    (the writer's v3 batch: phase 7's bytes), and level 3 on
    real_corpus(64 MiB) against the host.  The launch counts are set to 0
    just before each stream's compress and read just after its decode on
    the card."""
    import numpy as np
    import torch

    from kanzi_tpu_torch.io import stream as port
    from kanzi_tpu_torch.ops import launch
    from kanzi_tpu_torch.ops import lz_tpu as V
    from kanzi_tpu_torch.transforms.lz import LZXCodec
    from kanzi_tpu_torch.utils.corpus import real_corpus

    out: dict = {"launches": {}}
    blocks = [np.frombuffer(data[i:i + BLOCK], np.uint8) for i in range(0, len(data), BLOCK)]
    t = time.perf_counter()
    secs = [V.lzx_forward_device(b, True, 4, device=dev) for b in blocks]
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t
    t = time.perf_counter()
    for i in range(V1_CPU_BLOCKS):
        want = V.lzx_forward_device(blocks[i], True, 4, device="cpu")
        check((want is None and secs[i] is None)
              or (want is not None and secs[i] is not None and np.array_equal(want, secs[i])),
              f"phase 13: the v1 sections of block {i} differ from the port's CPU run")
    cpu_s = time.perf_counter() - t
    for i, (b, s) in enumerate(zip(blocks, secs)):
        check(s is None or np.array_equal(LZXCodec().inverse(s, b.size), b),
              f"phase 13: the v1 section of block {i} does not decode to the block")
    out["engine"] = {"blocks": len(blocks), "mb_s": len(data) / 1e6 / engine_s,
                     "bytes_out": sum(b.size if s is None else s.size
                                      for b, s in zip(blocks, secs)),
                     "skipped": sum(s is None for s in secs), "cpu_head_s": cpu_s,
                     "stages_ms": v1_stage_ms(data[:BLOCK], dev)}

    def level(label: str, lvl_data: bytes, chain: tuple, must: tuple,
              cpu_head: bool, host: bool) -> dict:
        """One stream of ``chain`` (transform, entropy) under legacy: the
        port compresses and decodes on the card (the launch counts of
        ``must`` and the engine's set to 0 just before, read just after;
        each of ``must`` has to have run), then the host coders decode;
        ``cpu_head``: its first V1_CPU_BLOCKS blocks against the port's CPU run;
        ``host``: the host coders' compress beside it."""
        ctx = {"transform": chain[0], "entropy": chain[1], "blockSize": BLOCK, "jobs": 8}
        mb = len(lvl_data) / 1e6
        r: dict = {"bytes_in": len(lvl_data)}
        os.environ["KANZI_TPU_DEVICE_LZ"] = "legacy"
        try:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            launch.reset_launches()
            t = time.perf_counter()
            blob = _compress(port.CompressedOutputStream, lvl_data, ctx, device=dev)
            torch.cuda.synchronize()
            port_c = time.perf_counter() - t
            t = time.perf_counter()
            got = _decompress(port.CompressedInputStream, blob, 8, device=dev)
            torch.cuda.synchronize()
            port_d = time.perf_counter() - t
            r["launches"] = {k: launch.launches[k] for k in must + ("lz_v1",)}
            r["peak_bytes"] = torch.cuda.max_memory_allocated() - base
            check(got == lvl_data, f"phase 13: {label}: the port's decode on the card differs")
            check(all(r["launches"][k] > 0 for k in must),
                  f"phase 13: {label}: a kernel never ran: {r['launches']}")
            if cpu_head:
                t = time.perf_counter()
                head = _compress(port.CompressedOutputStream,
                                 lvl_data[:V1_CPU_BLOCKS * BLOCK], ctx, device="cpu")
                r["cpu_head_s"] = time.perf_counter() - t
                check(first_frames(blob, V1_CPU_BLOCKS) == first_frames(head, V1_CPU_BLOCKS),
                      f"phase 13: {label}: the first blocks differ from the port's CPU run")
        finally:
            del os.environ["KANZI_TPU_DEVICE_LZ"]
        t = time.perf_counter()
        got = _decompress(port.CompressedInputStream, blob, 8, device=None)
        host_d = time.perf_counter() - t
        check(got == lvl_data, f"phase 13: {label}: the host coders' decode differs")
        r.update(bytes_out=len(blob), sha256=hashlib.sha256(blob).hexdigest(),
                 compress_mb_s={"port": mb / port_c},
                 decompress_mb_s={"port": mb / port_d, "host": mb / host_d})
        if host:
            t = time.perf_counter()
            ref = _compress(port.CompressedOutputStream, lvl_data, ctx, device=None)
            r["compress_mb_s"]["host"] = mb / (time.perf_counter() - t)
            r["host_bytes_out"] = len(ref)
        out["launches"][label] = r["launches"]
        return r

    out["l3"] = level("level 3", data, LEVEL3, HUFFMAN_KERNELS + ("lz_v1",), True, False)
    out["l1"] = level("level 1", data, ("LZX", "NONE"), LZ_KERNELS, False, False)
    check(out["l1"]["launches"]["lz_v1"] == 0, "phase 13: level 1 ran the v1 engine")
    p7 = prior.get("phase 7")
    check(p7 is None or out["l1"]["sha256"] == p7["sha256"],
          "phase 13: level 1 under legacy differs from phase 7's stream")
    t = time.perf_counter()
    real, sha, breakdown = real_corpus(64 << 20)
    out["real"] = {"sha256": sha, "sections": breakdown, "made_s": time.perf_counter() - t}
    out["real"].update(level("level 3 on real_corpus", real.tobytes(), LEVEL3,
                             HUFFMAN_KERNELS + ("lz_v1",), False, True))
    return out


def print_phase13(r: dict, prior: dict) -> None:
    card = card_line()
    e = r["engine"]
    s = e["stages_ms"]
    print(f"phase 13: the v1 engine alone on {e['blocks']} blocks of 4 MiB: "
          f"{e['bytes_out']} B out ({e['skipped']} skipped), {e['mb_s']:.2f} MB/s; the first "
          f"{V1_CPU_BLOCKS} block(s) equal the port's CPU run ({e['cpu_head_s']:.1f} s), every "
          f"section decodes; card {card}")
    print(f"phase 13: one 4 MiB block by stage (CUDA events, median of 3): ladder "
          f"{s['ladder']:.4f} ms, extension {s['extension']:.4f} ms, parse {s['parse']:.4f} "
          f"ms, fetch {s['fetch']:.4f} ms, host emission {s['emission']:.4f} ms; the whole call "
          f"{s['call_ms']:.4f} ms (host clock); peak {s['peak_bytes']} B allocated; card {card}")
    p6 = prior.get("phase 6")
    for key, label in (("l3", "level 3"), ("l1", "level 1")):
        a = r[key]
        was = "" if p6 is None or key != "l3" else (
            f" (phase 6: {p6['bytes_out']} B, compress MB/s {p6['compress_mb_s']['port']:.2f}, "
            f"decompress {p6['decompress_mb_s']['port']:.2f})")
        print(f"phase 13: {label} under legacy: {a['bytes_in']} B -> {a['bytes_out']} B; "
              f"compress MB/s {a['compress_mb_s']['port']:.2f}, decompress MB/s port "
              f"{a['decompress_mb_s']['port']:.2f} host {a['decompress_mb_s']['host']:.2f}"
              f"{was}; launches {a['launches']}; peak {a['peak_bytes']} B allocated"
              + (f"; first {V1_CPU_BLOCKS} block(s) equal the CPU run's ({a['cpu_head_s']:.1f} s)"
                 if "cpu_head_s" in a else "; phase 7's stream, byte for byte")
              + f"; card {card}")
    a = r["real"]
    print(f"phase 13: real_corpus(64 MiB) sha256 {a['sha256']}, sections {a['sections']} "
          f"({a['made_s']:.1f} s); level 3 under legacy {a['bytes_out']} B (host parse "
          f"{a['host_bytes_out']} B); compress MB/s port {a['compress_mb_s']['port']:.2f} host "
          f"{a['compress_mb_s']['host']:.2f}; decompress MB/s port "
          f"{a['decompress_mb_s']['port']:.2f} host {a['decompress_mb_s']['host']:.2f}; "
          f"round-tripped; launches {a['launches']}; card {card}")


# phase 14: the device LZ paths phase 7 does not take, under KANZI_TPU_DEVICE_LZ=1
LEVEL2 = ("DNA+LZ", "HUFFMAN")
WINDOW_BLOCK = 32 << 20    # over MAX_FLAT: the windowed 256 KiB-row engine
MAX_FLAT_BLOCK = 16 << 20  # MAX_FLAT: the flat engine's largest bucket


def first_group(block: bytes, dev, phase: str = "phase 14", timing: bool = True) -> dict:
    """The windowed engine's first group (GROUP_ROWS rows of ``block`` in
    _block_rows' layout) through _match_stage and _parse_stage on the card
    and on the CPU: (pk, dist) must be equal.  Then lz_words at that group's
    shape against its plain version on the card, and timed."""
    import numpy as np
    import torch

    from kanzi_tpu_torch.ops import lz_sort as T
    from kanzi_tpu_torch.ops import lz_words_cuda as L

    parts = T._block_rows(np.frombuffer(block, np.uint8))
    grp = [np.ascontiguousarray(a[:T.GROUP_ROWS]) for a in parts]

    def run(device):
        pk, dist, k = T._parse_stage(*T._match_stage(
            *(torch.from_numpy(a).to(device) for a in grp), 4), 4)
        return pk.cpu(), dist.cpu(), k

    got = run(dev)
    t = time.perf_counter()
    want = run("cpu")
    cpu_s = time.perf_counter() - t
    check(got[2] == want[2] > 0 and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{phase}: the windowed engine's first group on the card differs from the CPU's")
    x = torch.from_numpy(grp[0]).to(dev)
    ws, ref = L.lz_words(x), L.lz_words_ref(x)
    check(all(torch.equal(g, w) for g, w in zip(ws, ref)),
          f"{phase}: lz_words at {tuple(x.shape)} differs from its plain version")
    rec = {"lz_words": {"max_abs_err": max_abs_err(ws, ref)}}
    if timing:
        timed(rec, "lz_words", lambda: L.lz_words(x), lambda: L.lz_words_ref(x), x, x.numel())
    return {"rows": grp[0].shape[0], "tokens": got[2], "cpu_s": cpu_s,
            "lz_words": rec["lz_words"]}


def _mem() -> dict:
    """The caching allocator's readings: bytes allocated and reserved, and
    its counts of cudaMalloc calls and of retries after a failed one (each
    retry frees the cache and synchronises)."""
    import torch

    st = torch.cuda.memory_stats()
    return {"alloc": torch.cuda.memory_allocated(), "reserved": torch.cuda.memory_reserved(),
            "mallocs": st.get("num_device_alloc", 0), "retries": st.get("num_alloc_retries", 0)}


def lz_stream(label: str, data: bytes, chain: tuple, block: int, dev, head: int,
              kernels: tuple, repeats: int = 2, serial: bool = False) -> dict:
    """One stream of ``chain`` (transform, entropy) at ``block``-byte
    blocks, jobs 8, under KANZI_TPU_DEVICE_LZ=1, removed afterwards.  The
    launch counts are set to 0 just before the port's first compress and
    read just after its decode on the card; each of ``kernels`` has to have
    run.  ``repeats`` compresses on the card in all, each timed and each
    writing the same bytes; around each, the allocator's readings (_mem),
    its peak, and the host seconds of every engine dispatch
    (lzx_forward_device_batch, emission included) and of every flat
    analysis in it (_analyze_flat, which ends in a sync on its token
    count).  lz_words' launch shapes and the blocks the codec hands to
    lzx_forward_device_v2 are recorded by wrappers that call the originals.
    The first ``head`` blocks must equal a run of the port on the CPU; the
    stream must decode on the card and with the host coders; the host
    coders' compress stands beside it.  ``serial``: the stream must also
    equal the card's at jobs 1, where no two blocks' device calls
    overlap."""
    import torch

    from kanzi_tpu_torch.io import stream as port
    from kanzi_tpu_torch.ops import launch
    from kanzi_tpu_torch.ops import lz_sort as T

    ctx = {"transform": chain[0], "entropy": chain[1], "blockSize": block, "jobs": 8}
    mb = len(data) / 1e6
    shapes, v2_sizes, batch_s, analyze_s = [], [], [], []
    orig = (T.lz_words, T.lzx_forward_device_v2, T.lzx_forward_device_batch, T._analyze_flat)
    words, v2, batch, analyze = orig

    def words_seen(bufs):
        shapes.append(tuple(bufs.shape))
        return words(bufs)

    def v2_seen(src, *a, **kw):
        v2_sizes.append(len(src))
        return v2(src, *a, **kw)

    def clocked(fn, into):
        def run(*a, **kw):
            t = time.perf_counter()
            res = fn(*a, **kw)
            into.append(time.perf_counter() - t)
            return res
        return run

    def compress() -> tuple:
        del batch_s[:], analyze_s[:]
        torch.cuda.synchronize()
        m0 = _mem()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = _compress(port.CompressedOutputStream, data, ctx, device=dev)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        m1 = _mem()
        return out, {"mb_s": mb / sec,
                     "peak": torch.cuda.max_memory_allocated() - m0["alloc"],
                     "alloc": [m0["alloc"], m1["alloc"]],
                     "reserved": [m0["reserved"], m1["reserved"]],
                     "mallocs": m1["mallocs"] - m0["mallocs"],
                     "retries": m1["retries"] - m0["retries"],
                     "batch_s": list(batch_s), "analyze_s": list(analyze_s)}

    r: dict = {"bytes_in": len(data), "head": head}
    os.environ["KANZI_TPU_DEVICE_LZ"] = "1"
    T.lz_words, T.lzx_forward_device_v2 = words_seen, v2_seen
    T.lzx_forward_device_batch = clocked(batch, batch_s)
    T._analyze_flat = clocked(analyze, analyze_s)
    try:
        launch.reset_launches()
        blob, first = compress()
        t = time.perf_counter()
        got = _decompress(port.CompressedInputStream, blob, 8, device=dev)
        torch.cuda.synchronize()
        port_d = time.perf_counter() - t
        r["launches"] = {k: launch.launches[k] for k in kernels}
        r["shapes"] = sorted(set(shapes))
        r["v2_blocks"] = len(v2_sizes)
        check(got == data, f"phase 14: {label}: the port's decode on the card differs")
        check(all(v > 0 for v in r["launches"].values()),
              f"phase 14: {label}: a kernel never ran: {r['launches']}")
        r["runs"] = [first]
        for _ in range(repeats - 1):
            again, run = compress()
            check(again == blob, f"phase 14: {label}: a compress on the card differs")
            r["runs"].append(run)
        if head:
            t = time.perf_counter()
            cpu = _compress(port.CompressedOutputStream, data[:head * block], ctx, device="cpu")
            r["cpu_head_s"] = time.perf_counter() - t
            check(first_frames(blob, head) == first_frames(cpu, head),
                  f"phase 14: {label}: the first {head} blocks differ from the port's CPU run")
        if serial:
            t = time.perf_counter()
            one = _compress(port.CompressedOutputStream, data, dict(ctx, jobs=1), device=dev)
            torch.cuda.synchronize()
            r["serial_compress_mb_s"] = mb / (time.perf_counter() - t)
            check(one == blob, f"phase 14: {label}: the stream at jobs 8 differs from jobs 1's")
    finally:
        (T.lz_words, T.lzx_forward_device_v2, T.lzx_forward_device_batch,
         T._analyze_flat) = orig
        del os.environ["KANZI_TPU_DEVICE_LZ"]
    t = time.perf_counter()
    got = _decompress(port.CompressedInputStream, blob, 8, device=None)
    host_d = time.perf_counter() - t
    check(got == data, f"phase 14: {label}: the host coders' decode differs")
    t = time.perf_counter()
    ref = _compress(port.CompressedOutputStream, data, ctx, device=None)
    host_c = time.perf_counter() - t
    r.update(bytes_out=len(blob), host_bytes_out=len(ref),
             sha256=hashlib.sha256(blob).hexdigest(), peak_bytes=first["peak"],
             compress_mb_s={"port": first["mb_s"], "host": mb / host_c},
             decompress_mb_s={"port": mb / port_d, "host": mb / host_d})
    return r


def phase14_lz(data: bytes, dev, prior: dict) -> dict:
    """Level 1 at 4 MiB blocks (phase 7's path, this phase's comparator:
    its bytes equal phase 7's where phase 7 ran), at 32 MiB (the windowed
    row engine: its first group against the CPU, lz_words once a group at
    (bucket, 262144)) and at 16 MiB (MAX_FLAT: four blocks in one flat
    dispatch), three compresses each; levels 2 and 3 at 4 MiB blocks (the
    codec's per-block dispatch from eight pool threads: one lz_words a
    block that reached the engine)."""
    from kanzi_tpu_torch.ops import lz_sort as T

    out: dict = {"first_group": first_group(data[:WINDOW_BLOCK], dev)}
    l1 = ("LZX", "NONE")
    c = lz_stream("level 1 at 4 MiB blocks", data, l1, BLOCK, dev, 2, LZ_KERNELS, repeats=3)
    if "phase 7" in prior:
        check(c["bytes_out"] == prior["phase 7"]["bytes_out"],
              f"phase 14: level 1 at 4 MiB: {c['bytes_out']} B, phase 7 wrote "
              f"{prior['phase 7']['bytes_out']} B")
    out["l1_4m"] = c
    w = lz_stream("level 1 at 32 MiB blocks", data, l1, WINDOW_BLOCK, dev, 0, LZ_KERNELS,
                  repeats=3)
    rows = sum(-(-min(WINDOW_BLOCK, len(data) - i) // T.STRIDE)
               for i in range(0, len(data), WINDOW_BLOCK))
    groups = -(-rows // T.GROUP_ROWS)
    check(w["launches"]["lz_words"] == groups,
          f"phase 14: level 1 at 32 MiB: {w['launches']} for {groups} groups of {rows} rows")
    check(all(s[1] == T.ROW and s[0] in (4, 12, T.GROUP_ROWS) for s in w["shapes"]),
          f"phase 14: level 1 at 32 MiB: lz_words at {w['shapes']}")
    w.update(rows=rows, groups=groups)
    out["l1_32m"] = w
    f = lz_stream("level 1 at 16 MiB blocks", data, l1, MAX_FLAT_BLOCK, dev, 1, LZ_KERNELS,
                  repeats=3)
    nb = 1 << (-(-len(data) // MAX_FLAT_BLOCK) - 1).bit_length()   # padded to a power of 2
    check(f["launches"]["lz_words"] == 1 and f["shapes"] == [(nb, MAX_FLAT_BLOCK)],
          f"phase 14: level 1 at 16 MiB is not one flat dispatch of {nb} blocks: "
          f"{f['launches']} at {f['shapes']}")
    out["l1_16m"] = f
    for key, label, chain in (("l2", "level 2", LEVEL2), ("l3", "level 3", LEVEL3)):
        a = lz_stream(label, data, chain, BLOCK, dev, 2, LZ_KERNELS + HUFFMAN_KERNELS,
                      serial=True)
        check(a["launches"]["lz_words"] == a["v2_blocks"] > 0,
              f"phase 14: {label}: {a['launches']['lz_words']} lz_words launches for "
              f"{a['v2_blocks']} blocks through the device LZ")
        out[key] = a
    out["launches"] = {k: out[k]["launches"] for k in ("l1_4m", "l1_32m", "l1_16m", "l2", "l3")}
    return out


def _run_text(u: dict) -> str:
    """One compress of lz_stream: MB/s, the allocator, the dispatches."""
    gb = lambda v: f"{v / 1e9:.3f}"
    text = (f"{u['mb_s']:.2f} MB/s, allocated {gb(u['alloc'][0])}->{gb(u['alloc'][1])} GB, "
            f"reserved {gb(u['reserved'][0])}->{gb(u['reserved'][1])} GB, peak "
            f"{gb(u['peak'])} GB, {u['mallocs']} cudaMalloc, {u['retries']} retries")
    if u["batch_s"]:
        text += (f", {len(u['batch_s'])} dispatch(es) "
                 f"{sum(u['batch_s']):.3f} s (longest {max(u['batch_s']):.3f})")
    if u["analyze_s"]:
        text += f", flat analyses {' '.join(f'{v:.3f}' for v in u['analyze_s'])} s"
    return text


def print_phase14(r: dict, prior: dict) -> None:
    card = card_line()
    g = r["first_group"]
    k = g["lz_words"]
    print(f"phase 14: the windowed engine's first group ({g['rows']} rows of 256 KiB) on the "
          f"card equals the CPU's: {g['tokens']} tokens ({g['cpu_s']:.1f} s on the CPU); "
          f"lz_words at ({g['rows']}, 262144) bit-equal to its plain version: kernel "
          f"{k['ms']:.4f} ms ({k['device_ms']:.4f} on the card alone), plain "
          f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']}); card {card}")
    base = r["l1_4m"]["runs"]
    for key, label, ph in (
            ("l1_4m", "level 1 at 4 MiB blocks (flat, phase 7's path)", "phase 7"),
            ("l1_32m", "level 1 at 32 MiB blocks (windowed rows)", "phase 7"),
            ("l1_16m", "level 1 at 16 MiB blocks (flat, MAX_FLAT)", "phase 7"),
            ("l2", "level 2 (DNA+LZ), the codec's dispatch", None),
            ("l3", "level 3, the codec's dispatch", "phase 6")):
        a, p = r[key], prior.get(ph)
        side = "" if ph is None else f" ({ph}: not run)" if p is None else (
            f" ({ph}: {p['bytes_out']} B, compress MB/s {p['compress_mb_s']['port']:.2f}, "
            f"decompress {p['decompress_mb_s']['port']:.2f})")
        extra = (f"; {a['rows']} rows in {a['groups']} groups" if "groups" in a else "") + (
            f"; {a['v2_blocks']} blocks through the device LZ" if a["v2_blocks"] else "")
        head = "" if "cpu_head_s" not in a else (
            f"; its first {a['head']} block(s) equal the port's CPU run ({a['cpu_head_s']:.1f} s)")
        if "serial_compress_mb_s" in a:
            head += (f"; equal to the card's stream at jobs 1 (compress MB/s "
                     f"{a['serial_compress_mb_s']:.2f})")
        rates = [u["mb_s"] for u in a["runs"]]
        ratio = " ".join(f"{u / v['mb_s']:.3f}" for u, v in zip(rates, base))
        print(f"phase 14: {label}: {a['bytes_in']} B -> {a['bytes_out']} B (host parse "
              f"{a['host_bytes_out']} B){side}; compress MB/s port "
              f"{' '.join(f'{v:.2f}' for v in rates)} ({ratio} x the 4 MiB stream's "
              f"compress of the same rank) host {a['compress_mb_s']['host']:.2f}; "
              f"decompress MB/s port {a['decompress_mb_s']['port']:.2f} host "
              f"{a['decompress_mb_s']['host']:.2f}; launches {a['launches']} at "
              f"{a['shapes']}{extra}; peak {a['peak_bytes']} B allocated{head}; decoded on "
              f"the card and by the host coders; card {card}")
        for i, u in enumerate(a["runs"]):
            print(f"phase 14: {label}: compress {i + 1}: {_run_text(u)}")


# phase 15: the configuration space the CLI accepts, beside the one corpus of
# phases 3-14: every level's golden file, levels 1-5 through the harness, the
# entropy stages at the gates' block-size and data edges, the sweep harness
# both ways a user reaches it, and multihost's worker
FAMILY = {"ANS0": ANS0_KERNELS, "HUFFMAN": HUFFMAN_KERNELS, "ANS1": ANS1_KERNELS}
GOLDEN_DEVICE = {2: HUFFMAN_KERNELS, 3: HUFFMAN_KERNELS, 5: ANS0_KERNELS + ANS0_GLUE}
# block sizes of part c: one chunk short of the ANS0 and Huffman encode
# minimum, exactly four 16 KiB chunks, 64 chunks, 257 chunks; for ANS1 also
# a 4 MiB chunk and a tail, and two chunks
EDGE_BLOCKS = {e: (64 * 1024 - 16, 64 * 1024, 1 << 20, (4 << 20) + 16384)
               for e in ("ANS0", "HUFFMAN")}
EDGE_BLOCKS["ANS1"] = EDGE_BLOCKS["ANS0"] + (6 << 20, 8 << 20)
EDGE_TAIL = 12_345
HARNESS_SIZE = (8 << 20) + EDGE_TAIL      # part b: two 4 MiB blocks and a short one
SWEEP_SIZE = (1 << 20) + EDGE_TAIL        # part d: the CLI's sweep, 19 x 8 configurations
SWEEP_DEVICE_SIZE = (4 << 20) + EDGE_TAIL  # part d: the entropies with a device stage
SWEEP_ENTROPIES = ["NONE", "HUFFMAN", "ANS0", "ANS1"]
# part b: (level, environment, jobs, checksum bits)
HARNESS_RUNS = ((1, {"KANZI_TPU_DEVICE_LZ": "1"}, 8, 0), (2, {}, 8, 0), (3, {}, 8, 0),
                (4, {}, 8, 0), (5, {}, 8, 0), (5, {"KANZI_TPU_DEVICE_BWT": "1"}, 8, 0),
                (5, {}, 16, 64))


def _set_env(values: dict) -> None:
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@contextlib.contextmanager
def env_vars(**kw):
    """The environment variables of ``kw`` set (None: unset) for a block,
    then restored."""
    old = {k: os.environ.get(k) for k in kw}
    _set_env(kw)
    try:
        yield
    finally:
        _set_env(old)


def nonzero_launches() -> dict:
    from kanzi_tpu_torch.ops import launch
    return {k: v for k, v in launch.launches.items() if v}


def edge_size(block: int) -> int:
    """Part c's input length at ``block``: two full blocks and a short one."""
    return 2 * block + block // 2 + EDGE_TAIL


def edge_inputs(n: int) -> dict:
    """Part c's four inputs of ``n`` bytes, made from a seed with numpy."""
    import numpy as np

    from kanzi_tpu_torch.utils.corpus import mixed_corpus
    rng = np.random.default_rng(15)
    return {"mixed": mixed_corpus(n, seed=15),
            "random": rng.integers(0, 256, n, dtype=np.uint8),
            "one byte": np.full(n, 0x41, np.uint8),
            "two symbols 999:1": np.where(rng.random(n) < 0.001, 0x42, 0x41).astype(np.uint8)}


def copied_blocks(blob: bytes) -> list:
    """Whether each block of a stream is stored as a copy (its mode's
    COPY_BLOCK_MASK), without the entropy stage: encode_block stores a block
    so when the entropy stage's payload is no smaller than its bytes."""
    from kanzi_tpu_torch.io import stream as port
    out = []
    with port.CompressedInputStream(io.BytesIO(blob), {}, device=None) as cis:
        while (frame := cis._frame_next()) is not None:
            out.append(bool(frame[1][0] & port.COPY_BLOCK_MASK))
    return out


def gate_launches(entropy: str, data, block: int, blob: bytes) -> dict:
    """The launches the entropy stage's device gates give a transform-NONE
    stream of ``data`` (uint8) at ``block``-byte blocks, compressed and then
    decompressed on the card: one launch of each encode kernel a block that
    the encode gate sends to the card (ANS0 and Huffman: at least four full
    16 KiB chunks, entropy/ans.py and huffman.py; ANS1: a full 4 MiB chunk),
    and of the decode kernel a block that the decode gate sends there (ANS0:
    as its encode; Huffman: a full chunk, entropy/huffman.py decode), that
    the stream ``blob`` holds entropy-coded (copied_blocks) and that has
    a full chunk of two or more symbols (a one-symbol chunk is a header
    only); ANS1 decodes on the host; and for ANS0, one count of the decode's
    compiled header parse (ANS0_GLUE) a block its decode gate sends to the
    card that the stream holds entropy-coded, and one of the encode's
    compiled record writer a block its encode gate sends there.  Every other
    kernel none."""
    out = dict.fromkeys(REPLACES, 0)
    copied = copied_blocks(blob)
    for i, start in enumerate(range(0, len(data), block)):
        blk = data[start:start + block]
        nfull = len(blk) // CHUNK
        full = blk[:nfull * CHUNK].reshape(nfull, CHUNK)
        multi = bool((full != full[:, :1]).any())
        enc = len(blk) >= BLOCK if entropy == "ANS1" else nfull >= 4
        dec = ({"ANS0": enc, "HUFFMAN": nfull >= 1, "ANS1": False}[entropy]
               and multi and not copied[i])
        for k in FAMILY[entropy]:
            out[k] += int(dec if k.endswith("_decode") else enc)
        if entropy == "ANS0":
            out[ANS0_GLUE[0]] = out.get(ANS0_GLUE[0], 0) + int(enc and not copied[i])
            out[ANS0_GLUE[1]] = out.get(ANS0_GLUE[1], 0) + int(enc)
    return {k: v for k, v in out.items() if v}


def config_stream(label: str, data: bytes, ctx: dict, dev, expect,
                  phase: str = "phase 15") -> dict:
    """One stream of phase 15 (or ``phase``), written at ``dev`` and at None: the card's
    bytes must equal the host's, and decode at ``dev`` and at None.  The
    launch counts are set to 0 just before the card's compress and read just
    after its decode; they must equal ``expect(blob)`` (kernel -> launches,
    every kernel not named none)."""
    import torch

    from kanzi_tpu_torch.io import stream as port
    from kanzi_tpu_torch.ops import launch

    jobs = ctx["jobs"]
    launch.reset_launches()
    t0 = time.perf_counter()
    blob = _compress(port.CompressedOutputStream, data, ctx, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = _decompress(port.CompressedInputStream, blob, jobs, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    got = nonzero_launches()
    check(out == data, f"{phase}: {label}: the decode on the card differs from the input")
    ref = _compress(port.CompressedOutputStream, data, ctx, device=None)
    t3 = time.perf_counter()
    check(blob == ref, f"{phase}: {label}: the card's stream differs from the host's "
                       f"({len(blob)} B, host {len(ref)} B)")
    out = _decompress(port.CompressedInputStream, blob, jobs, device=None)
    t4 = time.perf_counter()
    check(out == data, f"{phase}: {label}: the host's decode differs from the input")
    want = expect(blob)
    check(got == want, f"{phase}: {label}: launches {got}, the gates give {want}")
    return {"bytes_in": len(data), "bytes_out": len(blob), "launches": got,
            "sha256": hashlib.sha256(blob).hexdigest(),
            "s": [t1 - t0, t2 - t1, t3 - t2, t4 - t3]}


def group_sum(runs: list) -> dict:
    """Streams, bytes, MB/s (card and host, each way) and launches of a group."""
    n = sum(r["bytes_in"] for r in runs)
    s = [sum(r["s"][i] for r in runs) for i in range(4)]
    launches: dict = {}
    for r in runs:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"streams": len(runs), "bytes_in": n, "bytes_out": sum(r["bytes_out"] for r in runs),
            "mb_s": {"card_compress": n / 1e6 / s[0], "card_decompress": n / 1e6 / s[1],
                     "host_compress": n / 1e6 / s[2], "host_decompress": n / 1e6 / s[3]},
            "launches": launches}


def golden_group(dev) -> dict:
    """Part a: tests/golden/l0..l9.knz written at ``dev`` from the CPU test's
    data and ctx (tests/test_torch_golden.py), byte for byte; levels 2, 3
    and 5 (whose entropy stage sees at least four full chunks) launch their
    family's kernels once, the others none."""
    from kanzi_tpu_torch.app.block_compressor import LEVELS, BlockCompressor
    from kanzi_tpu_torch.utils.corpus import mixed_corpus

    data = mixed_corpus(256 * 1024, seed=1234).tobytes()
    root = os.path.dirname(os.path.abspath(__file__))
    runs = []
    with env_vars(KANZI_TPU_DEVICE_LZ=None, KANZI_TPU_DEVICE_BWT=None):
        for level in range(10):
            t, e, b = LEVELS[level]
            ctx = BlockCompressor(transform=t, entropy=e, block_size=b, jobs=1,
                                  device=None)._ctx(len(data))
            once = dict.fromkeys(GOLDEN_DEVICE.get(level, ()), 1)
            r = config_stream(f"golden l{level}", data, ctx, dev, lambda _, once=once: once)
            with open(os.path.join(root, "tests", "golden", f"l{level}.knz"), "rb") as fh:
                golden = fh.read()
            check(r["sha256"] == hashlib.sha256(golden).hexdigest(),
                  f"phase 15: level {level} at {dev} differs from tests/golden/l{level}.knz")
            runs.append(r)
    return group_sum(runs)


def harness_group(dev) -> dict:
    """Part b: levels 1-5 through app/benchmark.py run_config on
    mixed_corpus(8 MiB + 12,345 B), at the card and at None (each round-
    tripped by run_config).  The launch counts are set to 0 just before the
    card's run_config and read just after: each level's device kernels ran
    (level 1 lz_words under KANZI_TPU_DEVICE_LZ=1, levels 2-3 Huffman's,
    level 5 ANS0's, and the device SA under KANZI_TPU_DEVICE_BWT=1) and no
    other.  The card's stream equals the host's (its sha256), but level 1's:
    its tokens are not the host parse's, so it is at most 1.05 x the host's
    bytes and the host coders decode it."""
    import torch

    from kanzi_tpu_torch.app import benchmark as bench
    from kanzi_tpu_torch.app.block_compressor import LEVELS, BlockCompressor
    from kanzi_tpu_torch.app.block_decompressor import BlockDecompressor
    from kanzi_tpu_torch.ops import launch
    from kanzi_tpu_torch.utils.corpus import mixed_corpus

    data = mixed_corpus(HARNESS_SIZE, seed=12).tobytes()
    kernels = {1: LZ_KERNELS + LZ_GLUE, 2: HUFFMAN_KERNELS, 3: HUFFMAN_KERNELS, 4: (),
               5: ANS0_KERNELS + ANS0_GLUE}
    runs = []
    for level, env, jobs, checksum in HARNESS_RUNS:
        t, e, b = LEVELS[level]
        label = (f"-l {level} -j {jobs}" + (f" -x {checksum}" if checksum else "")
                 + "".join(f" {k}={v}" for k, v in env.items()))
        with env_vars(**{"KANZI_TPU_DEVICE_LZ": None, "KANZI_TPU_DEVICE_BWT": None, **env}):
            launch.reset_launches()
            card = bench.run_config(data, t, e, b, jobs, device=dev, checksum=checksum)
            torch.cuda.synchronize()
            got = nonzero_launches()
            want = set(kernels[level]) | ({"suffix_array"} if env.get("KANZI_TPU_DEVICE_BWT")
                                          else set())
            check(set(got) == want, f"phase 15: {label}: launches {got}, want {sorted(want)}")
            if level == 1:
                blob = BlockCompressor(transform=t, entropy=e, block_size=b, jobs=jobs,
                                       device=dev).compress_bytes(data)
        host = bench.run_config(data, t, e, b, jobs, device=None, checksum=checksum)
        if level == 1:
            check(hashlib.sha256(blob).hexdigest() == card.digest,
                  f"phase 15: {label}: two compresses on the card differ")
            check(BlockDecompressor(jobs=jobs, device=None).decompress_bytes(blob) == data,
                  f"phase 15: {label}: the host coders' decode differs from the input")
            check(card.out_size <= 1.05 * host.out_size,
                  f"phase 15: {label}: {card.out_size} B is over 1.05 x the host parse's "
                  f"{host.out_size} B")
        else:
            check(card.digest == host.digest, f"phase 15: {label}: the card's stream "
                  f"({card.out_size} B) differs from the host's ({host.out_size} B)")
        runs.append({"label": label, "bytes_in": len(data), "bytes_out": card.out_size,
                     "host_bytes_out": host.out_size, "launches": got,
                     "mb_s": [card.enc_mbps, card.dec_mbps, host.enc_mbps, host.dec_mbps]})
    return {"runs": runs}


def edge_group(entropy: str, dev) -> dict:
    """Part c for one entropy: transform NONE at each of EDGE_BLOCKS[entropy]
    on the four inputs of edge_inputs, each a non-multiple of the block (two
    full blocks and a short one), jobs 8; every stream's launches equal
    gate_launches'."""
    sizes = [edge_size(b) for b in EDGE_BLOCKS[entropy]]
    inputs = edge_inputs(max(sizes))
    runs, by_block = [], {}
    for block, n in zip(EDGE_BLOCKS[entropy], sizes):
        ctx = {"transform": "NONE", "entropy": entropy, "blockSize": block, "jobs": 8}
        for kind, arr in inputs.items():
            r = config_stream(f"{entropy} at {block}-byte blocks, {kind}, {n} B",
                              arr[:n].tobytes(), ctx, dev,
                              functools.partial(gate_launches, entropy, arr[:n], block))
            runs.append(r)
            by_block.setdefault(block, []).append(r)
    out = group_sum(runs)
    out["by_block"] = {b: group_sum(rs)["launches"] for b, rs in by_block.items()}
    return out


def start_cli_sweep() -> dict:
    """Part d's subprocess, ``python -m kanzi_tpu_torch.app.benchmark <file>
    --sweep --device cuda`` over mixed_corpus(1 MiB + 12,345 B) written to a
    temporary directory; started first, it runs beside parts a-c and e."""
    import tempfile

    from kanzi_tpu_torch.utils.corpus import mixed_corpus

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sweep_")
    src = os.path.join(tmp, "corpus.bin")
    with open(src, "wb") as fh:
        fh.write(mixed_corpus(SWEEP_SIZE, seed=12).tobytes())
    run = start_cli([src, "--sweep", "--device", "cuda"], module="kanzi_tpu_torch.app.benchmark")
    return dict(run, tmp=tmp, src=src)


def sweep_group(dev, sweep: dict) -> dict:
    """Part d: run_sweep over 4 MiB + 12,345 B with the entropies that have
    a device stage, at ``dev`` and at None, each configuration's stream
    equal (its sha256), every ANS0, Huffman and ANS1 kernel launched;
    main(file, levels 0-9, --device cuda), run_levels, on the sweep's file,
    each level's size equal to run_levels' at None, the ANS0 and Huffman
    kernels launched; then the CLI's sweep (start_cli_sweep): exit 0, all
    19 x 8 configurations printed, none failed or skipped, the ANS0 and
    Huffman kernels launched (ANS1's take blocks of 4 MiB, so none)."""
    import re

    import torch

    from kanzi_tpu_torch.app import benchmark as bench
    from kanzi_tpu_torch.ops import launch
    from kanzi_tpu_torch.utils.corpus import mixed_corpus

    out: dict = {}
    data = mixed_corpus(SWEEP_DEVICE_SIZE, seed=12).tobytes()
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        launch.reset_launches()
        card = bench.run_sweep(data, 1, entropies=SWEEP_ENTROPIES, quiet=True, device=dev)
        torch.cuda.synchronize()
        got = nonzero_launches()
        t1 = time.perf_counter()
        host = bench.run_sweep(data, 1, entropies=SWEEP_ENTROPIES, quiet=True, device=None)
    t2 = time.perf_counter()
    check(len(card) == len(host) == len(bench.SWEEP_TRANSFORMS) * len(SWEEP_ENTROPIES),
          f"phase 15: run_sweep gave {len(card)} and {len(host)} results")
    differ = [c.config for c, h in zip(card, host)
              if (c.config, c.digest) != (h.config, h.digest)]
    check(not differ, f"phase 15: run_sweep at {dev} differs from None at {differ}")
    check(set(got) == set(ANS0_KERNELS + ANS0_GLUE + HUFFMAN_KERNELS + ANS1_KERNELS),
          f"phase 15: run_sweep's launches {got}")
    out["run_sweep"] = {"configs": len(card), "launches": got, "card_s": t1 - t,
                        "host_s": t2 - t1}

    small = mixed_corpus(SWEEP_SIZE, seed=12).tobytes()
    t = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch.reset_launches()
        code = bench.main([sweep["src"]] + [str(lv) for lv in range(10)] + ["--device", "cuda"])
        torch.cuda.synchronize()
        got = nonzero_launches()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        host = bench.run_levels(small, device=None)
    check(code == 0, f"phase 15: main(levels 0-9, --device cuda) returned {code}")
    sizes = [int(m.group(1))
             for m in re.finditer(r"^-l \d \(\S+\) +(\d+) \(", buf.getvalue(), re.M)]
    check(sizes == [r.out_size for r in host],
          f"phase 15: main's level sizes {sizes}, run_levels at None "
          f"{[r.out_size for r in host]}")
    check(set(got) == set(ANS0_KERNELS + ANS0_GLUE + HUFFMAN_KERNELS),
          f"phase 15: main's launches {got}")
    out["levels"] = {"launches": got, "card_s": t1 - t, "sizes": sizes}

    text, counts = finish_cli(sweep)
    configs = {m.group(1) for m in re.finditer(r"^(\S+) b=4M ", text, re.M)}
    n_configs = len(bench.SWEEP_TRANSFORMS) * len(bench.SWEEP_ENTROPIES)
    check(len(configs) == n_configs and "[failed" not in text and "[skipped" not in text,
          f"phase 15: the sweep printed {len(configs)} of {n_configs} configurations: "
          f"{text[-2000:]}")
    got = {k: v for k, v in counts["launches"].items() if v}
    check(set(got) == set(ANS0_KERNELS + ANS0_GLUE + HUFFMAN_KERNELS),
          f"phase 15: the sweep's launches {got}")
    out["cli_sweep"] = {"configs": len(configs), "launches": got,
                        "wall_s": counts["wall_ms"] / 1e3}
    return out


def multihost_group() -> dict:
    """Part e: one multihost worker process (--process-id 0 --num-processes
    1, NCCL on the loopback) through parallel/dryrun.py dryrun_multihost:
    "OK p0", its ANS0 wire equal to the host encoder's, its level-1 stream
    round-tripped, the ANS0 encode kernels, its compiled record writer
    (ans0_wire_write_native), lz_words and the C++ LZX emitter
    (lz_emit_native) counted in it."""
    import ast

    from kanzi_tpu_torch.parallel.dryrun import dryrun_multihost

    with contextlib.redirect_stdout(io.StringIO()):
        lines = dryrun_multihost(1, "cuda", timeout=300)
    line = lines[0]
    check(line.startswith("OK p0") and "equal to the host encoder's" in line
          and "round-trip ok" in line, f"phase 15: multihost: {line}")
    got = ast.literal_eval(line.rsplit("launches ", 1)[1])
    want = set(ANS0_KERNELS[:3] + ANS0_GLUE[1:] + LZ_KERNELS + LZ_GLUE[1:])
    check(set(got) == want, f"phase 15: multihost's launches {got}, want {sorted(want)}")
    return {"line": line, "launches": got}


def phase15_configs(dev) -> dict:
    """Parts a-e of phase 15, each group timed; the CLI's sweep of part d
    starts first and runs beside the others."""
    import shutil

    out = {}
    sweep = start_cli_sweep()
    try:
        for key, fn in (("a", lambda: golden_group(dev)), ("b", lambda: harness_group(dev)),
                        ("c ANS0", lambda: edge_group("ANS0", dev)),
                        ("c HUFFMAN", lambda: edge_group("HUFFMAN", dev)),
                        ("c ANS1", lambda: edge_group("ANS1", dev)), ("e", multihost_group),
                        ("d", lambda: sweep_group(dev, sweep))):
            t = time.perf_counter()
            out[key] = fn()
            out[key]["seconds"] = time.perf_counter() - t
    finally:
        stop_cli(sweep)
        shutil.rmtree(sweep["tmp"])
    launches: dict = {}
    for step in (out["a"], *out["b"]["runs"], out["c ANS0"], out["c HUFFMAN"], out["c ANS1"],
                 out["d"]["run_sweep"], out["d"]["levels"], out["e"]):
        for k, v in step["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    return out


def _rates(m: dict) -> str:
    return (f"card MB/s compress {m['card_compress']:.2f} decompress "
            f"{m['card_decompress']:.2f}, host compress {m['host_compress']:.2f} decompress "
            f"{m['host_decompress']:.2f}")


def print_phase15(r: dict) -> None:
    card = card_line()
    a = r["a"]
    print(f"phase 15: a. golden files l0-l9 (mixed_corpus(256 KiB, seed=1234)): {a['streams']} "
          f"streams, {a['bytes_in']} B -> {a['bytes_out']} B, each written at cuda byte for "
          f"byte as tests/golden/l<n>.knz and as the host stream, decoded at cuda and None; "
          f"{_rates(a['mb_s'])}; launches {a['launches']} (levels 2, 3, 5 once each, the "
          f"others none); {a['seconds']:.1f} s; card {card}")
    for u in r["b"]["runs"]:
        print(f"phase 15: b. run_config {u['label']} on {u['bytes_in']} B: {u['bytes_out']} B "
              f"(host {u['host_bytes_out']} B); MB/s card compress {u['mb_s'][0]:.2f} "
              f"decompress {u['mb_s'][1]:.2f}, host compress {u['mb_s'][2]:.2f} decompress "
              f"{u['mb_s'][3]:.2f}; launches {u['launches']}")
    print(f"phase 15: b. levels 1-5 through run_config: {len(r['b']['runs'])} runs, equal to the "
          f"host's (level 1: at most 1.05 x, decoded by the host coders); "
          f"{r['b']['seconds']:.1f} s; card {card}")
    for e in FAMILY:
        c = r["c " + e]
        print(f"phase 15: c. {e} alone at blocks of {', '.join(map(str, EDGE_BLOCKS[e]))} B "
              f"on mixed, random, one-byte and 999:1 inputs: {c['streams']} streams, "
              f"{c['bytes_in']} B -> {c['bytes_out']} B, each equal to the host stream, decoded "
              f"at cuda and None; {_rates(c['mb_s'])}; launches {c['launches']} (by block "
              f"{c['by_block']}), as the gates give; {c['seconds']:.1f} s; card {card}")
    d = r["d"]
    print(f"phase 15: d. python -m kanzi_tpu_torch.app.benchmark --sweep --device cuda on "
          f"{SWEEP_SIZE} B (beside parts a-c and e): {d['cli_sweep']['configs']} "
          f"configurations, none failed, exit 0, {d['cli_sweep']['wall_s']:.1f} s from its "
          f"start, launches {d['cli_sweep']['launches']}; run_sweep over {SWEEP_DEVICE_SIZE} B with {', '.join(SWEEP_ENTROPIES)}: "
          f"{d['run_sweep']['configs']} configurations equal to None's, card "
          f"{d['run_sweep']['card_s']:.1f} s, host {d['run_sweep']['host_s']:.1f} s, launches "
          f"{d['run_sweep']['launches']}; main(levels 0-9, --device cuda) sizes "
          f"{d['levels']['sizes']} equal to run_levels at None, {d['levels']['card_s']:.1f} s, "
          f"launches {d['levels']['launches']}; {d['seconds']:.1f} s; card {card}")
    e = r["e"]
    print(f"phase 15: e. multihost worker over NCCL on lo: {e['line']}; {e['seconds']:.1f} s")


# phase 16: the sizes kanzi's users run.  silesia.tar's size (BASELINE.md:8,
# kanzi's own benchmark file; mixed_corpus stands in for it), -b auto (the
# file size over the jobs, app/__main__.py _parse_block_size) and kanzi's
# 1 GiB block limit (io/stream.py MAX_BITSTREAM_BLOCK_SIZE)
SILESIA_SIZE = 211_957_760
LIMIT_BLOCK = 1 << 30
LIMIT_SIZE = LIMIT_BLOCK + EDGE_TAIL        # G: S tiled, for level 1 and the SA
AUTO_JOBS = 8
BIG_BLOCK = 256 << 20                       # part c: S in one block
ANS1_BLOCK = 64 << 20                       # part c: 16 order-1 chunks a launch
SA_SIZES = (LIMIT_BLOCK, LIMIT_BLOCK - 16, SILESIA_SIZE, 64 << 20, 32 << 20, 4 << 20)
SA_THREADS = 7                              # part e: 256 MiB calls from threads
PAIR_SIZE = (2 << 30) - (128 << 20)         # part e: L, a 1 GiB block and one of 0.875
PHASE16_PARTS = "abcde"
LEVEL5 = ("TEXT+UTF+BWT+RANK+ZRLT", "ANS0")
LEVEL3 = ("TEXT+UTF+PACK+MM+LZX", "HUFFMAN")


def scale_inputs() -> tuple:
    """S, mixed_corpus(SILESIA_SIZE, seed=12), and G, S tiled to LIMIT_SIZE
    (its repeats 212 MB apart, beyond every LZ window)."""
    import numpy as np

    from kanzi_tpu_torch.utils.corpus import mixed_corpus
    s = mixed_corpus(SILESIA_SIZE, seed=12)
    return s, np.resize(s, LIMIT_SIZE)


def entropy_inputs(blob: bytes, transforms: int) -> list:
    """(the bytes its entropy stage took, stored as a copy) of each block of
    a stream whose chain has ``transforms`` functions, from the block
    headers (the mode byte, the skip flags where the chain is longer than
    four, then the transformed length, big-endian)."""
    from kanzi_tpu_torch.io import stream as port
    out = []
    with port.CompressedInputStream(io.BytesIO(blob), {}, device=None) as cis:
        while (frame := cis._frame_next()) is not None:
            head = bytes(frame[1][:8])
            mode = head[0]
            copied = bool(mode & port.COPY_BLOCK_MASK)
            skip = bool(mode & port.TRANSFORMS_MASK) and (not copied or transforms > 4)
            size = 1 + ((mode >> 5) & 3)
            out.append((int.from_bytes(head[1 + skip:1 + skip + size], "big"), copied))
    return out


def level_launches(entropy: str, transforms: int):
    """The launches the ANS0 or Huffman gates give a level's stream: one of
    each encode kernel a block whose entropy input holds four full chunks,
    and of the decode kernel a block that the decode gate sends to the card
    and the stream holds entropy-coded (every block of these inputs has a
    chunk of two or more symbols), and for ANS0 one count of the decode's
    compiled header parse (ANS0_GLUE) a block the card decodes and one of
    the encode's compiled record writer a block the card encodes."""
    def expect(blob: bytes) -> dict:
        out = dict.fromkeys(FAMILY[entropy], 0)
        for size, copied in entropy_inputs(blob, transforms):
            nfull = size // CHUNK
            enc = nfull >= 4
            dec = (enc if entropy == "ANS0" else nfull >= 1) and not copied
            for k in FAMILY[entropy]:
                out[k] += int(dec if k.endswith("_decode") else enc)
            if entropy == "ANS0":
                out[ANS0_GLUE[0]] = out.get(ANS0_GLUE[0], 0) + int(dec)
                out[ANS0_GLUE[1]] = out.get(ANS0_GLUE[1], 0) + int(enc)
        return {k: v for k, v in out.items() if v}
    return expect


def scale_stream(label: str, data: bytes, ctx: dict, dev, expect) -> dict:
    """config_stream for phase 16, with the card's peak bytes allocated and
    reserved over it (reset just before) and the MB/s of each way."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r = config_stream(label, data, ctx, dev, expect, phase="phase 16")
    r.update(label=label, peak_alloc=torch.cuda.max_memory_allocated(),
             peak_reserved=torch.cuda.max_memory_reserved(),
             mb_s=[len(data) / 1e6 / s for s in r["s"]])
    return r


def lz_launches(sizes: list, jobs: int) -> int:
    """lz_words launches of a level-1 stream under KANZI_TPU_DEVICE_LZ=1
    written in one write: the writer's batches of ``jobs`` blocks, each one
    launch a flat dispatch (blocks of one bucket, at most FLAT_GROUP and
    MAX_DISPATCH positions) and one a windowed group of GROUP_ROWS rows."""
    from kanzi_tpu_torch.ops import lz_sort as T
    total = 0
    for b0 in range(0, len(sizes), jobs):
        batch = sizes[b0:b0 + jobs]
        buckets: dict = {}
        for n in batch:
            if T.MIN_BLOCK_LENGTH <= n <= T.MAX_FLAT:
                buckets[T._flat_bucket(n)] = buckets.get(T._flat_bucket(n), 0) + 1
        for bucket, count in buckets.items():
            g = max(1, min(T.FLAT_GROUP, T.MAX_DISPATCH // bucket))
            total += -(-count // g)
        rows = sum(-(-n // T.STRIDE) for n in batch if n > T.MAX_FLAT)
        total += -(-rows // T.GROUP_ROWS)
    return total


@contextlib.contextmanager
def counted_calls(module, name: str):
    """``module.name`` replaced for a block by a wrapper that counts its
    calls; yields the list of calls."""
    fn, calls = getattr(module, name), []

    def run(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    setattr(module, name, run)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def lz_scale_stream(label: str, data, block: int, jobs: int, dev) -> dict:
    """Level 1 under KANZI_TPU_DEVICE_LZ=1 at ``block``-byte blocks, written
    at ``dev`` and at None (the host parse).  Phase 14's gates: no byte gate
    against the host parse (the windowed engine reaches back only within a
    row), the first block's first windowed group equal to a CPU run of it,
    the stream decoded at ``dev`` and at None, each block by the native LZX
    inverse (a block's sections of 256 MiB or more once fell to the Python
    mirror); lz_words launched as lz_launches gives, nothing else."""
    import torch

    from kanzi_tpu_torch.io import stream as port
    from kanzi_tpu_torch.ops import launch
    from kanzi_tpu_torch.ops import lz_sort as T
    from kanzi_tpu_torch.transforms import lz

    raw = data.tobytes()
    ctx = {"transform": "LZX", "entropy": "NONE", "blockSize": block, "jobs": jobs}
    sizes = [min(block, len(raw) - i) for i in range(0, len(raw), block)]
    r: dict = {"label": label, "bytes_in": len(raw),
               "rows": sum(-(-n // T.STRIDE) for n in sizes if n > T.MAX_FLAT)}
    with counted_calls(lz, "_lzx_inverse_py") as mirrored:
        with env_vars(KANZI_TPU_DEVICE_LZ="1"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            launch.reset_launches()
            t0 = time.perf_counter()
            blob = _compress(port.CompressedOutputStream, raw, ctx, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = _decompress(port.CompressedInputStream, blob, jobs, device=dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            got = nonzero_launches()
            r.update(peak_alloc=torch.cuda.max_memory_allocated(),
                     peak_reserved=torch.cuda.max_memory_reserved())
            check(out == raw, f"phase 16: {label}: the decode on the card differs from the input")
            del out
            emitted = got.get("lz_emit_native", 0)
            want = {"lz_words": lz_launches(sizes, jobs), "lz_dispatch": lz_launches(sizes, jobs),
                    "lz_emit_native": emitted}
            check(got == want and 0 < emitted <= len(sizes),
                  f"phase 16: {label}: launches {got}, the gate gives {want}")
            r["first_group"] = first_group(raw[:block], dev, f"phase 16: {label}",
                                           timing=False)
        t3 = time.perf_counter()
        ref = _compress(port.CompressedOutputStream, raw, ctx, device=None)
        t4 = time.perf_counter()
        out = _decompress(port.CompressedInputStream, blob, jobs, device=None)
        t5 = time.perf_counter()
        check(out == raw, f"phase 16: {label}: the host's decode differs from the input")
    check(not mirrored, f"phase 16: {label}: a decode took the Python LZX inverse "
                        f"{len(mirrored)} times, not the native one")
    s = [t1 - t0, t2 - t1, t4 - t3, t5 - t4]
    r.update(bytes_out=len(blob), host_bytes_out=len(ref), ratio=len(blob) / len(ref),
             launches=got, s=s, mb_s=[len(raw) / 1e6 / v for v in s])
    return r


def sa_device_call(x, dev, sais=None) -> dict:
    """One device SA of ``x`` (uint8, numpy) admitted by the card's budget,
    on an emptied cache: the text uploaded, prefix_doubling, the linear
    check on the card (check_suffix_array), and, with ``sais`` (SA-IS's),
    equality with it.  Its rounds, card ms (CUDA events around the admitted
    call), the peak bytes allocated and reserved over upload and call, each
    over n; the reserved peak must be within sa_bytes(n), what the budget
    admits the call by."""
    import numpy as np
    import torch

    from kanzi_tpu_torch.ops import bwt_device as B

    n = x.size
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base, base_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    text = torch.from_numpy(x).to(dev)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    with B.admitted(dev, n):
        sa, rounds = B.prefix_doubling(text, n)
    b.record()
    b.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    reserved = torch.cuda.max_memory_reserved() - base_reserved
    check(reserved <= B.sa_bytes(n), f"phase 16: e. the device SA of n = {n} reserved "
                                     f"{reserved} B, over the {B.sa_bytes(n)} B it is "
                                     f"admitted by")
    t = time.perf_counter()
    check(B.check_suffix_array(text, sa), f"phase 16: e. the device SA of n = {n} fails the "
                                          f"linear check")
    check_s = time.perf_counter() - t
    if sais is not None:
        check(np.array_equal(sa.cpu().numpy(), sais),
              f"phase 16: e. the device SA of n = {n} differs from SA-IS")
    return {"n": n, "rounds": rounds, "card_ms": a.elapsed_time(b),
            "peak_alloc": peak, "peak_reserved": reserved, "bytes_per_n": peak / n,
            "reserved_per_n": reserved / n, "check_s": check_s, "reckoned": B.sa_bytes(n)}


def sa_threads(l, dev) -> dict:
    """SA_THREADS device SAs of 256 MiB (L's first SA_THREADS x 256 MiB) from
    as many threads through suffix_array_device and the card's budget, each
    checked on the card; the most calls the budget held at once, the calls
    that waited, the seconds and the peak bytes."""
    import concurrent.futures as cf

    import torch

    from kanzi_tpu_torch.ops import bwt_device as B

    blocks = [l[i * BIG_BLOCK:(i + 1) * BIG_BLOCK] for i in range(SA_THREADS)]
    budget = B.device_budget(dev)
    budget.peak, waits = budget.in_use, budget.waits
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base, base_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with cf.ThreadPoolExecutor(SA_THREADS) as pool:
        sas = list(pool.map(lambda x: B.suffix_array_device(x, device=dev), blocks))
    threads_s = time.perf_counter() - t
    r = {"n": BIG_BLOCK, "count": SA_THREADS, "s": threads_s,
         "peak_alloc": torch.cuda.max_memory_allocated() - base,
         "peak_reserved": torch.cuda.max_memory_reserved() - base_reserved,
         "at_once": budget.peak // B.sa_bytes(BIG_BLOCK), "capacity": budget.capacity,
         "waits": budget.waits - waits}
    for x, sa in zip(blocks, sas):
        check(B.check_suffix_array(torch.from_numpy(x).to(dev), torch.from_numpy(sa).to(dev)),
              "phase 16: e. a 256 MiB device SA from the threads fails the linear check")
    return r


def sa_pair_stream(l, dev) -> dict:
    """The BWT alone (level 5's gated stage, no entropy stage) at -b 1g,
    jobs 2, on L under KANZI_TPU_DEVICE_BWT=1 at ``dev``: two device SAs of
    2^30 and L - 2^30 positions from the writer's two pool threads at once,
    which the budget admits one at a time; decoded at None, equal to L (the
    first block's transformed length, 2^30 + 33 B, is over the cap that
    kanzi_tpu's reader sets).  The SA is unique and any other gives a BWT
    that does not invert; the host's stream is not written (two SA-IS runs
    of 1 GiB take minutes)."""
    import torch

    from kanzi_tpu_torch.io import stream as port
    from kanzi_tpu_torch.ops import bwt_device as B
    from kanzi_tpu_torch.ops import launch

    raw = l.tobytes()
    ctx = {"transform": "BWT", "entropy": "NONE", "blockSize": LIMIT_BLOCK, "jobs": 2}
    budget = B.device_budget(dev)
    budget.peak, waits = budget.in_use, budget.waits
    with env_vars(KANZI_TPU_DEVICE_BWT="1"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base, base_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        launch.reset_launches()
        t0 = time.perf_counter()
        blob = _compress(port.CompressedOutputStream, raw, ctx, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = nonzero_launches()
    r = {"bytes_in": len(raw), "bytes_out": len(blob), "launches": got,
         "peak_alloc": torch.cuda.max_memory_allocated() - base,
         "peak_reserved": torch.cuda.max_memory_reserved() - base_reserved,
         "at_once": budget.peak // B.sa_bytes(LIMIT_BLOCK), "waits": budget.waits - waits}
    check(got == {"suffix_array": 2}, f"phase 16: e. the -b 1g BWT stream launched {got}")
    out = _decompress(port.CompressedInputStream, blob, 2, device=None)
    t2 = time.perf_counter()
    check(out == raw, "phase 16: e. the -b 1g BWT stream does not decode to L")
    r["s"] = [t1 - t0, t2 - t1]
    r["mb_s"] = [len(raw) / 1e6 / v for v in r["s"]]
    return r


def sa_group(s, g, dev) -> dict:
    """Part e: the device SA alone at each of SA_SIZES (G's or S's first n
    bytes), each by sa_device_call, those of 64 MiB and less also against SA-IS; then
    L = S tiled to PAIR_SIZE: sa_threads on its first 1.75 GiB and
    sa_pair_stream on all of it."""
    import numpy as np

    from kanzi_tpu_torch.ops import launch
    from kanzi_tpu_torch.utils.native_transforms import suffix_array_native

    launch.reset_launches()
    calls = []
    for n in SA_SIZES:
        x = (s if n <= s.size else g)[:n]
        calls.append(sa_device_call(x, dev, suffix_array_native(x) if n <= 64 << 20 else None))
    l = np.resize(s, PAIR_SIZE)
    threads = sa_threads(l, dev)
    got = nonzero_launches()
    check(got == {"suffix_array": len(SA_SIZES) + SA_THREADS}, f"phase 16: e. launches {got}")
    pair = sa_pair_stream(l, dev)
    got["suffix_array"] += pair["launches"]["suffix_array"]
    return {"calls": calls, "threads": threads, "pair": pair, "launches": got}


def start_auto_cli(s) -> dict:
    """Part b's CLI runs, in a thread beside the other parts: S written to a
    file, ``python -m kanzi_tpu_torch.app -c -l 5 -b auto -j 8`` under
    KANZI_TPU_DEVICE_BWT=1 at --device cuda, then at none (the two files
    equal), then ``-d`` at cuda (equal to S); each run's launch counts."""
    import shutil
    import tempfile
    import threading

    tmp = tempfile.mkdtemp(prefix="chip_smoke_scale_")
    src = os.path.join(tmp, "silesia_size.bin")
    s.tofile(src)
    res: dict = {"tmp": tmp}

    def run():
        try:
            blobs = {}
            for device in ("cuda", "none"):
                dst = os.path.join(tmp, device + ".knz")
                t = time.perf_counter()
                out, counts = run_cli(["-c", "-l", "5", "-b", "auto", "-j", str(AUTO_JOBS), "-f",
                                       "-i", src, "-o", dst, "--device", device], "1")
                res[device] = {"wall_s": time.perf_counter() - t, "out": out,
                               "launches": {k: v for k, v in counts["launches"].items() if v}}
                with open(dst, "rb") as fh:
                    blobs[device] = fh.read()
            res["equal"] = blobs["cuda"] == blobs["none"]
            res["bytes_out"] = len(blobs["cuda"])
            res["blocks"] = len(entropy_inputs(blobs["cuda"], 5))
            dst = os.path.join(tmp, "back.bin")
            t = time.perf_counter()
            out, counts = run_cli(["-d", "-j", str(AUTO_JOBS), "-f", "-i",
                                   os.path.join(tmp, "cuda.knz"), "-o", dst, "--device", "cuda"])
            res["decompress"] = {"wall_s": time.perf_counter() - t, "out": out,
                                 "launches": {k: v for k, v in counts["launches"].items() if v}}
            with open(dst, "rb") as fh:
                res["back_equal"] = fh.read() == s.tobytes()
        except Exception as e:          # re-raised by finish_auto_cli
            res["error"] = e
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    res["thread"] = threading.Thread(target=run, daemon=True)
    res["t0"] = time.perf_counter()
    res["thread"].start()
    return res


def finish_auto_cli(res: dict, block: int) -> dict:
    """Wait for start_auto_cli's runs and check them: the files equal, the
    decode equal to S, ``block``-byte blocks, one device SA, one launch of
    each ANS0 encode kernel and one compiled record write a block at cuda,
    nothing at none, one ans0_decode a block on the card's decode."""
    res["thread"].join()
    if "error" in res:
        raise res["error"]
    blocks = -(-SILESIA_SIZE // block)
    check(res["equal"], "phase 16: b. the -b auto files at --device cuda and none differ")
    check(res["back_equal"], "phase 16: b. -d --device cuda of the -b auto file differs from S")
    check(res["blocks"] == blocks, f"phase 16: b. {res['blocks']} blocks, -b auto gives {blocks}")
    want = {"suffix_array": blocks, **dict.fromkeys(ANS0_KERNELS[:3] + ANS0_GLUE[1:], blocks)}
    check(res["cuda"]["launches"] == want,
          f"phase 16: b. the CLI at cuda launched {res['cuda']['launches']}, want {want}")
    check(not res["none"]["launches"], f"phase 16: b. the CLI at none launched "
                                       f"{res['none']['launches']}")
    check(res["decompress"]["launches"] == {"ans0_decode": blocks, ANS0_GLUE[0]: blocks},
          f"phase 16: b. the CLI's decode launched {res['decompress']['launches']}")
    return {k: res[k] for k in ("cuda", "none", "decompress", "bytes_out", "blocks")} | {
        "wall_s": time.perf_counter() - res["t0"], "block": block,
        "mb_s": {"cuda": SILESIA_SIZE / 1e6 / (cli_ms(res["cuda"]["out"]) / 1e3),
                 "none": SILESIA_SIZE / 1e6 / (cli_ms(res["none"]["out"]) / 1e3),
                 "decompress": SILESIA_SIZE / 1e6 / (cli_ms(res["decompress"]["out"]) / 1e3)}}


def phase16_scale(dev, parts: str = PHASE16_PARTS) -> dict:
    """Parts a-e of phase 16 (those named in ``parts``), each group timed;
    part b's CLI runs start first and run beside the others in a thread."""
    from kanzi_tpu_torch.app.__main__ import _parse_block_size

    t = time.perf_counter()
    s, g = scale_inputs()
    out: dict = {"inputs_s": time.perf_counter() - t}
    auto = _parse_block_size("auto", SILESIA_SIZE, AUTO_JOBS)
    cli = start_auto_cli(s) if "b" in parts else None
    raw = s.tobytes()
    steps = []
    try:
        if "e" in parts:
            t = time.perf_counter()
            out["e"] = sa_group(s, g, dev)
            out["e"]["seconds"] = time.perf_counter() - t
            steps.append(out["e"])
        if "a" in parts:
            t = time.perf_counter()
            runs = []
            for (tr, ent), nfun in ((LEVEL5, 5), (LEVEL3, 5)):
                ctx = {"transform": tr, "entropy": ent, "blockSize": BLOCK, "jobs": 8}
                runs.append(scale_stream(f"a. {tr} + {ent} at 4 MiB blocks, jobs 8", raw, ctx,
                                         dev, level_launches(ent, nfun)))
            out["a"] = {"runs": runs, "seconds": time.perf_counter() - t}
            steps += runs
        if "c" in parts:
            t = time.perf_counter()
            runs = []
            for ent, block, data in (("ANS0", BIG_BLOCK, s), ("HUFFMAN", BIG_BLOCK, s),
                                     ("ANS1", ANS1_BLOCK, s[:ANS1_BLOCK + EDGE_TAIL])):
                ctx = {"transform": "NONE", "entropy": ent, "blockSize": block, "jobs": 8}
                runs.append(scale_stream(f"c. NONE + {ent} at {block}-byte blocks", data.tobytes(),
                                         ctx, dev, functools.partial(gate_launches, ent, data,
                                                                     block)))
            out["c"] = {"runs": runs, "seconds": time.perf_counter() - t}
            steps += runs
        if "b" in parts:
            t = time.perf_counter()
            out["b"] = {"level1": lz_scale_stream(f"b. LZX + NONE at -b auto ({auto} B), jobs 8",
                                                  s, auto, AUTO_JOBS, dev)}
            steps.append(out["b"]["level1"])
        if "d" in parts:
            t = time.perf_counter()
            out["d"] = lz_scale_stream(f"d. LZX + NONE at -b 1g, jobs 2", g, LIMIT_BLOCK, 2, dev)
            out["d"]["seconds"] = time.perf_counter() - t
            steps.append(out["d"])
        if cli is not None:
            t = time.perf_counter()
            out["b"]["cli"] = finish_auto_cli(cli, auto)
            out["b"]["seconds"] = out["b"]["cli"]["wall_s"]
    finally:
        if cli is not None and cli["thread"].is_alive():
            cli["thread"].join()
    launches: dict = {}
    for step in steps:
        for k, v in step["launches"].items():
            launches[k] = launches.get(k, 0) + v
    if cli is not None:
        for k, v in cli["cuda"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
        for k, v in cli["decompress"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    return out


def _scale_text(r: dict) -> str:
    m = r["mb_s"]
    return (f"{r['bytes_in']} B -> {r['bytes_out']} B; MB/s card compress {m[0]:.2f} "
            f"decompress {m[1]:.2f}, host compress {m[2]:.2f} decompress {m[3]:.2f}; peak "
            f"{r['peak_alloc']} B allocated, {r['peak_reserved']} B reserved; seconds "
            f"{' '.join(f'{v:.1f}' for v in r['s'])}; launches {r['launches']}")


def print_phase16(r: dict) -> None:
    card = card_line()
    if "e" in r:
        for c in r["e"]["calls"]:
            print(f"phase 16: e. device SA of n = {c['n']} (npad {c['n']}): {c['rounds']} "
                  f"rounds after the seed, card {c['card_ms']:.1f} ms, peak {c['peak_alloc']} B "
                  f"allocated ({c['bytes_per_n']:.2f} B a position), {c['peak_reserved']} B "
                  f"reserved ({c['reserved_per_n']:.2f} B a position; admitted by "
                  f"{c['reckoned']} B); the linear check passed on the card "
                  f"({c['check_s']:.1f} s){'; equal to SA-IS' if c['n'] <= 64 << 20 else ''}; "
                  f"card {card}")
        th = r["e"]["threads"]
        print(f"phase 16: e. {th['count']} device SAs of {th['n']} B from {th['count']} threads: "
              f"{th['s']:.1f} s, peak {th['peak_alloc']} B allocated, {th['peak_reserved']} B "
              f"reserved; at most {th['at_once']} calls admitted at once by the budget of "
              f"{th['capacity']} B, {th['waits']} waited; each passed the linear check; card "
              f"{card}")
        u = r["e"]["pair"]
        print(f"phase 16: e. BWT + NONE at -b 1g, jobs 2, under KANZI_TPU_DEVICE_BWT=1 on "
              f"{u['bytes_in']} B: {u['bytes_out']} B; MB/s card compress {u['mb_s'][0]:.2f}, "
              f"host decompress {u['mb_s'][1]:.2f} (equal to L); seconds "
              f"{' '.join(f'{v:.1f}' for v in u['s'])}; at most {u['at_once']} SA admitted at "
              f"once, {u['waits']} waited; peak {u['peak_alloc']} B allocated, "
              f"{u['peak_reserved']} B reserved; launches {u['launches']}; "
              f"{r['e']['seconds']:.1f} s for part e; card {card}")
    for key in ("a", "c"):
        for u in r.get(key, {}).get("runs", []):
            print(f"phase 16: {u['label']}: {_scale_text(u)}; equal to the host's stream, "
                  f"decoded at cuda and None; card {card}")
    for u in ([r["b"]["level1"]] if "b" in r else []) + ([r["d"]] if "d" in r else []):
        g = u["first_group"]
        print(f"phase 16: {u['label']}: {_scale_text(u)}; {u['rows']} windowed rows; "
              f"{u['ratio']:.4f} x the host parse's {u['host_bytes_out']} B; first group "
              f"({g['rows']} rows) equal to the CPU's ({g['tokens']} tokens, {g['cpu_s']:.1f} s "
              f"on the CPU); decoded at cuda and None; card {card}")
    if "b" in r and "cli" in r["b"]:
        c = r["b"]["cli"]
        print(f"phase 16: b. python -m kanzi_tpu_torch.app -c -l 5 -b auto -j {AUTO_JOBS} under "
              f"KANZI_TPU_DEVICE_BWT=1 (beside the other parts): {c['blocks']} blocks of "
              f"{c['block']} B, {SILESIA_SIZE} B -> {c['bytes_out']} B, --device cuda and none "
              f"equal; compress MB/s (the CLI's clock) cuda {c['mb_s']['cuda']:.2f} none "
              f"{c['mb_s']['none']:.2f}, -d cuda {c['mb_s']['decompress']:.2f} (equal to S); "
              f"process walls {c['cuda']['wall_s']:.1f}, {c['none']['wall_s']:.1f}, "
              f"{c['decompress']['wall_s']:.1f} s; launches cuda {c['cuda']['launches']}, -d "
              f"{c['decompress']['launches']}, none none; card {card}")
    print(f"phase 16: inputs made in {r['inputs_s']:.1f} s; launches {r['launches']}")


LZ_SPANS = ("LZ_BATCH", "LZ_CARD", "LZ_FETCH", "LZ_EMIT")


def paired(events) -> dict:
    """{kind: [(block, t0, t1, size before, size after)]} of every span in
    ``events``, each BEFORE_<kind> closed by the next AFTER_<kind> of its
    block; an unpaired event fails the run."""
    open_, out = {}, {}
    for name, block, size, t in events:
        when, _, kind = name.partition("_")
        if when not in ("BEFORE", "AFTER"):
            continue
        if when == "BEFORE":
            check((block, kind) not in open_, f"phase 17: {kind} of block {block} opened twice")
            open_[(block, kind)] = (t, size)
        else:
            check((block, kind) in open_, f"phase 17: {kind} of block {block} closed unopened")
            t0, s0 = open_.pop((block, kind))
            out.setdefault(kind, []).append((block, t0, t, s0, size))
    check(not open_, f"phase 17: unclosed spans {sorted(open_)}")
    return out


def phase17_l1_archive(dev) -> dict:
    """Level 1 (LZX + NONE) under KANZI_TPU_DEVICE_LZ=1 on the archive of
    the benchmark's l1_devlz_archive cell: its corpus, the benchmark's
    mixed_corpus(SILESIA_SIZE, seed=12) in its base order, 4 MiB blocks,
    jobs 8, through BlockCompressor at ``dev`` as the benchmark drives it
    (a warm-up of eight blocks first).  Its bytes at
    most 1.05 x the host parse's (device None); every block decoded by
    portbench/reference (worker processes, one a core) and the stream by
    the port's reader at ``dev`` and None; lz_words and lz_dispatch as
    lz_launches gives, lz_emit_native one a block handed to the C++ emitter
    (an LZ_EMIT span of the traced run).  Then the same
    compress with a listener: the LZ spans (core/events.py) per MB."""
    import dataclasses

    import torch

    from kanzi_tpu_torch.app.block_compressor import BlockCompressor
    from kanzi_tpu_torch.app.block_decompressor import BlockDecompressor
    from kanzi_tpu_torch.ops import launch
    from portbench.lib import check as bench_check
    from portbench.lib.corpus import mixed_corpus
    from portbench.lib.spans import Recorder, union
    from portbench.reference import stream as ref

    t = time.perf_counter()
    raw = mixed_corpus(SILESIA_SIZE, seed=12).tobytes()
    r: dict = {"inputs_s": time.perf_counter() - t, "bytes_in": len(raw)}
    sizes = [min(BLOCK, len(raw) - i) for i in range(0, len(raw), BLOCK)]
    mb = len(raw) / 1e6
    with env_vars(KANZI_TPU_DEVICE_LZ="1"):
        comp = BlockCompressor("LZX", "NONE", BLOCK, jobs=8, device=dev)
        comp.compress_bytes(raw[:8 * BLOCK])
        torch.cuda.synchronize()
        launch.reset_launches()
        t = time.perf_counter()
        blob = comp.compress_bytes(raw)
        torch.cuda.synchronize()
        r["compress_s"] = time.perf_counter() - t
        got = nonzero_launches()
        rec = Recorder()
        comp.listeners.append(rec)
        t0 = time.monotonic_ns()
        traced = comp.compress_bytes(raw)
        torch.cuda.synchronize()
        t1 = time.monotonic_ns()
    check(traced == blob, "phase 17: the traced compress differs from the untraced one")
    spans = paired(rec.events)
    check(set(LZ_SPANS) <= set(spans), f"phase 17: spans {sorted(spans)}")
    emits = len(spans["LZ_EMIT"])
    groups = lz_launches(sizes, 8)
    check(got == {"lz_words": groups, "lz_dispatch": groups, "lz_emit_native": emits}
          and 0 < emits <= len(sizes),
          f"phase 17: launches {got}; {groups} dispatches, {emits} blocks emitted")
    batches = spans["LZ_BATCH"]
    check(sum(u[3] for u in batches) == len(raw) and len(batches) == -(-len(sizes) // 8),
          f"phase 17: {len(batches)} LZ_BATCH spans of {sum(u[3] for u in batches)} B")
    t = time.perf_counter()
    host = BlockCompressor("LZX", "NONE", BLOCK, jobs=8, device=None).compress_bytes(raw)
    r["host_compress_s"] = time.perf_counter() - t
    check(len(blob) <= 1.05 * len(host),
          f"phase 17: {len(blob)} B is over 1.05 x the host parse's {len(host)} B")
    for name, d in (("card", dev), ("host", None)):
        t = time.perf_counter()
        back = BlockDecompressor(jobs=8, device=d).decompress_bytes(blob)
        if d is not None:
            torch.cuda.synchronize()
        r[f"decompress_{name}_s"] = time.perf_counter() - t
        check(back == raw, f"phase 17: the port's reader at {d} does not give S back")
        del back
    t = time.perf_counter()
    st = ref.parse(blob, {"transform": "LZX", "entropy": "NONE", "block_size": BLOCK,
                          "size": len(raw)})
    decoded = bench_check._decode_blocks([(dataclasses.replace(st, blocks=[]), b)
                                          for b in st.blocks])
    bad = [i for i, (status, x) in enumerate(decoded)
           if status != "ok" or x.tobytes() != raw[i * BLOCK:(i + 1) * BLOCK]]
    check(len(decoded) == len(sizes) and not bad,
          f"phase 17: the reference decodes {len(decoded)} blocks, wrong: {bad[:8]} "
          f"{[decoded[i][1] for i in bad[:2] if decoded[i][0] != 'ok']}")
    r["reference_s"] = time.perf_counter() - t

    def per_mb(ns: int) -> float:
        return ns / 1e6 / mb

    def total(kind: str) -> int:
        return sum(u[2] - u[1] for u in spans.get(kind, []))

    def covered(*kinds) -> int:
        return sum(b - a for a, b in union((u[1], u[2]) for k in kinds
                                           for u in spans.get(k, [])))

    inner = covered("LZ_CARD", "LZ_FETCH", "LZ_EMIT")
    r.update(bytes_out=len(blob), host_bytes_out=len(host), blocks=len(sizes),
             emitted=emits, dispatches=groups, batches=len(batches), launches=got,
             wall_ms_per_mb=per_mb(t1 - t0),
             ms_per_mb={"LZ_BATCH": per_mb(total("LZ_BATCH")),
                        "LZ_CARD": per_mb(total("LZ_CARD")),
                        "LZ_FETCH": per_mb(total("LZ_FETCH")),
                        "LZ_EMIT": per_mb(total("LZ_EMIT")),
                        "LZ_EMIT_union": per_mb(covered("LZ_EMIT")),
                        "batch_outside_card_fetch_emit": per_mb(total("LZ_BATCH") - inner),
                        "transform": per_mb(total("TRANSFORM")),
                        "entropy": per_mb(total("ENTROPY")),
                        "stream_self_outside_batch": per_mb(
                            (t1 - t0) - covered("LZ_BATCH", "TRANSFORM", "ENTROPY"))},
             emit_bytes=sum(u[4] for u in spans["LZ_EMIT"]),
             fetch_bytes=sum(u[3] for u in spans["LZ_FETCH"]))
    return r


def print_phase17(r: dict) -> None:
    mb = r["bytes_in"] / 1e6
    m = r["ms_per_mb"]
    print(f"phase 17: level 1 under KANZI_TPU_DEVICE_LZ=1 on the archive ({r['blocks']} blocks "
          f"of 4 MiB, jobs 8): {r['bytes_in']} B -> {r['bytes_out']} B, {r['bytes_out'] / r['bytes_in']:.5f}"
          f" of the input, {r['bytes_out'] / r['host_bytes_out']:.4f} x the host parse's "
          f"{r['host_bytes_out']} B; MB/s compress card {mb / r['compress_s']:.2f} host parse "
          f"{mb / r['host_compress_s']:.2f}, decompress card {mb / r['decompress_card_s']:.2f} "
          f"host {mb / r['decompress_host_s']:.2f}; launches {r['launches']}; card {card_line()}")
    print(f"phase 17: portbench/reference decoded all {r['blocks']} blocks to S's bytes "
          f"({r['reference_s']:.1f} s); the port's reader at cuda and None gave S back")
    print(f"phase 17: traced compress, ms per MB: wall {r['wall_ms_per_mb']:.3f}; LZ_BATCH "
          f"{m['LZ_BATCH']:.3f} ({r['batches']} batches); LZ_CARD {m['LZ_CARD']:.3f} "
          f"({r['dispatches']} dispatches); LZ_FETCH {m['LZ_FETCH']:.3f} ({r['fetch_bytes']} B); "
          f"LZ_EMIT summed {m['LZ_EMIT']:.3f}, their union on the emitter threads "
          f"{m['LZ_EMIT_union']:.3f} ({r['emitted']} blocks, {r['emit_bytes']} B); batch "
          f"outside card, fetch and emit {m['batch_outside_card_fetch_emit']:.3f}; transform "
          f"{m['transform']:.3f}, entropy {m['entropy']:.3f}; stream self outside LZ_BATCH "
          f"{m['stream_self_outside_batch']:.3f}; lz_emit_native {r['launches']['lz_emit_native']}"
          f" = LZ_EMIT spans")


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
    ap.add_argument("--mesh", action="store_true",
                    help="run phases 0-1 and 12 (the multi-GPU engine) only")
    ap.add_argument("--phase14", action="store_true",
                    help="run phases 0-1 and 14 (the device LZ paths beside phase 7) only")
    ap.add_argument("--phase15", action="store_true",
                    help="run phases 0-1 and 15 (the configuration space) only")
    ap.add_argument("--phase16", nargs="?", const=PHASE16_PARTS, metavar="PARTS",
                    help="run phases 0-1 and 16 (the sizes users run) only, or only "
                         "its parts named (of abcde)")
    ap.add_argument("--phase10", action="store_true",
                    help="run phases 0 and 10 (the device suffix array) only")
    ap.add_argument("--phase17", action="store_true",
                    help="run phases 0-1 and 17 (level 1 with the parse on the card on the "
                         "benchmark's archive) only")
    ap.add_argument("--phase2", metavar="GROUPS",
                    help="run only these comma-separated phase-2 groups (of "
                         f"{', '.join(PHASE2_GROUPS)}), then stop")
    args = ap.parse_args()
    groups = PHASE2_GROUPS if args.phase2 is None else tuple(args.phase2.split(","))
    if not set(groups) <= set(PHASE2_GROUPS + PHASE2_PARTS):
        ap.error(f"--phase2: groups are {', '.join(PHASE2_GROUPS + PHASE2_PARTS)}")
    if args.phase16 is not None and not set(args.phase16) <= set(PHASE16_PARTS):
        ap.error(f"--phase16: parts are {PHASE16_PARTS}")

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
    t = time.perf_counter()
    data = mixed_corpus(64 << 20, seed=12).tobytes()
    print(f"phase 0: corpus of {len(data)} B made in {time.perf_counter() - t:.1f} s")
    if args.phase10:
        t = time.perf_counter()
        print_phase10(phase10_sa(data, dev), t)
        return 0
    plain = None
    if not (args.mesh or args.phase10 or args.phase14 or args.phase15 or args.phase16 is not None
            or args.phase17 or args.profile) and "ans1" in groups:
        plain = start_plain_ans1(dev, data)
        print("phase 1: ans1_scan's plain version started beside the build")

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

    if args.mesh:
        t = time.perf_counter()
        print_phase12(phase12_mesh(data), {})
        print(f"phase 12: done in {time.perf_counter() - t:.1f} s")
        return 0
    if args.phase14:
        t = time.perf_counter()
        print_phase14(phase14_lz(data, dev, {}), {})
        print(f"phase 14: done in {time.perf_counter() - t:.1f} s")
        return 0
    if args.phase15:
        t = time.perf_counter()
        print_phase15(phase15_configs(dev))
        print(f"phase 15: done in {time.perf_counter() - t:.1f} s")
        return 0
    if args.phase16 is not None:
        t = time.perf_counter()
        print_phase16(phase16_scale(dev, args.phase16))
        print(f"phase 16: done in {time.perf_counter() - t:.1f} s")
        return 0
    if args.phase17:
        t = time.perf_counter()
        print_phase17(phase17_l1_archive(dev))
        print(f"phase 17: done in {time.perf_counter() - t:.1f} s")
        return 0
    if args.profile:
        print(card_line())
        print(json.dumps({"level1_profile": profile_level1(data[:32 << 20], dev)}))
        return 0
    if plain is not None:
        t = time.perf_counter()
        join_plain_ans1(plain)
        print(f"phase 2: ans1_scan's plain version ran {plain['ms'] / 1e3:.1f} s beside the "
              f"build, then {time.perf_counter() - t:.1f} s more")
    t = time.perf_counter()
    if "floor" in groups:
        print("phase 2: the floor of the card-alone times, an empty kernel queued as the "
              "kernels are: " + ", ".join(f"{v:.4f} ms at {k} threads"
                                          for k, v in card_floor(dev).items()))
    kern = phase2_kernels(dev, data, groups, plain)
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
        print(f"phase 2: ksort at {shape}: kernel {a['ms']:.4f} ms ({a['device_ms']:.4f} on "
              f"the card alone), plain {a['plain_ms']:.4f} "
              f"ms, library call {a['library_ms']:.4f} ms, bound {a['bound_ms']:.4f} ms "
              f"({a['bound_by']}); {a['passes']} passes, alone: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in a["pass_ms"].items()))
    print(f"phase 2: done in {time.perf_counter() - t:.1f} s")
    if args.quick or args.phase2 is not None:
        return 0

    launches = dict.fromkeys(REPLACES, 0)
    prior = {}
    for label, transform, entropy, names, dec in (
            ("phase 3: ANS0 alone", "NONE", "ANS0", ANS0_KERNELS, "ans0_decode"),
            ("phase 4: level 5", "TEXT+UTF+BWT+RANK+ZRLT", "ANS0", ANS0_KERNELS, "ans0_decode"),
            ("phase 5: Huffman alone", "NONE", "HUFFMAN", HUFFMAN_KERNELS, "huffman_decode"),
            ("phase 6: level 3", "TEXT+UTF+PACK+MM+LZX", "HUFFMAN", HUFFMAN_KERNELS,
             "huffman_decode")):
        t = time.perf_counter()
        r = stream_phase(label, data, transform, entropy, dev, kern, names, dec)
        prior[label.split(":")[0]] = r
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
    prior["phase 7"] = r
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
    t = time.perf_counter()
    print_phase10(phase10_sa(data, dev), t)
    t = time.perf_counter()
    r = phase11_cli(data)

    def note(a, way):
        ms = a[way + "_startup_ms"]
        return (f" (process wall {a[way + '_wall_ms']:.1f} ms"
                + ("" if ms is None else f", card start-up before the CLI's clock {ms:.1f} ms")
                + ")")

    for name, a in r["runs"].items():
        dec = (f", decompress MB/s {a['decompress_mb_s']:.4f}{note(a, 'decompress')} with "
               f"ans0_decode launches {a['decode_launches']}" if "decompress_mb_s" in a else "")
        print(f"phase 11: CLI -l 5 -j 8 --device {name.replace('_device_bwt', '')}"
              f"{' with KANZI_TPU_DEVICE_BWT=1' if 'bwt' in name else ''}: compress MB/s "
              f"{a['compress_mb_s']:.4f}{note(a, 'compress')}{dec}; device SA calls "
              f"{a['sa_calls']}, ANS0 launches {a['launches']}")
    print(f"phase 11: {r['bytes_in']} B -> {r['bytes_out']} B ({r['blocks']} blocks), the "
          f"three .knz files identical, -d on the card and on the host give back the input, "
          f"-y prints the header; {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    r12 = phase12_mesh(data)
    print_phase12(r12, prior)
    print(f"phase 12: done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    r13 = phase13_v1(data, dev, prior)
    print_phase13(r13, prior)
    print(f"phase 13: done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    r14 = phase14_lz(data, dev, prior)
    print_phase14(r14, prior)
    print(f"phase 14: done in {time.perf_counter() - t:.1f} s")
    kern["lz_words"]["at"] = {f"({r14['first_group']['rows']}, 262144)":
                              r14["first_group"]["lz_words"]}
    t = time.perf_counter()
    r15 = phase15_configs(dev)
    print_phase15(r15)
    print(f"phase 15: done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    r16 = phase16_scale(dev)
    print_phase16(r16)
    print(f"phase 16: done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    r17 = phase17_l1_archive(dev)
    print_phase17(r17)
    print(f"phase 17: done in {time.perf_counter() - t:.1f} s")
    for step in [*r12["launches"].values(), *r13["launches"].values(),
                 *r14["launches"].values(), r15["launches"], r16["launches"], r17["launches"]]:
        for k, v in step.items():
            if k in launches:
                launches[k] += v

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
