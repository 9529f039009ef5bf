"""What decides ``correct``: five counts, each held to the limit 0.

``warmup_bad``
    warm-up round trips (the same calls as the window's) that raised or
    did not give their input back.
``failed``
    requests whose compress or decompress call raised.
``roundtrip_bad``
    requests whose decompressed bytes differ from the bytes sent
    (every request of the window, compared whole).
``frame_bad``
    streams that the reference (``portbench/reference``) refuses on
    their header or framing, read in full: the configured codec, chain,
    block size and length, each block's bit length, header and header
    checksum, the number of blocks, the end-of-stream block.
``block_bad``
    blocks that the reference's own decoders (entropy stage, inverse
    transforms) do not turn back into the bytes sent.  They are drawn
    from the seed among all blocks of the window's streams: the first
    block of the longest request, then one at each other position of a
    batch of ``jobs`` blocks in flight (block index mod jobs) that the
    streams have, then any.  The blocks are decoded in worker
    processes, one a core, since the decoders are Python loops.

The round trip alone would pass a stream that only the port reads; the
reference holds the stream to kanzi's format.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..reference import stream as ref

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORKER_TIMEOUT_S = 240

LIMITS = {"warmup_bad": 0, "failed": 0, "roundtrip_bad": 0, "frame_bad": 0, "block_bad": 0}


def reference_checks(records, config: dict, seed: int, ref_blocks: int,
                     log) -> dict:
    """``records``: (request bytes, compressed stream or None) of every
    request of the window, in order."""
    t0 = time.monotonic()
    bs = int(config["block_size"])
    parsed = []
    frame_bad = 0
    for i, (data, comp) in enumerate(records):
        if comp is None:
            continue
        try:
            st = ref.parse(comp, {"entropy": config["entropy"],
                                  "transform": config["transform"],
                                  "block_size": bs, "size": len(data)})
        except (ref.StreamError, EOFError) as e:
            frame_bad += 1
            log(f"reference: request {i}: {e}")
            continue
        parsed.append((i, st))
    block_bad = 0
    picks = _pick(records, parsed, seed, ref_blocks, int(config["jobs"]))
    decoded = _decode_blocks([(dataclasses.replace(st, blocks=[]), st.blocks[b])
                              for _, st, b in picks])
    for (i, st, b), (status, got) in zip(picks, decoded):
        data = records[i][0]
        want = np.frombuffer(data, np.uint8)[b * bs:(b + 1) * bs]
        if status != "ok":              # any failure to decode is a fault
            block_bad += 1
            log(f"reference: request {i} block {b}: {got}")
            continue
        if got.size != want.size or not np.array_equal(got, want):
            block_bad += 1
            diff = int(np.count_nonzero(got[:want.size] != want[:got.size]))
            log(f"reference: request {i} block {b}: {got.size} B decoded, "
                f"{want.size} B sent, {diff} differ")
    log(f"reference: {len(parsed)} streams framed, {len(picks)} blocks decoded, "
        f"{time.monotonic() - t0:.2f} s")
    return {"frame_bad": frame_bad, "block_bad": block_bad}


def _pick(records, parsed, seed: int, k: int, jobs: int):
    if not parsed or k <= 0:
        return []
    longest = max(parsed, key=lambda p: len(records[p[0]][0]))
    pool = [(i, st, b) for i, st in parsed for b in range(len(st.blocks))
            if (i, b) != (longest[0], 0)]
    order = np.random.default_rng([seed, 11]).permutation(len(pool)).tolist()
    taken = []
    for slot in range(1, jobs):
        j = next((j for j in order if pool[j][2] % jobs == slot), None)
        if j is not None and len(taken) < k - 1:
            taken.append(j)
    taken += [j for j in order if j not in taken][:k - 1 - len(taken)]
    rest = sorted(taken, key=lambda j: (pool[j][0], pool[j][2]))
    return [(longest[0], longest[1], 0)] + [pool[j] for j in rest]


def _decode_blocks(tasks: list) -> list:
    """("ok", bytes) or ("error", why) for each (stream, block) pair, in
    order; the pairs are dealt to one worker process a core."""
    if not tasks:
        return []
    n = min(len(tasks), os.cpu_count() or 1)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)

    def work(group):
        try:
            p = subprocess.run([sys.executable, "-m", __name__], input=pickle.dumps(group),
                               capture_output=True, cwd=ROOT, env=env,
                               timeout=WORKER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            return [("error", f"no answer in {WORKER_TIMEOUT_S} s")] * len(group)
        if p.returncode:
            why = p.stderr.decode(errors="replace").strip().splitlines()[-1:] or ["?"]
            return [("error", f"worker exited {p.returncode}: {why[0]}")] * len(group)
        return pickle.loads(p.stdout)

    with ThreadPoolExecutor(n) as ex:
        outs = list(ex.map(work, [tasks[j::n] for j in range(n)]))
    return [outs[t % n][t // n] for t in range(len(tasks))]


def _worker() -> None:
    out = []
    for st, blk in pickle.load(sys.stdin.buffer):
        try:
            out.append(("ok", ref.decode_block(st, blk)))
        except Exception as e:              # reported, counted by the caller
            out.append(("error", f"{type(e).__name__}: {e}"))
    pickle.dump(out, sys.stdout.buffer)


if __name__ == "__main__":
    _worker()
