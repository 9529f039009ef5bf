"""Multi-GPU block engine: blocks shard over the ranks of a torch.distributed
process group, one rank for each device.

Counterpart of kanzi_tpu/parallel/engine.py.  The reference's only parallel
axis is independent blocks over a thread pool
(K/io/CompressedOutputStream.java:512-586, ordered commit); kanzi_tpu shards
the chunk axis of a block batch over a 1-D ``blocks`` mesh in one process
(shard_map).  PyTorch's idiom for several GPUs is one process for each
device, so here the mesh is a process group: rank r computes its shard on
its own device (``cuda:{r % device_count}``, or ``cpu``), the ordered-commit
metadata (per-chunk lengths, consumed byte counts, per-shard token counts)
is all-gathered first, and the payloads follow, each rank's populated
prefix only (a power-of-two width every rank knows from the lengths).
NCCL carries the collectives on the GPUs, gloo on the CPU; under gloo a
CUDA rank stages its tensors through host memory (``Mesh.comm_device``).

Two layers:

  - the SPMD steps (``make_pipeline_step``, ``compress_step``,
    ``train_step``, ``make_decode_step``, ``make_sa_step``,
    ``make_l1_step``): every rank calls the step with its own shard of
    rows, as each process of kanzi_tpu's multihost.py feeds its local
    shard; every rank gets the gathered result.  A rank whose local work
    raises still joins the first gather, with a nonzero status word, so
    that every rank raises ``MeshError`` instead of waiting forever;
  - the stream paths (``mesh_ans0_compress``, ``mesh_ans0_decompress``,
    ``mesh_decompress``, ``mesh_l5_compress``, ``mesh_l1_compress``): every
    rank calls them; rank 0 drives and the other ranks serve.  The stream
    writer and reader call their hooks from pool threads in no fixed
    order, so only rank 0 runs them; each hook call takes
    ``MESH_DISPATCH_LOCK``, broadcasts a small int64 header (the op, the
    rows of each rank, the widths), scatters the rows and runs the step
    with every other rank, which loops in ``serve``.  Rank 0 sends the stop
    op in a ``finally``, flagged when it stops on an error, so a corrupt
    stream raises on every rank instead of hanging them.  These functions
    return rank 0's result on rank 0 and None elsewhere.

Batches pad to a multiple of the world size as kanzi_tpu pads them, and the
pad rows are dropped after the gather.  The CUDA kernels take 16 KiB ANS0
chunks only (the writer's size); the plain versions, on ``cpu``, any power
of two, as kanzi_tpu's XLA path does.
"""

from __future__ import annotations

import contextlib
import io as _io
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core.bits import BitReader, BitWriter
from ..ops import ans_cuda, bwt_device, launch
from ..ops import lz_sort as L
from ..ops.ans_block import decode_ans0_wire, encode_ans0_wire
from ..utils.device import check_device

CHUNK = ans_cuda.CHUNK
LOG_RANGE = ans_cuda.LOG_RANGE

# Serializes rank 0's dispatches, issued from the stream writer's and
# reader's pool threads (the entropy hooks of entropy/ans.py): every rank
# must issue the same collectives in the same order.  Reentrant, so that a
# hook may hold it around a function that dispatches.  One dispatch a block;
# batching the blocks of a write is later work (ROADMAP G4).
MESH_DISPATCH_LOCK = threading.RLock()

# the ops of the dispatch header
OP_STOP, OP_ENCODE, OP_DECODE, OP_SA, OP_L1 = range(5)
HEADER = 4                  # op, rows a rank, two widths


class MeshError(RuntimeError):
    """A step failed on some rank; raised on every rank of the mesh."""


class Mesh:
    """One rank's view of the 1-D ``blocks`` mesh: the process group
    (``None``: the default group), this rank, the world size and this
    rank's device.  ``stats`` maps a name to [seconds, calls, bytes]: each
    gather (its metadata and its payloads apart, the copy to the host
    included) and each pass of level 5."""

    def __init__(self, group, rank: int, size: int, device: torch.device,
                 backend: str) -> None:
        self.group = group
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        # NCCL moves device tensors; gloo moves host tensors
        self.comm_device = device if "nccl" in backend else torch.device("cpu")
        self.stats: dict[str, list] = {}
        self._driving = False

    def clock(self, name: str, seconds: float, nbytes: int = 0) -> None:
        s = self.stats.setdefault(name, [0.0, 0, 0])
        s[0] += seconds
        s[1] += 1
        s[2] += nbytes

    def __repr__(self) -> str:
        return (f"Mesh(rank {self.rank} of {self.size}, {self.device}, "
                f"{self.backend})")


def make_mesh(n_devices: int | None = None, *, device, group=None) -> Mesh:
    """This rank's mesh over ``group`` (default: the whole world, which the
    caller, ``torchrun`` or parallel/dryrun.py initialised).  ``device``
    ``cuda`` gives rank r the card ``cuda:{r % device_count}``, and raises
    without a card; ``cpu`` the host.  A world of another size than
    ``n_devices`` raises: a silently short mesh invalidates every
    measurement built on it; so does a mix of ``cuda`` and ``cpu`` ranks.
    Every rank of the group calls it."""
    dev = check_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group: call "
                           "torch.distributed.init_process_group first")
    size = dist.get_world_size(group)
    if n_devices is not None and size != n_devices:
        raise ValueError(f"make_mesh({n_devices}): the process group has "
                         f"{size} ranks; the mesh is the whole group")
    backend = str(dist.get_backend(group))
    if dev.type == "cuda":
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    elif backend == "nccl":
        raise ValueError("make_mesh: an NCCL group needs device 'cuda'")
    mesh = Mesh(group, dist.get_rank(group), size, dev, backend)
    # one device type on every rank, so that a step's checks (the chunk
    # width) pass or fail alike on all ranks, ahead of any collective
    kind = torch.tensor([int(dev.type == "cuda")], device=mesh.comm_device)
    kinds = [torch.empty_like(kind) for _ in range(size)]
    dist.all_gather(kinds, kind, group=group)
    if len({int(k) for k in kinds}) > 1:
        raise ValueError("make_mesh: the ranks' devices differ (cuda and cpu)")
    return mesh


# ---------------------------------------------------------------------------
# collectives (every rank issues the same ones, of the same sizes, in order)
# ---------------------------------------------------------------------------

def _sync(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _all_gather(mesh: Mesh, t: torch.Tensor, name: str) -> np.ndarray:
    """``t`` of every rank (one shape and dtype on all), concatenated along
    dim 0 in rank order, on the host."""
    _sync(mesh)
    t0 = time.perf_counter()
    src = t.to(mesh.comm_device).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat(parts).cpu().numpy()
    mesh.clock(name, time.perf_counter() - t0, out.nbytes)
    return out


def _attempt(fn):
    """(fn(), None), or (None, the exception) when it raises."""
    try:
        return fn(), None
    except Exception as e:
        return None, e


def _meta(mesh: Mesh, what: str, width: int, err, meta) -> np.ndarray:
    """All-gather each rank's ``width`` int64 metadata words after a status
    word, the first gather of every step.  A rank whose local work raised
    (``err``) sends status 1, and then every rank raises MeshError (chained
    to its own error there), so no rank waits on a gather that will not
    come.  Returns (world, width) int64."""
    buf = torch.zeros((1, width + 1), dtype=torch.int64)
    if err is None:
        buf[0, 1:] = torch.as_tensor(meta).reshape(-1).to("cpu", torch.int64)
    else:
        buf[0, 0] = 1
    rows = _all_gather(mesh, buf, f"{what} lengths")
    failed = np.flatnonzero(rows[:, 0]).tolist()
    if failed:
        raise MeshError(f"mesh {what} step failed on rank(s) {failed}") from err
    return rows[:, 1:]


def _pack(*ts: torch.Tensor) -> torch.Tensor:
    """Row-aligned tensors as one (rows, bytes) uint8 tensor: one gather
    carries them all, in a type every backend moves."""
    return torch.cat([t.contiguous().view(torch.uint8).reshape(t.shape[0], -1)
                      for t in ts], 1)


def _unpack(rows: np.ndarray, specs) -> list:
    """Inverse of ``_pack`` on the host: (dtype, width) per part."""
    out, at = [], 0
    for dt, w in specs:
        nb = np.dtype(dt).itemsize * w
        out.append(np.ascontiguousarray(rows[:, at:at + nb]).view(dt))
        at += nb
    return out


def _width(n: int) -> int:
    """The power of two at or above ``n`` (at least 2)."""
    return 1 << max(int(n) - 1, 1).bit_length()


_TORCH = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int32): torch.int32,
          np.dtype(np.int64): torch.int64}


def _to(mesh: Mesh, a, dtype) -> torch.Tensor:
    """``a`` (numpy or a tensor) on this rank's device, as ``dtype``."""
    if isinstance(a, torch.Tensor):
        return a.to(mesh.device, _TORCH[np.dtype(dtype)])
    return launch.to_device(a, mesh.device, dtype)


def _check_chunk(mesh: Mesh, chunk: int) -> None:
    if chunk < 4 or chunk & (chunk - 1):
        raise ValueError(f"chunk {chunk} must be a power of two for device stats")
    if mesh.device.type == "cuda" and chunk != CHUNK:
        raise ValueError(f"chunk {chunk}: the CUDA kernels take {CHUNK}-byte "
                         "ANS0 chunks only")


# ---------------------------------------------------------------------------
# the SPMD steps: each rank passes its own rows
# ---------------------------------------------------------------------------

def _encode_gathered(mesh: Mesh, what: str, run, n: int):
    """Run ``run()`` -> (freq, payload, n_emit, states) tensors on this
    rank's ``n`` rows (its input conversion included, so that any local
    failure reaches the status word), gather the lengths, then each row's
    table, states and populated payload prefix.  Returns numpy (freq (N,
    256) i32, payload (N, w) u16, lengths (N,) i32, states (N, 4) i32) of
    all N rows."""
    out, err = _attempt(run)
    lengths = _meta(mesh, what, n, err, None if err else out[2]).reshape(-1)
    freq, payload, _, states = out
    w = min(_width(lengths.max(initial=0)), payload.shape[1])
    rows = _all_gather(mesh, _pack(freq.to(torch.int32), states.to(torch.int32),
                                   payload[:, :w]), f"{what} payloads")
    freq, states, payload = _unpack(rows, [(np.int32, 256), (np.int32, 4),
                                           (np.uint16, w)])
    return freq, payload, lengths.astype(np.int32), states


def compress_step(mesh: Mesh, chunks, freq, cum):
    """Block-batch ANS0 compression with given tables.  This rank's rows:
    chunks uint8 (n, C), freq/cum (n, 256).  Returns (payload (N, w) u16,
    lengths (N,) i32, states (N, 4) i32) of all N rows of the mesh, on
    every rank; w is a power of two at or above every length, and words
    past a row's length are 0."""
    def run():
        fr = _to(mesh, freq, np.int32)
        tables = ans_cuda.pack_tables(fr, _to(mesh, cum, np.int32))
        words, flags, states = ans_cuda.encode_scan(_to(mesh, chunks, np.uint8), tables)
        payload, n_emit = ans_cuda.compact(words, flags)
        return fr, payload, n_emit, states

    _, payload, lengths, states = _encode_gathered(mesh, "compress", run, len(chunks))
    return payload, lengths, states


def train_step(mesh: Mesh, chunks, freq, cum):
    """compress_step and the mesh's total payload bytes, summed by an
    all_reduce (kanzi_tpu's psum): (payload, lengths, states, total_bytes)."""
    payload, lengths, states = compress_step(mesh, chunks, freq, cum)
    n = len(chunks)
    local = lengths[mesh.rank * n:(mesh.rank + 1) * n]
    total = torch.tensor([2 * int(local.sum())], dtype=torch.int64,
                         device=mesh.comm_device)
    dist.all_reduce(total, group=mesh.group)
    return payload, lengths, states, int(total.item())


def make_pipeline_step(mesh: Mesh, chunk: int):
    """The full ANS0 entropy stage over the mesh: on each rank its rows'
    histogram and exact normalisation, the 4-state rANS scan and the
    compaction (ops/ans_cuda.py: the kernels on ``cuda``, their plain
    versions on ``cpu``), then the gathers.  step(this rank's chunks uint8
    (n, chunk)) -> (freq (N, 256) i32, payload (N, w) u16, lengths (N,) i32,
    states (N, 4) i32) of all N rows, on every rank (``_encode_gathered``)."""
    _check_chunk(mesh, chunk)

    def step(chunks):
        return _encode_gathered(
            mesh, "encode",
            lambda: ans_cuda.encode_chunks_tensors(_to(mesh, chunks, np.uint8)),
            len(chunks))
    return step


def make_decode_step(mesh: Mesh, maxp: int, chunk: int = CHUNK):
    """Sharded ANS0 decode: step(this rank's payload uint8 (n, maxp),
    lengths (n,) i32, states (n, 4) int64, freq/cum (n, 256) i32) -> (out
    uint8 (N, chunk), consumed (N,) int64) of all N rows, on every rank.
    The headers are parsed on rank 0 in stream order; the payloads, the
    expensive part, decode on the ranks (ans_cuda.decode)."""
    _check_chunk(mesh, chunk)

    def step(payload, lengths, states, freq, cum):
        out, err = _attempt(lambda: ans_cuda.decode(
            _to(mesh, payload, np.uint8), _to(mesh, lengths, np.int32),
            _to(mesh, states, np.int64), _to(mesh, freq, np.int32),
            _to(mesh, cum, np.int32), width=chunk))
        used = _meta(mesh, "decode", len(payload), err,
                     None if err else out[1]).reshape(-1)
        return _all_gather(mesh, out[0], "decode payloads"), used
    return step


def make_sa_step(mesh: Mesh, npad: int):
    """Sharded suffix arrays (level 5's BWT forward): step(this rank's rows
    uint8 (n, npad), each a block's BWT input zero-padded to ``npad``, and
    their lengths (n,)) -> the SAs int32 (N, npad) of all N rows, on every
    rank.  Each row runs ops/bwt_device.py's prefix doubling on the rank's
    device over its n real bytes, each admitted by the device's byte
    budget as one call is; a row's SA is its first n entries, the rest -1.
    Any correct SA gives the identical BWT."""
    def step(glob, ns):
        def run():
            g = _to(mesh, glob, np.uint8)
            if g.shape[1] != npad:
                raise ValueError(f"rows of {g.shape[1]} bytes, expected {npad}")
            sas, rounds = [], []
            for k, n in enumerate(torch.as_tensor(ns).tolist()):
                with bwt_device.admitted(g.device, int(n)):
                    sa, r = bwt_device.prefix_doubling(g[k], int(n))
                row = torch.full((npad,), -1, dtype=torch.int32, device=g.device)
                row[:int(n)] = sa
                sas.append(row)
                rounds.append(r)
            return torch.stack(sas), rounds

        out, err = _attempt(run)
        _meta(mesh, "sa", len(ns), err, None if err else out[1])
        return _all_gather(mesh, out[0], "sa payloads")
    return step


def make_l1_step(mesh: Mesh, mm: int = 4):
    """Sharded LZX analysis (the whole-block engine of ops/lz_sort.py,
    ``_analyze_flat``): step(this rank's blocks uint8 (n, bucket), src_end
    (n,) = size - 18, max_dist (n,)) -> (pk, dist, counts): each rank's
    tokens in position order, int32 (world, w) with the first counts[s] of
    row s real, positions local to that rank's shard of n * bucket."""
    def step(bufs, send, mdist):
        out, err = _attempt(lambda: L._analyze_flat(
            _to(mesh, bufs, np.uint8), _to(mesh, send, np.int64),
            _to(mesh, mdist, np.int64), mm))
        counts = _meta(mesh, "l1", 1, err, None if err else [out[2]]).reshape(-1)
        w = _width(counts.max())
        tok = torch.zeros((2, w), dtype=torch.int32, device=mesh.device)
        tok[0, :out[2]] = out[0]
        tok[1, :out[2]] = out[1]
        rows = _all_gather(mesh, _pack(tok.reshape(1, 2 * w)), "l1 payloads")
        pk, dist_ = _unpack(rows, [(np.int32, w), (np.int32, w)])
        return pk, dist_, counts
    return step


# ---------------------------------------------------------------------------
# the dispatch: rank 0 drives, the other ranks serve
# ---------------------------------------------------------------------------

def _inputs(op: int, rows: int, w) -> list:
    """(shape, dtype) of each tensor a rank receives for ``op``."""
    if op == OP_ENCODE:
        return [((rows, w[0]), torch.uint8)]
    if op == OP_DECODE:
        return [((rows, w[0]), torch.uint8), ((rows,), torch.int32),
                ((rows, 4), torch.int64), ((rows, 256), torch.int32),
                ((rows, 256), torch.int32)]
    if op == OP_SA:
        return [((rows, w[0]), torch.uint8), ((rows,), torch.int64)]
    if op == OP_L1:
        return [((rows, w[0]), torch.uint8), ((rows,), torch.int64),
                ((rows,), torch.int64)]
    raise ValueError(f"unknown mesh op {op}")


def _run(mesh: Mesh, op: int, w, args):
    if op == OP_ENCODE:
        return make_pipeline_step(mesh, w[0])(*args)
    if op == OP_DECODE:
        return make_decode_step(mesh, w[0], w[1])(*args)
    if op == OP_SA:
        return make_sa_step(mesh, w[0])(*args)
    return make_l1_step(mesh, w[1])(*args)


def _scatter(mesh: Mesh, full: torch.Tensor | None, shape, dtype) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=mesh.comm_device)
    parts = None
    if mesh.rank == 0:
        parts = [p.contiguous() for p in full.to(mesh.comm_device).chunk(mesh.size)]
    dist.scatter(out, parts, src=0, group=mesh.group)
    return out


def _header(op: int, rows: int = 0, widths=()) -> torch.Tensor:
    h = torch.zeros(HEADER, dtype=torch.int64)
    h[:2 + len(widths)] = torch.tensor([op, rows, *widths])
    return h


def _dispatch(mesh: Mesh, op: int, widths: tuple, arrays: tuple):
    """Rank 0: run ``op`` over the mesh on ``arrays`` (the whole batch, its
    rows a multiple of the world size): broadcast the header, scatter the
    rows, run the step with every rank.  Everything that can fail on the
    host is checked before the header goes out."""
    with MESH_DISPATCH_LOCK:
        if not mesh._driving:
            raise RuntimeError("mesh dispatch outside a driven call: the other "
                               "ranks do not serve (call a mesh_* function)")
        rows = arrays[0].shape[0]
        if rows % mesh.size:
            raise ValueError(f"{rows} rows do not split over {mesh.size} ranks")
        ts = [launch.to_device(a, "cpu") for a in arrays]
        specs = _inputs(op, rows // mesh.size, widths)
        for t, (shape, dt) in zip(ts, specs):
            if t.dtype != dt or tuple(t.shape[1:]) != shape[1:]:
                raise TypeError(f"mesh op {op}: got {t.dtype} {tuple(t.shape)}, "
                                f"expected {dt} {shape}")
        dist.broadcast(_header(op, rows // mesh.size, widths).to(mesh.comm_device),
                       0, group=mesh.group)
        local = [_scatter(mesh, t, shape, dt) for t, (shape, dt) in zip(ts, specs)]
        return _run(mesh, op, widths, local)


def serve(mesh: Mesh) -> None:
    """Ranks above 0: run each step whose header rank 0 broadcasts, on this
    rank's shard, until the stop op.  A step that fails here has told every
    rank through its status word (rank 0 raises and stops the mesh); the
    first such error is raised after the stop, and so is a stop that rank 0
    sent on an error of its own."""
    if mesh.rank == 0:
        raise ValueError("rank 0 drives the mesh; it does not serve")
    first_error = None
    while True:
        header = torch.empty(HEADER, dtype=torch.int64, device=mesh.comm_device)
        dist.broadcast(header, 0, group=mesh.group)
        op, arg, *w = header.tolist()      # arg: the rows a rank, or the stop's flag
        if op == OP_STOP:
            break
        local = [_scatter(mesh, None, shape, dt) for shape, dt in _inputs(op, arg, w)]
        try:
            _run(mesh, op, w, local)
        except Exception as e:
            first_error = first_error or e
    if first_error is not None:
        raise first_error
    if arg:
        raise MeshError("rank 0 stopped the mesh on an error")


@contextlib.contextmanager
def _driving(mesh: Mesh):
    """Rank 0's side of a driven call: dispatches are open inside; the stop
    op goes out in any case, flagged when leaving on an error."""
    with MESH_DISPATCH_LOCK:
        mesh._driving = True
    failed = True
    try:
        yield
        failed = False
    finally:
        with MESH_DISPATCH_LOCK:
            mesh._driving = False
            dist.broadcast(_header(OP_STOP, int(failed)).to(mesh.comm_device), 0,
                           group=mesh.group)


def _drive(mesh: Mesh, fn, *args):
    """Every rank calls this: rank 0 runs ``fn(*args)`` and returns its
    result; the other ranks serve and return None."""
    if mesh.rank != 0:
        serve(mesh)
        return None
    with _driving(mesh):
        return fn(*args)


# ---------------------------------------------------------------------------
# the ANS0 stage
# ---------------------------------------------------------------------------

def ans0_wire(mesh: Mesh, block: np.ndarray, chunk: int = CHUNK) -> bytes:
    """Rank 0's side of mesh_ans0_compress, which the entropy hook calls from
    the writer's threads: the exact ANSRangeEncoder wire of ``block``
    (ops/ans_block.py ``encode_ans0_wire``), the full chunks over the mesh,
    padded to a multiple of the world size by repeating the last one."""
    _check_chunk(mesh, chunk)

    def rows(chunks):
        n = chunks.shape[0]
        npad = (-n) % mesh.size
        if npad:  # pad the batch to the mesh size; padded rows are dropped
            chunks = np.concatenate([chunks, np.repeat(chunks[-1:], npad, axis=0)])
        return [a[:n] for a in _dispatch(mesh, OP_ENCODE, (chunk,), (chunks,))]

    bw = BitWriter()
    encode_ans0_wire(block, bw, rows, chunk)
    return bw.getvalue()


def mesh_ans0_compress(mesh: Mesh, block, chunk: int = CHUNK) -> bytes | None:
    """Compress ``block`` (rank 0's) through the mesh ANS0 stage: the exact
    ANSRangeEncoder wire bytes (decodable by entropy.ans.ANSRangeDecoder
    with ``chunk_size=chunk``) on rank 0, None elsewhere."""
    return _drive(mesh, ans0_wire, mesh, block, chunk)


def mesh_ans0_decode_stream(mesh: Mesh, br: BitReader, count: int,
                            chunk: int = CHUNK) -> np.ndarray:
    """Rank 0, inside a driven call: decode an ANSRangeEncoder order-0
    stream from ``br`` (any bit position) with the chunk payloads sharded
    over the mesh (ops/ans_block.py ``decode_ans0_wire``, kanzi_tpu's mesh
    rule: a non-default log range raises BitStreamError).  The rows pad to a
    multiple of the world size with a zero payload and a valid table, and
    the payload width to a power of two at least 8 bytes past the longest."""
    _check_chunk(mesh, chunk)

    def rows(pay, lens, states, freq, cum):
        n, p = pay.shape
        nrows = n + (-n) % mesh.size
        maxp = max(256, _width(p + 8))
        pay_p = np.zeros((nrows, maxp), dtype=np.uint8)
        pay_p[:n, :p] = pay
        fr = np.zeros((nrows, 256), dtype=np.int64)
        fr[:, 0] = 1 << LOG_RANGE          # valid tables for the pad rows
        fr[:n] = freq
        st = np.zeros((nrows, 4), dtype=np.int64)
        st[:n] = states
        ln = np.zeros(nrows, dtype=np.int32)
        ln[:n] = lens
        res, used = _dispatch(mesh, OP_DECODE, (maxp, chunk),
                              (pay_p, ln, st, fr.astype(np.int32),
                               (np.cumsum(fr, axis=1) - fr).astype(np.int32)))
        return res[:n], used[:n]

    return decode_ans0_wire(count, br, rows, chunk, host_log_ranges=False)


def mesh_ans0_decompress(mesh: Mesh, wire, count: int,
                         chunk: int = CHUNK) -> np.ndarray | None:
    """Decode rank 0's order-0 ``wire`` of ``count`` bytes with the chunk
    payloads sharded over the mesh: the bytes on rank 0, None elsewhere."""
    return _drive(mesh, lambda: mesh_ans0_decode_stream(mesh, BitReader(wire),
                                                        count, chunk))


def mesh_decompress(mesh: Mesh, blob, jobs: int | None = None) -> bytes | None:
    """Decode a complete v7 .knz stream (rank 0's) with every ANS0 entropy
    payload's chunk decode sharded over the mesh through the ctx hook
    (entropy/ans.py ANSRangeDecoder.decode); the standard reader, on the
    host, drives block framing, transform inverses and checksums.  The
    bytes on rank 0, None elsewhere."""
    from ..io.stream import CompressedInputStream

    def run():
        ctx: dict = {"_ans0_mesh": mesh}
        if jobs:
            ctx["jobs"] = jobs
        with CompressedInputStream(_io.BytesIO(blob), ctx, device=None) as cis:
            return cis.read(-1)
    return _drive(mesh, run)


# ---------------------------------------------------------------------------
# level 5: the suffix arrays and the ANS0 stage on the mesh
# ---------------------------------------------------------------------------

def _l5_compress(mesh: Mesh, data: np.ndarray, block_size: int, checksum: int,
                 jobs: int | None) -> bytes:
    from ..core.types import TransformSkip
    from ..io.stream import MAX_CONCURRENCY, CompressedOutputStream
    from ..transforms import factory as tf
    from ..utils.xxhash import xxhash64

    data = np.asarray(data, dtype=np.uint8)
    nblocks = max(1, -(-data.size // block_size))

    # pass A (host): each block's TEXT+UTF prefix, the bytes the writer's
    # chain feeds the BWT (same ctx: the text codec variant follows the
    # entropy id); the writer's Sequence reuses them through _chain_prefix
    t0 = time.perf_counter()
    pre = []
    prefix_map: dict = {}
    for bid in range(nblocks):
        blk = data[bid * block_size:(bid + 1) * block_size]
        ctx_a = {"entropy": "ANS0", "blockSize": block_size, "size": blk.size}
        seq_a = tf.new_function(ctx_a, tf.get_type("TEXT+UTF"))
        try:
            tub = seq_a.forward(blk)
        except TransformSkip:
            tub = blk
        tub = np.asarray(tub, dtype=np.uint8)
        pre.append(tub)
        prefix_map[(blk.size, xxhash64(blk.tobytes(), 0))] = (tub, seq_a.skip_flags, 2)
    t1 = time.perf_counter()
    mesh.clock("l5 pass A", t1 - t0)

    # pass B (mesh): suffix arrays, one padded block a rank a dispatch,
    # bucketed by padded length
    sa_map: dict[tuple[int, int], np.ndarray] = {}
    ndev = mesh.size
    by_bucket: dict[int, list[int]] = {}
    for bid, tub in enumerate(pre):
        if tub.size >= 4:
            by_bucket.setdefault(bwt_device._bucket(tub.size + 1), []).append(bid)
    for npad, bids in sorted(by_bucket.items()):
        for g0 in range(0, len(bids), ndev):
            grp = bids[g0:g0 + ndev]
            rows = len(grp) + (-len(grp)) % ndev
            glob = np.zeros((rows, npad), np.uint8)
            ns = np.full(rows, pre[grp[-1]].size, np.int64)   # pad rows
            for k, bid in enumerate(grp):
                glob[k, :pre[bid].size] = pre[bid]
                ns[k] = pre[bid].size
            if rows > len(grp):   # pad rows repeat the last real block
                glob[len(grp):] = glob[len(grp) - 1]
            sa_rows = _dispatch(mesh, OP_SA, (npad,), (glob, ns))
            for k, bid in enumerate(grp):
                n = pre[bid].size
                sa_map[(n, xxhash64(pre[bid].tobytes(), 0))] = \
                    sa_rows[k][:n].astype(np.int64)
    t2 = time.perf_counter()
    mesh.clock("l5 pass B", t2 - t1)

    # pass C: the standard v7 writer on the host; the BWT takes its SA from
    # the map, the ANS0 stage dispatches to the mesh (both through ctx)
    sink = _io.BytesIO()
    cos = CompressedOutputStream(sink, {
        "entropy": "ANS0", "transform": "TEXT+UTF+BWT+RANK+ZRLT",
        "blockSize": block_size,
        "jobs": min(jobs or MAX_CONCURRENCY, MAX_CONCURRENCY, nblocks),
        "checksum": checksum, "fileSize": data.size}, device=None)
    cos.ctx["_bwt_sa_map"] = sa_map
    cos.ctx["_ans0_mesh"] = mesh
    cos.ctx["_chain_prefix"] = prefix_map
    cos.write(data.tobytes())
    cos.close()
    mesh.clock("l5 pass C", time.perf_counter() - t2)
    return sink.getvalue()


def mesh_l5_compress(mesh: Mesh, data, block_size: int = 4 << 20,
                     checksum: int = 0, jobs: int | None = None) -> bytes | None:
    """Compress rank 0's ``data`` at level 5 (TEXT+UTF+BWT+RANK+ZRLT +
    ANS0, BlockCompressor.java:539 row 5) with both heavy stages sharded
    over the mesh: every block's suffix array up front (pass B), and each
    block's ANS0 stage from the writer's threads; the light filters
    (TEXT/UTF, RANK/ZRLT) and the writer stay on the host.  Each block's
    ANS0 wire is appended byte-aligned, so the stream is kanzi_tpu's mesh
    stream, up to 4 bytes a block longer than the host writer's.  The
    stream on rank 0, None elsewhere."""
    return _drive(mesh, _l5_compress, mesh, data, block_size, checksum, jobs)


# ---------------------------------------------------------------------------
# level 1: the LZX engine on the mesh
# ---------------------------------------------------------------------------

def _l1_batch_arrays(blocks, live, ndev: int, bucket: int | None = None):
    """The (bufs, send, mdist, bucket, nb) batch of the sharded LZX stage over
    the ``live`` block indices, padded with zero rows (src_end -18: no
    tokens) to a multiple of ``ndev``."""
    if bucket is None:
        bucket = L._flat_bucket(max(blocks[i].size for i in live))
    nb = len(live) + (-len(live)) % ndev
    bufs = np.zeros((nb, bucket), np.uint8)
    send = np.full(nb, -18, np.int64)
    mdist = np.zeros(nb, np.int64)
    for j, i in enumerate(live):
        bufs[j, :blocks[i].size] = blocks[i]
        send[j] = blocks[i].size - 18
        mdist[j] = L._block_max_dist(blocks[i].size)
    return bufs, send, mdist, bucket, nb


def tokens_to_hints(blocks, live, hints, pk, dist_, counts, bucket: int, nb: int,
                    ndev: int, mm: int):
    """Each live block's stream-writer hint (mm, LZX section bytes or None)
    from the gathered tokens (pk/dist_ (ndev, w), the first counts[s] of
    row s real, positions local to shard s of nb / ndev blocks).  Host
    numpy, for the dispatch and for multihost.py's SPMD run alike."""
    span = (nb // ndev) * bucket            # positions a shard
    ps, ls, ds = [], [], []
    for s in range(ndev):
        k = int(counts[s])
        if k == 0:
            continue
        p_s, l_s = L._unpack_tokens(pk[s, :k])
        ps.append(p_s + s * span)
        ls.append(l_s)
        ds.append(dist_[s, :k].astype(np.int64))
    if not ps:
        return hints
    p = np.concatenate(ps)
    l_ = np.concatenate(ls)
    d = np.concatenate(ds)
    for j, i in enumerate(live):
        lo, hi = np.searchsorted(p, [j * bucket, (j + 1) * bucket])
        if hi > lo:
            hints[i] = (mm, L._emit_block(blocks[i], mm, p[lo:hi] - j * bucket,
                                          l_[lo:hi].copy(), d[lo:hi]))
    return hints


def _l1_mesh_hints(mesh: Mesh, chunks, mm: int = 4):
    """Rank 0: the sharded LZX stage over one write's blocks, in batches of
    at most MAX_DISPATCH positions a rank (the packed tokens' bound); the
    per-block stream-writer hints [(mm, payload or None)]."""
    from ..ops.lz_emit import MIN_BLOCK_LENGTH

    ndev = mesh.size
    blocks = [np.asarray(b, dtype=np.uint8) for b in chunks]
    hints = [(mm, None)] * len(blocks)
    live = [i for i, b in enumerate(blocks) if MIN_BLOCK_LENGTH <= b.size <= L.MAX_FLAT]
    if not live:
        return hints
    bucket = L._flat_bucket(max(blocks[i].size for i in live))
    per = ndev * max(1, L.MAX_DISPATCH // bucket)
    for g0 in range(0, len(live), per):
        grp = live[g0:g0 + per]
        bufs, send, mdist, _, nb = _l1_batch_arrays(blocks, grp, ndev, bucket)
        pk, dist_, counts = _dispatch(mesh, OP_L1, (bucket, mm), (bufs, send, mdist))
        tokens_to_hints(blocks, grp, hints, pk, dist_, counts, bucket, nb, ndev, mm)
    return hints


def _l1_compress(mesh: Mesh, data: np.ndarray, block_size: int, checksum: int,
                 jobs: int | None) -> bytes:
    from ..io.stream import MAX_CONCURRENCY, CompressedOutputStream

    data = np.asarray(data, dtype=np.uint8)
    nblocks = max(1, -(-data.size // block_size))
    sink = _io.BytesIO()
    cos = CompressedOutputStream(sink, {
        "entropy": "NONE", "transform": "LZX", "blockSize": block_size,
        "jobs": min(jobs or MAX_CONCURRENCY, MAX_CONCURRENCY, nblocks),
        "checksum": checksum, "fileSize": data.size}, device=None)
    cos._lz_hint_fn = lambda chunks: _l1_mesh_hints(mesh, chunks, 4)
    cos.write(data.tobytes())
    cos.close()
    return sink.getvalue()


def mesh_l1_compress(mesh: Mesh, data, block_size: int = 4 << 20,
                     checksum: int = 0, jobs: int | None = None) -> bytes | None:
    """Compress rank 0's ``data`` at level 1 (LZX + NONE) with the per-block
    LZX analysis sharded over the mesh; a complete v7 .knz stream (header,
    block framing, copy fallbacks, optional checksums) on rank 0, None
    elsewhere.  ``jobs`` bounds the blocks of one write, hence of one
    dispatch."""
    return _drive(mesh, _l1_compress, mesh, data, block_size, checksum, jobs)
