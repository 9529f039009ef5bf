"""Burrows-Wheeler Transform with multi-chunk primary indexes, plus the
block codec framing.

Re-derived from K/transform/BWT.java:57-686, BWTBlockCodec.java:29-225 and
DivSufSort.java:204-329.  The BWT layout (no sentinel):

  out[0] = src[n-1]; L-column from the suffix array skipping the primary
  row; 8 primary indexes when n >= 256 (1 otherwise):
  indexes[k] = rank(suffix at k*step) + 1 with step = n/8 rounded up when
  8 does not divide n.  Any correct suffix array yields the identical BWT.

Block codec header: mode byte (log2(chunks) << 2 | pIndexSize-1) followed by
chunks primary indexes of pIndexSize bytes each (big-endian, value-1).

The suffix array comes from the C++ SA-IS kernel; the fallback is a numpy
prefix-doubling SA (O(n log^2 n) sorts).  Under ``KANZI_TPU_DEVICE_BWT=1``
a block of at least 64 KiB on a stream with a torch device takes the
prefix-doubling SA of ops/bwt_device.py on that device instead.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.globals import log2
from ..core.types import TransformSkip
from ..utils import native_transforms as nt

MAX_BLOCK_SIZE = 1024 * 1024 * 1024
ASSEMBLE_SLICE = 1 << 24        # positions a slice of _assemble_forward
BLOCK_SIZE_THRESHOLD1 = 256
BWT_MAX_HEADER_SIZE = 1 + 8 * 4


def get_bwt_chunks(size: int) -> int:
    return 1 if size < BLOCK_SIZE_THRESHOLD1 else 8


def suffix_array(src: np.ndarray) -> np.ndarray:
    """Suffix array; native SA-IS or numpy prefix doubling."""
    res = nt.suffix_array_native(src)
    if res is not None:
        return res
    return _suffix_array_doubling(src)


def _suffix_array_doubling(src: np.ndarray) -> np.ndarray:
    """Prefix-doubling SA: rank pairs (rank[i], rank[i+k]) sorted per round.
    Suffix semantics: shorter suffix that is a prefix of another sorts first
    (pad with -1 beyond the end)."""
    n = src.size
    rank = src.astype(np.int64)
    k = 1
    idx = np.arange(n, dtype=np.int64)
    while True:
        rank2 = np.full(n, -1, dtype=np.int64)
        rank2[:n - k] = rank[k:]
        order = np.lexsort((rank2, rank))
        pair = np.stack([rank[order], rank2[order]])
        new = np.ones(n, dtype=np.int64)
        new[0] = 0
        if n > 1:
            new[1:] = (pair[0, 1:] != pair[0, :-1]) | (pair[1, 1:] != pair[1, :-1])
        ranks_sorted = np.cumsum(new) - new[0] * 0
        rank = np.empty(n, dtype=np.int64)
        rank[order] = ranks_sorted
        if int(rank.max()) == n - 1:
            break
        k <<= 1
        if k >= n:
            break
    sa = np.empty(n, dtype=np.int32)
    sa[rank] = idx
    return sa


class BWT:
    def __init__(self, ctx: dict | None = None) -> None:
        self.primary_indexes = [0] * 8
        self._ctx = ctx

    def get_primary_index(self, n: int) -> int:
        return self.primary_indexes[n]

    def set_primary_index(self, n: int, value: int) -> bool:
        if value < 0 or n < 0 or n >= 8:
            return False
        self.primary_indexes[n] = value
        return True

    def max_encoded_len(self, src_len: int) -> int:
        return src_len

    def forward(self, src: np.ndarray) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        n = src.size
        if n == 0:
            return src.copy()
        if n > MAX_BLOCK_SIZE:
            raise TransformSkip("BWT: block too large")
        if n == 1:
            self.primary_indexes[0] = 1
            return src.copy()
        chunks = get_bwt_chunks(n)
        # a caller may hand over suffix arrays computed ahead of the
        # writer's workers, keyed by (length, content hash); any correct SA
        # yields the identical BWT, and a miss just computes locally
        sa_map = (self._ctx or {}).get("_bwt_sa_map")
        if sa_map:
            from ..utils.xxhash import xxhash64
            sa = sa_map.get((n, xxhash64(src.tobytes(), 0)))
            if sa is not None and sa.size == n:
                return self._assemble_forward(src, sa.astype(np.int64),
                                              chunks)
        # the suffix array on the stream's torch device (ops/bwt_device.py),
        # opt-in with KANZI_TPU_DEVICE_BWT; with no device (the host coders)
        # the variable is ignored.  Any correct SA yields the identical BWT,
        # so the wire is unchanged; a failure on the device raises
        device = (self._ctx or {}).get("_device")
        if (device is not None and n >= 65536
                and os.environ.get("KANZI_TPU_DEVICE_BWT", "0") == "1"):
            from ..ops.bwt_device import suffix_array_device
            sa = suffix_array_device(src, device=device)
            return self._assemble_forward(src, sa, chunks)
        # leftover thread budget from the encode task (1 when blocks
        # already saturate the cores, more when a lone block has the
        # machine to itself) threads the SA's data-parallel phases
        jobs = int((self._ctx or {}).get("jobs", 1))
        res = nt.bwt_forward_native(src, chunks, jobs=jobs)
        if res is not None:
            dst, indexes = res
            self.primary_indexes[:len(indexes)] = [int(x) for x in indexes]
            return dst
        # numpy fallback
        sa = suffix_array(src).astype(np.int64)
        return self._assemble_forward(src, sa, chunks)

    def _assemble_forward(self, src: np.ndarray, sa: np.ndarray,
                          chunks: int) -> np.ndarray:
        """The BWT of ``src`` from its suffix array, in slices of
        ASSEMBLE_SLICE positions: beside ``sa`` (as int32) it holds the
        output and one slice's temporaries, so a 1 GiB block takes no
        int64 array of its length."""
        n = src.size
        st = n // chunks
        step = st + 1 if st * chunks != n else st
        sa = np.asarray(sa, dtype=np.int32)         # n <= MAX_BLOCK_SIZE < 2^31
        # the rank of each chunk's first position: where sa holds it
        starts = np.zeros(chunks, dtype=np.int64)
        for a in range(0, n, ASSEMBLE_SLICE):
            part = sa[a:a + ASSEMBLE_SLICE]
            for t in np.flatnonzero(part % step == 0):
                starts[part[t] // step] = a + t
        for k in range(chunks):
            self.primary_indexes[k] = int(starts[k]) + 1
        p_idx = int(starts[0])
        # the last column, src[sa - 1], shifted one place right up to the
        # primary index (sa == 0 there; its byte, src[n - 1], comes first)
        dst = np.empty(n, dtype=np.uint8)
        dst[0] = src[n - 1]
        for a in range(0, n, ASSEMBLE_SLICE):
            b = min(a + ASSEMBLE_SLICE, n)
            l_col = src[sa[a:b] - 1]
            m = min(b, p_idx)
            if m > a:
                dst[a + 1:m + 1] = l_col[:m - a]
            lo = max(a, p_idx + 1)
            if b > lo:
                dst[lo:b] = l_col[lo - a:]
        return dst

    def inverse(self, src: np.ndarray, count: int | None = None) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        n = src.size
        if n == 0:
            return src.copy()
        if n == 1:
            return src.copy()
        chunks = get_bwt_chunks(n)
        # the 8-chain walk threads up to the ctx job budget (the stream
        # layer leaves 1 when blocks already saturate the cores, more when
        # a lone block has the machine to itself — BWT.java:568-674)
        jobs = int((self._ctx or {}).get("jobs", 0)) or 0
        res = nt.bwt_inverse_native(src, self.primary_indexes, chunks,
                                    jobs=jobs)
        if res is not None:
            return res
        return self._inverse_numpy(src, chunks)

    def _inverse_numpy(self, src: np.ndarray, chunks: int) -> np.ndarray:
        """mergeTPSI with vectorized table construction and log-doubling
        chain walk (numpy fallback; also the TPU kernel's dataflow)."""
        n = src.size
        p_idx = self.primary_indexes[0]
        if p_idx <= 0 or p_idx > n:
            raise ValueError("BWT: invalid primary index")
        order = np.argsort(src, kind="stable").astype(np.int64)
        # packed successor index per TPSI slot
        idx = np.where(order < p_idx, order - 1, order)
        # the i==0 slot terminates the cycle; keep its successor in-bounds
        # for the vectorized doubling walk (never semantically followed)
        idx[order == 0] = 0
        nxt = np.empty(n, dtype=np.int64)
        nxt = idx  # data[k] = idx of predecessor slot
        vals = src[order]
        # walk chains via pointer doubling (orbit enumeration)
        if chunks != 8:
            starts = [p_idx - 1]
            lengths = [n]
            ck = n
        else:
            ck = (n >> 3) if (n & 7) == 0 else (n >> 3) + 1
            starts = [self.primary_indexes[k] - 1 for k in range(8)]
            lengths = [ck] * 7 + [n - 7 * ck]
        out = np.empty(n, dtype=np.uint8)
        for k, (st, ln) in enumerate(zip(starts, lengths)):
            pos = np.zeros(1, dtype=np.int64) + st
            chain = [st]
            # doubling enumeration
            j = nxt.copy()
            cur = np.array([st], dtype=np.int64)
            acc = cur
            while acc.size < ln:
                nxt_pos = j[acc]
                acc = np.concatenate([acc, nxt_pos])
                if acc.size < ln:
                    j = j[j]
            acc = acc[:ln]
            out[k * ck:k * ck + ln] = vals[acc]
        return out


class BWTBlockCodec:
    """BWT + header framing (mode byte + primary indexes)."""

    def __init__(self, ctx: dict | None = None) -> None:
        self.bwt = BWT(ctx)
        self.bs_version = (ctx or {}).get("bsVersion", 7)

    def max_encoded_len(self, src_len: int) -> int:
        return src_len + BWT_MAX_HEADER_SIZE

    def forward(self, src: np.ndarray) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        n = src.size
        if n == 0:
            return src.copy()
        log_bs = log2(n)
        if n & (n - 1):
            log_bs += 1
        p_index_size = (log_bs + 7) >> 3
        if not 0 < p_index_size < 5:
            raise TransformSkip("BWT: block size out of range")
        chunks = get_bwt_chunks(n)
        log_chunks = log2(chunks)
        data = self.bwt.forward(src)
        header = bytearray()
        header.append((log_chunks << 2) | (p_index_size - 1))
        for i in range(chunks):
            pi = self.bwt.get_primary_index(i) - 1
            for shift in range((p_index_size - 1) * 8, -1, -8):
                header.append((pi >> shift) & 0xFF)
        return np.concatenate([np.frombuffer(bytes(header), dtype=np.uint8), data])

    def inverse(self, src: np.ndarray, count: int | None = None) -> np.ndarray:
        src = np.asarray(src, dtype=np.uint8)
        if src.size == 0:
            return src.copy()
        if self.bs_version <= 5:
            return self._inverse_v5(src, count)
        mode = int(src[0])
        log_chunks = (mode >> 2) & 0x07
        p_index_size = (mode & 0x03) + 1
        chunks = 1 << log_chunks
        header_size = 1 + chunks * p_index_size
        if src.size < header_size:
            raise ValueError("BWT: truncated header")
        if chunks != get_bwt_chunks(src.size - header_size):
            raise ValueError("BWT: chunk count mismatch")
        pos = 1
        for i in range(chunks):
            pi = 0
            for _ in range(p_index_size):
                pi = (pi << 8) | int(src[pos])
                pos += 1
            if pi >= 0x7FFFFFFF:
                raise ValueError("BWT: invalid primary index")
            if not self.bwt.set_primary_index(i, pi + 1):
                raise ValueError("BWT: invalid primary index")
        return self.bwt.inverse(src[header_size:], count)

    def _inverse_v5(self, src: np.ndarray, count: int | None) -> np.ndarray:
        """Pre-v6 framing: one (mode + primary index) header per chunk, the
        chunk count derived from the full block size and the index packed
        into the mode byte's low 6 bits (BWTBlockCodec.java:186-209)."""
        chunks = get_bwt_chunks(src.size)
        pos = 0
        length = src.size
        for i in range(chunks):
            block_mode = int(src[pos])
            pos += 1
            p_index_size = 1 + ((block_mode >> 6) & 0x03)
            if length < p_index_size:
                raise ValueError("BWT: truncated legacy header")
            length -= p_index_size
            shift = (p_index_size - 1) << 3
            pi = (block_mode & 0x3F) << shift
            for _ in range(1, p_index_size):
                shift -= 8
                pi |= int(src[pos]) << shift
                pos += 1
            if not self.bwt.set_primary_index(i, pi):
                raise ValueError("BWT: invalid primary index")
        return self.bwt.inverse(src[pos:], count)
