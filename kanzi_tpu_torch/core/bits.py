"""Bit-level I/O for the kanzi v7 bitstream format.

Wire contract (re-derived from the reference's bitstream layer,
K/bitstream/DefaultOutputBitStream.java:103-125 and DefaultInputBitStream.java):
bits are emitted MSB-first; a multi-bit value of ``count`` bits is emitted with
its bit ``count-1`` first.  Bytes on the wire are therefore plain big-endian
bit packing of the logical bit sequence.

Unlike the reference (a streaming 64-bit accumulator), this implementation is
array-first: writers accumulate *segments* (scalar value/count pairs, vectors
of value/count pairs, or raw byte payloads with a bit length) and the final
byte image is produced with a single vectorized pack.  This shape matches how
the TPU kernels produce output: byte-aligned per-chunk buffers plus small
headers, merged once at the end.
"""

from __future__ import annotations

import numpy as np

_U64 = np.uint64
_MASK64 = (1 << 64) - 1


def pack_msb(values: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Pack ``values[i]`` (low ``counts[i]`` bits, MSB-first) into a bit array.

    Returns a uint8 array of 0/1 bits of length ``counts.sum()``.
    """
    values = np.asarray(values, dtype=_U64)
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.uint8)
    item = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    ends = np.cumsum(counts)
    starts = ends - counts
    pos = np.arange(total, dtype=np.int64) - starts[item]
    shift = (counts[item] - 1 - pos).astype(_U64)
    return ((values[item] >> shift) & _U64(1)).astype(np.uint8)


def mask_tail(seg: np.ndarray, nbits: int) -> np.ndarray:
    """Zero any bits of ``seg`` past ``nbits`` (copying only if needed)."""
    nbytes = (nbits + 7) >> 3
    seg = seg[:nbytes]
    pad = nbytes * 8 - nbits
    if pad and nbytes and (seg[-1] & ((1 << pad) - 1)):
        seg = seg.copy()
        seg[-1] &= (0xFF << pad) & 0xFF
    return seg


def append_packed(out: np.ndarray, bitpos: int, seg: np.ndarray, nbits: int) -> int:
    """OR-merge a packed MSB-first segment into ``out`` at bit offset ``bitpos``.

    ``out`` must be zero beyond ``bitpos``; ``seg`` holds ``nbits`` bits with a
    zero-padded tail (see :func:`mask_tail`).  Returns the new bit offset.
    This is the vectorized equivalent of the reference's 64-bit accumulator
    loop (DefaultOutputBitStream.java:103-206) for whole buffers.
    """
    if nbits == 0:
        return bitpos
    seg = mask_tail(seg, nbits)
    k = bitpos & 7
    byte0 = bitpos >> 3
    if k == 0:
        out[byte0:byte0 + seg.size] |= seg
    else:
        wide = np.zeros(seg.size + 2, dtype=np.uint16)
        wide[1:-1] = seg
        shifted = (((wide[:-1] << (8 - k)) | (wide[1:] >> k)) & 0xFF).astype(np.uint8)
        need = (k + nbits + 7) >> 3
        out[byte0:byte0 + need] |= shifted[:need]
    return bitpos + nbits


def pack_pairs(values: np.ndarray, counts: np.ndarray) -> tuple[np.ndarray, int]:
    """Pack (value, count) pairs MSB-first into (bytes, nbits)."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.uint8), 0
    if counts.size <= 64:
        acc = 0
        for v, c in zip(np.asarray(values, dtype=_U64).tolist(), counts.tolist()):
            acc = (acc << c) | (int(v) & ((1 << c) - 1))
        nbytes = (total + 7) >> 3
        acc <<= nbytes * 8 - total
        return np.frombuffer(acc.to_bytes(nbytes, "big"), dtype=np.uint8), total
    return np.packbits(pack_msb(values, counts)), total


def bits_to_bytes(bits: np.ndarray) -> np.ndarray:
    """Pack a 0/1 uint8 bit array MSB-first into bytes (zero-padded tail)."""
    return np.packbits(bits)


def bytes_to_bits(data: np.ndarray, nbits: int | None = None) -> np.ndarray:
    """Unpack bytes into a 0/1 uint8 bit array, MSB-first."""
    bits = np.unpackbits(np.asarray(data, dtype=np.uint8))
    if nbits is not None:
        bits = bits[:nbits]
    return bits


class BitWriter:
    """MSB-first bit writer producing an in-memory byte image.

    Segments are deferred; ``getvalue()`` performs one vectorized pack.
    """

    __slots__ = ("_segments", "_nbits", "_pend_vals", "_pend_cnts")

    def __init__(self) -> None:
        self._segments: list[tuple[str, object]] = []
        self._nbits = 0
        self._pend_vals: list[int] = []
        self._pend_cnts: list[int] = []

    # -- writing ---------------------------------------------------------

    def write_bit(self, bit: int) -> None:
        self.write_bits(bit & 1, 1)

    def write_bits(self, value: int, count: int) -> None:
        """Write the low ``count`` (0..64) bits of ``value``, MSB-first."""
        if count == 0:
            return
        if not 0 < count <= 64:
            raise ValueError(f"invalid bit count {count}")
        self._pend_vals.append(value & _MASK64 if count == 64 else value & ((1 << count) - 1))
        self._pend_cnts.append(count)
        self._nbits += count

    def write_bits_vec(self, values: np.ndarray, counts: np.ndarray) -> None:
        """Vectorized write of many (value, count) pairs."""
        counts = np.asarray(counts, dtype=np.int64)
        if counts.size == 0:
            return
        self._flush_pending()
        self._segments.append(("v", (np.asarray(values, dtype=_U64), counts)))
        self._nbits += int(counts.sum())

    def write_bytes(self, data, nbits: int | None = None) -> None:
        """Append a byte buffer as ``nbits`` bits (default: all of it)."""
        arr = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data.astype(np.uint8, copy=False)
        n = arr.size * 8 if nbits is None else int(nbits)
        if n == 0:
            return
        if n > arr.size * 8:
            raise ValueError("nbits exceeds buffer size")
        self._flush_pending()
        self._segments.append(("b", (arr, n)))
        self._nbits += n

    def write_bit_array(self, bits: np.ndarray) -> None:
        """Append a 0/1 uint8 bit array verbatim."""
        bits = np.asarray(bits, dtype=np.uint8)
        if bits.size == 0:
            return
        self._flush_pending()
        self._segments.append(("a", bits))
        self._nbits += bits.size

    # -- finalization ----------------------------------------------------

    @property
    def written(self) -> int:
        """Total bits written so far."""
        return self._nbits

    def _flush_pending(self) -> None:
        if self._pend_vals:
            vals = np.array(self._pend_vals, dtype=_U64)
            cnts = np.array(self._pend_cnts, dtype=np.int64)
            self._segments.append(("v", (vals, cnts)))
            self._pend_vals = []
            self._pend_cnts = []

    def getvalue(self) -> bytes:
        """Byte image; the last byte is zero-padded (reference pads with 0s
        on close, DefaultOutputBitStream.java:253-293)."""
        self._flush_pending()
        # Fast path: single aligned byte segment.
        out_bits = np.zeros(self._nbits, dtype=np.uint8)
        pos = 0
        for kind, payload in self._segments:
            if kind == "v":
                vals, cnts = payload
                seg = pack_msb(vals, cnts)
            elif kind == "a":
                seg = payload
            else:
                arr, n = payload
                seg = np.unpackbits(arr)[:n]
            out_bits[pos:pos + seg.size] = seg
            pos += seg.size
        return np.packbits(out_bits).tobytes()

    def getvalue_bits(self) -> np.ndarray:
        self._flush_pending()
        segs = []
        for kind, payload in self._segments:
            if kind == "v":
                vals, cnts = payload
                segs.append(pack_msb(vals, cnts))
            elif kind == "a":
                segs.append(payload)
            else:
                arr, n = payload
                segs.append(np.unpackbits(arr)[:n])
        if not segs:
            return np.zeros(0, dtype=np.uint8)
        return np.concatenate(segs)

    def extend(self, other: "BitWriter") -> None:
        """Append another writer's segments without re-packing."""
        other._flush_pending()
        self._flush_pending()
        self._segments.extend(other._segments)
        self._nbits += other._nbits

    def getvalue_packed(self) -> tuple[np.ndarray, int]:
        """Packed byte image + exact bit count, without bit expansion.

        The hot path for block assembly: byte segments are merged with one
        vectorized shift each instead of expanding to 1-byte-per-bit arrays.
        """
        self._flush_pending()
        out = np.zeros((self._nbits + 7) >> 3, dtype=np.uint8)
        bitpos = 0
        for kind, payload in self._segments:
            if kind == "v":
                seg, n = pack_pairs(*payload)
            elif kind == "a":
                seg, n = np.packbits(payload), payload.size
            else:
                arr, n = payload
                seg = arr
            bitpos = append_packed(out, bitpos, seg, n)
        return out, self._nbits


class BitReader:
    """MSB-first bit reader over an in-memory byte buffer."""

    __slots__ = ("_data", "_pos", "_nbits")

    def __init__(self, data, nbits: int | None = None, bitpos: int = 0) -> None:
        if isinstance(data, np.ndarray):
            self._data = data.astype(np.uint8, copy=False)
        else:
            self._data = np.frombuffer(bytes(data), dtype=np.uint8)
        self._nbits = self._data.size * 8 if nbits is None else int(nbits)
        self._pos = bitpos

    @property
    def read_count(self) -> int:
        return self._pos

    @property
    def remaining(self) -> int:
        return self._nbits - self._pos

    def seek(self, bitpos: int) -> None:
        self._pos = bitpos

    def read_bit(self) -> int:
        return self.read_bits(1)

    def read_bits(self, count: int) -> int:
        """Read ``count`` (0..64) bits MSB-first, returned as an int."""
        if count == 0:
            return 0
        if count < 0 or count > 64:
            raise ValueError(f"invalid bit count {count}")
        pos = self._pos
        if pos + count > self._nbits:
            raise EOFError("bitstream exhausted")
        self._pos = pos + count
        b0 = pos >> 3
        b1 = (pos + count + 7) >> 3
        chunk = int.from_bytes(self._data[b0:b1].tobytes(), "big")
        tail = (b1 << 3) - (pos + count)
        return (chunk >> tail) & ((1 << count) - 1)

    def read_bits_vec(self, counts: np.ndarray) -> np.ndarray:
        """Vectorized read of len(counts) values with per-item bit widths.

        Requires max(counts) <= 56 (values straddle at most 8 bytes).
        """
        counts = np.asarray(counts, dtype=np.int64)
        if counts.size == 0:
            return np.zeros(0, dtype=_U64)
        total = int(counts.sum())
        if self._pos + total > self._nbits:
            raise EOFError("bitstream exhausted")
        ends = np.cumsum(counts) + self._pos
        starts = ends - counts
        # read 8 bytes ending at each item's end (clamped)
        data = self._data
        padded = np.concatenate([np.zeros(8, dtype=np.uint8), data, np.zeros(8, dtype=np.uint8)])
        byte_end = (ends + 7) >> 3
        # gather 8 bytes [byte_end-8, byte_end) from padded (offset +8)
        idx = byte_end[:, None] + np.arange(8, dtype=np.int64)[None, :]  # padded idx
        window = padded[idx]  # (n, 8) bytes, big-endian value ends at window end
        vals = window.astype(_U64)
        weights = (_U64(1) << (np.arange(7, -1, -1, dtype=_U64) * _U64(8)))
        chunk = (vals * weights[None, :]).sum(axis=1, dtype=_U64)
        tail = ((byte_end << 3) - ends).astype(_U64)
        mask = np.where(counts >= 64, _U64(_MASK64), (_U64(1) << counts.astype(_U64)) - _U64(1))
        out = (chunk >> tail) & mask
        self._pos += total
        return out

    def read_bit_array(self, nbits: int) -> np.ndarray:
        """Read ``nbits`` bits as a 0/1 uint8 array."""
        pos = self._pos
        if pos + nbits > self._nbits:
            raise EOFError("bitstream exhausted")
        self._pos = pos + nbits
        b0 = pos >> 3
        b1 = (pos + nbits + 7) >> 3
        bits = np.unpackbits(self._data[b0:b1])
        off = pos - (b0 << 3)
        return bits[off:off + nbits]

    def read_packed(self, nbits: int) -> np.ndarray:
        """Read ``nbits`` bits as a packed byte array (zero-padded tail)."""
        pos = self._pos
        if pos + nbits > self._nbits:
            raise EOFError("bitstream exhausted")
        nbytes = (nbits + 7) >> 3
        sh = pos & 7
        b0 = pos >> 3
        if sh == 0:
            out = self._data[b0:b0 + nbytes].copy()
        else:
            raw = self._data[b0:b0 + nbytes + 1].astype(np.uint16)
            if raw.size < nbytes + 1:
                raw = np.concatenate([raw, np.zeros(nbytes + 1 - raw.size, dtype=np.uint16)])
            out = (((raw[:-1] << sh) | (raw[1:] >> (8 - sh))) & 0xFF).astype(np.uint8)
        self._pos = pos + nbits
        pad = nbytes * 8 - nbits
        if pad and nbytes:
            out[-1] &= (0xFF << pad) & 0xFF
        return out

    def read_bytes(self, nbytes: int) -> np.ndarray:
        """Bulk read of nbytes; works at any bit alignment."""
        pos = self._pos
        if pos + nbytes * 8 > self._nbits:
            raise EOFError("bitstream exhausted")
        self._pos = pos + nbytes * 8
        if (pos & 7) == 0:
            b0 = pos >> 3
            return self._data[b0:b0 + nbytes].copy()
        sh = pos & 7
        b0 = pos >> 3
        raw = self._data[b0:b0 + nbytes + 1].astype(np.uint16)
        if raw.size < nbytes + 1:
            raw = np.concatenate([raw, np.zeros(nbytes + 1 - raw.size, dtype=np.uint16)])
        out = ((raw[:-1] << sh) | (raw[1:] >> (8 - sh))) & 0xFF
        return out.astype(np.uint8)
