"""Endian-explicit scalar and bulk reads/writes on byte buffers.

Mirror of the reference's ``Memory`` utility (K/Memory.java:56-234): the
``BigEndian``/``LittleEndian`` pairs read and write 16/32/64-bit values at
arbitrary byte offsets of a ``bytearray``/``np.ndarray``.  The block engine
itself uses numpy views; this module is the standalone utility surface.
"""

from __future__ import annotations

import numpy as np

_MASKS = {16: 0xFFFF, 32: 0xFFFFFFFF, 64: 0xFFFFFFFFFFFFFFFF}


class _Endian:
    _order: str  # "big" or "little"

    @classmethod
    def read_int16(cls, buf, idx: int) -> int:
        v = int.from_bytes(bytes(buf[idx:idx + 2]), cls._order)
        return v - 0x10000 if v >= 0x8000 else v

    @classmethod
    def read_uint16(cls, buf, idx: int) -> int:
        return int.from_bytes(bytes(buf[idx:idx + 2]), cls._order)

    @classmethod
    def read_int32(cls, buf, idx: int) -> int:
        v = int.from_bytes(bytes(buf[idx:idx + 4]), cls._order)
        return v - 0x100000000 if v >= 0x80000000 else v

    @classmethod
    def read_uint32(cls, buf, idx: int) -> int:
        return int.from_bytes(bytes(buf[idx:idx + 4]), cls._order)

    @classmethod
    def read_long64(cls, buf, idx: int) -> int:
        v = int.from_bytes(bytes(buf[idx:idx + 8]), cls._order)
        return v - (1 << 64) if v >= (1 << 63) else v

    @classmethod
    def _write(cls, buf, idx: int, value: int, nbits: int) -> None:
        buf[idx:idx + nbits // 8] = (value & _MASKS[nbits]).to_bytes(
            nbits // 8, cls._order)

    @classmethod
    def write_int16(cls, buf, idx: int, value: int) -> None:
        cls._write(buf, idx, value, 16)

    @classmethod
    def write_int32(cls, buf, idx: int, value: int) -> None:
        cls._write(buf, idx, value, 32)

    @classmethod
    def write_long64(cls, buf, idx: int, value: int) -> None:
        cls._write(buf, idx, value, 64)


class BigEndian(_Endian):
    _order = "big"


class LittleEndian(_Endian):
    _order = "little"


def read_u16_array(buf: np.ndarray, big_endian: bool = True) -> np.ndarray:
    """Bulk 16-bit view of a byte array (vectorized counterpart of the
    scalar readers; used by codec payload framing)."""
    dt = ">u2" if big_endian else "<u2"
    return np.frombuffer(np.ascontiguousarray(buf), dtype=dt)


def read_u32_array(buf: np.ndarray, big_endian: bool = True) -> np.ndarray:
    dt = ">u4" if big_endian else "<u4"
    return np.frombuffer(np.ascontiguousarray(buf), dtype=dt)
