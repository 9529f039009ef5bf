"""XXHash32/64, matching the reference's (slightly non-canonical) variants.

Re-derived from K/util/hash/XXHash32.java:94-160 and XXHash64.java:95-170.
Two reference quirks are preserved because block checksums are wire format:
  * XXHash64 combines stripe lanes with 32-bit-style shift pairs
    ((v<<1)|(v>>>31) on 64-bit lanes), not 64-bit rotations;
  * the 4-byte tail read in XXHash64 is sign-extended before multiply.
Fast path is the C++ native library; the Python fallback is exact but slow.
"""

from __future__ import annotations

from .native import get_lib

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF

P32_1 = 2654435761
P32_2 = 2246822519
P32_3 = 3266489917
P32_4 = 668265263
P32_5 = 374761393

P64_1 = 0x9E3779B185EBCA87
P64_2 = 0xC2B2AE3D27D4EB4F
P64_3 = 0x165667B19E3779F9
P64_4 = 0x85EBCA77C2B2AE63
P64_5 = 0x27D4EB2F165667C5


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def xxhash32(data, seed: int) -> int:
    """32-bit hash; ``seed`` is the bitstream type magic in the block engine."""
    buf = bytes(data)
    lib = get_lib()
    seed &= _M32
    if lib is not None:
        return int(lib.kz_xxhash32(buf, len(buf), seed))
    return _xxhash32_py(buf, seed)


def xxhash64(data, seed: int) -> int:
    buf = bytes(data)
    lib = get_lib()
    seed &= _M64
    if lib is not None:
        return int(lib.kz_xxhash64(buf, len(buf), seed))
    return _xxhash64_py(buf, seed)


def _xxhash32_py(buf: bytes, seed: int) -> int:
    n = len(buf)
    i = 0
    if n >= 16:
        v1 = (seed + P32_1 + P32_2) & _M32
        v2 = (seed + P32_2) & _M32
        v3 = seed
        v4 = (seed - P32_1) & _M32
        lim = n - 16
        while i <= lim:
            v1 = (_rotl32((v1 + int.from_bytes(buf[i:i+4], "little") * P32_2) & _M32, 13) * P32_1) & _M32
            v2 = (_rotl32((v2 + int.from_bytes(buf[i+4:i+8], "little") * P32_2) & _M32, 13) * P32_1) & _M32
            v3 = (_rotl32((v3 + int.from_bytes(buf[i+8:i+12], "little") * P32_2) & _M32, 13) * P32_1) & _M32
            v4 = (_rotl32((v4 + int.from_bytes(buf[i+12:i+16], "little") * P32_2) & _M32, 13) * P32_1) & _M32
            i += 16
        h = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12) + _rotl32(v4, 18)) & _M32
    else:
        h = (seed + P32_5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        h = (h + int.from_bytes(buf[i:i+4], "little") * P32_3) & _M32
        h = (_rotl32(h, 17) * P32_4) & _M32
        i += 4
    while i < n:
        h = (h + buf[i] * P32_5) & _M32
        h = (_rotl32(h, 11) * P32_1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * P32_2) & _M32
    h ^= h >> 13
    h = (h * P32_3) & _M32
    return h ^ (h >> 16)


def _xx64_round(acc: int, val: int) -> int:
    return (_rotl64((acc + val * P64_2) & _M64, 31) * P64_1) & _M64


def _xxhash64_py(buf: bytes, seed: int) -> int:
    n = len(buf)
    i = 0
    if n >= 32:
        v1 = (seed + P64_1 + P64_2) & _M64
        v2 = (seed + P64_2) & _M64
        v3 = seed
        v4 = (seed - P64_1) & _M64
        lim = n - 32
        while i <= lim:
            v1 = _xx64_round(v1, int.from_bytes(buf[i:i+8], "little"))
            v2 = _xx64_round(v2, int.from_bytes(buf[i+8:i+16], "little"))
            v3 = _xx64_round(v3, int.from_bytes(buf[i+16:i+24], "little"))
            v4 = _xx64_round(v4, int.from_bytes(buf[i+24:i+32], "little"))
            i += 32
        # 32-bit-style shift pairs on 64-bit lanes (reference quirk)
        h = (((v1 << 1) | (v1 >> 31)) + ((v2 << 7) | (v2 >> 25)) +
             ((v3 << 12) | (v3 >> 20)) + ((v4 << 18) | (v4 >> 14))) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _xx64_round(0, v)) * P64_1 + P64_4) & _M64
    else:
        h = (seed + P64_5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _xx64_round(0, int.from_bytes(buf[i:i+8], "little"))
        h = (_rotl64(h, 27) * P64_1 + P64_4) & _M64
        i += 8
    while i + 4 <= n:
        w = int.from_bytes(buf[i:i+4], "little")
        if w >= 1 << 31:  # sign-extended read (reference quirk)
            w -= 1 << 32
        h ^= (w * P64_1) & _M64
        h = (_rotl64(h, 23) * P64_2 + P64_3) & _M64
        i += 4
    while i < n:
        h ^= (buf[i] * P64_5) & _M64
        h = (_rotl64(h, 11) * P64_1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * P64_2) & _M64
    h ^= h >> 29
    h = (h * P64_3) & _M64
    return h ^ (h >> 32)
