"""Global tables and helpers shared across the framework.

Re-derives the probability/log tables from the reference core layer
(K/Global.java:92-198, 274-470, 556-614).  The ``INV_EXP`` anchor table is a
wire-format constant: it defines squash(), which the CM/TPAQ binary coders use
to map mixer outputs to arithmetic-coder probabilities — any deviation changes
encoded bits.  The log tables are generated (round(4096*log2(x))) and verified
by tests against values lifted from the spec.
"""

from __future__ import annotations

import enum

import numpy as np


class DataType(enum.Enum):
    UNDEFINED = 0
    TEXT = 1
    MULTIMEDIA = 2
    EXE = 3
    NUMERIC = 4
    BASE64 = 5
    DNA = 6
    BIN = 7
    UTF8 = 8
    SMALL_ALPHABET = 9


# --- log tables (K/Global.java:92-123) ----------------------------------

# LOG2_VALUES[x-1] == floor(log2(x)) for x in 1..256
LOG2_VALUES = np.floor(np.log2(np.arange(1, 257))).astype(np.int32)

# LOG2_4096[x] == round(4096*log2(x)) for x in 1..256 ([0] unused = 0)
LOG2_4096 = np.zeros(257, dtype=np.int64)
LOG2_4096[1:] = np.floor(4096.0 * np.log2(np.arange(1, 258, dtype=np.float64))[:256] + 0.5).astype(np.int64)
# correct entry 257 slot: table covers x in [0..256]
LOG2_4096 = LOG2_4096[:257]


def log2(x: int) -> int:
    """floor(log2(x)); raises on x <= 0 (K/Global.java:207-212)."""
    if x <= 0:
        raise ValueError("log2 of non-positive value")
    return int(x).bit_length() - 1


def log2_1024(x: int) -> int:
    """1024*log2(x) with < 0.1% error (K/Global.java:222-235)."""
    if x <= 0:
        raise ValueError("log2_1024 of non-positive value")
    if x < 256:
        return int(LOG2_4096[x] + 2) >> 2
    lg = x.bit_length() - 1
    if x & (x - 1) == 0:
        return lg << 10
    return (lg - 7) * 1024 + ((int(LOG2_4096[x >> (lg - 7)]) + 2) >> 2)


# --- squash / stretch (K/Global.java:149-198) ---------------------------

# 65536/(1+exp(-alpha*x)), alpha ~= 0.54 — 33 anchors (wire constant)
INV_EXP = np.array([
    0, 8, 22, 47, 88, 160, 283, 492, 848, 1451, 2459,
    4117, 6766, 10819, 16608, 24127, 32768, 41409, 48928, 54717, 58770,
    61419, 63077, 64085, 64688, 65044, 65253, 65376, 65448, 65489, 65514,
    65528, 65536], dtype=np.int64)


def _init_squash() -> np.ndarray:
    x = np.arange(-2047, 2048, dtype=np.int64)
    w = x & 127
    y = (x >> 7) + 16
    res = np.zeros(4096, dtype=np.int32)
    res[x + 2047] = (INV_EXP[y] * (128 - w) + INV_EXP[y + 1] * w) >> 11
    res[4095] = 4095
    return res


SQUASH = _init_squash()


def squash(d: int) -> int:
    """p = 1/(1+exp(-d)); d scaled by 8 bits, p by 12 bits."""
    if d >= 2048:
        return 4095
    i = d + 2047
    return int(SQUASH[i if i > 0 else 0])


def _init_stretch() -> np.ndarray:
    res = np.zeros(4096, dtype=np.int32)
    pi = 0
    for x in range(-2047, 2048):
        i = squash(x)
        while pi <= i:
            res[pi] = x
            pi += 1
        if pi >= 4096:
            break
    res[4095] = 2047
    return res


STRETCH = _init_stretch()


# --- histograms / entropy (K/Global.java:274-470) ------------------------

def histogram_order0(block: np.ndarray) -> np.ndarray:
    """256-bin byte histogram (vectorized equivalent of computeHistogramOrder0)."""
    return np.bincount(np.asarray(block, dtype=np.uint8), minlength=256).astype(np.int64)


def histogram_order1(block: np.ndarray) -> np.ndarray:
    """(256,256) order-1 histogram; context of the first byte is 0."""
    b = np.asarray(block, dtype=np.uint8)
    if b.size == 0:
        return np.zeros((256, 256), dtype=np.int64)
    prev = np.concatenate([[0], b[:-1]]).astype(np.int64)
    idx = prev * 256 + b
    return np.bincount(idx, minlength=65536).reshape(256, 256).astype(np.int64)


def first_order_entropy_1024(length: int, histo: np.ndarray) -> int:
    """Entropy scaled to [0..1024] (K/Global.java:440-456)."""
    if length == 0:
        return 0
    log_len = log2_1024(length)
    s = 0
    for c in histo[:256]:
        c = int(c)
        if c:
            s += (c * (log_len - log2_1024(c))) >> 3
    return int(s // length)


def compute_jobs_per_task(jobs: int, tasks: int) -> list[int]:
    """Spread ``jobs`` over ``tasks`` round-robin (K/Global.java:473-494)."""
    if tasks <= 0 or jobs <= 0:
        raise ValueError("invalid jobs/tasks")
    q = 1 if jobs <= tasks else jobs // tasks
    r = 0 if jobs <= tasks else jobs - q * tasks
    out = [q] * tasks
    for n in range(r):
        out[n % tasks] += 1
    return out


_DNA_SYMBOLS = np.frombuffer(b"acgntuACGNTU", dtype=np.uint8)
_NUMERIC_SYMBOLS = np.frombuffer(b"0123456789+-*/=,.:; ", dtype=np.uint8)
_BASE64_SYMBOLS = np.frombuffer(
    b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/", dtype=np.uint8)


def detect_simple_type(count: int, freqs0: np.ndarray) -> DataType:
    """Classify data from its byte histogram (K/Global.java:556-614)."""
    if count == 0:
        return DataType.UNDEFINED
    f = np.asarray(freqs0, dtype=np.int64)
    if int(f[_DNA_SYMBOLS].sum()) > count - count // 12:
        return DataType.DNA
    if int(f[_NUMERIC_SYMBOLS].sum()) == count:
        return DataType.NUMERIC
    s = (1 if int(f[0x3D]) == 1 else 0) + int(f[_BASE64_SYMBOLS].sum())
    if s == count:
        return DataType.BASE64
    nsym = int((f[:256] > 0).sum())
    if nsym == 256:
        return DataType.BIN
    if nsym <= 4:
        return DataType.SMALL_ALPHABET
    return DataType.UNDEFINED


_WIN_RESERVED = (
    "AUX", "COM0", "COM1", "COM2", "COM3", "COM4", "COM5", "COM6", "COM7",
    "COM8", "COM9", "COM¹", "COM²", "COM³", "CON", "LPT0",
    "LPT1", "LPT2", "LPT3", "LPT4", "LPT5", "LPT6", "LPT7", "LPT8", "LPT9",
    "NUL", "PRN",
)


def is_reserved_name(file_name: str) -> bool:
    """Windows reserved device names (Global.java:619-635); always False on
    other platforms like the reference."""
    import sys
    if not sys.platform.startswith("win"):
        return False
    return file_name in _WIN_RESERVED
