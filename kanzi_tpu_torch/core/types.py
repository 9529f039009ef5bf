"""Framework contracts.

The reference expresses these as mutable-slice interfaces
(K/ByteTransform.java:36-56, K/EntropyEncoder.java:34-48, K/Predictor.java).
Here they are functional: transforms map ndarray -> ndarray, entropy coders
bridge ndarrays and bit streams.  A forward transform signals "not
beneficial / not applicable" by raising :class:`TransformSkip`, which the
sequence layer records as a per-stage skip flag — same semantics as the
reference returning ``false`` from ``forward()``.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np

from .bits import BitReader, BitWriter


class TransformSkip(Exception):
    """Forward transform declined (output would not be smaller / wrong data)."""


@runtime_checkable
class ByteTransform(Protocol):
    """Stage-1 byte transform."""

    def forward(self, src: np.ndarray) -> np.ndarray:
        """Transform ``src``; raise TransformSkip to decline."""
        ...

    def inverse(self, src: np.ndarray) -> np.ndarray:
        ...

    def max_encoded_len(self, src_len: int) -> int:
        ...


@runtime_checkable
class EntropyEncoder(Protocol):
    """Stage-2 entropy encoder writing to a BitWriter."""

    def encode(self, block: np.ndarray, bw: BitWriter) -> int:
        ...

    def dispose(self) -> None:
        ...


@runtime_checkable
class EntropyDecoder(Protocol):
    def decode(self, count: int, br: BitReader) -> np.ndarray:
        ...

    def dispose(self) -> None:
        ...


@runtime_checkable
class Predictor(Protocol):
    """Binary probability model: get() -> P(bit==1) in [0..4095]."""

    def get(self) -> int: ...

    def update(self, bit: int) -> None: ...
