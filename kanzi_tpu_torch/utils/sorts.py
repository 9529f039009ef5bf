"""Sorting utilities mirroring the reference's K/util/sort package
(QuickSort, RadixSort, BucketSort, MergeSort, HeapSort, InsertionSort,
DefaultArrayComparator).

These are standalone utilities in the reference (K/util/sort/*.java, used by
UTFCodec and tests); the array-first implementations here delegate to numpy
where a comparator is not supplied — on this framework's hardware the sort
itself runs as an XLA `sort` when called from ops/ kernels.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


class DefaultArrayComparator:
    def __init__(self, array) -> None:
        self.array = array

    def compare(self, lidx: int, ridx: int) -> int:
        return int(self.array[lidx]) - int(self.array[ridx])


class QuickSort:
    """3-way introsort equivalent (K/util/sort/QuickSort.java:62)."""

    def __init__(self, cmp=None) -> None:
        self.cmp = cmp

    def sort(self, block: np.ndarray, idx: int = 0, length: Optional[int] = None) -> bool:
        length = block.size - idx if length is None else length
        seg = block[idx:idx + length]
        if self.cmp is None:
            seg.sort(kind="quicksort")
            block[idx:idx + length] = seg
        else:
            # ArrayComparator contract: elements are indices compared through
            # the comparator (as in UTFCodec's rank sort)
            import functools
            vals = sorted(seg.tolist(), key=functools.cmp_to_key(self.cmp.compare))
            block[idx:idx + length] = vals
        return True


class RadixSort:
    """LSD radix sort (K/util/sort/RadixSort.java)."""

    def __init__(self, bits: int = 8) -> None:
        self.bits = bits

    def sort(self, block: np.ndarray, idx: int = 0, length: Optional[int] = None) -> bool:
        length = block.size - idx if length is None else length
        block[idx:idx + length] = np.sort(block[idx:idx + length], kind="stable")
        return True


class BucketSort:
    """Counting sort for small alphabets (K/util/sort/BucketSort.java)."""

    def sort(self, block: np.ndarray, idx: int = 0, length: Optional[int] = None) -> bool:
        length = block.size - idx if length is None else length
        seg = block[idx:idx + length]
        counts = np.bincount(seg)
        block[idx:idx + length] = np.repeat(np.arange(counts.size), counts)
        return True


class MergeSort:
    def sort(self, block: np.ndarray, idx: int = 0, length: Optional[int] = None) -> bool:
        length = block.size - idx if length is None else length
        block[idx:idx + length] = np.sort(block[idx:idx + length], kind="stable")
        return True


class HeapSort:
    def sort(self, block: np.ndarray, idx: int = 0, length: Optional[int] = None) -> bool:
        length = block.size - idx if length is None else length
        block[idx:idx + length] = np.sort(block[idx:idx + length], kind="heapsort")
        return True


class InsertionSort:
    def sort(self, block: np.ndarray, idx: int = 0, length: Optional[int] = None) -> bool:
        length = block.size - idx if length is None else length
        block[idx:idx + length] = np.sort(block[idx:idx + length], kind="stable")
        return True
