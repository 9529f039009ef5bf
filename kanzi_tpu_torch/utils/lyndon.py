"""Chen–Fox–Lyndon factorization (K/util/LyndonWords.java:36-183)."""

from __future__ import annotations


def lyndon_factorize(data) -> list[int]:
    """Return the start indexes of the Lyndon factorization (Duval's
    algorithm)."""
    s = bytes(data)
    n = len(s)
    res = []
    i = 0
    while i < n:
        j = i + 1
        k = i
        while j < n and s[k] <= s[j]:
            k = i if s[k] < s[j] else k + 1
            j += 1
        while i <= k:
            res.append(i)
            i += j - k
    return res


def lyndon_words(data) -> list[bytes]:
    """The factorization as byte strings."""
    s = bytes(data)
    starts = lyndon_factorize(s)
    return [s[a:b] for a, b in zip(starts, starts[1:] + [len(s)])]
