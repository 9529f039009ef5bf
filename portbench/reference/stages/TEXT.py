"""Inverse TEXT transform, kanzi's second text codec (TextCodec.java,
TextCodec2; the variant a stream with Huffman, ANS0, range or no entropy
coder carries).

The first byte holds flags (0x40: line ends were CR LF, 0x10: the second
codec).  Letters stand for themselves.  A byte with the top bit set is a
dictionary reference: 0x80 flips the case of the next reference's first
letter; in the reference byte r, r & 0x7F below 64 is index + 1, from 64
to 111 (r & 0x1F) << 8 | next byte, from 112 (r & 0x0F) << 16 | next two
bytes.  0x0F escapes the next byte.  Any other byte stands for itself (an
LF after CR under the CRLF flag).

The dictionary starts with the 1024 static words.  Each time a delimiter
follows a literal word of 3 to 31 letters in the input, that word is
looked up by its hash; if absent, and the hash slot is free, and it is
longer than 3 letters or fewer than 16384 words were added, it takes the
next index (the slot of the entry it replaces is freed first)."""

from __future__ import annotations

import numpy as np

from ..text_dict import DICT_EN_1024

HASH1 = 0x7FEB352D
HASH2 = 0x846CA68B
M32 = 0xFFFFFFFF
MAX_DICT = 1 << 19
MAX_WORD = 31
THRESHOLD2 = 128 * 128
CRLF = 0x40
CODEC2 = 0x10
FLIP = 0x80
ESCAPE = 0x0F

_LETTER = [(c | 0x20) in range(0x61, 0x7B) for c in range(256)]
_DELIM = [(0x20 <= c <= 0x2F) or (0x3A <= c <= 0x3F) or c in b"\n\t\r_|{}[]"
          for c in range(256)]


class TextError(ValueError):
    pass


def _static():
    """(hash, bytes) of the static words, in index order, lower case."""
    words = bytearray(DICT_EN_1024)
    out = []
    anchor, h = 0, HASH1
    for i in range(len(words)):
        if not _LETTER[words[i]]:
            continue
        if 0x41 <= words[i] <= 0x5A:
            if i > anchor:
                out.append((h, bytes(words[anchor:i])))
                if len(out) == 1024:
                    return out
                anchor, h = i, HASH1
            words[i] ^= 0x20
        h = ((h * HASH1) ^ (words[i] * HASH2)) & M32
    out.append((h, bytes(words[anchor:])))
    return out


def _log2(x: int) -> int:
    return max(x.bit_length() - 1, 0)


def inverse(data: np.ndarray, ctx: dict) -> np.ndarray:
    src = data.tobytes()
    n = len(src)
    if not src[0] & CODEC2:
        raise TextError("first text codec: not what this configuration writes")
    crlf = bool(src[0] & CRLF)
    block_size = ctx["block_size"]
    hash_mask = (1 << max(min(_log2(block_size // 32), 24), 13)) - 1
    # the dictionary's size grows by doubling; the reader's start (from
    # its output bound, 8 n + 1024) only sets when it next doubles
    cap = 8 * n + 1024
    dict_size = 1 << max(min(_log2(cap // 128), 18), 13)
    static = _static()
    n_static = len(static)
    # entry: [hash, bytes]; map: slot -> index
    entries: dict[int, list] = {}
    slots: dict[int, int] = {}
    for i, (h, w) in enumerate(static[:dict_size]):
        entries[i] = [h, w]
        slots[h & hash_mask] = i
    words = n_static
    out = bytearray()
    i = 1
    if i >= n:
        return np.zeros(0, np.uint8)
    anchor = i - 1 if _LETTER[src[i]] else i
    run = False
    while i < n:
        cur = src[i]
        if _LETTER[cur]:
            j = i + 1
            while j < n and _LETTER[src[j]]:
                j += 1
            out += src[i:j]
            i = j
            continue
        if i > anchor + 3 and _DELIM[cur] and i - anchor - 1 <= MAX_WORD:
            words = _learn(src, anchor, i, entries, slots, hash_mask, words,
                           n_static, dict_size)
            if words < 0:
                words, dict_size = -words, min(dict_size * 2, MAX_DICT)
        i += 1
        if cur & 0x80:
            flip = 0
            if cur == FLIP:
                flip = 0x20
                cur = src[i]
                i += 1
            idx = cur & 0x7F
            if idx >= 112:
                idx = ((idx & 0x0F) << 16) | (src[i] << 8) | src[i + 1]
                i += 2
            elif idx >= 64:
                idx = ((idx & 0x1F) << 8) | src[i]
                i += 1
            elif idx == 0:
                raise TextError("reference 0")
            idx -= 1
            e = entries.get(idx)
            if e is None:
                raise TextError(f"reference to empty entry {idx}")
            w = e[1]
            if run and len(w) > 1:
                out.append(0x20)
            out.append(w[0] ^ flip)
            out += w[1:]
            run = len(w) > 1
            anchor = i if run else i - 1
            continue
        if cur == ESCAPE:
            out.append(src[i])
            i += 1
        else:
            if crlf and cur == 0x0A:
                out.append(0x0D)
            out.append(cur)
        run = False
        anchor = i - 1
    return np.frombuffer(bytes(out), np.uint8)


def _learn(src: bytes, anchor: int, end: int, entries, slots, hash_mask: int,
           words: int, n_static: int, dict_size: int) -> int:
    """The reader's dictionary update for the literal word src[anchor+1:end];
    returns the next index, negated when the dictionary doubled."""
    word = src[anchor + 1:end]
    h = HASH1
    for c in word:
        h = ((h * HASH1) ^ (c * HASH2)) & M32
    slot = h & hash_mask
    found = slots.get(slot)
    if found is not None:
        e = entries[found]
        if e[0] == h and len(e[1]) == len(word) and e[1][1:] == word[1:]:
            return words
        return words                     # slot taken: nothing is added
    if len(word) <= 3 and words >= THRESHOLD2:
        return words
    old = entries.get(words)
    if words >= n_static:
        # the slot of the entry this index held is freed (an index never
        # used counts as hash 0)
        old_slot = (old[0] if old is not None else 0) & hash_mask
        slots.pop(old_slot, None)
        entries[words] = [h, word]
    slots[slot] = words
    words += 1
    if words >= dict_size:
        if dict_size >= MAX_DICT:
            return n_static
        return -words
    return words
