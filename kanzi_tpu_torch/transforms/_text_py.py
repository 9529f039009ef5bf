"""Pure-Python TEXT codec — the executable spec / no-native fallback
(mirrors native/text.cpp kz_text_forward/kz_text_inverse, themselves
re-derived from K/transform/TextCodec.java:266-760).

Serial per-byte loops: correctness over speed (the C++ path is the fast
one; this exists so KANZI_TPU_NO_NATIVE=1 can encode and decode every
level with the same wire bytes)."""

from __future__ import annotations

import numpy as np

THRESHOLD1 = 128
THRESHOLD2 = 128 * 128
THRESHOLD3 = 64
THRESHOLD4 = THRESHOLD3 * 128
MAX_DICT_SIZE = 1 << 19
MAX_WORD_LENGTH = 31
LF, CR = 0x0A, 0x0D
ESCAPE_TOKEN1, ESCAPE_TOKEN2 = 0x0F, 0x0E
HASH1 = 0x7FEB352D
HASH2 = 0x846CA68B
MASK_CRLF = 0x40
MASK_LENGTH = 0x0007FFFF
MASK_FLIP_CASE = 0x80
_M32 = 0xFFFFFFFF


def _is_text(v: int) -> bool:
    c = v | 0x20
    return 0x61 <= c <= 0x7A


_DELIM = [False] * 256
for _i in range(256):
    _d = (0x20 <= _i <= 0x2F) or (0x3A <= _i <= 0x3F)
    if _i in (0x0A, 0x09, 0x0D, 0x5F, 0x7C, 0x7B, 0x7D, 0x5B, 0x5D):
        _d = True
    _DELIM[_i] = _d


def _ilog2(x: int) -> int:
    return max(x.bit_length() - 1, 0)


class _Entry:
    __slots__ = ("hash", "pos", "data", "buf")

    def __init__(self, h, pos, data, buf):
        self.hash = h
        self.pos = pos
        self.data = data
        self.buf = buf


def _static_dict():
    """Build the 1024-word static dictionary (kz_text_set_dict mirror)."""
    from ._text_dict import DICT_EN_1024
    words = bytearray(DICT_EN_1024)
    entries = []
    anchor, h, nb = 0, HASH1, 0
    for i in range(len(words)):
        if not _is_text(words[i]):
            continue
        if 0x41 <= words[i] <= 0x5A:  # upper: word boundary
            if i > anchor:
                entries.append(_Entry(h, anchor, ((i - anchor) << 24) | nb,
                                      words))
                nb += 1
                anchor = i
                h = HASH1
                if nb >= 1024:
                    break
            words[i] ^= 0x20
        h = (h * HASH1 ^ words[i] * HASH2) & _M32
    if nb < 1024:
        entries.append(_Entry(h, anchor,
                              ((len(words) - anchor) << 24) | nb, words))
    return entries


_STATIC = None


def _get_static():
    global _STATIC
    if _STATIC is None:
        _STATIC = _static_dict()
    return _STATIC


class _Dict:
    def __init__(self, count: int, log_hash: int, with_escapes: bool):
        static = _get_static()
        log = 13 if count < 1024 else max(min(_ilog2(count // 128), 18), 13)
        self.dict_size = 1 << log
        self.static_size = len(static) + (2 if with_escapes else 0)
        self.hash_mask = (1 << log_hash) - 1
        self.map: dict[int, _Entry] = {}
        self.list: dict[int, _Entry] = {}
        for i, e in enumerate(static):
            if i >= self.dict_size:
                break
            self.list[i] = _Entry(e.hash, e.pos, e.data, e.buf)
        if with_escapes:
            n = len(static)
            self.list[n] = _Entry(0, 0, (1 << 24) | n, bytes([ESCAPE_TOKEN2]))
            self.list[n + 1] = _Entry(0, 0, (1 << 24) | (n + 1),
                                      bytes([ESCAPE_TOKEN1]))
        for i in range(self.static_size):
            e = self.list.get(i)
            if e is not None:
                self.map[e.hash & self.hash_mask] = e

    def entry(self, i: int) -> _Entry:
        e = self.list.get(i)
        if e is None:
            e = _Entry(0, -1, i, None)
            self.list[i] = e
        return e

    def expand(self) -> bool:
        if self.dict_size >= MAX_DICT_SIZE:
            return False
        self.dict_size <<= 1
        return True


def _lookup_or_add(D: _Dict, src, delim_anchor: int, src_idx: int,
                   length: int, words: int) -> int:
    """Decoder-side dictionary update (tryFlipped/threshold flags False).
    Returns the updated word counter."""
    val = src[delim_anchor + 1]
    h1 = (HASH1 * HASH1 ^ val * HASH2) & _M32
    for i in range(delim_anchor + 2, src_idx):
        h1 = (h1 * HASH1 ^ src[i] * HASH2) & _M32
    e1 = D.map.get(h1 & D.hash_mask)
    e = None
    if e1 is not None and e1.hash == h1 and (e1.data >> 24) & 0xFF == length:
        e = e1
        # verify bytes
        for k in range(length - 1):
            if src[delim_anchor + 2 + k] != e.buf[e.pos + 1 + k]:
                e = None
                break
    if e is None:
        add_ok = (length > 3) or (words < THRESHOLD2)
        if add_ok and e1 is None:
            ne = D.entry(words)
            if (ne.data & MASK_LENGTH) >= D.static_size:
                D.map.pop(ne.hash & D.hash_mask, None)  # unconditional, as C++
                ne.buf = src
                ne.pos = delim_anchor + 1
                ne.hash = h1
                ne.data = (length << 24) | words
            D.map[h1 & D.hash_mask] = ne
            words += 1
            if words >= D.dict_size:
                if not D.expand():
                    words = D.static_size
    return words


MASK_NOT_TEXT = 0x80
MASK_XML_HTML = 0x20
MASK_DT = 0x0F

# DataType ordinals (core.globals.DataType)
_DT_UNDEF, _DT_TEXT, _DT_NUMERIC, _DT_BASE64, _DT_DNA = 0, 1, 4, 5, 6
_DT_BIN, _DT_UTF8, _DT_SMALL = 7, 8, 9


def _detect_simple_type(f0: np.ndarray, count: int) -> int:
    """Global.detectSimpleType mirror (native/text.cpp:172-191)."""
    dna = np.frombuffer(b"acgntuACGNTU", np.uint8)
    num = np.frombuffer(b"0123456789+-*/=,.:; ", np.uint8)
    b64 = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                        b"abcdefghijklmnopqrstuvwxyz0123456789+/", np.uint8)
    if int(f0[dna].sum()) > count - count // 12:
        return _DT_DNA
    if int(f0[num].sum()) == count:
        return _DT_NUMERIC
    if int(f0[b64].sum()) + (1 if int(f0[0x3D]) == 1 else 0) == count:
        return _DT_BASE64
    nsym = int((f0 > 0).sum())
    if nsym == 256:
        return _DT_BIN
    if nsym <= 4:
        return _DT_SMALL
    return _DT_UNDEF


def _detect_type(f0: np.ndarray, f: np.ndarray, count: int) -> int:
    """native/text.cpp:193-220 (UTF-8 validity over the bigram table)."""
    dt = _detect_simple_type(f0, count)
    if dt != _DT_UNDEF:
        return MASK_NOT_TEXT | dt
    if int(f0[0xC0] + f0[0xC1] + f0[0xF5:0x100].sum()) != 0:
        return MASK_NOT_TEXT
    cols = np.arange(256)
    sum1 = 0
    sum1 += int(f[0xE0, (cols < 0xA0) | (cols > 0xBF)].sum())
    sum1 += int(f[0xED, (cols < 0x80) | (cols > 0x9F)].sum())
    sum1 += int(f[0xF0, (cols < 0x90) | (cols > 0xBF)].sum())
    sum1 += int(f[0xF4, (cols < 0x80) | (cols > 0x8F)].sum())
    out = (cols < 0x80) | (cols > 0xBF)
    rows = np.r_[np.arange(0xC2, 0xE0), np.arange(0xE1, 0xED),
                 [0xEE, 0xEF, 0xF1, 0xF2, 0xF3]]
    sum1 += int(f[np.ix_(rows, np.flatnonzero(out))].sum())
    if sum1 != 0:
        return MASK_NOT_TEXT
    sum2 = int(f0[~out].sum())
    return (MASK_NOT_TEXT | _DT_UTF8) if sum2 >= count // 8 else MASK_NOT_TEXT


def _compute_stats(src: np.ndarray, strict: bool, magic_found: bool) -> int:
    """TextCodec.computeStats mirror (native/text.cpp:118-166)."""
    count = src.size
    if not strict and magic_found:
        return MASK_NOT_TEXT
    f0 = np.bincount(src, minlength=256).astype(np.int64)
    prv = np.concatenate([[0], src[:-1].astype(np.int64)])
    f = np.bincount(prv * 256 + src, minlength=65536) \
        .astype(np.int64).reshape(256, 256)
    is_txt = np.zeros(256, bool)
    for i in range(128):
        is_txt[i] = _is_text(i)
    nb_text = int(f0[CR] + f0[LF] + f0[:128][is_txt[:128]].sum())
    nb_ascii = int(f0[:128].sum())
    nb_bin = count - nb_ascii
    not_text = nb_bin > (count >> 2)
    if not not_text:
        not_text = nb_text < count // 4
        if strict:
            not_text |= (int(f0[0]) >= count // 100) or \
                (nb_ascii // 95 < count // 100)
        else:
            not_text |= int(f0[0x20]) < count // 50
    if not_text:
        return _detect_type(f0, f, count)
    res = 0
    if nb_bin <= count - count // 10:
        f1, f2 = int(f0[ord("<")]), int(f0[ord(">")])
        f3 = int(f[ord("&"), ord("a")] + f[ord("&"), ord("g")]
                 + f[ord("&"), ord("l")] + f[ord("&"), ord("q")])
        min_freq = max((count - nb_bin) >> 9, 2)
        if f1 >= min_freq and f2 >= min_freq and f3 > 0:
            if f1 < f2:
                if f1 >= f2 - f2 // 100:
                    res |= MASK_XML_HTML
            elif f2 < f1:
                if f2 >= f1 - f1 // 100:
                    res |= MASK_XML_HTML
            else:
                res |= MASK_XML_HTML
    if int(f0[CR]) != 0 and int(f0[CR]) == int(f0[LF]):
        res |= MASK_CRLF
        for i in range(256):
            if i != LF and int(f[CR, i]) != 0:
                res &= ~MASK_CRLF
                break
            if i != CR and int(f[i, LF]) != 0:
                res &= ~MASK_CRLF
                break
    return res


def _lookup_or_add_fwd(D: _Dict, src, delim_anchor: int, src_idx: int,
                       length: int, words: int):
    """Encoder-side dictionary probe (tryFlipped=True, strict len-3 add;
    native/text.cpp:262-306).  Returns (entry_or_None, h1, words)."""
    val = src[delim_anchor + 1]
    h1 = (HASH1 * HASH1 ^ val * HASH2) & _M32
    h2 = (HASH1 * HASH1 ^ (val ^ 0x20) * HASH2) & _M32
    for i in range(delim_anchor + 2, src_idx):
        h = src[i] * HASH2
        h1 = (h1 * HASH1 ^ h) & _M32
        h2 = (h2 * HASH1 ^ h) & _M32
    e = None
    e1 = D.map.get(h1 & D.hash_mask)
    if e1 is not None and e1.hash == h1 and (e1.data >> 24) & 0xFF == length:
        e = e1
    else:
        e2 = D.map.get(h2 & D.hash_mask)
        if e2 is not None and e2.hash == h2 and \
                (e2.data >> 24) & 0xFF == length:
            e = e2
    if e is not None:
        for k in range(length - 1):
            if src[delim_anchor + 2 + k] != e.buf[e.pos + 1 + k]:
                e = None
                break
    if e is None:
        add_ok = (length > 3) or (length == 3 and words < THRESHOLD2)
        if add_ok and e1 is None:
            ne = D.entry(words)
            if (ne.data & MASK_LENGTH) >= D.static_size:
                D.map.pop(ne.hash & D.hash_mask, None)
                ne.buf = src
                ne.pos = delim_anchor + 1
                ne.hash = h1
                ne.data = (length << 24) | words
            D.map[h1 & D.hash_mask] = ne
            words += 1
            if words >= D.dict_size:
                if not D.expand():
                    words = D.static_size
        return None, h1, words
    return e, h1, words


def text_forward_py(src: np.ndarray, codec_type: int, block_size: int,
                    extra: bool, magic_found: bool):
    """Mirror of native/text.cpp kz_text_forward.  Returns
    (encoded-bytes-or-None, data-type-ordinal)."""
    arr = np.asarray(src, dtype=np.uint8)
    count = arr.size
    t1 = codec_type == 1
    mode = _compute_stats(arr, t1, magic_found)
    if mode & MASK_NOT_TEXT:
        return None, mode & MASK_DT
    src = bytes(arr.tobytes())
    log = 13
    if t1:
        if block_size >= 8:
            log = max(min(_ilog2(block_size // 8), 26), 13)
    else:
        if block_size >= 32:
            log = max(min(_ilog2(block_size // 32), 24), 13)
    log += 1 if extra else 0
    D = _Dict(count, log, t1)
    is_crlf = (mode & MASK_CRLF) != 0
    dst_end = count
    dst_end_m = dst_end - 4 if t1 else dst_end - 3
    dst = bytearray(dst_end)
    src_idx = dst_idx = emit_anchor = 0
    words = D.static_size
    dst[dst_idx] = mode
    dst_idx += 1
    while src_idx < count and src[src_idx] == 0x20:
        if dst_idx >= dst_end:
            return None, _DT_TEXT
        dst[dst_idx] = 0x20
        dst_idx += 1
        src_idx += 1
        emit_anchor += 1
    if src_idx >= count:
        return None, _DT_TEXT

    def emit_symbols(frm: int, to: int) -> bool:
        nonlocal dst_idx
        for i in range(frm, to):
            cur = src[i]
            if t1:
                if cur in (ESCAPE_TOKEN1, ESCAPE_TOKEN2):
                    if dst_idx >= dst_end:
                        return False
                    dst[dst_idx] = ESCAPE_TOKEN1
                    dst_idx += 1
                    idx = D.static_size - 1 if cur == ESCAPE_TOKEN1 \
                        else D.static_size - 2
                    len_idx = 3 if idx >= THRESHOLD2 else \
                        (1 if idx < THRESHOLD1 else 2)
                    if dst_idx + len_idx >= dst_end:
                        return False
                    if idx >= THRESHOLD1:
                        if idx >= THRESHOLD2:
                            dst[dst_idx] = 0xE0 | (idx >> 14)
                            dst_idx += 1
                        dst[dst_idx] = 0x80 | ((idx >> 7) & 0xFF)
                        dst[dst_idx + 1] = idx & 0x7F
                        dst_idx += 2
                    else:
                        dst[dst_idx] = idx
                        dst_idx += 1
                elif cur == CR:
                    if not is_crlf:
                        if dst_idx >= dst_end:
                            return False
                        dst[dst_idx] = cur
                        dst_idx += 1
                else:
                    if dst_idx >= dst_end:
                        return False
                    dst[dst_idx] = cur
                    dst_idx += 1
            else:
                if cur == ESCAPE_TOKEN1:
                    if dst_idx >= dst_end - 1:
                        return False
                    dst[dst_idx] = ESCAPE_TOKEN1
                    dst[dst_idx + 1] = ESCAPE_TOKEN1
                    dst_idx += 2
                elif cur == CR:
                    if not is_crlf:
                        if dst_idx >= dst_end:
                            return False
                        dst[dst_idx] = cur
                        dst_idx += 1
                else:
                    if cur & 0x80:
                        if dst_idx >= dst_end:
                            return False
                        dst[dst_idx] = ESCAPE_TOKEN1
                        dst_idx += 1
                    if dst_idx >= dst_end:
                        return False
                    dst[dst_idx] = cur
                    dst_idx += 1
        return True

    delim_anchor = src_idx - 1 if _is_text(src[src_idx]) else src_idx
    ok = True
    while src_idx < count:
        cur = src[src_idx]
        if _is_text(cur):
            src_idx += 1
            continue
        if src_idx > delim_anchor + 2 and _DELIM[cur]:
            length = src_idx - delim_anchor - 1
            if length <= MAX_WORD_LENGTH:
                e, h1, words = _lookup_or_add_fwd(
                    D, src, delim_anchor, src_idx, length, words)
                if e is not None:
                    # escape/flip choice: did the match come from the
                    # straight (case-exact) hash slot?
                    e1b = D.map.get(h1 & D.hash_mask)
                    case_exact = e is e1b
                    if emit_anchor != delim_anchor or \
                            src[delim_anchor] != 0x20:
                        if not emit_symbols(emit_anchor, delim_anchor + 1):
                            ok = False
                            break
                    if dst_idx >= dst_end_m:
                        ok = False
                        break
                    widx = e.data & MASK_LENGTH
                    if t1:
                        dst[dst_idx] = ESCAPE_TOKEN1 if case_exact \
                            else ESCAPE_TOKEN2
                        dst_idx += 1
                        if widx >= THRESHOLD1:
                            if widx >= THRESHOLD2:
                                dst[dst_idx] = 0xE0 | (widx >> 14)
                                dst_idx += 1
                            dst[dst_idx] = 0x80 | ((widx >> 7) & 0xFF)
                            dst[dst_idx + 1] = widx & 0x7F
                            dst_idx += 2
                        else:
                            dst[dst_idx] = widx
                            dst_idx += 1
                    else:
                        dst[dst_idx] = MASK_FLIP_CASE
                        if not case_exact:
                            dst_idx += 1
                        w = widx + 1
                        if w >= THRESHOLD3:
                            if w >= THRESHOLD4:
                                dst[dst_idx] = 0xF0 | (w >> 16)
                                dst[dst_idx + 1] = (w >> 8) & 0xFF
                                dst[dst_idx + 2] = w & 0xFF
                                dst_idx += 3
                            else:
                                dst[dst_idx] = 0xC0 | (w >> 8)
                                dst[dst_idx + 1] = w & 0xFF
                                dst_idx += 2
                        else:
                            dst[dst_idx] = 0x80 | w
                            dst_idx += 1
                    emit_anchor = delim_anchor + 1 + ((e.data >> 24) & 0xFF)
        delim_anchor = src_idx
        src_idx += 1
    if ok:
        if not emit_symbols(emit_anchor, count):
            return None, _DT_TEXT
        if src_idx != count:
            return None, _DT_TEXT
        return np.frombuffer(bytes(dst[:dst_idx]), np.uint8).copy(), _DT_TEXT
    return None, _DT_TEXT


def text_inverse_py(src: np.ndarray, codec_type: int, block_size: int,
                    extra: bool, count_hint: int | None,
                    legacy: bool = False) -> np.ndarray:
    """Mirror of native/text.cpp kz_text_inverse."""
    src = bytes(np.asarray(src, dtype=np.uint8).tobytes())
    count = len(src)
    cap = count_hint if count_hint is not None else count * 5 + 1024
    t1 = codec_type == 1
    log = 13
    if t1:
        if block_size >= 8:
            log = max(min(_ilog2(block_size // 8), 26), 13)
    else:
        if block_size >= 32:
            log = max(min(_ilog2(block_size // 32), 24), 13)
    log += 1 if extra else 0
    D = _Dict(cap, log, t1)
    dst = bytearray(cap)
    src_idx, dst_idx = 0, 0
    is_crlf = (src[src_idx] & MASK_CRLF) != 0
    src_idx += 1
    if src_idx >= count:
        return np.frombuffer(bytes(dst[:dst_idx]), np.uint8).copy()
    delim_anchor = src_idx - 1 if _is_text(src[src_idx]) else src_idx
    words = D.static_size
    word_run = False
    while src_idx < count and dst_idx < cap:
        cur = src[src_idx]
        if _is_text(cur):
            dst[dst_idx] = cur
            dst_idx += 1
            src_idx += 1
            continue
        if src_idx > delim_anchor + 3 and _DELIM[cur]:
            length = src_idx - delim_anchor - 1
            if length <= MAX_WORD_LENGTH:
                words = _lookup_or_add(D, src, delim_anchor, src_idx,
                                       length, words)
        src_idx += 1
        flip_mask = 0
        idx = -1
        if t1:
            is_word_ref = cur in (ESCAPE_TOKEN1, ESCAPE_TOKEN2)
            if is_word_ref:
                if src_idx >= count:
                    raise ValueError("TEXT: truncated")
                idx = src[src_idx]
                src_idx += 1
                if idx >= 128:
                    idx &= 0x7F
                    idx2 = src[src_idx]
                    src_idx += 1
                    if idx2 & 0x80:
                        idx = ((idx & 0x1F) << 7) | (idx2 & 0x7F)
                        idx2 = src[src_idx] & 0x7F
                        src_idx += 1
                    idx = (idx << 7) | idx2
                    if idx >= D.dict_size:
                        raise ValueError("TEXT: bad index")
                flip_mask = 0x20 if cur == ESCAPE_TOKEN2 else 0
        elif legacy:
            is_word_ref = (cur & 0x80) != 0
            if is_word_ref:
                flip_mask = cur & 0x20
                idx = cur & 0x1F
                if cur & 0x40:
                    if src_idx >= count:
                        raise ValueError("TEXT: truncated")
                    idx2 = src[src_idx]
                    src_idx += 1
                    if idx2 & 0x80:
                        idx = (idx << 7) | (idx2 & 0x7F)
                        if src_idx >= count:
                            raise ValueError("TEXT: truncated")
                        idx2 = src[src_idx] & 0x7F
                        src_idx += 1
                    idx = (idx << 7) | idx2
                    if idx >= D.dict_size:
                        raise ValueError("TEXT: bad index")
        else:
            is_word_ref = (cur & 0x80) != 0
            if is_word_ref:
                if cur == MASK_FLIP_CASE:
                    flip_mask = 0x20
                    if src_idx >= count:
                        raise ValueError("TEXT: truncated")
                    cur = src[src_idx]
                    src_idx += 1
                idx = cur & 0x7F
                if idx >= 64:
                    if idx >= 112:
                        if src_idx + 1 >= count:
                            raise ValueError("TEXT: truncated")
                        idx = ((idx & 0x0F) << 16) | (src[src_idx] << 8) \
                            | src[src_idx + 1]
                        src_idx += 2
                    else:
                        if src_idx >= count:
                            raise ValueError("TEXT: truncated")
                        idx = ((idx & 0x1F) << 8) | src[src_idx]
                        src_idx += 1
                    if idx > D.dict_size:
                        raise ValueError("TEXT: bad index")
                elif idx == 0:
                    raise ValueError("TEXT: bad index")
                idx -= 1
        if is_word_ref:
            e = D.entry(idx)
            length = (e.data >> 24) & 0xFF
            if word_run and length > 1:
                if dst_idx >= cap:
                    raise ValueError("TEXT: overflow")
                dst[dst_idx] = 0x20
                dst_idx += 1
            if e.pos < 0 or dst_idx + length >= cap:
                raise ValueError("TEXT: bad entry")
            dst[dst_idx] = e.buf[e.pos] ^ flip_mask
            dst_idx += 1
            if length > 1:
                dst[dst_idx:dst_idx + length - 1] = \
                    e.buf[e.pos + 1:e.pos + length]
                dst_idx += length - 1
                word_run = True
                delim_anchor = src_idx
            else:
                word_run = False
                delim_anchor = src_idx - 1
        else:
            if not t1 and cur == ESCAPE_TOKEN1:
                if src_idx >= count:
                    raise ValueError("TEXT: truncated")
                dst[dst_idx] = src[src_idx]
                dst_idx += 1
                src_idx += 1
            else:
                if is_crlf and cur == LF:
                    dst[dst_idx] = CR
                    dst_idx += 1
                    if dst_idx >= cap:
                        raise ValueError("TEXT: overflow")
                dst[dst_idx] = cur
                dst_idx += 1
            word_run = False
            delim_anchor = src_idx - 1
    if src_idx != count:
        raise ValueError("TEXT: stream mismatch")
    return np.frombuffer(bytes(dst[:dst_idx]), np.uint8).copy()
