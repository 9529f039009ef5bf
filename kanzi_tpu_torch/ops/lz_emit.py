"""Host emission of an LZX section stream from a token list, in numpy.

The numpy parts of kanzi_tpu/ops/lz_tpu.py (its v1 JAX engine is not
ported): the emitter that ops/lz_sort.py runs when the native library
(native/lz.cpp kz_lzx_emit_tokens) is missing.  The output is a valid v7
LZX section stream (LZCodec.java:144-760 semantics); its inverse is
transforms/lz.py's.
"""

from __future__ import annotations

import numpy as np

MAX_DISTANCE1 = (1 << 16) - 2
MIN_BLOCK_LENGTH = 24
_MERGE_CAP = 65535


def _emit_len_bytes(v: np.ndarray):
    """Vectorized emit_len (LZCodec.java emitLength): per-value byte count
    and up to 4 bytes, big-endian extensions."""
    v = v.astype(np.int64)
    nb = np.where(v < 254, 1, np.where(v < 65536 + 254, 3, 4))
    b = np.zeros((v.size, 4), dtype=np.uint8)
    b[:, 0] = np.where(v < 254, v, np.where(nb == 3, 254, 255))
    v3 = v - 254
    v4 = v - 255
    b[:, 1] = np.where(nb == 3, (v3 >> 8) & 0xFF, (v4 >> 16) & 0xFF)
    b[:, 2] = np.where(nb == 3, v3 & 0xFF, (v4 >> 8) & 0xFF)
    b[:, 3] = v4 & 0xFF
    return nb, b


def _scatter_varlen(nb: np.ndarray, b: np.ndarray, out: np.ndarray,
                    offs: np.ndarray) -> None:
    """Write per-item variable-length byte groups b[i, :nb[i]] at offs[i]."""
    for k in range(4):
        sel = nb > k
        if not sel.any():
            break
        out[offs[sel] + k] = b[sel, k]


def _merge_adjacent(tok_pos, tok_len, tok_dist):
    """Fuse runs of exactly-adjacent matches with equal distance (identical
    decode output) so the device extension cap never costs token bytes on
    long repeats; re-split merged tokens at _MERGE_CAP."""
    k = tok_pos.size
    if k == 0:
        return tok_pos, tok_len, tok_dist
    adj = (tok_pos[1:] == tok_pos[:-1] + tok_len[:-1]) \
        & (tok_dist[1:] == tok_dist[:-1])
    starts = np.flatnonzero(np.concatenate([[True], ~adj]))
    pos2 = tok_pos[starts]
    dist2 = tok_dist[starts]
    len2 = np.add.reduceat(tok_len, starts)
    cnt = (len2 + _MERGE_CAP - 1) // _MERGE_CAP
    if (cnt == 1).all():
        return pos2, len2, dist2
    total = int(cnt.sum())
    tid = np.repeat(np.arange(cnt.size), cnt)
    intra = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    pos3 = pos2[tid] + intra * _MERGE_CAP
    len3 = np.minimum(len2[tid] - intra * _MERGE_CAP, _MERGE_CAP)
    return pos3, len3, dist2[tid]


def _emit(src, count, mm, max_dist, tok_pos, tok_len, tok_dist):
    """Vectorized host emission of the LZX section layout; None when the
    block gains nothing."""
    tok_pos, tok_len, tok_dist = _merge_adjacent(tok_pos, tok_len, tok_dist)
    k = tok_pos.size
    anchors = np.empty(k + 1, dtype=np.int64)
    anchors[0] = 0
    np.add(tok_pos, tok_len, out=anchors[1:])
    lit_len = np.empty(k + 1, dtype=np.int64)
    lit_len[:k] = tok_pos - anchors[:k]
    lit_len[k] = count - anchors[k]          # final literal-only token

    # rep flags: dist equals the previous / before-previous match distance
    d_prev = np.full(k, count, dtype=np.int64)
    d_prev2 = np.full(k, count, dtype=np.int64)
    d_prev[1:] = tok_dist[:-1]
    d_prev2[2:] = tok_dist[:-2]
    rep0 = tok_dist == d_prev
    rep1 = ~rep0 & (tok_dist == d_prev2)
    isrep = rep0 | rep1

    # token match bits
    nb_dist = np.where(isrep, 0,
                       1 + (tok_dist >= 256) + (tok_dist >= 65536))
    m_th = np.where(isrep, 3, 7)
    m_val = tok_len - mm
    m_ext = m_val >= m_th
    tok_match = np.where(isrep, np.where(rep1, 0x04, 0x00), nb_dist << 3) \
        + np.minimum(m_val, m_th)

    # literal-length bits + extension varints (into the literal section)
    lit_ext = lit_len >= 7
    tok_bits = np.minimum(lit_len, 7) << 5
    tokens = np.empty(k + 1, dtype=np.uint8)
    tokens[:k] = (tok_bits[:k] + tok_match).astype(np.uint8)
    tokens[k] = tok_bits[k]

    # ----- literal section: [ext varint?][run bytes] per token -----
    ext_nb = np.zeros(k + 1, dtype=np.int64)
    if lit_ext.any():
        nbv, bv = _emit_len_bytes(lit_len[lit_ext] - 7)
        ext_nb[lit_ext] = nbv
    piece = ext_nb + lit_len
    lit_off = 13 + np.cumsum(piece) - piece
    lit_sec_end = int(lit_off[-1] + piece[-1])
    out = np.zeros(lit_sec_end + (k + 1) + 3 * k + 4 * (k + 1) + 16,
                   dtype=np.uint8)
    if lit_ext.any():
        _scatter_varlen(nbv, bv, out, lit_off[lit_ext])
    total_lit = int(lit_len.sum())
    if total_lit:
        tid = np.repeat(np.arange(k + 1), lit_len)
        starts_dst = lit_off + ext_nb
        intra = np.arange(total_lit) - np.repeat(
            np.cumsum(lit_len) - lit_len, lit_len)
        out[starts_dst[tid] + intra] = src[anchors[tid] + intra]

    dst_idx = lit_sec_end
    out[0:4] = np.frombuffer(np.uint32(dst_idx).tobytes(), np.uint8)
    out[4:8] = np.frombuffer(np.uint32(k + 1).tobytes(), np.uint8)
    out[12] = (0 if max_dist == MAX_DISTANCE1 else 1) | (((mm - 2) & 7) << 1)

    out[dst_idx:dst_idx + k + 1] = tokens
    dst_idx += k + 1

    # ----- distance section (big-endian, 1..3 bytes per non-rep match) ----
    nr = ~isrep
    d_nr = tok_dist[nr]
    nbd = nb_dist[nr]
    if d_nr.size:
        offs = np.cumsum(nbd) - nbd + dst_idx
        db = np.zeros((d_nr.size, 3), dtype=np.uint8)
        db[:, 0] = np.where(nbd == 3, d_nr >> 16,
                            np.where(nbd == 2, d_nr >> 8, d_nr)) & 0xFF
        db[:, 1] = np.where(nbd == 3, d_nr >> 8, d_nr) & 0xFF
        db[:, 2] = d_nr & 0xFF
        _scatter_varlen(nbd, np.concatenate(
            [db, np.zeros((d_nr.size, 1), np.uint8)], axis=1), out, offs)
        m_idx_len = int(nbd.sum())
    else:
        m_idx_len = 0
    dst_idx += m_idx_len
    out[8:12] = np.frombuffer(np.uint32(m_idx_len).tobytes(), np.uint8)

    # ----- match-length section -----
    if m_ext.any():
        nbm, bm = _emit_len_bytes((m_val - m_th)[m_ext])
        offs = np.cumsum(nbm) - nbm + dst_idx
        _scatter_varlen(nbm, bm, out, offs)
        dst_idx += int(nbm.sum())

    if dst_idx >= count - (count // 100):
        return None
    return out[:dst_idx].copy()
