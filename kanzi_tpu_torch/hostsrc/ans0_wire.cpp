// The host side of the ANS0 device stage (kanzi_tpu_torch/ops/ans_block.py).
// On encode, a block's full-chunk records written from the device's rows in
// one call a block: each chunk's log range, alphabet and grouped frequencies
// (entropy/ans.py _write_freqs_header), then, for a chunk of two symbols or
// more, its payload size, final states and big-endian payload, bit for bit
// as kanzi_tpu's device glue (kanzi_tpu/ops/ans_block.py) writes them.  On
// decode, a block's full-chunk headers parsed in stream order, in one call a
// block, and each full chunk's payload gathered, realigned, into a row of the
// buffer the decode kernel reads.  The parse is the host decoder's
// (entropy/ans.py _read_freqs_header and ANSRangeDecoder), check for check
// and in the same order, so that a corrupt or truncated stream stops at the
// same chunk with the same error; ops/ans_block.py raises it from the code
// returned here.  Built into the port's own libkanzi_native.so beside
// native/*.cpp (utils/native.py).

#include <cstdint>
#include <cstring>

#define EXPORT extern "C" __attribute__((visibility("default")))

namespace {

typedef uint8_t u8;
typedef int32_t i32;
typedef int64_t i64;
typedef uint16_t u16;
typedef uint32_t u32;
typedef uint64_t u64;

// error codes, raised by ops/ans_block.py's _WIRE_ERRORS
enum {
    OK = 0,
    E_EOF = 1,           // EOFError("bitstream exhausted")
    E_MESH_RANGE = 2,    // a non-default log range under host_log_ranges false
    E_RANGE = 3,         // a log range outside [8, 15]
    E_EMPTY = 4,         // an empty alphabet
    E_FREQ_SIZE = 5,     // a group's logMax over the scale
    E_FREQ = 6,          // a frequency at or over the scale
    E_FREQS = 7,         // frequencies summing to the scale or more
    E_CHUNK_SIZE = 8,    // a payload size at or over MAX_CHUNK_SIZE
};

const i64 MAX_CHUNK_SIZE = i64(1) << 27;
// bytes of one chunk header at most: 3 bits of log range, an alphabet of at
// most 263 bits, 255 values of at most 31 bits and 43 logMax of 4 bits
const i64 WIRE_HEADER_MAX = 1100;

struct Reader {
    const u8* buf; i64 nbits; i64 pos;
    bool has(i64 n) const { return pos + n <= nbits; }
    // 1 <= n <= 32 bits, MSB first; the caller checked has(n), so the
    // bytes read all hold bits of the stream
    u64 bits(i32 n) {
        const u8* p = buf + (pos >> 3);
        const i32 off = (i32)(pos & 7);
        const i32 nb = (off + n + 7) >> 3;
        u64 w = 0;
        for (i32 k = 0; k < nb; k++) w = (w << 8) | p[k];
        pos += n;
        return (w >> (8 * nb - off - n)) & ((u64(1) << n) - 1);
    }
};

// EntropyUtils decode_alphabet (entropy/utils.py): the symbols ascending
int read_alphabet(Reader& r, i32* alpha, i32* count) {
    if (!r.has(1)) return E_EOF;
    if (r.bits(1) == 0) {                       // full or empty
        if (!r.has(1)) return E_EOF;
        if (r.bits(1) == 1) { *count = 0; return OK; }
        for (i32 i = 0; i < 256; i++) alpha[i] = i;
        *count = 256;
        return OK;
    }
    if (!r.has(5)) return E_EOF;
    const i32 last = (i32)r.bits(5);
    if (!r.has(8 * (last + 1))) return E_EOF;
    i32 n = 0;
    for (i32 i = 0; i <= last; i++) {
        const i32 mask = (i32)r.bits(8);
        for (i32 j = 0; j < 8; j++)
            if (mask & (1 << j)) alpha[n++] = (i << 3) + j;
    }
    *count = n;
    return OK;
}

// entropy/ans.py _read_freqs_header: freq[256] of one chunk
int read_freqs(Reader& r, i32 lr, i32* alpha, i32* count, i32* freq) {
    const i32 scale = 1 << lr;
    int e = read_alphabet(r, alpha, count);
    if (e) return e;
    std::memset(freq, 0, 256 * sizeof(i32));
    const i32 n = *count;
    if (n == 0) return OK;
    if (n == 1) { freq[alpha[0]] = scale; return OK; }
    const i32 chk = n >= 64 ? 8 : 6;
    i32 llr = 3;
    while ((1 << llr) <= lr) llr++;
    i64 total = 0;
    for (i32 i = 1; i < n; i += chk) {
        if (!r.has(llr)) return E_EOF;
        const i32 log_max = (i32)r.bits(llr);
        if ((i64(1) << log_max) > scale) return E_FREQ_SIZE;
        const i32 end = i + chk < n ? i + chk : n;
        // the group is read whole before its values are checked
        if (log_max > 0 && !r.has((i64)log_max * (end - i))) return E_EOF;
        bool bad = false;
        for (i32 j = i; j < end; j++) {
            const i64 f = log_max == 0 ? 1 : (i64)r.bits(log_max) + 1;
            bad |= f >= scale;
            freq[alpha[j]] = (i32)f;
            total += f;
        }
        if (bad) return E_FREQ;
    }
    if (scale <= total) return E_FREQS;
    freq[alpha[0]] = (i32)(scale - total);
    return OK;
}

// entropy/utils.py read_varint: up to five bytes, 35 bits
int read_varint(Reader& r, u64* out) {
    if (!r.has(8)) return E_EOF;
    u64 value = r.bits(8);
    u64 res = value & 0x7F;
    i32 shift = 7;
    while (value >= 128) {
        if (!r.has(8)) return E_EOF;
        value = r.bits(8);
        res |= (value & 0x7F) << shift;
        if (shift == 28) break;
        shift += 7;
    }
    *out = res;
    return OK;
}

// MSB first into a buffer the caller sized; the last byte zero-padded
struct Writer {
    u8* out; i64 pos; u64 acc; i32 nacc;
    // the low n (0 <= n <= 32) bits of v
    void put(u64 v, i32 n) {
        acc = (acc << n) | (v & ((u64(1) << n) - 1));
        nacc += n;
        if (nacc >= 32) {
            nacc -= 32;
            const u32 w = (u32)(acc >> nacc);
            out[pos] = (u8)(w >> 24);
            out[pos + 1] = (u8)(w >> 16);
            out[pos + 2] = (u8)(w >> 8);
            out[pos + 3] = (u8)w;
            pos += 4;
        }
    }
    i64 bits() const { return 8 * pos + nacc; }
    void finish() {
        for (; nacc >= 8; nacc -= 8) out[pos++] = (u8)(acc >> (nacc - 8));
        if (nacc) out[pos++] = (u8)(acc << (8 - nacc));
        nacc = 0;
    }
};

// EntropyUtils encode_alphabet (entropy/utils.py)
void write_alphabet(Writer& w, const i32* alpha, i32 count) {
    if (count == 0 || count == 256) {
        w.put(0, 1);
        w.put(count == 0 ? 1 : 0, 1);
        return;
    }
    u8 masks[32] = {0};
    for (i32 i = 0; i < count; i++) masks[alpha[i] >> 3] |= (u8)(1 << (alpha[i] & 7));
    const i32 last = alpha[count - 1] >> 3;
    w.put(1, 1);
    w.put((u64)last, 5);
    for (i32 i = 0; i <= last; i++) w.put(masks[i], 8);
}

// entropy/ans.py _write_freqs_header: the alphabet, then freq - 1 of every
// symbol after the first, in groups each after its llr-bit logMax
void write_freqs(Writer& w, i32 lr, const i32* alpha, i32 count, const i32* freq) {
    write_alphabet(w, alpha, count);
    if (count <= 1) return;
    const i32 chk = count >= 64 ? 8 : 6;
    i32 llr = 3;
    while ((1 << llr) <= lr) llr++;
    for (i32 i = 1; i < count; i += chk) {
        const i32 end = i + chk < count ? i + chk : count;
        i64 mx = 0;
        for (i32 j = i; j < end; j++) {
            const i64 v = (i64)freq[alpha[j]] - 1;
            if (v > mx) mx = v;
        }
        i32 log_max = 0;
        while (log_max < 32 && (mx >> log_max) != 0) log_max++;
        w.put((u64)log_max, llr);
        if (log_max > 0)
            for (i32 j = i; j < end; j++) w.put((u64)((i64)freq[alpha[j]] - 1), log_max);
    }
}

}  // namespace

// Parse the headers of a block's ``nfull`` full order-0 chunks from bit
// ``bitpos`` of ``src`` (``src_bits`` bits), in stream order, one chunk
// after the other.  Each chunk with two symbols or more becomes a row:
// ``row_chunk`` its chunk index, ``freq``/``cum`` (256 each) its table and
// its exclusive prefix sum, ``states`` (4) its final states, ``lens`` its
// payload bytes and ``pay_bit`` the payload's first bit in ``src``.  Each
// single-symbol chunk becomes a pair (chunk index, symbol) of ``single``.
// A chunk with a log range other than ``lr_kernel`` ends the parse (unless
// ``host_log_ranges`` is 0, which raises): the rest of the block decodes on
// the host, from that chunk's first bit.  info: [rows, singles, index of
// that chunk or -1, the bit after the parse].  Returns 0, or the first
// error's code.
EXPORT i32 kz_ans0_wire_parse(const u8* src, i64 src_bits, i64 bitpos, i64 nfull,
                              i32 lr_kernel, i32 host_log_ranges, i32* row_chunk,
                              i32* freq, i32* cum, i64* states, i32* lens,
                              i64* pay_bit, i32* single, i64* info) {
    Reader r{src, src_bits, bitpos};
    i64 rows = 0, singles = 0;
    info[2] = -1;
    int e = OK;
    i32 alpha[256];
    for (i64 i = 0; i < nfull; i++) {
        const i64 start = r.pos;
        if (!r.has(3)) { e = E_EOF; break; }
        const i32 lr = 8 + (i32)r.bits(3);
        if (lr != lr_kernel) {
            if (!host_log_ranges) { e = E_MESH_RANGE; break; }
            if (lr < 8 || lr > 15) { e = E_RANGE; break; }
            info[2] = i;
            r.pos = start;
            break;
        }
        i32* f = freq + rows * 256;
        i32 count = 0;
        if ((e = read_freqs(r, lr, alpha, &count, f))) break;
        if (count == 0) { e = E_EMPTY; break; }
        if (count == 1) {
            single[2 * singles] = (i32)i;
            single[2 * singles + 1] = alpha[0];
            singles++;
            continue;
        }
        u64 sz = 0;
        if ((e = read_varint(r, &sz))) break;
        if (sz >= (u64)MAX_CHUNK_SIZE) { e = E_CHUNK_SIZE; break; }
        if (!r.has(128)) { e = E_EOF; break; }
        for (i32 j = 0; j < 4; j++) states[rows * 4 + j] = (i64)r.bits(32);
        if (!r.has(8 * (i64)sz)) { e = E_EOF; break; }
        row_chunk[rows] = (i32)i;
        lens[rows] = (i32)sz;
        pay_bit[rows] = r.pos;
        r.pos += 8 * (i64)sz;
        i32 s = 0;
        i32* c = cum + rows * 256;
        for (i32 k = 0; k < 256; k++) { c[k] = s; s += f[k]; }
        rows++;
    }
    info[0] = rows;
    info[1] = singles;
    info[3] = r.pos;
    return e;
}

// Copy each row's payload (``lens[k]`` bytes from bit ``pay_bit[k]`` of
// ``src``, any alignment) to row k of ``dst`` (n, width), zero past it.
EXPORT void kz_ans0_wire_gather(const u8* src, i64 n, const i64* pay_bit,
                                const i32* lens, i64 width, u8* dst) {
    for (i64 k = 0; k < n; k++) {
        u8* row = dst + k * width;
        const i64 len = lens[k];
        const u8* p = src + (pay_bit[k] >> 3);
        const i32 sh = (i32)(pay_bit[k] & 7);
        if (sh == 0) {
            std::memcpy(row, p, len);
        } else {
            // the payload's last bit lies in byte len of p, inside src
            for (i64 i = 0; i < len; i++)
                row[i] = (u8)((p[i] << sh) | (p[i + 1] >> (8 - sh)));
        }
        std::memset(row + len, 0, width - len);
    }
}

// The records of a block's ``n`` full order-0 chunks, in stream order, from
// the device's rows: ``freq`` (n, 256) each chunk's normalised table,
// ``n_emit`` (n,) its payload words, ``states`` (n, 4) its final states and
// ``payload`` (n, width) its words, of which the first n_emit[k] are
// written, big-endian; 0 <= n_emit[k] <= width.  Each record: 3 bits of
// ``lr`` - 8, the alphabet (the symbols of non-zero frequency) and grouped
// frequencies, and, for two symbols or more, the varint byte count, the
// four 32-bit states and the payload.  Writes MSB first into ``dst``
// (``cap`` bytes, zero past the last bit) and returns the bits written, or
// -1 where a record would not fit.
EXPORT i64 kz_ans0_wire_write(const i32* freq, const i32* n_emit, const u32* states,
                              const u16* payload, i64 n, i64 width, i32 lr, u8* dst,
                              i64 cap) {
    Writer w{dst, 0, 0, 0};
    i32 alpha[256];
    for (i64 k = 0; k < n; k++) {
        const i32* f = freq + k * 256;
        const i64 ne = n_emit[k];
        // a header is under WIRE_HEADER_MAX bytes; the varint, the states,
        // the payload and the bits still in the accumulator follow it
        if (w.pos + WIRE_HEADER_MAX + 5 + 16 + 2 * ne + 8 > cap) return -1;
        i32 count = 0;
        for (i32 s = 0; s < 256; s++)
            if (f[s] > 0) alpha[count++] = s;
        w.put((u64)(lr - 8), 3);
        write_freqs(w, lr, alpha, count, f);
        if (count <= 1) continue;
        u64 size = (u64)(2 * ne) & 0xFFFFFFFFu;   // entropy/utils.py write_varint
        while (size >= 128) {
            w.put(0x80 | (size & 0x7F), 8);
            size >>= 7;
        }
        w.put(size, 8);
        for (i32 j = 0; j < 4; j++) w.put(states[k * 4 + j], 32);
        const u16* p = payload + k * width;
        i64 t = 0;
        for (; t + 1 < ne; t += 2) w.put(((u64)p[t] << 16) | p[t + 1], 32);
        if (t < ne) w.put(p[t], 16);
    }
    const i64 bits = w.bits();
    w.finish();
    return bits;
}
