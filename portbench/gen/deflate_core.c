/*
 * Frozen copy of the encoder half of the program's C core
 * (native/deflate_core.c), kept with the benchmark so that its decode
 * inputs do not move when the program's core changes. One entry point:
 * td_deflate_members, the TD member profile (one gzip member per
 * member_data bytes, one final block each with code lengths capped, or
 * stored blocks where smaller; the member's size in the TD subfield), on
 * all host cores. What it needs is copied unchanged: CRC-32, the bit
 * writer, length-limited Huffman lengths and the hash-chain lazy encoder.
 * Built with cc into portbench/_build/ at first use.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>


/* ------------------------------------------------------------------ */
/* Checksums                                                           */
/* ------------------------------------------------------------------ */

static uint32_t crc_tab[8][256];
static int crc_tab_init = 0;

static void crc_init(void) {
    if (crc_tab_init) return;
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_tab[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
        for (int t = 1; t < 8; t++)
            crc_tab[t][i] = (crc_tab[t - 1][i] >> 8) ^ crc_tab[0][crc_tab[t - 1][i] & 0xFF];
    crc_tab_init = 1;
}

uint32_t td_crc32(const uint8_t *buf, size_t len, uint32_t init) {
    crc_init();
    uint32_t c = init ^ 0xFFFFFFFFu;
    while (len >= 8) {
        uint32_t lo, hi;
        memcpy(&lo, buf, 4);
        memcpy(&hi, buf + 4, 4);
        lo ^= c;
        c = crc_tab[7][lo & 0xFF] ^ crc_tab[6][(lo >> 8) & 0xFF] ^
            crc_tab[5][(lo >> 16) & 0xFF] ^ crc_tab[4][lo >> 24] ^
            crc_tab[3][hi & 0xFF] ^ crc_tab[2][(hi >> 8) & 0xFF] ^
            crc_tab[1][(hi >> 16) & 0xFF] ^ crc_tab[0][hi >> 24];
        buf += 8;
        len -= 8;
    }
    while (len--) c = (c >> 8) ^ crc_tab[0][(c ^ *buf++) & 0xFF];
    return c ^ 0xFFFFFFFFu;
}

/* run/dist base+extra tables (closed form at init) */
static const uint16_t LEN_BASE[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,
    35,43,51,59,67,83,99,115,131,163,195,227,258};
static const uint8_t LEN_EXTRA[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,
    3,3,3,3,4,4,4,4,5,5,5,5,0};
static const uint16_t DIST_BASE[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,97,129,193,
    257,385,513,769,1025,1537,2049,3073,4097,6145,8193,12289,16385,24577};
static const uint8_t DIST_EXTRA[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,
    7,7,8,8,9,9,10,10,11,11,12,12,13,13};

static const uint8_t CLEN_ORDER[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,13,2,14,1,15};

/* ------------------------------------------------------------------ */
/* Deflate: one-shot member payload encoder (single final block)       */
/* ------------------------------------------------------------------ */

typedef struct {
    uint8_t *out;
    size_t cap;
    size_t pos;       /* bytes written */
    uint64_t reg;
    int reg_bits;
    int overflow;
} BitOut;

static void bo_init(BitOut *o, uint8_t *out, size_t cap) {
    o->out = out; o->cap = cap; o->pos = 0; o->reg = 0; o->reg_bits = 0; o->overflow = 0;
}

static void bo_write(BitOut *o, uint32_t val, int n) {
    o->reg |= (uint64_t)val << o->reg_bits;
    o->reg_bits += n;
    while (o->reg_bits >= 8) {
        if (o->pos >= o->cap) { o->overflow = 1; o->reg_bits = 0; return; }
        o->out[o->pos++] = (uint8_t)(o->reg & 0xFF);
        o->reg >>= 8;
        o->reg_bits -= 8;
    }
}

static size_t bo_finish(BitOut *o) {
    if (o->reg_bits > 0) {
        if (o->pos >= o->cap) { o->overflow = 1; return o->pos; }
        o->out[o->pos++] = (uint8_t)(o->reg & 0xFF);
        o->reg = 0; o->reg_bits = 0;
    }
    return o->pos;
}

/* ---- Huffman code length computation (heap Huffman + Kraft repair) -- */

static void heap_push(uint64_t *h, int *n, uint64_t v) {
    int i = (*n)++;
    h[i] = v;
    while (i > 0) {
        int p = (i - 1) >> 1;
        if (h[p] <= h[i]) break;
        uint64_t t = h[p]; h[p] = h[i]; h[i] = t;
        i = p;
    }
}

static uint64_t heap_pop(uint64_t *h, int *n) {
    uint64_t top = h[0];
    h[0] = h[--(*n)];
    int i = 0;
    for (;;) {
        int l = 2 * i + 1, r = l + 1, m = i;
        if (l < *n && h[l] < h[m]) m = l;
        if (r < *n && h[r] < h[m]) m = r;
        if (m == i) break;
        uint64_t t = h[m]; h[m] = h[i]; h[i] = t;
        i = m;
    }
    return top;
}

/* freqs[n] -> lens[n], max_len-limited complete code (>=2 used symbols
 * assumed handled by caller fixes). */
static void huff_lengths(const uint32_t *freqs, int n, int max_len, uint8_t *lens) {
    /* nodes: leaf i in [0,n); internal from n. value packed freq<<16|id */
    uint64_t heap[640];
    int hn = 0;
    int parent[1280];
    int used = 0, lastsym = -1;
    for (int i = 0; i < n; i++) {
        lens[i] = 0;
        if (freqs[i]) { used++; lastsym = i; }
    }
    if (used == 0) return;
    if (used == 1) { lens[lastsym] = 1; return; }
    for (int i = 0; i < n; i++)
        if (freqs[i]) heap_push(heap, &hn, ((uint64_t)freqs[i] << 16) | (uint64_t)i);
    int next_id = n;
    while (hn > 1) {
        uint64_t a = heap_pop(heap, &hn), bnd = heap_pop(heap, &hn);
        uint64_t f = (a >> 16) + (bnd >> 16);
        parent[a & 0xFFFF] = next_id;
        parent[bnd & 0xFFFF] = next_id;
        heap_push(heap, &hn, (f << 16) | (uint64_t)next_id);
        next_id++;
    }
    int root = next_id - 1;
    /* depths: parents have higher ids; iterate down */
    static __thread int depth_buf[1280];
    depth_buf[root] = 0;
    for (int id = root - 1; id >= 0; id--) {
        if (id < n && !freqs[id]) continue;
        depth_buf[id] = depth_buf[parent[id]] + 1;
    }
    /* bl_count with clamp + exact slot repair (same algebra as
     * kernels/huffman.py huffman_lengths_batch) */
    long bl_count[64];
    memset(bl_count, 0, sizeof bl_count);
    for (int i = 0; i < n; i++) {
        if (!freqs[i]) continue;
        int d = depth_buf[i];
        if (d > max_len) d = max_len;
        if (d < 1) d = 1;
        bl_count[d]++;
    }
    long full = 1L << max_len;
    long needed = 0;
    for (int l = 1; l <= max_len; l++) needed += bl_count[l] << (max_len - l);
    while (needed > full) {
        int bits = max_len - 1;
        while (bits > 0 && bl_count[bits] == 0) bits--;
        bl_count[bits]--;
        bl_count[bits + 1] += 2;
        bl_count[max_len]--;
        needed--;
    }
    /* assign: ascending frequency -> descending length. sort used symbols
     * by (freq, sym) via simple index sort (n <= 320). */
    int order[320];
    int m = 0;
    for (int i = 0; i < n; i++)
        if (freqs[i]) order[m++] = i;
    /* insertion sort by freq then sym (stable enough; n small) */
    for (int i = 1; i < m; i++) {
        int key = order[i];
        int j = i - 1;
        while (j >= 0 && (freqs[order[j]] > freqs[key] ||
               (freqs[order[j]] == freqs[key] && order[j] > key))) {
            order[j + 1] = order[j];
            j--;
        }
        order[j + 1] = key;
    }
    int oi = 0;
    for (int l = max_len; l >= 1; l--)
        for (long c = 0; c < bl_count[l]; c++)
            lens[order[oi++]] = (uint8_t)l;
}

static void canon_codes(const uint8_t *lens, int n, uint16_t *codes) {
    int counts[16];
    memset(counts, 0, sizeof counts);
    for (int i = 0; i < n; i++) counts[lens[i]]++;
    counts[0] = 0;
    int next_code[16];
    int code = 0;
    for (int l = 1; l <= 15; l++) {
        code = (code + counts[l - 1]) << 1;
        next_code[l] = code;
    }
    for (int s = 0; s < n; s++) {
        int l = lens[s];
        if (!l) { codes[s] = 0; continue; }
        int c = next_code[l]++;
        int rev = 0;
        for (int k = 0; k < l; k++) rev |= ((c >> k) & 1) << (l - 1 - k);
        codes[s] = (uint16_t)rev;
    }
}

/* run -> (sym, extra bits, extra val) */
static inline void run_sym(uint32_t run, int *sym, int *eb, uint32_t *ev) {
    int lo = 0, hi = 28;
    while (lo < hi) {
        int mid = (lo + hi + 1) >> 1;
        if (LEN_BASE[mid] <= run) lo = mid; else hi = mid - 1;
    }
    if (run == 258) lo = 28;
    *sym = 257 + lo;
    *eb = LEN_EXTRA[lo];
    *ev = run - LEN_BASE[lo];
}

static inline void dist_sym(uint32_t dist, int *sym, int *eb, uint32_t *ev) {
    int lo = 0, hi = 29;
    while (lo < hi) {
        int mid = (lo + hi + 1) >> 1;
        if (DIST_BASE[mid] <= dist) lo = mid; else hi = mid - 1;
    }
    *sym = lo;
    *eb = DIST_EXTRA[lo];
    *ev = dist - DIST_BASE[lo];
}

#define HASH_BITS 15
#define HASH_SIZE (1 << HASH_BITS)
#define WIN 32768

static inline uint32_t hash4(const uint8_t *p) {
    uint32_t x;
    memcpy(&x, p, 4);
    return (x * 2654435761u) >> (32 - HASH_BITS);
}

/* 3-byte hash: chains keyed on the minimum match length, so length-3
 * matches are discoverable (a 4-byte key silently loses every len-3
 * match; ≙ the reference searches all distances down to minRun=3,
 * comp/Lz77Huffman.java:71-84). */
static inline uint32_t hash3(const uint8_t *p) {
    uint32_t x = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
    return (x * 2654435761u) >> (32 - HASH_BITS);
}

/* Core block encoder.
 *
 * in = [history (hist_len bytes) | data (n bytes)], total <= 128 KiB.
 * Emits ONE DEFLATE block covering the data (dynamic, or stored when
 * smaller and byte-alignable), starting at bit position start_bit (0-7)
 * with seed_byte's low start_bit bits already occupied. Matches may
 * reach into the history (the continuous-stream mode: ≙ the reference's
 * sliding [history][data] buffer, DeflaterOutputStream.java:38-45).
 *
 * Returns the TOTAL bit count (including start_bit) written into out
 * (out[0] is OR-seeded with seed_byte), or 0 on error. */
static size_t deflate_block(const uint8_t *in, size_t hist_len, size_t n,
                            uint8_t *out, size_t out_cap, int final,
                            int start_bit, uint8_t seed_byte,
                            int max_code_len, int max_chain);

/* Encode one member payload (<= 64 KiB data) as a single final DEFLATE
 * block with code lengths capped at max_code_len. Falls back to stored
 * blocks when that is smaller. Returns compressed size, or 0 on error. */
size_t td_deflate_member(const uint8_t *in, size_t n, uint8_t *out, size_t out_cap,
                         int max_code_len, int max_chain) {
    size_t bits = deflate_block(in, 0, n, out, out_cap, 1, 0, 0,
                                max_code_len, max_chain);
    if (bits == 0 && n > 0) return 0;
    return (bits + 7) / 8;
}

/* Exported generalized block encoder (continuous-stream building block). */

#define ENC_MAX_TOTAL (1 << 17)

static size_t deflate_block(const uint8_t *in, size_t hist_len, size_t n,
                            uint8_t *out, size_t out_cap, int final,
                            int start_bit, uint8_t seed_byte,
                            int max_code_len, int max_chain) {
    /* --- tokenize: hash-chain lazy matcher over [history | data] --- */
    static __thread int32_t head[HASH_SIZE];
    static __thread int32_t prevtab[ENC_MAX_TOTAL];
    static __thread uint16_t tok_run[1 << 16];
    static __thread uint16_t tok_dist[1 << 16];
    static __thread uint8_t tok_lit[1 << 16];
    static __thread uint32_t freqs_ll[288], freqs_d[30];
    size_t total = hist_len + n;
    if (n > (1 << 16) || total > ENC_MAX_TOTAL || out_cap < 64) return 0;
    if (start_bit < 0 || start_bit > 7) return 0;
    memset(freqs_ll, 0, sizeof freqs_ll);
    memset(freqs_d, 0, sizeof freqs_d);
    memset(head, -1, sizeof head);
    int ntok = 0;
    size_t i = hist_len;
    /* zlib-style "nice length": once a match this long is found, stop
     * walking the chain (derived from max_chain to keep the ABI). */
    uint32_t nice_len = max_chain <= 8 ? 32 : max_chain <= 64 ? 96 : 258;

    if (max_chain <= 4) {
        /* Greedy hash4 fast mode (effort 1): a single-entry head table,
         * no chains, no lazy pass — one hash+verify per position, match
         * length >=4 (the classic fast-level trade: len-3 matches are
         * not discoverable). Several times the throughput of the lazy
         * matcher at a few percent ratio cost. */
        for (size_t j = 0; j + 4 <= hist_len; j++)
            head[hash4(in + j)] = (int32_t)j;
        i = hist_len;
        while (i < total) {
            uint32_t x, y;
            if (i + 4 > total) goto fast_lit;
            {
                uint32_t h = hash4(in + i);
                int32_t c = head[h];
                head[h] = (int32_t)i;
                memcpy(&x, in + i, 4);
                if (c < 0 || i - (size_t)c > WIN) goto fast_lit;
                memcpy(&y, in + (size_t)c, 4);
                if (x != y) goto fast_lit;
                uint32_t lim = total - i < 258 ? (uint32_t)(total - i) : 258;
                uint32_t l = 4;
                const uint8_t *a = in + i, *bb = in + (size_t)c;
                while (l + 8 <= lim) {
                    uint64_t xa, xb;
                    memcpy(&xa, a + l, 8);
                    memcpy(&xb, bb + l, 8);
                    uint64_t d = xa ^ xb;
                    if (d) { l += (uint32_t)(__builtin_ctzll(d) >> 3); break; }
                    l += 8;
                }
                while (l < lim && a[l] == bb[l]) l++;
                uint32_t dist = (uint32_t)(i - (size_t)c);
                int s, eb; uint32_t ev;
                run_sym(l, &s, &eb, &ev);
                freqs_ll[s]++;
                dist_sym(dist, &s, &eb, &ev);
                freqs_d[s]++;
                tok_run[ntok] = (uint16_t)l;
                tok_dist[ntok] = (uint16_t)(dist - 1);
                tok_lit[ntok] = 0;
                ntok++;
                /* keep the table warm without hashing the whole span */
                size_t p1 = i + (l >> 1), p2 = i + l - 2;
                if (p1 + 4 <= total) head[hash4(in + p1)] = (int32_t)p1;
                if (p2 + 4 <= total && p2 != p1) head[hash4(in + p2)] = (int32_t)p2;
                i += l;
                continue;
            }
        fast_lit:
            freqs_ll[in[i]]++;
            tok_run[ntok] = 0;
            tok_dist[ntok] = 0;
            tok_lit[ntok] = in[i];
            ntok++;
            i++;
        }
        goto tokens_done;
    }

    #define FIND(ipos, bestlen_out, bestdist_out) do { \
        uint32_t _bl = 0, _bd = 0; \
        if ((ipos) + 3 <= total) { \
            uint32_t _h = hash3(in + (ipos)); \
            int32_t _c = head[_h]; \
            int _chain = max_chain; \
            uint32_t _lim = total - (ipos) < 258 ? (uint32_t)(total - (ipos)) : 258; \
            const uint8_t *_a = in + (ipos); \
            while (_c >= 0 && _chain-- > 0) { \
                uint32_t _d = (uint32_t)((ipos) - _c); \
                if (_d > WIN) break; \
                const uint8_t *_b2 = in + _c; \
                /* one-byte pre-filter: once a decent match is held, a \
                 * candidate that can't extend past it loses on score \
                 * almost surely — skip it with a single load. */ \
                if (_bl >= 6 && _b2[_bl] != _a[_bl]) { _c = prevtab[_c]; continue; } \
                uint32_t _l = 0; \
                while (_l + 8 <= _lim) { \
                    uint64_t _xa, _xb; \
                    memcpy(&_xa, _a + _l, 8); \
                    memcpy(&_xb, _b2 + _l, 8); \
                    uint64_t _x = _xa ^ _xb; \
                    if (_x) { _l += (uint32_t)(__builtin_ctzll(_x) >> 3); break; } \
                    _l += 8; \
                } \
                while (_l < _lim && _a[_l] == _b2[_l]) _l++; \
                /* cost-aware: a longer match must pay for its extra \
                 * distance bits (dist extra ~ 2*(log2(d)-2); len gain is \
                 * ~8 bits/byte of literals saved). Score = 8*len - dbits. */ \
                uint32_t _db = _d <= 4 ? 0 : (uint32_t)(30 - __builtin_clz(_d - 1) - 2) * 2; \
                uint32_t _bdb = _bd <= 4 ? 0 : (uint32_t)(30 - __builtin_clz(_bd - 1) - 2) * 2; \
                int _sc = (int)(_l * 8) - (int)_db, _bsc = (int)(_bl * 8) - (int)_bdb; \
                if (_bl == 0 || _sc > _bsc || (_sc == _bsc && _d < _bd)) { _bl = _l; _bd = _d; } \
                if (_l >= _lim || _bl >= nice_len) break; \
                _c = prevtab[_c]; \
            } \
        } \
        bestlen_out = _bl; bestdist_out = _bd; \
    } while (0)

    #define INSERT(ipos) do { \
        if ((ipos) + 3 <= total) { \
            uint32_t _h = hash3(in + (ipos)); \
            prevtab[ipos] = head[_h]; \
            head[_h] = (int32_t)(ipos); \
        } \
    } while (0)

    size_t ins = 0;
    #define INS_UPTO(x) do { while (ins < (x) && ins < total) { INSERT(ins); ins++; } } while (0)

    uint32_t cur_len = 0, cur_dist = 0;
    INS_UPTO(hist_len);
    FIND(hist_len, cur_len, cur_dist);
    INS_UPTO(hist_len + 1);
    while (i < total) {
        uint32_t nl = 0, nd = 0;
        /* lazy evaluation pays only for middling matches: a match at
         * nice_len+ is taken immediately (zlib's max_lazy rule). */
        if (i + 1 < total && cur_len < nice_len) {
            INS_UPTO(i + 1);
            FIND(i + 1, nl, nd);
        }
        /* score-aware lazy: defer to the next position's match only when
         * its cost-adjusted gain beats the current match plus the literal
         * byte deferral forces out (~8 bits). Same scoring as FIND. */
        int cur_sc = (int)(cur_len * 8) -
                     (cur_dist <= 4 ? 0 : (int)(30 - __builtin_clz(cur_dist - 1) - 2) * 2);
        int nxt_sc = (int)(nl * 8) -
                     (nd <= 4 || nl == 0 ? 0 : (int)(30 - __builtin_clz(nd - 1) - 2) * 2);
        int take = cur_len >= 3 && !(cur_len == 3 && cur_dist > 4096) &&
                   cur_sc + 8 >= nxt_sc;
        if (take) {
            int s, eb; uint32_t ev;
            run_sym(cur_len, &s, &eb, &ev);
            freqs_ll[s]++;
            dist_sym(cur_dist, &s, &eb, &ev);
            freqs_d[s]++;
            tok_run[ntok] = (uint16_t)cur_len;
            tok_dist[ntok] = (uint16_t)(cur_dist - 1);
            tok_lit[ntok] = 0;
            ntok++;
            i += cur_len;
            if (i < total) {
                /* long matches (typically runs) skip interior inserts:
                 * the chain already holds the span's start, and hashing
                 * every covered position costs more than the sliver of
                 * ratio it buys. */
                if (cur_len >= nice_len && ins < i) ins = i > 2 ? i - 2 : ins;
                INS_UPTO(i);
                FIND(i, cur_len, cur_dist);
            } else cur_len = 0;
        } else {
            freqs_ll[in[i]]++;
            tok_run[ntok] = 0;
            tok_dist[ntok] = 0;
            tok_lit[ntok] = in[i];
            ntok++;
            i++;
            cur_len = nl; cur_dist = nd;
        }
    }
tokens_done:
    freqs_ll[256]++;

    /* --- code lengths + degenerate fixes (reference semantics) --- */
    int used_d = 0, last_d = -1;
    for (int k = 0; k < 30; k++)
        if (freqs_d[k]) { used_d++; last_d = k; }
    if (used_d == 1) {
        if (last_d + 1 < 30) freqs_d[last_d + 1] = 1;
        else freqs_d[last_d - 1] = 1;
    }
    int used_ll = 0;
    for (int k = 0; k < 288; k++) if (freqs_ll[k]) used_ll++;
    if (used_ll < 2) freqs_ll[0]++;

    static __thread uint8_t ll_lens[288], d_lens[30], clen_lens[19];
    static __thread uint16_t ll_codes[288], d_codes[30], clen_codes[19];
    huff_lengths(freqs_ll, 288, max_code_len, ll_lens);
    huff_lengths(freqs_d, 30, max_code_len, d_lens);
    canon_codes(ll_lens, 288, ll_codes);
    canon_codes(d_lens, 30, d_codes);

    int hlit = 288;
    while (hlit > 257 && ll_lens[hlit - 1] == 0) hlit--;
    int hdist = 30;
    while (hdist > 1 && d_lens[hdist - 1] == 0) hdist--;

    /* clen RLE (greedy, comp/Lz77Huffman.java:189-223 rules) */
    uint8_t all_lens[288 + 30];
    memcpy(all_lens, ll_lens, hlit);
    memcpy(all_lens + hlit, d_lens, hdist);
    int rle_total = hlit + hdist;
    static __thread uint8_t rle_sym[320];
    static __thread uint8_t rle_extra[320];
    int nrle = 0;
    uint32_t clen_freq[19];
    memset(clen_freq, 0, sizeof clen_freq);
    {
        int p = 0;
        while (p < rle_total) {
            int val = all_lens[p];
            if (val == 0) {
                int run = 1;
                while (run < 138 && p + run < rle_total && all_lens[p + run] == 0) run++;
                if (run < 3) { rle_sym[nrle] = 0; rle_extra[nrle++] = 0; clen_freq[0]++; p++; }
                else if (run < 11) { rle_sym[nrle] = 17; rle_extra[nrle++] = (uint8_t)(run - 3); clen_freq[17]++; p += run; }
                else { rle_sym[nrle] = 18; rle_extra[nrle++] = (uint8_t)(run - 11); clen_freq[18]++; p += run; }
                continue;
            }
            if (p > 0) {
                int run = 0;
                while (run < 6 && p + run < rle_total && all_lens[p + run] == all_lens[p - 1]) run++;
                if (run >= 3) { rle_sym[nrle] = 16; rle_extra[nrle++] = (uint8_t)(run - 3); clen_freq[16]++; p += run; continue; }
            }
            rle_sym[nrle] = (uint8_t)val; rle_extra[nrle++] = 0; clen_freq[val]++; p++;
        }
    }
    {
        int used_c = 0, first_c = 0;
        for (int k = 0; k < 19; k++) if (clen_freq[k]) { used_c++; first_c = k; }
        if (used_c < 2) clen_freq[(first_c + 1) % 19]++;
    }
    huff_lengths(clen_freq, 19, 7, clen_lens);
    canon_codes(clen_lens, 19, clen_codes);
    int hclen = 19;
    while (hclen > 4 && clen_lens[CLEN_ORDER[hclen - 1]] == 0) hclen--;

    /* --- emit dynamic block --- */
    BitOut o;
    bo_init(&o, out, out_cap);
    if (start_bit) {
        out[0] = 0;
        o.reg = seed_byte & ((1u << start_bit) - 1);
        o.reg_bits = start_bit;
    }
    bo_write(&o, final ? 1 : 0, 1);
    bo_write(&o, 2, 2); /* dynamic */
    bo_write(&o, (uint32_t)(hlit - 257), 5);
    bo_write(&o, (uint32_t)(hdist - 1), 5);
    bo_write(&o, (uint32_t)(hclen - 4), 4);
    for (int k = 0; k < hclen; k++) bo_write(&o, clen_lens[CLEN_ORDER[k]], 3);
    for (int k = 0; k < nrle; k++) {
        int s = rle_sym[k];
        bo_write(&o, clen_codes[s], clen_lens[s]);
        if (s == 16) bo_write(&o, rle_extra[k], 2);
        else if (s == 17) bo_write(&o, rle_extra[k], 3);
        else if (s == 18) bo_write(&o, rle_extra[k], 7);
    }
    for (int k = 0; k < ntok && !o.overflow; k++) {
        if (tok_run[k] == 0) {
            int s2 = tok_lit[k];
            bo_write(&o, ll_codes[s2], ll_lens[s2]);
        } else {
            int s2, eb; uint32_t ev;
            run_sym(tok_run[k], &s2, &eb, &ev);
            bo_write(&o, ll_codes[s2], ll_lens[s2]);
            if (eb) bo_write(&o, ev, eb);
            dist_sym((uint32_t)tok_dist[k] + 1, &s2, &eb, &ev);
            bo_write(&o, d_codes[s2], d_lens[s2]);
            if (eb) bo_write(&o, ev, eb);
        }
    }
    bo_write(&o, ll_codes[256], ll_lens[256]);
    size_t dyn_bits = (size_t)o.pos * 8 + (size_t)o.reg_bits;
    bo_finish(&o);

    /* stored fallback: header(3) + pad-to-byte + (5-byte hdr + data)/block */
    size_t stored_bits;
    {
        size_t blocks = n ? (n + 65534) / 65535 : 1;
        size_t pad = (8 - ((start_bit + 3) & 7)) & 7;
        /* first block: 3-bit header + pad + 32-bit len/nlen; each later
           block starts byte-aligned: 3 + 5 pad + 32 = 40 bits */
        stored_bits = (size_t)start_bit + 3 + pad + 32 + n * 8 + (blocks - 1) * 40;
    }
    if (o.overflow || dyn_bits >= stored_bits) {
        if ((stored_bits + 7) / 8 > out_cap) return 0;
        BitOut so;
        bo_init(&so, out, out_cap);
        if (start_bit) {
            out[0] = 0;
            so.reg = seed_byte & ((1u << start_bit) - 1);
            so.reg_bits = start_bit;
        }
        size_t ip = 0;
        do {
            size_t blk = n - ip > 65535 ? 65535 : n - ip;
            int fin = final && (ip + blk == n);
            bo_write(&so, (uint32_t)(fin ? 1 : 0), 1);
            bo_write(&so, 0, 2);
            int pad = (int)((8 - (((size_t)so.pos * 8 + so.reg_bits) & 7)) & 7);
            if (pad) bo_write(&so, 0, pad);
            bo_write(&so, (uint32_t)(blk & 0xFFFF), 16);
            bo_write(&so, (uint32_t)(~blk & 0xFFFF), 16);
            for (size_t k2 = 0; k2 < blk; k2++) bo_write(&so, in[hist_len + ip + k2], 8);
            ip += blk;
        } while (ip < n);
        size_t sbits = (size_t)so.pos * 8 + (size_t)so.reg_bits;
        bo_finish(&so);
        if (so.overflow) return 0;
        return sbits;
    }
    return dyn_bits;
}


#include <pthread.h>
#include <stdlib.h>

/* ------------------------------------------------------------------ */
/* Member-parallel deflate: encode fixed-size chunks as independent   */
/* TD-profile gzip members on a pthread work queue. Workers encode    */
/* into a reusable per-thread slot (warm pages), then commit to the   */
/* shared output IN MEMBER ORDER (spin on a committed counter), so    */
/* the result is deterministic and needs no giant scratch buffer.     */
/* ------------------------------------------------------------------ */

#include <sched.h>

#define MEMBER_HDR 20 /* 10-byte gzip header + XLEN + 'TD' u32 subfield */

typedef struct {
    const uint8_t *data;
    size_t n;
    size_t member_data;
    int max_code_len, max_chain;
    uint8_t *out;
    size_t out_cap;
    long nm;
    long next;       /* atomic: next member to encode */
    long committed;  /* members fully written to out */
    size_t out_pos;  /* write cursor (owned by the committing thread) */
    int failed;
} EncJob;

static void enc_frame(uint8_t *slot, const uint8_t *src, size_t len, size_t pay) {
    static const uint8_t HDR10[10] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff};
    uint32_t total = (uint32_t)(MEMBER_HDR + pay + 8);
    memcpy(slot, HDR10, 10);
    slot[10] = 8; slot[11] = 0;                  /* XLEN */
    slot[12] = 'T'; slot[13] = 'D';
    slot[14] = 4; slot[15] = 0;                  /* subfield len */
    slot[16] = (uint8_t)total; slot[17] = (uint8_t)(total >> 8);
    slot[18] = (uint8_t)(total >> 16); slot[19] = (uint8_t)(total >> 24);
    uint32_t crc = td_crc32(src, len, 0);
    uint8_t *tr = slot + MEMBER_HDR + pay;
    tr[0] = (uint8_t)crc; tr[1] = (uint8_t)(crc >> 8);
    tr[2] = (uint8_t)(crc >> 16); tr[3] = (uint8_t)(crc >> 24);
    uint32_t is = (uint32_t)len;
    tr[4] = (uint8_t)is; tr[5] = (uint8_t)(is >> 8);
    tr[6] = (uint8_t)(is >> 16); tr[7] = (uint8_t)(is >> 24);
}

static void *enc_worker(void *arg) {
    EncJob *j = (EncJob *)arg;
    size_t slot_cap = MEMBER_HDR + j->member_data + j->member_data / 8 + 1024 + 8;
    uint8_t *slot = (uint8_t *)malloc(slot_cap);
    if (!slot) { j->failed = 1; return NULL; }
    for (;;) {
        long i = __sync_fetch_and_add(&j->next, 1);
        if (i >= j->nm || j->failed) break;
        size_t start = (size_t)i * j->member_data;
        size_t len = j->n - start;
        if (len > j->member_data) len = j->member_data;
        size_t pay = td_deflate_member(j->data + start, len, slot + MEMBER_HDR,
                                       slot_cap - MEMBER_HDR - 8,
                                       j->max_code_len, j->max_chain);
        if (pay == 0 && len > 0) { j->failed = 1; break; }
        enc_frame(slot, j->data + start, len, pay);
        size_t total = MEMBER_HDR + pay + 8;
        while (__sync_fetch_and_add(&j->committed, 0) != i) {
            if (j->failed) goto done;
            sched_yield();
        }
        if (j->out_pos + total > j->out_cap) { j->failed = 1; break; }
        memcpy(j->out + j->out_pos, slot, total);
        j->out_pos += total;
        __sync_fetch_and_add(&j->committed, 1);
    }
done:
    free(slot);
    return NULL;
}

/* Encode n bytes as ceil(n/member_data) TD-profile gzip members in
 * parallel. Returns total output size, or 0 on failure. */
size_t td_deflate_members(const uint8_t *data, size_t n, size_t member_data,
                          int max_code_len, int max_chain, int n_threads,
                          uint8_t *out, size_t out_cap) {
    if (n == 0 || member_data == 0) return 0;
    EncJob job = {data, n, member_data, max_code_len, max_chain,
                  out, out_cap, 0, 0, 0, 0, 0};
    job.nm = (long)((n + member_data - 1) / member_data);
    if (n_threads < 1) n_threads = 1;
    if (n_threads > job.nm) n_threads = (int)job.nm;
    if (n_threads > 64) n_threads = 64;
    pthread_t tids[64];
    int spawned = 0;
    for (int t = 0; t < n_threads - 1; t++)
        if (pthread_create(&tids[t], NULL, enc_worker, &job) == 0) spawned++;
    enc_worker(&job);
    for (int t = 0; t < spawned; t++) pthread_join(tids[t], NULL);
    if (job.failed || job.committed != job.nm) return 0;
    return job.out_pos;
}
