/* A Zstandard decoder (RFC 8878) and CRC-32C, for reading Orbax checkpoints.
 *
 * tensorstore compresses OCDBT's manifests and b-tree nodes and zarr's chunks
 * with zstd; the port reads them without the zstd library. This decodes:
 *   - frames: single segment or not, frame content size present or absent,
 *     the window descriptor, the XXH64 content checksum (verified when its
 *     flag is set); concatenated frames and skippable frames;
 *   - raw, RLE and compressed blocks;
 *   - literals: raw, RLE, Huffman-compressed and treeless, 1 or 4 streams,
 *     Huffman weights stored direct or FSE-compressed;
 *   - sequences in predefined, RLE, FSE-compressed and repeat modes, and the
 *     three repeat offsets.
 * A frame that names a dictionary is refused by name: no dictionary is ever
 * given, and tensorstore writes none.
 *
 * The caller gives the output's capacity. Every read is checked against the
 * input's end and every write against the capacity: a truncated, overrunning
 * or corrupt input returns an error with a message and never touches memory
 * outside the two buffers. Errors unwind with longjmp to the entry point,
 * which frees the one work area it allocated.
 *
 * Entry points (see utils/zstd.py):
 *   long tcs_zstd_decompress(src, n, dst, cap, err, errlen)
 *       bytes written, or -1 with err set;
 *   long long tcs_zstd_content_size(src, n)
 *       the first frame's content size, -1 where the header omits it,
 *       -2 where the header cannot be read;
 *   unsigned tcs_crc32c(crc, p, n)   CRC-32C (Castagnoli), OCDBT's checksum.
 */

#include <setjmp.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define ZSTD_MAGIC 0xFD2FB528u
#define BLOCK_MAX (128 * 1024)
#define HUF_MAX_BITS 11
#define HUF_MAX_SYMBOLS 256
#define LL_MAX_LOG 9
#define ML_MAX_LOG 9
#define OF_MAX_LOG 8
#define MAX_FSE_SYMBOLS 256

typedef struct {
  uint8_t symbol;
  uint8_t nbits;
} HufCell;

typedef struct {
  uint16_t base;
  uint8_t symbol;
  uint8_t nbits;
} FseCell;

typedef struct {
  FseCell cell[1 << LL_MAX_LOG];
  int log;
  int ready;
} FseTable;

typedef struct {
  jmp_buf fail;
  char *err;
  int errlen;
  /* the frame's persistent state */
  HufCell huf[1 << HUF_MAX_BITS];
  int huf_bits;
  int huf_ready;
  FseTable ll, of, ml;
  FseTable weights; /* the Huffman weights' table, built per description */
  uint32_t rep[3];
  /* one block's literals */
  uint8_t lit[BLOCK_MAX + 8];
  size_t nlit;
} Ctx;

static void fail(Ctx *c, const char *fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  if (c->err && c->errlen > 0) vsnprintf(c->err, (size_t)c->errlen, fmt, ap);
  va_end(ap);
  longjmp(c->fail, 1);
}

#define CORRUPT(...) fail(c, __VA_ARGS__)

static int highbit32(uint32_t v) { /* index of the highest set bit; v > 0 */
  int n = 0;
  while (v >>= 1) n++;
  return n;
}

static uint32_t le16(const uint8_t *p) { return (uint32_t)p[0] | ((uint32_t)p[1] << 8); }
static uint32_t le24(const uint8_t *p) { return le16(p) | ((uint32_t)p[2] << 16); }
static uint32_t le32(const uint8_t *p) { return le16(p) | (le16(p + 2) << 16); }
static uint64_t le64(const uint8_t *p) { return (uint64_t)le32(p) | ((uint64_t)le32(p + 4) << 32); }

/* ---------------------------------------------------------------- bits */

/* A forward little-endian bit reader (FSE table descriptions). */
typedef struct {
  const uint8_t *p;
  size_t n;      /* bytes */
  size_t bit;    /* next bit to read */
} FwdBits;

static uint32_t fwd_read(Ctx *c, FwdBits *b, int nbits) {
  uint32_t v = 0;
  for (int i = 0; i < nbits; i++, b->bit++) {
    if ((b->bit >> 3) >= b->n) CORRUPT("FSE table description runs past its block");
    v |= (uint32_t)((b->p[b->bit >> 3] >> (b->bit & 7)) & 1) << i;
  }
  return v;
}

/* A backward bit reader (Huffman and FSE streams): the stream is read from
 * its last bit towards its first; bits before the first read as 0 and are
 * counted, so that a caller can check how far it overran. */
typedef struct {
  const uint8_t *p;
  size_t n;
  int64_t pos; /* bits [0, pos) are unread; negative once past the start */
} BackBits;

static void back_init(Ctx *c, BackBits *b, const uint8_t *p, size_t n) {
  if (n == 0) CORRUPT("empty bit stream");
  uint8_t last = p[n - 1];
  if (last == 0) CORRUPT("bit stream without its end mark");
  b->p = p;
  b->n = n;
  b->pos = (int64_t)n * 8 - 8 + highbit32(last);
}

/* bits [lo, lo + nbits) of the stream, lo >= 0, nbits <= 57 */
static uint64_t bits_at(const BackBits *b, int64_t lo, int nbits) {
  if (nbits == 0) return 0;
  size_t byte = (size_t)(lo >> 3);
  int shift = (int)(lo & 7);
  uint64_t w = 0;
  size_t avail = b->n - byte;
  if (avail >= 8) {
    w = le64(b->p + byte);
  } else {
    for (size_t i = 0; i < avail; i++) w |= (uint64_t)b->p[byte + i] << (8 * i);
  }
  return (w >> shift) & ((((uint64_t)1) << nbits) - 1);
}

static inline uint64_t back_read(BackBits *b, int nbits) {
  b->pos -= nbits;
  if (b->pos >= 0) return bits_at(b, b->pos, nbits);
  int64_t have = nbits + b->pos; /* bits still in the stream */
  if (have <= 0) return 0;
  return bits_at(b, 0, (int)have) << (-b->pos);
}

/* ---------------------------------------------------------------- FSE */

/* Reads a normalised distribution (RFC 8878 4.1.1); returns bytes used. */
static size_t fse_read_counts(Ctx *c, const uint8_t *p, size_t n, int max_log, int max_symbol,
                              int16_t *counts, int *nsym, int *log) {
  FwdBits b = {p, n, 0};
  int al = (int)fwd_read(c, &b, 4) + 5;
  if (al > max_log) CORRUPT("FSE accuracy log %d above %d", al, max_log);
  int remaining = 1 << al;
  int s = 0;
  while (remaining > 0) {
    if (s > max_symbol) CORRUPT("FSE distribution has more than %d symbols", max_symbol + 1);
    int nb = highbit32((uint32_t)remaining + 1) + 1;
    uint32_t val = fwd_read(c, &b, nb);
    uint32_t lower_mask = (1u << (nb - 1)) - 1;
    uint32_t threshold = (1u << nb) - 1 - ((uint32_t)remaining + 1);
    if ((val & lower_mask) < threshold) {
      b.bit--; /* the value took one bit less */
      val &= lower_mask;
    } else if (val > lower_mask) {
      val -= threshold;
    }
    int prob = (int)val - 1;
    remaining -= prob < 0 ? -prob : prob;
    counts[s++] = (int16_t)prob;
    if (prob == 0) {
      for (;;) {
        int repeat = (int)fwd_read(c, &b, 2);
        for (int i = 0; i < repeat; i++) {
          if (s > max_symbol) CORRUPT("FSE zero run passes symbol %d", max_symbol);
          counts[s++] = 0;
        }
        if (repeat != 3) break;
      }
    }
  }
  if (remaining != 0) CORRUPT("FSE distribution does not sum to its table size");
  *nsym = s;
  *log = al;
  return (b.bit + 7) >> 3;
}

static void fse_build(Ctx *c, FseTable *t, const int16_t *counts, int nsym, int log) {
  int size = 1 << log;
  int high = size - 1;
  uint16_t next[MAX_FSE_SYMBOLS];
  for (int s = 0; s < nsym; s++) {
    if (counts[s] == -1) {
      t->cell[high--].symbol = (uint8_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint16_t)counts[s];
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; s++) {
    for (int i = 0; i < counts[s]; i++) {
      t->cell[pos].symbol = (uint8_t)s;
      do pos = (pos + step) & mask; while (pos > high);
    }
  }
  if (pos != 0) CORRUPT("FSE distribution does not fill its table");
  for (int u = 0; u < size; u++) {
    int s = t->cell[u].symbol;
    uint32_t state = next[s]++;
    int nb = log - highbit32(state);
    t->cell[u].nbits = (uint8_t)nb;
    t->cell[u].base = (uint16_t)((state << nb) - (uint32_t)size);
  }
  t->log = log;
  t->ready = 1;
}

static void fse_rle(FseTable *t, uint8_t symbol) {
  t->cell[0].symbol = symbol;
  t->cell[0].nbits = 0;
  t->cell[0].base = 0;
  t->log = 0;
  t->ready = 1;
}

static inline uint32_t fse_init(BackBits *b, const FseTable *t) {
  return (uint32_t)back_read(b, t->log);
}

static inline uint32_t fse_update(BackBits *b, const FseTable *t, uint32_t state) {
  const FseCell *cell = &t->cell[state];
  return cell->base + (uint32_t)back_read(b, cell->nbits);
}

/* ------------------------------------------------------------- Huffman */

static void huf_build(Ctx *c, const uint8_t *weights, int nweights) {
  /* the last symbol's weight is implied by the others' sum */
  uint32_t total = 0;
  for (int i = 0; i < nweights; i++) {
    if (weights[i] > HUF_MAX_BITS) CORRUPT("Huffman weight %d above %d", weights[i], HUF_MAX_BITS);
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) CORRUPT("Huffman weights all zero");
  int max_bits = highbit32(total) + 1;
  if (max_bits > HUF_MAX_BITS) CORRUPT("Huffman code longer than %d bits", HUF_MAX_BITS);
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) CORRUPT("Huffman weights leave no power of two for the last symbol");
  int nsym = nweights + 1;
  if (nsym > HUF_MAX_SYMBOLS) CORRUPT("more than 256 Huffman symbols");
  uint8_t nbits[HUF_MAX_SYMBOLS];
  int rank_count[HUF_MAX_BITS + 2] = {0};
  for (int i = 0; i < nsym; i++) {
    int w = i < nweights ? weights[i] : highbit32(rest) + 1;
    nbits[i] = (uint8_t)(w ? max_bits + 1 - w : 0);
    rank_count[nbits[i]]++;
  }
  uint32_t rank_idx[HUF_MAX_BITS + 2];
  rank_idx[max_bits] = 0;
  for (int i = max_bits; i >= 1; i--)
    rank_idx[i - 1] = rank_idx[i] + (uint32_t)rank_count[i] * (1u << (max_bits - i));
  if (rank_idx[0] != (1u << max_bits)) CORRUPT("Huffman code does not fill its table");
  for (int i = 0; i < nsym; i++) {
    if (!nbits[i]) continue;
    uint32_t len = 1u << (max_bits - nbits[i]);
    for (uint32_t k = 0; k < len; k++) {
      c->huf[rank_idx[nbits[i]] + k].symbol = (uint8_t)i;
      c->huf[rank_idx[nbits[i]] + k].nbits = nbits[i];
    }
    rank_idx[nbits[i]] += len;
  }
  c->huf_bits = max_bits;
  c->huf_ready = 1;
}

/* Reads a Huffman tree description; returns the bytes it took. */
static size_t huf_read_tree(Ctx *c, const uint8_t *p, size_t n) {
  if (n < 1) CORRUPT("Huffman tree description missing");
  uint8_t weights[HUF_MAX_SYMBOLS];
  int nw = 0;
  size_t used;
  int hb = p[0];
  if (hb >= 128) {
    nw = hb - 127;
    used = 1 + (size_t)(nw + 1) / 2;
    if (used > n) CORRUPT("Huffman weights run past the literals");
    for (int i = 0; i < nw; i++) {
      uint8_t b = p[1 + i / 2];
      weights[i] = (uint8_t)((i & 1) ? b & 15 : b >> 4);
    }
  } else {
    used = 1 + (size_t)hb;
    if (used > n || hb == 0) CORRUPT("Huffman weights' FSE stream runs past the literals");
    int16_t counts[MAX_FSE_SYMBOLS];
    int nsym, log;
    size_t hdr = fse_read_counts(c, p + 1, (size_t)hb, 6, 15, counts, &nsym, &log);
    if (hdr >= (size_t)hb) CORRUPT("Huffman weights' FSE stream is empty");
    FseTable *t = &c->weights;
    fse_build(c, t, counts, nsym, log);
    BackBits b;
    back_init(c, &b, p + 1 + hdr, (size_t)hb - hdr);
    uint32_t s1 = fse_init(&b, t), s2 = fse_init(&b, t);
    for (;;) {
      if (nw >= HUF_MAX_SYMBOLS - 1) CORRUPT("more than 255 Huffman weights");
      weights[nw++] = t->cell[s1].symbol;
      s1 = fse_update(&b, t, s1);
      if (b.pos < 0) {
        weights[nw++] = t->cell[s2].symbol;
        break;
      }
      if (nw >= HUF_MAX_SYMBOLS - 1) CORRUPT("more than 255 Huffman weights");
      weights[nw++] = t->cell[s2].symbol;
      s2 = fse_update(&b, t, s2);
      if (b.pos < 0) {
        if (nw >= HUF_MAX_SYMBOLS - 1) CORRUPT("more than 255 Huffman weights");
        weights[nw++] = t->cell[s1].symbol;
        break;
      }
    }
  }
  huf_build(c, weights, nw);
  return used;
}

/* The rest of one Huffman stream, from bit ``pos`` and literal ``i`` to
 * ``count``. The decoder's state is the next ``huf_bits`` bits of the stream
 * (zeros past its start); a symbol takes its code's length of them. While 57
 * bits remain, a symbol's bits are taken from one load of the stream; the
 * last ones one at a time. The stream must end exactly with its last
 * symbol. */
static void huf_finish(Ctx *c, const BackBits *b, int64_t pos, uint8_t *out, size_t i,
                       size_t count) {
  const int mb = c->huf_bits;
  const uint32_t mask = (1u << mb) - 1;
  while (pos >= 57 && i < count) {
    uint64_t w = bits_at(b, pos - 57, 57);
    int avail = 57;
    while (avail >= mb && i < count) {
      const HufCell *cell = &c->huf[(w >> (avail - mb)) & mask];
      out[i++] = cell->symbol;
      avail -= cell->nbits;
    }
    pos -= 57 - avail;
  }
  for (; i < count; i++) {
    uint32_t idx = pos >= mb  ? (uint32_t)bits_at(b, pos - mb, mb)
                   : pos > 0 ? (uint32_t)(bits_at(b, 0, (int)pos) << (mb - pos))
                             : 0;
    const HufCell *cell = &c->huf[idx];
    out[i] = cell->symbol;
    pos -= cell->nbits;
    if (pos < 0) CORRUPT("Huffman stream ends before its literals");
  }
  if (pos != 0) CORRUPT("Huffman stream longer than its literals");
}

static void huf_stream(Ctx *c, const uint8_t *p, size_t n, uint8_t *out, size_t count) {
  BackBits b;
  back_init(c, &b, p, n);
  huf_finish(c, &b, b.pos, out, 0, count);
}

/* The four streams of 4-stream literals, decoded in lockstep while each has
 * 57 bits and a load's worth of literals left (four independent chains of
 * table lookups), then each to its end alone. A load holds at least
 * floor(57 / huf_bits) symbols. */
static void huf_streams4(Ctx *c, const uint8_t *const p[4], const size_t n[4],
                         uint8_t *const out[4], const size_t count[4]) {
  BackBits b[4];
  int64_t pos[4];
  size_t i[4] = {0, 0, 0, 0};
  for (int k = 0; k < 4; k++) {
    back_init(c, &b[k], p[k], n[k]);
    pos[k] = b[k].pos;
  }
  const int mb = c->huf_bits;
  const uint32_t mask = (1u << mb) - 1;
  const size_t per = (size_t)(57 / mb);
  for (;;) {
    int ready = 1;
    for (int k = 0; k < 4; k++) ready &= pos[k] >= 57 && count[k] - i[k] >= per;
    if (!ready) break;
    uint64_t w[4];
    int avail[4];
    for (int k = 0; k < 4; k++) {
      w[k] = bits_at(&b[k], pos[k] - 57, 57);
      avail[k] = 57;
    }
    for (size_t r = 0; r < per; r++) {
      for (int k = 0; k < 4; k++) {
        const HufCell *cell = &c->huf[(w[k] >> (avail[k] - mb)) & mask];
        out[k][i[k]++] = cell->symbol;
        avail[k] -= cell->nbits;
      }
    }
    for (int k = 0; k < 4; k++) pos[k] -= 57 - avail[k];
  }
  for (int k = 0; k < 4; k++) huf_finish(c, &b[k], pos[k], out[k], i[k], count[k]);
}

/* Decodes the literals section; returns the bytes it took. */
static size_t read_literals(Ctx *c, const uint8_t *p, size_t n) {
  if (n < 1) CORRUPT("block without literals section");
  int type = p[0] & 3, fmt = (p[0] >> 2) & 3;
  size_t regen, comp = 0, hdr;
  if (type < 2) {
    if (fmt == 0 || fmt == 2) {
      hdr = 1;
      regen = p[0] >> 3;
    } else if (fmt == 1) {
      hdr = 2;
      if (n < 2) CORRUPT("literals header truncated");
      regen = (p[0] >> 4) + ((size_t)p[1] << 4);
    } else {
      hdr = 3;
      if (n < 3) CORRUPT("literals header truncated");
      regen = (p[0] >> 4) + ((size_t)p[1] << 4) + ((size_t)p[2] << 12);
    }
  } else {
    int streams = fmt == 0 ? 1 : 4;
    hdr = fmt < 2 ? 3 : fmt == 2 ? 4 : 5;
    if (n < hdr) CORRUPT("literals header truncated");
    if (hdr == 3) {
      uint32_t h = le24(p);
      regen = (h >> 4) & 0x3FF;
      comp = (h >> 14) & 0x3FF;
    } else if (hdr == 4) {
      uint32_t h = le32(p);
      regen = (h >> 4) & 0x3FFF;
      comp = h >> 18;
    } else {
      uint64_t h = le32(p) | ((uint64_t)p[4] << 32);
      regen = (size_t)((h >> 4) & 0x3FFFF);
      comp = (size_t)((h >> 22) & 0x3FFFF);
    }
    if (regen > BLOCK_MAX) CORRUPT("%zu literals in one block", regen);
    if (comp > n - hdr) CORRUPT("compressed literals run past their block");
    const uint8_t *q = p + hdr;
    size_t left = comp;
    if (type == 2) {
      size_t t = huf_read_tree(c, q, left);
      q += t;
      left -= t;
    } else if (!c->huf_ready) {
      CORRUPT("treeless literals without an earlier Huffman table");
    }
    if (streams == 1) {
      huf_stream(c, q, left, c->lit, regen);
    } else {
      if (left < 6) CORRUPT("4-stream literals without their jump table");
      size_t s1 = le16(q), s2 = le16(q + 2), s3 = le16(q + 4);
      q += 6;
      left -= 6;
      if (s1 + s2 + s3 > left) CORRUPT("literal streams run past their section");
      size_t s4 = left - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) CORRUPT("too few literals for 4 streams");
      const uint8_t *const streams[4] = {q, q + s1, q + s1 + s2, q + s1 + s2 + s3};
      const size_t sizes[4] = {s1, s2, s3, s4};
      uint8_t *const outs[4] = {c->lit, c->lit + seg, c->lit + 2 * seg, c->lit + 3 * seg};
      const size_t counts[4] = {seg, seg, seg, regen - 3 * seg};
      huf_streams4(c, streams, sizes, outs, counts);
    }
    c->nlit = regen;
    return hdr + comp;
  }
  if (regen > BLOCK_MAX) CORRUPT("%zu literals in one block", regen);
  if (type == 0) {
    if (regen > n - hdr) CORRUPT("raw literals run past their block");
    memcpy(c->lit, p + hdr, regen);
    c->nlit = regen;
    return hdr + regen;
  }
  if (n - hdr < 1) CORRUPT("RLE literals without their byte");
  memset(c->lit, p[hdr], regen);
  c->nlit = regen;
  return hdr + 1;
}

/* ----------------------------------------------------------- sequences */

static const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                       2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
static const uint32_t LL_BASE[36] = {0,    1,    2,    3,     4,     5,     6,   7,   8,
                                     9,    10,   11,   12,    13,    14,    15,  16,  18,
                                     20,   22,   24,   28,    32,    40,    48,  64,  128,
                                     256,  512,  1024, 2048,  4096,  8192,  16384, 32768, 65536};
static const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                    1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
static const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                    2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

/* Sets up one of the three tables by its mode; returns the bytes it took. */
static size_t read_table(Ctx *c, FseTable *t, int mode, const uint8_t *p, size_t n,
                         const int16_t *def, int ndef, int deflog, int max_log, int max_symbol,
                         const char *name) {
  int16_t counts[MAX_FSE_SYMBOLS];
  int nsym, log;
  size_t used;
  switch (mode) {
    case 0:
      fse_build(c, t, def, ndef, deflog);
      return 0;
    case 1:
      if (n < 1) CORRUPT("%s RLE table without its symbol", name);
      if (p[0] > max_symbol) CORRUPT("%s RLE symbol %d out of range", name, p[0]);
      fse_rle(t, p[0]);
      return 1;
    case 2:
      used = fse_read_counts(c, p, n, max_log, max_symbol, counts, &nsym, &log);
      fse_build(c, t, counts, nsym, log);
      return used;
    default:
      if (!t->ready) CORRUPT("%s table repeated before any was given", name);
      return 0;
  }
}

static size_t exec_sequences(Ctx *c, const uint8_t *p, size_t n, uint8_t *dst, size_t done,
                             size_t cap, size_t frame_start) {
  size_t start = done;
  if (n < 1) CORRUPT("block without sequences section");
  size_t nseq, h;
  if (p[0] < 128) {
    nseq = p[0];
    h = 1;
  } else if (p[0] < 255) {
    if (n < 2) CORRUPT("sequences header truncated");
    nseq = ((size_t)(p[0] - 128) << 8) + p[1];
    h = 2;
  } else {
    if (n < 3) CORRUPT("sequences header truncated");
    nseq = p[1] + ((size_t)p[2] << 8) + 0x7F00;
    h = 3;
  }
  size_t lit_used = 0;
  if (nseq > 0) {
    if (n - h < 1) CORRUPT("sequences without their modes");
    int modes = p[h++];
    if (modes & 3) CORRUPT("reserved bits set in the sequences' modes");
    h += read_table(c, &c->ll, modes >> 6, p + h, n - h, LL_DEFAULT, 36, 6, LL_MAX_LOG, 35,
                    "literal-length");
    h += read_table(c, &c->of, (modes >> 4) & 3, p + h, n - h, OF_DEFAULT, 29, 5, OF_MAX_LOG, 31,
                    "offset");
    h += read_table(c, &c->ml, (modes >> 2) & 3, p + h, n - h, ML_DEFAULT, 53, 6, ML_MAX_LOG, 52,
                    "match-length");
    if (h >= n) CORRUPT("sequences without their bit stream");
    BackBits b;
    back_init(c, &b, p + h, n - h);
    uint32_t sll = fse_init(&b, &c->ll), sof = fse_init(&b, &c->of), sml = fse_init(&b, &c->ml);
    for (size_t i = 0; i < nseq; i++) {
      int llc = c->ll.cell[sll].symbol, ofc = c->of.cell[sof].symbol, mlc = c->ml.cell[sml].symbol;
      if (llc > 35 || mlc > 52 || ofc > 31) CORRUPT("sequence code out of range");
      uint64_t ofv = ((uint64_t)1 << ofc) + back_read(&b, ofc);
      uint64_t ml = ML_BASE[mlc] + back_read(&b, ML_BITS[mlc]);
      uint64_t ll = LL_BASE[llc] + back_read(&b, LL_BITS[llc]);
      uint64_t off;
      if (ofv > 3) {
        off = ofv - 3;
        c->rep[2] = c->rep[1];
        c->rep[1] = c->rep[0];
        c->rep[0] = (uint32_t)off;
      } else {
        int idx = (int)ofv - 1 + (ll == 0);
        if (idx == 0) {
          off = c->rep[0];
        } else {
          off = idx == 3 ? (uint64_t)c->rep[0] - 1 : c->rep[idx];
          if (idx != 1) c->rep[2] = c->rep[1];
          c->rep[1] = c->rep[0];
          c->rep[0] = (uint32_t)off;
        }
      }
      if (i + 1 < nseq) {
        sll = fse_update(&b, &c->ll, sll);
        sml = fse_update(&b, &c->ml, sml);
        sof = fse_update(&b, &c->of, sof);
      }
      if (b.pos < 0) CORRUPT("sequence bit stream ends early");
      if (ll > c->nlit - lit_used) CORRUPT("sequence takes more literals than the block has");
      if (ll > cap - done) CORRUPT("output larger than its capacity of %zu bytes", cap);
      memcpy(dst + done, c->lit + lit_used, (size_t)ll);
      lit_used += (size_t)ll;
      done += (size_t)ll;
      if (off == 0 || off > done - frame_start) CORRUPT("match offset %llu before the frame",
                                                        (unsigned long long)off);
      if (ml > cap - done) CORRUPT("output larger than its capacity of %zu bytes", cap);
      uint8_t *o = dst + done;
      const uint8_t *from = o - off;
      if (off >= ml) {
        memcpy(o, from, (size_t)ml);
      } else {
        for (size_t k = 0; k < ml; k++) o[k] = from[k];
      }
      done += (size_t)ml;
      if (done - start > BLOCK_MAX) CORRUPT("block decodes to more than 128 KiB");
    }
    if (b.pos != 0) CORRUPT("sequence bit stream longer than its sequences");
  } else if (h != n) {
    CORRUPT("bytes after a block's empty sequences section");
  }
  size_t rest = c->nlit - lit_used;
  if (rest > cap - done) CORRUPT("output larger than its capacity of %zu bytes", cap);
  memcpy(dst + done, c->lit + lit_used, rest);
  done += rest;
  if (done - start > BLOCK_MAX) CORRUPT("block decodes to more than 128 KiB");
  return done;
}

/* --------------------------------------------------------------- XXH64 */

#define P64_1 11400714785074694791ULL
#define P64_2 14029467366897019727ULL
#define P64_3 1609587929392839161ULL
#define P64_4 9650029242287828579ULL
#define P64_5 2870177450012600261ULL

static uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
static uint64_t xxh_round(uint64_t acc, uint64_t in) {
  acc += in * P64_2;
  return rotl64(acc, 31) * P64_1;
}
static uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  acc ^= xxh_round(0, v);
  return acc * P64_1 + P64_4;
}

static uint64_t xxh64(const uint8_t *p, size_t n) {
  const uint8_t *end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P64_1 + P64_2, v2 = P64_2, v3 = 0, v4 = 0 - P64_1;
    const uint8_t *limit = end - 32;
    do {
      v1 = xxh_round(v1, le64(p));
      v2 = xxh_round(v2, le64(p + 8));
      v3 = xxh_round(v3, le64(p + 16));
      v4 = xxh_round(v4, le64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = P64_5;
  }
  h += (uint64_t)n;
  while (p + 8 <= end) {
    h ^= xxh_round(0, le64(p));
    h = rotl64(h, 27) * P64_1 + P64_4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)le32(p) * P64_1;
    h = rotl64(h, 23) * P64_2 + P64_3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P64_5;
    h = rotl64(h, 11) * P64_1;
    p++;
  }
  h ^= h >> 33;
  h *= P64_2;
  h ^= h >> 29;
  h *= P64_3;
  h ^= h >> 32;
  return h;
}

/* --------------------------------------------------------------- frames */

typedef struct {
  size_t header;         /* bytes of the frame header */
  long long content;     /* -1 where absent */
  int checksum;
} FrameHeader;

/* Reads a zstd frame header at p; returns 0, or -1 (error set) where the
 * input ends inside it, a reserved bit is set or it names a dictionary. */
static int read_frame_header(const uint8_t *p, size_t n, FrameHeader *f, char *err, int errlen) {
  if (n < 5) {
    snprintf(err, (size_t)errlen, "zstd frame header truncated");
    return -1;
  }
  int fhd = p[4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, did_flag = fhd & 3;
  if (fhd & 8) {
    snprintf(err, (size_t)errlen, "reserved bit set in a zstd frame header");
    return -1;
  }
  size_t did_size = did_flag == 3 ? 4 : (size_t)did_flag;
  size_t fcs_size = fcs_flag == 0 ? (size_t)single : (size_t)1 << fcs_flag;
  size_t need = 5 + (size_t)!single + did_size + fcs_size;
  if (n < need) {
    snprintf(err, (size_t)errlen, "zstd frame header truncated");
    return -1;
  }
  const uint8_t *q = p + 5 + !single;
  uint32_t did = 0;
  for (size_t i = 0; i < did_size; i++) did |= (uint32_t)q[i] << (8 * i);
  if (did != 0) {
    snprintf(err, (size_t)errlen,
             "zstd frame needs dictionary %u; this decoder reads no dictionary", did);
    return -1;
  }
  q += did_size;
  f->content = -1;
  if (fcs_size == 1) f->content = q[0];
  else if (fcs_size == 2) f->content = le16(q) + 256;
  else if (fcs_size == 4) f->content = le32(q);
  else if (fcs_size == 8) f->content = (long long)le64(q);
  f->header = need;
  f->checksum = (fhd >> 2) & 1;
  return 0;
}

static size_t decode_frame(Ctx *c, const uint8_t *src, size_t n, uint8_t *dst, size_t *done,
                           size_t cap) {
  FrameHeader f;
  char msg[128];
  int r = read_frame_header(src, n, &f, msg, (int)sizeof msg);
  if (r) CORRUPT("%s", msg);
  size_t frame_start = *done, pos = f.header;
  c->huf_ready = 0;
  c->ll.ready = c->of.ready = c->ml.ready = 0;
  c->rep[0] = 1;
  c->rep[1] = 4;
  c->rep[2] = 8;
  for (;;) {
    if (n - pos < 3) CORRUPT("zstd block header truncated");
    uint32_t bh = le24(src + pos);
    pos += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) CORRUPT("reserved zstd block type");
    if (size > BLOCK_MAX) CORRUPT("zstd block of %zu bytes", size);
    if (type == 0) {
      if (size > n - pos) CORRUPT("raw block runs past the input");
      if (size > cap - *done) CORRUPT("output larger than its capacity of %zu bytes", cap);
      memcpy(dst + *done, src + pos, size);
      *done += size;
      pos += size;
    } else if (type == 1) {
      if (n - pos < 1) CORRUPT("RLE block without its byte");
      if (size > cap - *done) CORRUPT("output larger than its capacity of %zu bytes", cap);
      memset(dst + *done, src[pos], size);
      *done += size;
      pos += 1;
    } else {
      if (size > n - pos) CORRUPT("compressed block runs past the input");
      size_t lit = read_literals(c, src + pos, size);
      *done = exec_sequences(c, src + pos + lit, size - lit, dst, *done, cap, frame_start);
      pos += size;
    }
    if (last) break;
  }
  size_t produced = *done - frame_start;
  if (f.content >= 0 && (unsigned long long)f.content != produced)
    CORRUPT("zstd frame decodes to %zu bytes, its header says %lld", produced, f.content);
  if (f.checksum) {
    if (n - pos < 4) CORRUPT("zstd content checksum truncated");
    uint32_t want = le32(src + pos);
    uint32_t got = (uint32_t)xxh64(dst + frame_start, produced);
    if (want != got) CORRUPT("zstd content checksum mismatch (%08x, computed %08x)", want, got);
    pos += 4;
  }
  return pos;
}

long tcs_zstd_decompress(const uint8_t *src, long n, uint8_t *dst, long cap, char *err,
                         int errlen) {
  if (n < 0 || cap < 0) return -1;
  Ctx *c = (Ctx *)malloc(sizeof(Ctx));
  if (!c) {
    snprintf(err, (size_t)errlen, "out of memory");
    return -1;
  }
  c->err = err;
  c->errlen = errlen;
  size_t done = 0, pos = 0, frames = 0;
  if (setjmp(c->fail)) {
    free(c);
    return -1;
  }
  while (pos < (size_t)n) {
    if ((size_t)n - pos < 4) CORRUPT("%zu stray bytes after the last frame", (size_t)n - pos);
    uint32_t magic = le32(src + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if ((size_t)n - pos < 8) CORRUPT("skippable frame header truncated");
      size_t size = le32(src + pos + 4);
      if (size > (size_t)n - pos - 8) CORRUPT("skippable frame runs past the input");
      pos += 8 + size;
      continue;
    }
    if (magic != ZSTD_MAGIC) CORRUPT("not a zstd frame (magic %08x)", magic);
    pos += decode_frame(c, src + pos, (size_t)n - pos, dst, &done, (size_t)cap);
    frames++;
  }
  if (frames == 0) CORRUPT("no zstd frame in the input");
  free(c);
  return (long)done;
}

long long tcs_zstd_content_size(const uint8_t *src, long n) {
  char err[128];
  FrameHeader f;
  if (n < 4 || le32(src) != ZSTD_MAGIC) return -2;
  if (read_frame_header(src, (size_t)n, &f, err, (int)sizeof err)) return -2;
  return f.content;
}

/* -------------------------------------------------------------- CRC-32C */

static uint32_t crc_table[8][256];

/* Built when the library loads: calls come from threads without the GIL. */
__attribute__((constructor)) static void crc_init(void) {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t r = i;
    for (int k = 0; k < 8; k++) r = (r >> 1) ^ (0x82F63B78u & (0u - (r & 1)));
    crc_table[0][i] = r;
  }
  for (int t = 1; t < 8; t++)
    for (int i = 0; i < 256; i++)
      crc_table[t][i] = (crc_table[t - 1][i] >> 8) ^ crc_table[0][crc_table[t - 1][i] & 0xFF];
}

unsigned tcs_crc32c(unsigned crc, const uint8_t *p, long n) {
  uint32_t r = ~(uint32_t)crc;
  while (n >= 8) {
    uint32_t lo = le32(p) ^ r, hi = le32(p + 4);
    r = crc_table[7][lo & 0xFF] ^ crc_table[6][(lo >> 8) & 0xFF] ^ crc_table[5][(lo >> 16) & 0xFF] ^
        crc_table[4][lo >> 24] ^ crc_table[3][hi & 0xFF] ^ crc_table[2][(hi >> 8) & 0xFF] ^
        crc_table[1][(hi >> 16) & 0xFF] ^ crc_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) r = (r >> 8) ^ crc_table[0][(r ^ *p++) & 0xFF];
  return ~r;
}
