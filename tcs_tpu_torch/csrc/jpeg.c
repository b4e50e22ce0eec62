/* JPEG for the port's host core: a decoder that gives libjpeg's default
 * decompression bit for bit, and a baseline 4:2:0 encoder.
 *
 * tcs_tpu reads JPEG through libjpeg (native/tcs_io.cc); the card's machine
 * has no libjpeg, so the port carries its own codec. Built into the host
 * library beside host_io.c (tcs_tpu_torch/data/_host.py) and called through
 * ctypes, which releases the GIL for the length of each call.
 *
 * The decoder reads baseline sequential and progressive Huffman JPEG, 8-bit,
 * 1 or 3 components, sampling factors whose ratios to the largest are 1 or 2
 * on each axis, restart intervals, any width and height. Its arithmetic is
 * libjpeg's defaults (what tcs_tpu's reader asks for):
 *   - JDCT_ISLOW (jidctint.c): CONST_BITS 13, PASS1_BITS 2, and the post-IDCT
 *     range-limit table, which saturates to +-384 around the centre and wraps
 *     (masks with 1023) beyond;
 *   - fancy upsampling (jdsample.c): the triangle filters for h2v1, h2v2 and
 *     h1v2 with their alternating rounding biases, box replication for h2
 *     components of downsampled width <= 2 (libjpeg takes the fancy filter
 *     only above that width), context rows replicated at the top and bottom
 *     edges (jdmainct.c);
 *   - jdcolor.c's fixed-point YCbCr->RGB tables (SCALEBITS 16);
 *   - no block smoothing: libjpeg smooths a progressive image only while
 *     some of its first ten coefficients are not complete, which never holds
 *     at the end of a whole file; a file that leaves them incomplete is
 *     refused as unsupported.
 * It refuses (TCS_JPEG_UNSUPPORTED) arithmetic coding, 12-bit and other
 * precisions, lossless and hierarchical processes, 4-component (CMYK/YCCK)
 * and 2-component images, and other sampling ratios. Where libjpeg would
 * warn and go on (a truncated or corrupt stream: it pads with zeros and
 * returns an image), this decoder fails with TCS_JPEG_CORRUPT.
 *
 * The encoder writes what libjpeg writes with its defaults, jpeg_set_quality
 * (force_baseline) and 2x2 luma sampling: JFIF, the Annex K quantisation
 * tables scaled by jpeg_quality_scaling, jccolor.c's RGB->YCbCr, jcsample.c's
 * h2v2 downsampling (biases 1, 2, 1, 2, ...), jcprepct.c's edge padding,
 * jccoefct.c's dummy blocks, the ISLOW forward DCT (jfdctint.c), rounding
 * division by the quantiser, and the standard Huffman tables.
 */

#include <setjmp.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

enum { TCS_JPEG_OK = 0, TCS_JPEG_CORRUPT = 1, TCS_JPEG_UNSUPPORTED = 2, TCS_JPEG_NOMEM = 3 };

static const int natural_order[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

/* The standard Huffman tables (ITU T.81 Annex K.3): bits[1..16], values. */
static const uint8_t std_dc_bits[2][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
static const uint8_t std_dc_vals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t std_ac_bits[2][17] = {
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
static const uint8_t std_ac_vals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
     0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
     0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
     0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
     0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
     0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
     0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
     0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
     0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
     0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
     0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
     0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
     0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
     0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
     0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
     0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
     0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

/* ISLOW constants (jidctint.c / jfdctint.c), FIX(x) at CONST_BITS 13. */
#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

/* ======================================================================== */
/* Decoder                                                                   */
/* ======================================================================== */

typedef struct {
  int present;
  uint8_t look_len[512], look_val[512]; /* codes of up to 9 bits */
  int32_t maxcode[18], valoffset[18];
  uint8_t huffval[256];
} huff_t;

typedef struct {
  int id, h, v, tq;
  int cw, ch;       /* downsampled width and height (samples) */
  int bw, bh;       /* blocks held: the MCU grid's, padded */
  int dc, ac;       /* the current scan's table numbers */
  int last_dc;
  int scanned;      /* appeared in a scan: its quantiser is latched */
  int16_t q[64];    /* latched quantiser, natural order (ISLOW_MULT_TYPE) */
  int coef_bits[64];
  int16_t *coef;    /* bw * bh blocks of 64, natural order */
  uint8_t *plane;   /* bw*8 x bh*8 samples after the IDCT */
} comp_t;

typedef struct {
  jmp_buf jb;
  char *err;
  int errlen;
  const uint8_t *p, *end;
  int width, height, ncomp, progressive, frame_seen;
  int hmax, vmax, mcux, mcuy;
  comp_t comp[3];
  uint16_t qt[4][64];
  int qt_present[4];
  huff_t dc[4], ac[4];
  int restart_interval;
  int saw_jfif, saw_adobe, adobe_transform;
  /* the scan */
  int ns, sc[3], ss, se, ah, al, eobrun;
  /* the bit reader: nbits valid bits at the bottom of acc, the lowest
   * padbits of them zeros put in past a marker or the end of the data */
  uint64_t acc;
  int nbits, padbits, marker_hit;
  uint8_t *rows; /* the upsampled rows of one output row */
} dec_t;

static void fail(dec_t *d, int kind, const char *fmt, ...) {
  if (d->err && d->errlen > 0) {
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(d->err, (size_t)d->errlen, fmt, ap);
    va_end(ap);
  }
  longjmp(d->jb, kind);
}

static void *dalloc(dec_t *d, size_t n) {
  void *p = calloc(n ? n : 1, 1);
  if (!p) fail(d, TCS_JPEG_NOMEM, "out of memory (%zu bytes)", n);
  return p;
}

static void free_dec(dec_t *d) {
  for (int c = 0; c < 3; c++) {
    free(d->comp[c].coef);
    free(d->comp[c].plane);
    d->comp[c].coef = NULL;
    d->comp[c].plane = NULL;
  }
  free(d->rows);
  d->rows = NULL;
}

/* jpeg_make_d_derived_tbl, with a 9-bit look-ahead table. */
static void build_huff(dec_t *d, huff_t *t, const uint8_t bits[17], const uint8_t *vals,
                       int is_dc) {
  int huffsize[257], huffcode[257], p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  int n = p, code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if ((int64_t)code >= ((int64_t)1 << si)) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: bad Huffman table");
    code <<= 1;
    si++;
  }
  memset(t, 0, sizeof *t);
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l]) {
      t->valoffset[l] = p - huffcode[p];
      p += bits[l];
      t->maxcode[l] = huffcode[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->maxcode[17] = 0xFFFFF;
  for (int i = 0; i < n; i++) {
    t->huffval[i] = vals[i];
    if (is_dc && vals[i] > 15) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: bad Huffman table");
  }
  p = 0;
  for (int l = 1; l <= 9; l++)
    for (int i = 0; i < bits[l]; i++, p++) {
      int lookbits = huffcode[p] << (9 - l);
      for (int ctr = 1 << (9 - l); ctr > 0; ctr--) {
        t->look_len[lookbits] = (uint8_t)l;
        t->look_val[lookbits] = vals[p];
        lookbits++;
      }
    }
  t->present = 1;
}

static void fill(dec_t *d) {
  while (d->nbits <= 56) {
    uint32_t b = 0;
    if (!d->marker_hit) {
      if (d->p >= d->end) {
        d->marker_hit = 1;
      } else if (*d->p != 0xFF) {
        b = *d->p++;
      } else {
        /* FF 00 is a data FF (and FF FF ... 00, which libjpeg accepts too);
         * FF followed by anything else starts a marker. */
        const uint8_t *q = d->p + 1;
        while (q < d->end && *q == 0xFF) q++;
        if (q < d->end && *q == 0) {
          b = 0xFF;
          d->p = q + 1;
        } else {
          d->marker_hit = 1;
        }
      }
    }
    if (d->marker_hit) d->padbits += 8;
    d->acc = (d->acc << 8) | b;
    d->nbits += 8;
  }
}

static inline void consume(dec_t *d, int n) {
  d->nbits -= n;
  if (d->nbits < d->padbits)
    fail(d, TCS_JPEG_CORRUPT, "truncated or corrupt JPEG: the entropy-coded data ends "
                              "before the scan's last block");
}

static inline int get_bits(dec_t *d, int n) {
  if (n == 0) return 0;
  if (d->nbits < n) fill(d);
  int v = (int)((d->acc >> (d->nbits - n)) & ((1u << n) - 1));
  consume(d, n);
  return v;
}

static inline int get_bit(dec_t *d) { return get_bits(d, 1); }

static inline int huff_decode(dec_t *d, const huff_t *t) {
  if (d->nbits < 16) fill(d);
  unsigned look = (unsigned)(d->acc >> (d->nbits - 9)) & 511u;
  int len = t->look_len[look];
  if (len) {
    consume(d, len);
    return t->look_val[look];
  }
  unsigned code16 = (unsigned)(d->acc >> (d->nbits - 16)) & 0xFFFFu;
  for (int l = 10; l <= 16; l++) {
    int32_t code = (int32_t)(code16 >> (16 - l));
    if (code <= t->maxcode[l]) {
      consume(d, l);
      return t->huffval[(code + t->valoffset[l]) & 0xFF];
    }
  }
  fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: a Huffman code that its table does not hold");
  return 0;
}

static inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r + (int)((unsigned)-1 << s) + 1 : r;
}

/* Marker segments ------------------------------------------------------- */

static int u8(dec_t *d) {
  if (d->p >= d->end) fail(d, TCS_JPEG_CORRUPT, "truncated JPEG: the file ends inside a marker segment");
  return *d->p++;
}

static int u16(dec_t *d) {
  int hi = u8(d);
  return (hi << 8) | u8(d);
}

/* The next marker's code. Bytes other than 0xFF fill before it are data
 * libjpeg would discard with a warning: refused here. */
static int next_marker(dec_t *d) {
  if (d->p >= d->end) fail(d, TCS_JPEG_CORRUPT, "truncated JPEG: no end-of-image marker");
  if (*d->p != 0xFF) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: extraneous bytes before a marker");
  while (d->p < d->end && *d->p == 0xFF) d->p++;
  if (d->p >= d->end) fail(d, TCS_JPEG_CORRUPT, "truncated JPEG: no end-of-image marker");
  int m = *d->p++;
  if (m == 0) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: a stuffed byte outside entropy-coded data");
  return m;
}

static const uint8_t *segment(dec_t *d, int *len) {
  int n = u16(d);
  if (n < 2 || d->end - d->p < n - 2) fail(d, TCS_JPEG_CORRUPT, "truncated or corrupt JPEG: a marker segment runs past the file");
  const uint8_t *s = d->p;
  d->p += n - 2;
  *len = n - 2;
  return s;
}

static void read_sof(dec_t *d, int marker, int allocate) {
  int n;
  const uint8_t *s = segment(d, &n);
  if (d->frame_seen) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: a second frame header");
  if (n < 6) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: short frame header");
  int precision = s[0];
  d->height = (s[1] << 8) | s[2];
  d->width = (s[3] << 8) | s[4];
  d->ncomp = s[5];
  d->progressive = marker == 0xC2;
  if (precision != 8)
    fail(d, TCS_JPEG_UNSUPPORTED, "%d-bit JPEG: the port reads 8-bit samples only", precision);
  if (d->ncomp == 4)
    fail(d, TCS_JPEG_UNSUPPORTED, "4-component (CMYK/YCCK) JPEG: the port reads gray and YCbCr/RGB only");
  if (d->ncomp != 1 && d->ncomp != 3)
    fail(d, TCS_JPEG_UNSUPPORTED, "%d-component JPEG: the port reads gray and YCbCr/RGB only", d->ncomp);
  if (d->height == 0)
    fail(d, TCS_JPEG_UNSUPPORTED, "JPEG with its height in a DNL marker: not read by the port");
  if (d->width == 0) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: zero width");
  if (n != 6 + 3 * d->ncomp) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: bad frame header length");
  d->hmax = d->vmax = 1;
  for (int c = 0; c < d->ncomp; c++) {
    comp_t *k = &d->comp[c];
    k->id = s[6 + 3 * c];
    k->h = s[7 + 3 * c] >> 4;
    k->v = s[7 + 3 * c] & 15;
    k->tq = s[8 + 3 * c];
    if (k->h < 1 || k->h > 4 || k->v < 1 || k->v > 4 || k->tq > 3)
      fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: bad sampling factors or table number");
    if (k->h > d->hmax) d->hmax = k->h;
    if (k->v > d->vmax) d->vmax = k->v;
  }
  d->mcux = (d->width + 8 * d->hmax - 1) / (8 * d->hmax);
  d->mcuy = (d->height + 8 * d->vmax - 1) / (8 * d->vmax);
  for (int c = 0; c < d->ncomp; c++) {
    comp_t *k = &d->comp[c];
    int rx = d->hmax / k->h, ry = d->vmax / k->v;
    if (d->hmax % k->h || d->vmax % k->v || rx > 2 || ry > 2)
      fail(d, TCS_JPEG_UNSUPPORTED, "JPEG sampling factors %dx%d against %dx%d: the port "
           "upsamples by 1 or 2 on each axis", k->h, k->v, d->hmax, d->vmax);
    k->cw = (int)(((int64_t)d->width * k->h + d->hmax - 1) / d->hmax);
    k->ch = (int)(((int64_t)d->height * k->v + d->vmax - 1) / d->vmax);
    k->bw = d->mcux * k->h;
    k->bh = d->mcuy * k->v;
    for (int i = 0; i < 64; i++) k->coef_bits[i] = -1;
    if (allocate) k->coef = dalloc(d, (size_t)k->bw * k->bh * 64 * sizeof(int16_t));
  }
  d->frame_seen = 1;
}

static void read_dqt(dec_t *d) {
  int n;
  const uint8_t *s = segment(d, &n), *e = s + n;
  while (s < e) {
    int pq = *s >> 4, tq = *s & 15;
    s++;
    if (pq > 1 || tq > 3 || e - s < 64 * (pq + 1)) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: bad quantisation table");
    for (int k = 0; k < 64; k++) {
      int v = pq ? (s[2 * k] << 8) | s[2 * k + 1] : s[k];
      d->qt[tq][natural_order[k]] = (uint16_t)v;
    }
    s += 64 * (pq + 1);
    d->qt_present[tq] = 1;
  }
}

static void read_dht(dec_t *d) {
  int n;
  const uint8_t *s = segment(d, &n), *e = s + n;
  while (s < e) {
    if (e - s < 17) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: bad Huffman table");
    int tc = *s >> 4, th = *s & 15;
    uint8_t bits[17] = {0};
    int count = 0;
    for (int l = 1; l <= 16; l++) count += bits[l] = s[l];
    s += 17;
    if (tc > 1 || th > 3 || count > 256 || e - s < count) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: bad Huffman table");
    build_huff(d, tc ? &d->ac[th] : &d->dc[th], bits, s, !tc);
    s += count;
  }
}

static void read_app(dec_t *d, int marker) {
  int n;
  const uint8_t *s = segment(d, &n);
  if (marker == 0xE0 && n >= 14 && !memcmp(s, "JFIF", 5)) d->saw_jfif = 1;
  if (marker == 0xEE && n >= 12 && !memcmp(s, "Adobe", 5)) {
    d->saw_adobe = 1;
    d->adobe_transform = s[11];
  }
}

/* A missing table 0 or 1 is the standard one, as libjpeg-turbo takes it for
 * Motion-JPEG frames, which may leave their tables out. */
static const huff_t *table(dec_t *d, int ac, int n) {
  huff_t *t = ac ? &d->ac[n] : &d->dc[n];
  if (!t->present) {
    if (n > 1) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: a scan uses an undefined Huffman table");
    if (ac) build_huff(d, t, std_ac_bits[n], std_ac_vals[n], 0);
    else build_huff(d, t, std_dc_bits[n], std_dc_vals, 1);
  }
  return t;
}

/* Entropy decoding ------------------------------------------------------ */

static void reset_reader(dec_t *d) {
  d->acc = 0;
  d->nbits = d->padbits = d->marker_hit = 0;
}

/* At the end of a restart interval or a scan: what is left in the bit
 * buffer must be the padding of one byte, and the next bytes a marker. */
static void end_of_segment(dec_t *d) {
  if (d->nbits - d->padbits >= 8)
    fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: extraneous entropy-coded bytes");
  reset_reader(d);
}

static void restart(dec_t *d, int *next_rst) {
  end_of_segment(d);
  int m = next_marker(d);
  if (m != 0xD0 + *next_rst)
    fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: expected restart marker %d, found 0x%02X", *next_rst, m);
  *next_rst = (*next_rst + 1) & 7;
  for (int c = 0; c < d->ncomp; c++) d->comp[c].last_dc = 0;
  d->eobrun = 0;
}

static void decode_block(dec_t *d, comp_t *k, int16_t *blk) {
  if (!d->progressive) {
    int s = huff_decode(d, table(d, 0, k->dc));
    if (s) s = extend(get_bits(d, s), s);
    k->last_dc += s;
    blk[0] = (int16_t)k->last_dc;
    const huff_t *ac = table(d, 1, k->ac);
    for (int i = 1; i < 64; i++) {
      int rs = huff_decode(d, ac), r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        if (i > 63) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: a run past the block's end");
        blk[natural_order[i]] = (int16_t)extend(get_bits(d, s), s);
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
    return;
  }
  if (d->ss == 0) {
    if (d->ah == 0) { /* DC first */
      int s = huff_decode(d, table(d, 0, k->dc));
      if (s) s = extend(get_bits(d, s), s);
      k->last_dc += s;
      blk[0] = (int16_t)((unsigned)k->last_dc << d->al);
    } else if (get_bit(d)) { /* DC refine */
      blk[0] |= (int16_t)(1 << d->al);
    }
    return;
  }
  const huff_t *ac = table(d, 1, k->ac);
  if (d->ah == 0) { /* AC first */
    if (d->eobrun > 0) {
      d->eobrun--;
      return;
    }
    for (int i = d->ss; i <= d->se; i++) {
      int rs = huff_decode(d, ac), r = rs >> 4, s = rs & 15;
      if (s) {
        i += r;
        if (i > d->se) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: a run past the band's end");
        blk[natural_order[i]] = (int16_t)((unsigned)extend(get_bits(d, s), s) << d->al);
      } else if (r == 15) {
        i += 15;
      } else {
        d->eobrun = 1 << r;
        if (r) d->eobrun += get_bits(d, r);
        d->eobrun--;
        break;
      }
    }
    return;
  }
  /* AC refine (jdphuff.c decode_mcu_AC_refine) */
  int p1 = 1 << d->al, m1 = (int)((unsigned)-1 << d->al), i = d->ss;
  if (d->eobrun == 0) {
    for (; i <= d->se; i++) {
      int rs = huff_decode(d, ac), r = rs >> 4, s = rs & 15;
      if (s) {
        if (s != 1) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: a refinement value of size %d", s);
        s = get_bit(d) ? p1 : m1;
      } else if (r != 15) {
        d->eobrun = 1 << r;
        if (r) d->eobrun += get_bits(d, r);
        break;
      }
      do {
        int16_t *c = blk + natural_order[i];
        if (*c != 0) {
          if (get_bit(d) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
        } else if (--r < 0) {
          break;
        }
        i++;
      } while (i <= d->se);
      if (s) {
        if (i > d->se) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: a refinement past the band's end");
        blk[natural_order[i]] = (int16_t)s;
      }
    }
  }
  if (d->eobrun > 0) {
    for (; i <= d->se; i++) {
      int16_t *c = blk + natural_order[i];
      if (*c != 0 && get_bit(d) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
    }
    d->eobrun--;
  }
}

static void read_sos(dec_t *d) {
  int n;
  const uint8_t *s = segment(d, &n);
  if (!d->frame_seen) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: a scan before the frame header");
  if (n < 1) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: short scan header");
  d->ns = s[0];
  if (d->ns < 1 || d->ns > d->ncomp || n != 4 + 2 * d->ns)
    fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: bad scan header");
  for (int j = 0; j < d->ns; j++) {
    int id = s[1 + 2 * j], c;
    for (c = 0; c < d->ncomp && d->comp[c].id != id; c++) {}
    if (c == d->ncomp) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: a scan of an unknown component");
    for (int i = 0; i < j; i++)
      if (d->sc[i] == c) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: a component twice in a scan");
    d->sc[j] = c;
    d->comp[c].dc = s[2 + 2 * j] >> 4;
    d->comp[c].ac = s[2 + 2 * j] & 15;
    if (d->comp[c].dc > 3 || d->comp[c].ac > 3) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: bad table number");
  }
  const uint8_t *t = s + 1 + 2 * d->ns;
  d->ss = t[0];
  d->se = t[1];
  d->ah = t[2] >> 4;
  d->al = t[2] & 15;
  if (!d->progressive) {
    if (d->ss != 0 || d->se != 63 || d->ah != 0 || d->al != 0)
      fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: a sequential scan with progressive parameters");
  } else {
    if ((d->ss == 0 && d->se != 0) || (d->ss > 0 && (d->se < d->ss || d->se > 63 || d->ns != 1)) ||
        d->al > 13 || (d->ah != 0 && d->al != d->ah - 1))
      fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: bad progressive scan parameters");
    for (int j = 0; j < d->ns; j++) {
      int *bits = d->comp[d->sc[j]].coef_bits;
      if (d->ss > 0 && bits[0] < 0)
        fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: an AC scan before the component's DC scan");
      for (int i = d->ss; i <= d->se; i++) {
        if ((bits[i] < 0 ? 0 : bits[i]) != d->ah)
          fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: a scan out of progression order");
        bits[i] = d->al;
      }
    }
  }
  for (int j = 0; j < d->ns; j++) { /* latch_quant_tables */
    comp_t *k = &d->comp[d->sc[j]];
    if (!k->scanned) {
      if (!d->qt_present[k->tq]) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: undefined quantisation table");
      for (int i = 0; i < 64; i++) k->q[i] = (int16_t)d->qt[k->tq][i];
      k->scanned = 1;
    }
    k->last_dc = 0;
  }
}

static void decode_scan(dec_t *d) {
  int next_rst = 0, todo = d->restart_interval;
  d->eobrun = 0;
  reset_reader(d);
  if (d->ns == 1) { /* one block an MCU, over the component's own blocks */
    comp_t *k = &d->comp[d->sc[0]];
    int bx = (k->cw + 7) / 8, by = (k->ch + 7) / 8;
    for (int y = 0; y < by; y++)
      for (int x = 0; x < bx; x++) {
        if (d->restart_interval) {
          if (todo == 0) {
            restart(d, &next_rst);
            todo = d->restart_interval;
          }
          todo--;
        }
        decode_block(d, k, k->coef + ((size_t)y * k->bw + x) * 64);
      }
  } else {
    for (int my = 0; my < d->mcuy; my++)
      for (int mx = 0; mx < d->mcux; mx++) {
        if (d->restart_interval) {
          if (todo == 0) {
            restart(d, &next_rst);
            todo = d->restart_interval;
          }
          todo--;
        }
        for (int j = 0; j < d->ns; j++) {
          comp_t *k = &d->comp[d->sc[j]];
          for (int v = 0; v < k->v; v++)
            for (int h = 0; h < k->h; h++)
              decode_block(d, k, k->coef + ((size_t)(my * k->v + v) * k->bw + mx * k->h + h) * 64);
        }
      }
  }
  end_of_segment(d);
}

/* IDCT (jidctint.c jpeg_idct_islow) ------------------------------------- */

/* The post-IDCT range limit, indexed by the descaled value & 1023. */
static uint8_t idct_limit[1024];

static void init_idct_limit(void) {
  for (int i = 0; i < 1024; i++) {
    int v;
    if (i < 128) v = 128 + i;
    else if (i < 512) v = 255;
    else if (i < 896) v = 0;
    else v = i - 896;
    idct_limit[i] = (uint8_t)v;
  }
}

static void idct_islow(const int16_t *in, const int16_t *q, uint8_t *out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t *ip = in + c;
    const int16_t *qp = q + c;
    int *w = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = (ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
    z2 = ip[16] * qp[16];
    z3 = ip[48] * qp[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    tmp0 = (z2 + z3) * (1 << CONST_BITS);
    tmp1 = (z2 - z3) * (1 << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    w[0] = (int)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
    w[56] = (int)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
    w[8] = (int)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
    w[48] = (int)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
    w[16] = (int)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
    w[40] = (int)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
    w[24] = (int)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
    w[32] = (int)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
  }
  for (int r = 0; r < 8; r++) {
    const int *w = ws + 8 * r;
    uint8_t *o = out + (size_t)r * stride;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
#define OUT(x) idct_limit[(int)DESCALE((x), CONST_BITS + PASS1_BITS + 3) & 1023]
    o[0] = OUT(tmp10 + tmp3);
    o[7] = OUT(tmp10 - tmp3);
    o[1] = OUT(tmp11 + tmp2);
    o[6] = OUT(tmp11 - tmp2);
    o[2] = OUT(tmp12 + tmp1);
    o[5] = OUT(tmp12 - tmp1);
    o[3] = OUT(tmp13 + tmp0);
    o[4] = OUT(tmp13 - tmp0);
#undef OUT
  }
}

/* Upsampling (jdsample.c) and colour conversion (jdcolor.c) -------------- */

/* One output row of component k, upsampled to at least the image width. */
static void upsample_row(const dec_t *d, const comp_t *k, int y, uint8_t *out) {
  int rx = d->hmax / k->h, ry = d->vmax / k->v, stride = k->bw * 8, dw = k->cw;
  const uint8_t *pl = k->plane;
  if (ry == 1) {
    const uint8_t *in = pl + (size_t)y * stride;
    if (rx == 1) {
      memcpy(out, in, (size_t)dw);
    } else if (dw > 2) { /* h2v1_fancy_upsample */
      int iv = in[0];
      out[0] = (uint8_t)iv;
      out[1] = (uint8_t)((iv * 3 + in[1] + 2) >> 2);
      int o = 2;
      for (int c = 1; c < dw - 1; c++) {
        iv = in[c] * 3;
        out[o++] = (uint8_t)((iv + in[c - 1] + 1) >> 2);
        out[o++] = (uint8_t)((iv + in[c + 1] + 2) >> 2);
      }
      iv = in[dw - 1];
      out[o++] = (uint8_t)((iv * 3 + in[dw - 2] + 1) >> 2);
      out[o] = (uint8_t)iv;
    } else { /* h2v1_upsample */
      for (int c = 0; c < dw; c++) out[2 * c] = out[2 * c + 1] = in[c];
    }
    return;
  }
  /* ry == 2: output row y comes from input row y/2, with the row above it
   * (even y) or below it (odd y) as the farther one; the rows past the
   * component's edges repeat its first and last rows (jdmainct.c). */
  int r = y / 2, below = y & 1;
  int far = below ? (r + 1 < k->ch ? r + 1 : k->ch - 1) : (r > 0 ? r - 1 : 0);
  const uint8_t *in0 = pl + (size_t)r * stride, *in1 = pl + (size_t)far * stride;
  if (rx == 1) { /* h1v2_fancy_upsample */
    int bias = below ? 2 : 1;
    for (int c = 0; c < dw; c++) out[c] = (uint8_t)((in0[c] * 3 + in1[c] + bias) >> 2);
  } else if (dw > 2) { /* h2v2_fancy_upsample */
    int this = in0[0] * 3 + in1[0], next = in0[1] * 3 + in1[1], last;
    out[0] = (uint8_t)((this * 4 + 8) >> 4);
    out[1] = (uint8_t)((this * 3 + next + 7) >> 4);
    last = this;
    this = next;
    int o = 2;
    for (int c = 2; c < dw; c++) {
      next = in0[c] * 3 + in1[c];
      out[o++] = (uint8_t)((this * 3 + last + 8) >> 4);
      out[o++] = (uint8_t)((this * 3 + next + 7) >> 4);
      last = this;
      this = next;
    }
    out[o++] = (uint8_t)((this * 3 + last + 8) >> 4);
    out[o] = (uint8_t)((this * 4 + 7) >> 4);
  } else { /* h2v2_upsample: both output rows repeat input row y/2 */
    for (int c = 0; c < dw; c++) out[2 * c] = out[2 * c + 1] = in0[c];
  }
}

#define SCALEBITS 16
#define ONE_HALF ((int64_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int64_t)((x) * (1L << SCALEBITS) + 0.5))

static int cr_r_tab[256], cb_b_tab[256];
static int64_t cr_g_tab[256], cb_g_tab[256];

static void init_ycc_tables(void) {
  for (int i = 0, x = -128; i < 256; i++, x++) {
    cr_r_tab[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
    cb_b_tab[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
    cr_g_tab[i] = -FIX(0.71414) * x;
    cb_g_tab[i] = -FIX(0.34414) * x + ONE_HALF;
  }
}

static inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

/* Built once when the library is loaded, before any thread can decode. */
__attribute__((constructor)) static void init_tables(void) {
  init_idct_limit();
  init_ycc_tables();
}

static void parse(dec_t *d, int decode) {
  if (d->end - d->p < 2 || d->p[0] != 0xFF || d->p[1] != 0xD8) fail(d, TCS_JPEG_CORRUPT, "not a JPEG file: no start-of-image marker");
  d->p += 2;
  for (;;) {
    int m = next_marker(d), n;
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      read_sof(d, m, decode);
      if (!decode) return;
    } else if (m == 0xC3 || m == 0xC7) {
      fail(d, TCS_JPEG_UNSUPPORTED, "lossless JPEG: not read by the port");
    } else if (m == 0xC5 || m == 0xC6) {
      fail(d, TCS_JPEG_UNSUPPORTED, "hierarchical (differential) JPEG: not read by the port");
    } else if ((m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF) || m == 0xCC) {
      fail(d, TCS_JPEG_UNSUPPORTED, "arithmetic-coded JPEG: the port reads Huffman coding only");
    } else if (m == 0xC4) {
      read_dht(d);
    } else if (m == 0xDB) {
      read_dqt(d);
    } else if (m == 0xDD) {
      const uint8_t *s = segment(d, &n);
      if (n != 2) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: bad restart interval");
      d->restart_interval = (s[0] << 8) | s[1];
    } else if (m == 0xDA) {
      if (!decode) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: a scan before the frame header");
      read_sos(d);
      decode_scan(d);
    } else if (m == 0xD9) {
      if (!d->frame_seen) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: no frame");
      return;
    } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
      read_app(d, m);
    } else if (m == 0xDC) {
      fail(d, TCS_JPEG_UNSUPPORTED, "JPEG with a DNL marker: not read by the port");
    } else {
      fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: unexpected marker 0x%02X", m);
    }
  }
}

/* Width, height and components of the frame; 0 or an error kind. */
int tcs_jpeg_info(const uint8_t *data, long size, int *width, int *height, int *channels,
                  int *progressive, char *err, int errlen) {
  dec_t *d = calloc(1, sizeof(dec_t));
  if (!d) return TCS_JPEG_NOMEM;
  d->err = err;
  d->errlen = errlen;
  d->p = data;
  d->end = data + size;
  int rc = setjmp(d->jb);
  if (rc == 0) {
    parse(d, 0);
    if (!d->frame_seen) fail(d, TCS_JPEG_CORRUPT, "corrupt JPEG: no frame header");
    *width = d->width;
    *height = d->height;
    *channels = d->ncomp;
    *progressive = d->progressive;
  }
  free(d);
  return rc;
}

/* Decodes into out, (height, width, channels) uint8 as tcs_jpeg_info gives
 * them; 0 or an error kind with its message in err. */
int tcs_jpeg_decode(const uint8_t *data, long size, uint8_t *out, long out_size, char *err,
                    int errlen) {
  dec_t *d = calloc(1, sizeof(dec_t));
  if (!d) return TCS_JPEG_NOMEM;
  d->err = err;
  d->errlen = errlen;
  d->p = data;
  d->end = data + size;
  int rc = setjmp(d->jb);
  if (rc == 0) {
    parse(d, 1);
    int W = d->width, H = d->height, C = d->ncomp;
    if ((long)W * H * C != out_size) fail(d, TCS_JPEG_CORRUPT, "output buffer does not fit the image");
    for (int c = 0; c < C; c++) {
      comp_t *k = &d->comp[c];
      if (!k->scanned) fail(d, TCS_JPEG_CORRUPT, "truncated JPEG: component %d has no scan", c);
      if (d->progressive)
        for (int i = 0; i < 10; i++)
          if (k->coef_bits[i] != 0)
            fail(d, TCS_JPEG_UNSUPPORTED, "progressive JPEG whose scans leave coefficient %d of "
                 "component %d incomplete: libjpeg block-smooths such an image, the port does not", i, c);
      int stride = k->bw * 8, bx = (k->cw + 7) / 8, by = (k->ch + 7) / 8;
      k->plane = dalloc(d, (size_t)stride * k->bh * 8);
      for (int y = 0; y < by; y++)
        for (int x = 0; x < bx; x++)
          idct_islow(k->coef + ((size_t)y * k->bw + x) * 64, k->q,
                     k->plane + (size_t)y * 8 * stride + x * 8, stride);
    }
    int rw = 2 * (W + 16);
    uint8_t *rows = d->rows = dalloc(d, (size_t)3 * rw);
    int rgb = C == 3;
    if (rgb) { /* default_decompress_parms: which 3-component files are RGB */
      if (d->saw_jfif) rgb = 0;
      else if (d->saw_adobe) rgb = d->adobe_transform == 0;
      else rgb = d->comp[0].id == 82 && d->comp[1].id == 71 && d->comp[2].id == 66;
    }
    for (int y = 0; y < H; y++) {
      for (int c = 0; c < C; c++) upsample_row(d, &d->comp[c], y, rows + (size_t)c * rw);
      uint8_t *o = out + (size_t)y * W * C;
      if (C == 1) {
        memcpy(o, rows, (size_t)W);
      } else if (rgb) {
        for (int x = 0; x < W; x++) {
          o[3 * x] = rows[x];
          o[3 * x + 1] = rows[rw + x];
          o[3 * x + 2] = rows[2 * rw + x];
        }
      } else {
        const uint8_t *Y = rows, *cb = rows + rw, *cr = rows + 2 * rw;
        for (int x = 0; x < W; x++) {
          int yy = Y[x];
          o[3 * x] = clamp255(yy + cr_r_tab[cr[x]]);
          o[3 * x + 1] = clamp255(yy + (int)((cb_g_tab[cb[x]] + cr_g_tab[cr[x]]) >> SCALEBITS));
          o[3 * x + 2] = clamp255(yy + cb_b_tab[cb[x]]);
        }
      }
    }
  }
  free_dec(d);
  free(d);
  return rc;
}

/* ======================================================================== */
/* Encoder                                                                   */
/* ======================================================================== */

static const int std_luma_q[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
static const int std_chroma_q[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

typedef struct {
  uint8_t *out;
  long cap, n;
  uint64_t acc;
  int nbits;
  uint16_t code[2][2][256]; /* [dc/ac][table] */
  uint8_t size[2][2][256];
} enc_t;

static void put_byte(enc_t *e, int b) {
  if (e->n < e->cap) e->out[e->n] = (uint8_t)b;
  e->n++;
}

static void put_u16(enc_t *e, int v) {
  put_byte(e, v >> 8);
  put_byte(e, v & 255);
}

static void emit_bits(enc_t *e, unsigned code, int size) {
  e->acc = (e->acc << size) | (code & ((1u << size) - 1));
  e->nbits += size;
  while (e->nbits >= 8) {
    int b = (int)(e->acc >> (e->nbits - 8)) & 255;
    put_byte(e, b);
    if (b == 0xFF) put_byte(e, 0);
    e->nbits -= 8;
  }
}

/* jpeg_make_c_derived_tbl */
static void build_ehuff(enc_t *e, int ac, int t, const uint8_t bits[17], const uint8_t *vals) {
  int huffsize[257], huffcode[257], p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  int n = p, code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    code <<= 1;
    si++;
  }
  for (int i = 0; i < n; i++) {
    e->code[ac][t][vals[i]] = (uint16_t)huffcode[i];
    e->size[ac][t][vals[i]] = (uint8_t)huffsize[i];
  }
}

static void fdct_islow(int *data) {
  int64_t tmp0, tmp1, tmp2, tmp3, tmp4, tmp5, tmp6, tmp7, tmp10, tmp11, tmp12, tmp13;
  int64_t z1, z2, z3, z4, z5;
  for (int pass = 0; pass < 2; pass++) {
    int step = pass ? 8 : 1, next = pass ? 1 : 8;
    for (int ctr = 0; ctr < 8; ctr++) {
      int *dp = data + ctr * next;
      tmp0 = dp[0] + dp[7 * step];
      tmp7 = dp[0] - dp[7 * step];
      tmp1 = dp[step] + dp[6 * step];
      tmp6 = dp[step] - dp[6 * step];
      tmp2 = dp[2 * step] + dp[5 * step];
      tmp5 = dp[2 * step] - dp[5 * step];
      tmp3 = dp[3 * step] + dp[4 * step];
      tmp4 = dp[3 * step] - dp[4 * step];
      tmp10 = tmp0 + tmp3;
      tmp13 = tmp0 - tmp3;
      tmp11 = tmp1 + tmp2;
      tmp12 = tmp1 - tmp2;
      int sh = pass ? CONST_BITS + PASS1_BITS : CONST_BITS - PASS1_BITS;
      if (pass) {
        dp[0] = (int)DESCALE(tmp10 + tmp11, PASS1_BITS);
        dp[4 * step] = (int)DESCALE(tmp10 - tmp11, PASS1_BITS);
      } else {
        dp[0] = (int)((tmp10 + tmp11) * (1 << PASS1_BITS));
        dp[4 * step] = (int)((tmp10 - tmp11) * (1 << PASS1_BITS));
      }
      z1 = (tmp12 + tmp13) * FIX_0_541196100;
      dp[2 * step] = (int)DESCALE(z1 + tmp13 * FIX_0_765366865, sh);
      dp[6 * step] = (int)DESCALE(z1 + tmp12 * -FIX_1_847759065, sh);
      z1 = tmp4 + tmp7;
      z2 = tmp5 + tmp6;
      z3 = tmp4 + tmp6;
      z4 = tmp5 + tmp7;
      z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      dp[7 * step] = (int)DESCALE(tmp4 + z1 + z3, sh);
      dp[5 * step] = (int)DESCALE(tmp5 + z2 + z4, sh);
      dp[3 * step] = (int)DESCALE(tmp6 + z2 + z3, sh);
      dp[step] = (int)DESCALE(tmp7 + z1 + z4, sh);
    }
  }
}

/* Division by a quantiser's divisor d = 8 q (8..2040) as a multiply and a
 * shift: floor(n / d) == (n * m) >> s for every n < 2^24 with s = 24 +
 * ceil(log2 d) and m = ceil(2^s / d) (Granlund and Montgomery); the forward
 * DCT's outputs plus d / 2 stay far below 2^24. */
typedef struct {
  uint64_t m[64];
  int s[64], half[64];
} divisors_t;

static void make_divisors(const int *q, divisors_t *dv) {
  for (int i = 0; i < 64; i++) {
    int d = q[i] * 8, l = 0;
    while ((1 << l) < d) l++;
    dv->s[i] = 24 + l;
    dv->m[i] = (((uint64_t)1 << dv->s[i]) + (uint64_t)d - 1) / (uint64_t)d;
    dv->half[i] = d >> 1;
  }
}

/* The block of plane (stride samples a row) at block (bx, by), through the
 * forward DCT and the quantiser (jcdctmgr.c: the magnitude plus half the
 * divisor 8 q, divided, the sign put back). */
static void forward_block(const uint8_t *plane, int stride, int bx, int by,
                          const divisors_t *dv, int *coef) {
  int ws[64];
  const uint8_t *src = plane + (size_t)by * 8 * stride + bx * 8;
  for (int r = 0; r < 8; r++)
    for (int c = 0; c < 8; c++) ws[8 * r + c] = src[(size_t)r * stride + c] - 128;
  fdct_islow(ws);
  for (int i = 0; i < 64; i++) {
    int t = ws[i], neg = t < 0;
    uint64_t n = (uint64_t)(neg ? -t : t) + (uint64_t)dv->half[i];
    int v = (int)((n * dv->m[i]) >> dv->s[i]);
    coef[i] = neg ? -v : v;
  }
}

static void encode_block(enc_t *e, const int *coef, int *last_dc, int t) {
  int temp = coef[0] - *last_dc, temp2 = temp, nbits = 0;
  *last_dc = coef[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  while (temp) {
    nbits++;
    temp >>= 1;
  }
  emit_bits(e, e->code[0][t][nbits], e->size[0][t][nbits]);
  if (nbits) emit_bits(e, (unsigned)temp2, nbits);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    temp = coef[natural_order[k]];
    if (temp == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      emit_bits(e, e->code[1][t][0xF0], e->size[1][t][0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nbits = 1;
    while ((temp >>= 1)) nbits++;
    int i = (r << 4) + nbits;
    emit_bits(e, e->code[1][t][i], e->size[1][t][i]);
    emit_bits(e, (unsigned)temp2, nbits);
    r = 0;
  }
  if (r > 0) emit_bits(e, e->code[1][t][0], e->size[1][t][0]);
}

static void write_dht(enc_t *e, int ac, int t, const uint8_t bits[17], const uint8_t *vals) {
  int count = 0;
  for (int l = 1; l <= 16; l++) count += bits[l];
  put_u16(e, 0xFFC4);
  put_u16(e, 2 + 1 + 16 + count);
  put_byte(e, (ac << 4) | t);
  for (int l = 1; l <= 16; l++) put_byte(e, bits[l]);
  for (int i = 0; i < count; i++) put_byte(e, vals[i]);
}

/* Encodes (height, width, 3) RGB uint8 at quality 1..100 into out; returns
 * the bytes the file takes (more than cap: nothing past cap was written,
 * call again with that much room), or -1 where memory ran out. */
long tcs_jpeg_encode(const uint8_t *rgb, int width, int height, int quality, uint8_t *out,
                     long cap) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2; /* jpeg_quality_scaling */
  int qt[2][64];
  divisors_t dv[2];
  for (int i = 0; i < 64; i++) {
    for (int t = 0; t < 2; t++) {
      long v = ((long)(t ? std_chroma_q : std_luma_q)[i] * scale + 50L) / 100L;
      qt[t][i] = (int)(v <= 0 ? 1 : (v > 255 ? 255 : v));
    }
  }
  make_divisors(qt[0], &dv[0]);
  make_divisors(qt[1], &dv[1]);
  int mcux = (width + 15) / 16, mcuy = (height + 15) / 16;
  int ywb = (width + 7) / 8, yhb = (height + 7) / 8;     /* luma blocks with samples */
  int cw = (width + 1) / 2, ch = (height + 1) / 2;       /* chroma samples */
  int cwb = (cw + 7) / 8, chb = (ch + 7) / 8;            /* == mcux, mcuy */
  int ystride = ywb * 8, cstride = cwb * 8;
  int yrows = yhb * 8, crows = chb * 8;
  uint8_t *Y = malloc((size_t)ystride * yrows), *cb = malloc((size_t)cstride * crows),
          *cr = malloc((size_t)cstride * crows);
  uint8_t *fcb = malloc((size_t)2 * cstride * 2), *fcr = malloc((size_t)2 * cstride * 2);
  enc_t *e = calloc(1, sizeof(enc_t));
  if (!Y || !cb || !cr || !fcb || !fcr || !e) {
    free(Y), free(cb), free(cr), free(fcb), free(fcr), free(e);
    return -1;
  }
  /* rgb_ycc_convert's tables (jccolor.c) */
  static const int64_t CBCR_OFFSET = (int64_t)128 << SCALEBITS;
  for (int r = 0; r < ch * 2; r += 2) {
    /* two image rows, the last one repeated where the height is odd; each
     * converted and padded on the right to the chroma width x 2 */
    for (int j = 0; j < 2; j++) {
      int sy = r + j < height ? r + j : height - 1;
      const uint8_t *src = rgb + (size_t)sy * width * 3;
      for (int x = 0; x < cstride * 2; x++) {
        const uint8_t *px = src + 3 * (x < width ? x : width - 1);
        int R = px[0], G = px[1], B = px[2];
        int64_t yv = (FIX(0.29900) * R + FIX(0.58700) * G + FIX(0.11400) * B + ONE_HALF) >> SCALEBITS;
        int64_t cbv = (-FIX(0.16874) * R - FIX(0.33126) * G + FIX(0.50000) * B + CBCR_OFFSET + ONE_HALF - 1) >> SCALEBITS;
        int64_t crv = (FIX(0.50000) * R - FIX(0.41869) * G - FIX(0.08131) * B + CBCR_OFFSET + ONE_HALF - 1) >> SCALEBITS;
        if (r + j < yrows && x < ystride) Y[(size_t)(r + j) * ystride + x] = (uint8_t)yv;
        fcb[j * cstride * 2 + x] = (uint8_t)cbv;
        fcr[j * cstride * 2 + x] = (uint8_t)crv;
      }
    }
    /* h2v2_downsample, biases 1, 2, 1, 2, ... along the row */
    uint8_t *ocb = cb + (size_t)(r / 2) * cstride, *ocr = cr + (size_t)(r / 2) * cstride;
    for (int x = 0, bias = 1; x < cstride; x++, bias ^= 3) {
      const uint8_t *a = fcb + 2 * x, *b = fcb + 2 * cstride + 2 * x;
      ocb[x] = (uint8_t)((a[0] + a[1] + b[0] + b[1] + bias) >> 2);
      a = fcr + 2 * x;
      b = fcr + 2 * cstride + 2 * x;
      ocr[x] = (uint8_t)((a[0] + a[1] + b[0] + b[1] + bias) >> 2);
    }
  }
  /* Luma rows past an even height (jcprepct.c pads the downsampler's output
   * with its last row), and chroma rows past the last computed one. */
  for (int r = (height + 1) / 2 * 2; r < yrows; r++)
    memcpy(Y + (size_t)r * ystride, Y + (size_t)(r - 1) * ystride, (size_t)ystride);
  for (int r = ch; r < crows; r++) {
    memcpy(cb + (size_t)r * cstride, cb + (size_t)(ch - 1) * cstride, (size_t)cstride);
    memcpy(cr + (size_t)r * cstride, cr + (size_t)(ch - 1) * cstride, (size_t)cstride);
  }

  e->out = out;
  e->cap = cap;
  for (int t = 0; t < 2; t++) {
    build_ehuff(e, 0, t, std_dc_bits[t], std_dc_vals);
    build_ehuff(e, 1, t, std_ac_bits[t], std_ac_vals[t]);
  }
  static const uint8_t jfif[18] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I',
                                   'F',  0x00, 0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01};
  for (int i = 0; i < 18; i++) put_byte(e, jfif[i]);
  put_u16(e, 0x0000); /* no thumbnail */
  for (int t = 0; t < 2; t++) {
    put_u16(e, 0xFFDB);
    put_u16(e, 67);
    put_byte(e, t);
    for (int k = 0; k < 64; k++) put_byte(e, qt[t][natural_order[k]]);
  }
  put_u16(e, 0xFFC0);
  put_u16(e, 17);
  put_byte(e, 8);
  put_u16(e, height);
  put_u16(e, width);
  put_byte(e, 3);
  static const uint8_t comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  for (int i = 0; i < 9; i++) put_byte(e, comps[i]);
  write_dht(e, 0, 0, std_dc_bits[0], std_dc_vals);
  write_dht(e, 1, 0, std_ac_bits[0], std_ac_vals[0]);
  write_dht(e, 0, 1, std_dc_bits[1], std_dc_vals);
  write_dht(e, 1, 1, std_ac_bits[1], std_ac_vals[1]);
  static const uint8_t sos[14] = {0xFF, 0xDA, 0x00, 0x0C, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  for (int i = 0; i < 14; i++) put_byte(e, sos[i]);

  int dc[3] = {0, 0, 0}, coef[4][64], cc[64];
  for (int my = 0; my < mcuy; my++)
    for (int mx = 0; mx < mcux; mx++) {
      /* jccoefct.c: blocks past the image's last block column or row are
       * zeros with the DC of the block before them in the MCU */
      for (int j = 0; j < 2; j++) {
        int by = 2 * my + j;
        for (int i = 0; i < 2; i++) {
          int bx = 2 * mx + i, *b = coef[2 * j + i];
          if (by < yhb && bx < ywb) {
            forward_block(Y, ystride, bx, by, &dv[0], b);
          } else {
            memset(b, 0, sizeof coef[0]);
            b[0] = by < yhb ? coef[2 * j + i - 1][0] : coef[1][0];
          }
        }
      }
      for (int b = 0; b < 4; b++) encode_block(e, coef[b], &dc[0], 0);
      forward_block(cb, cstride, mx, my, &dv[1], cc);
      encode_block(e, cc, &dc[1], 1);
      forward_block(cr, cstride, mx, my, &dv[1], cc);
      encode_block(e, cc, &dc[2], 1);
    }
  emit_bits(e, 0x7F, 7); /* flush_bits: the last byte padded with ones */
  put_u16(e, 0xFFD9);
  long n = e->n;
  free(Y), free(cb), free(cr), free(fcb), free(fcr), free(e);
  return n;
}
