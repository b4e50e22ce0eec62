/* The port's host core for the data path: PNG row unfiltering, the
 * half-pixel bilinear resize of the augmentor and its colour jitter.
 *
 * Counterpart of native/tcs_io.cc (tcs_tpu's libpng/libjpeg core), without
 * libpng or libjpeg: the port inflates with Python's zlib, which releases the
 * GIL while it inflates, and this file undoes the row filters. Plain C with a
 * plain C interface, built at first use with the host compiler
 * (tcs_tpu_torch/data/_host.py, -O3 -fPIC -ffp-contract=off -fno-trapping-math) and called
 * through ctypes, which releases the GIL for the length of each call.
 *
 * Each entry point has a numpy version beside its Python wrapper that it is
 * held to in the tests:
 *   tcs_png_unfilter     data/png.py _unfilter_rows, _unfilter_diagonals (bit for bit)
 *   tcs_resize_bilinear  data/augmentor.py resize_bilinear_plain (bit for bit:
 *                        the same float64 expression in the same order; the
 *                        sparse valid mask tests the result with == 1.0, so an
 *                        FMA or a float32 tap sum would drop pixels whose four
 *                        taps are all 1)
 *   tcs_color_jitter     data/augmentor.py ColorJitter's numpy ops (float32 in
 *                        the same order; the contrast mean is summed in double,
 *                        so a pixel may round to the other uint8 level)
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------------ */
/* PNG row filters (PNG specification, section 9)                            */
/* ------------------------------------------------------------------------ */

/* The predictor nearest a + b - c, ties to a, then b. Written as selects
 * (conditional moves): photographs make the branches unpredictable. */
static inline int paeth(int a, int b, int c) {
  const int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
  const int bc = pb <= pc ? b : c;
  return (pa <= pb) & (pa <= pc) ? a : bc;
}

/* One row of the Sub (1), Average (3) or Paeth (4) filter, whose bytes
 * depend on the reconstructed byte one pixel to the left. The left and
 * upper-left bytes of each of the bpp channels are carried in locals, not
 * read back from the row just written: with bpp a constant (the callers
 * below), they live in registers and the bpp channels' chains overlap. */
static inline void unfilter_left(int kind, const uint8_t *f, uint8_t *o,
                                 const uint8_t *up, int rowbytes, const int bpp) {
  int a[8], c[8];
  for (int k = 0; k < bpp; ++k) {
    const int b = up ? up[k] : 0;
    /* the first pixel has no left neighbour: a = c = 0 */
    const int pred = kind == 1 ? 0 : (kind == 3 ? b >> 1 : b);
    a[k] = o[k] = (uint8_t)(f[k] + pred);
    c[k] = b;
  }
  for (int x = bpp; x + bpp <= rowbytes; x += bpp) {
    for (int k = 0; k < bpp; ++k) {
      const int b = up ? up[x + k] : 0;
      const int pred = kind == 1 ? a[k] : (kind == 3 ? (a[k] + b) >> 1 : paeth(a[k], b, c[k]));
      a[k] = o[x + k] = (uint8_t)(f[x + k] + pred);
      c[k] = b;
    }
  }
}

/* raw: height rows of 1 + rowbytes bytes, the filter type first.
 * out: height rows of rowbytes bytes. bpp: bytes per complete pixel (1..8),
 * and rowbytes a multiple of it.
 * Returns 0, or 1 + the index of the first row with an unknown filter. */
int tcs_png_unfilter(const uint8_t *raw, uint8_t *out, int height, int rowbytes,
                     int bpp) {
  for (int r = 0; r < height; ++r) {
    const uint8_t *f = raw + (long)r * (rowbytes + 1) + 1;
    const int kind = f[-1];
    uint8_t *o = out + (long)r * rowbytes;
    const uint8_t *up = r > 0 ? out + (long)(r - 1) * rowbytes : NULL;
    switch (kind) {
      case 0:
        memcpy(o, f, (size_t)rowbytes);
        break;
      case 2:
        for (int x = 0; x < rowbytes; ++x) o[x] = (uint8_t)(f[x] + (up ? up[x] : 0));
        break;
      case 1: case 3: case 4:
        switch (bpp) {  /* a constant bpp for each instance of the loop */
          case 1: unfilter_left(kind, f, o, up, rowbytes, 1); break;
          case 2: unfilter_left(kind, f, o, up, rowbytes, 2); break;
          case 3: unfilter_left(kind, f, o, up, rowbytes, 3); break;
          case 4: unfilter_left(kind, f, o, up, rowbytes, 4); break;
          case 6: unfilter_left(kind, f, o, up, rowbytes, 6); break;
          default: unfilter_left(kind, f, o, up, rowbytes, 8); break;
        }
        break;
      default:
        return r + 1;
    }
  }
  return 0;
}

/* ------------------------------------------------------------------------ */
/* Bilinear resize, half-pixel centres (cv2.INTER_LINEAR)                    */
/* ------------------------------------------------------------------------ */

/* Source taps and weight of output coordinates start .. start + len - 1 of
 * n_out, as numpy computes them: s = (i + 0.5) * (n / n_out) - 0.5;
 * i0 = clip(floor(s), 0, n - 1); i1 = clip(i0 + 1, 0, n - 1);
 * w = clip(s - i0, 0, 1). */
static void taps(int n, int n_out, int start, int len, int *i0, int *i1, double *w) {
  const double step = (double)n / (double)n_out;
  for (int j = 0; j < len; ++j) {
    const double s = ((double)(start + j) + 0.5) * step - 0.5;
    double f = floor(s);
    if (f < 0.0) f = 0.0;
    if (f > (double)(n - 1)) f = (double)(n - 1);
    const int a = (int)f;
    double t = s - (double)a;
    if (t < 0.0) t = 0.0;
    if (t > 1.0) t = 1.0;
    i0[j] = a;
    i1[j] = a + 1 < n ? a + 1 : n - 1;
    w[j] = t;
  }
}

/* in: H x W x C float32. out: the window of h rows from y_start and w
 * columns from x_start of the H2 x W2 x C resize, float64, each value
 * top * (1 - fy) + bot * fy with top = a * (1 - fx) + b * fx, in double:
 * the same values as the whole resize, cut after. Returns 0, or 1 where
 * the scratch could not be allocated. */
int tcs_resize_bilinear(const float *in, int H, int W, int C, double *out, int H2, int W2,
                        int y_start, int x_start, int h, int w) {
  int *x0 = malloc(sizeof(int) * (size_t)w * 2);
  int *y0 = malloc(sizeof(int) * (size_t)h * 2);
  double *fx = malloc(sizeof(double) * (size_t)w);
  double *fy = malloc(sizeof(double) * (size_t)h);
  if (!x0 || !y0 || !fx || !fy) {
    free(x0); free(y0); free(fx); free(fy);
    return 1;
  }
  int *x1 = x0 + w, *y1 = y0 + h;
  taps(W, W2, x_start, w, x0, x1, fx);
  taps(H, H2, y_start, h, y0, y1, fy);
  for (int y = 0; y < h; ++y) {
    const float *r0 = in + (long)y0[y] * W * C;
    const float *r1 = in + (long)y1[y] * W * C;
    const double wy = fy[y], wy0 = 1.0 - wy;
    double *o = out + (long)y * w * C;
    for (int x = 0; x < w; ++x) {
      const double wx = fx[x], wx0 = 1.0 - wx;
      const float *p00 = r0 + (long)x0[x] * C, *p01 = r0 + (long)x1[x] * C;
      const float *p10 = r1 + (long)x0[x] * C, *p11 = r1 + (long)x1[x] * C;
      for (int c = 0; c < C; ++c) {
        const double top = (double)p00[c] * wx0 + (double)p01[c] * wx;
        const double bot = (double)p10[c] * wx0 + (double)p11[c] * wx;
        o[(long)x * C + c] = top * wy0 + bot * wy;
      }
    }
  }
  free(x0); free(y0); free(fx); free(fy);
  return 0;
}

/* ------------------------------------------------------------------------ */
/* Colour jitter and gamma (torchvision ColorJitter + AdjustGamma)           */
/* ------------------------------------------------------------------------ */

/* Inputs are finite, so plain comparisons stand in for fmaxf, fminf, floorf
 * and rintf (the x86-64 baseline, without SSE4.1, calls these out of line). */
static inline float clip255(float v) { return v < 0.f ? 0.f : (v > 255.f ? 255.f : v); }
static inline float max2(float a, float b) { return a > b ? a : b; }
static inline float min2(float a, float b) { return a < b ? a : b; }

/* Round half to even (np.round, rintf) of v in [0, 255]; v - (int)v is exact. */
static inline uint8_t round_u8(float v) {
  int i = (int)v;
  const float fr = v - (float)i;
  if (fr > 0.5f || (fr == 0.5f && (i & 1))) ++i;
  return (uint8_t)i;
}

/* ITU-R 601-2 luma, summed left to right as numpy does. */
static inline float gray(const float *p) { return 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2]; }

/* numpy's float remainder x % 1.0 (fmod, plus 1 where negative) for x in
 * (-1, 2), where fmod is x or x - 1, both exact. Hue values stay in that
 * range: (bc - gc) / 6 lies in [-1/6, 5/6], a shift in [-0.5, 0.5]. */
static inline float mod1(float x) {
  const float m = x >= 1.f ? x - 1.f : x;
  return m < 0.f ? m + 1.f : m;
}

/* Hue rotation by shift turns of n planar pixels (RGB 0..255, in place):
 * numpy's _rgb_to_hsv, the shift and _hsv_to_rgb, in float32. Every operand
 * is computed before it is selected, so that the loop has no branch and the
 * compiler vectorises it (-fno-trapping-math lets it evaluate a division
 * whose result a select then drops). */
static void hue_planar(float *R, float *G, float *B, int n, float shift) {
  for (int i = 0; i < n; ++i) {
    const float r = R[i] / 255.f, g = G[i] / 255.f, b = B[i] / 255.f;
    const float maxc = max2(max2(r, g), b), minc = min2(min2(r, g), b);
    const float v = maxc, delta = maxc - minc;
    const float s_any = delta / max2(maxc, 1e-12f);
    const float s = maxc > 0.f ? s_any : 0.f;
    const float dc = delta == 0.f ? 1.f : delta;
    const float rc = (maxc - r) / dc, gc = (maxc - g) / dc, bc = (maxc - b) / dc;
    const float h_r = bc - gc, h_g = 2.f + rc - bc, h_b = 4.f + gc - rc;
    float h = r == maxc ? h_r : (g == maxc ? h_g : h_b);
    h = mod1(h / 6.f);
    h = delta == 0.f ? 0.f : h;
    h = mod1(h + shift);
    const float h6 = h * 6.f;
    const float sector = (float)(int)h6;  /* floor: h6 in [0, 6] */
    const float f = h6 - sector;
    const float p = v * (1.f - s), q = v * (1.f - s * f), t = v * (1.f - s * (1.f - f));
    /* numpy's select over sector % 6, as sums of 0/1 masks: exactly one mask
     * is 1, so each sum is the selected value exactly. */
    const float k = sector == 6.f ? 0.f : sector;
    const float m0 = k == 0.f ? 1.f : 0.f, m1 = k == 1.f ? 1.f : 0.f, m2 = k == 2.f ? 1.f : 0.f;
    const float m3 = k == 3.f ? 1.f : 0.f, m4 = k == 4.f ? 1.f : 0.f, m5 = k == 5.f ? 1.f : 0.f;
    R[i] = (v * (m0 + m5) + q * m1 + p * (m2 + m3) + t * m4) * 255.f;
    G[i] = (v * (m1 + m2) + t * m0 + q * m3 + p * (m4 + m5)) * 255.f;
    B[i] = (v * (m3 + m4) + p * (m0 + m1) + t * m2 + q * m5) * 255.f;
  }
}

#define HUE_BLOCK 1024

static void hue_rotate(float *work, long npx, float shift) {
  float R[HUE_BLOCK], G[HUE_BLOCK], B[HUE_BLOCK];
  for (long i0 = 0; i0 < npx; i0 += HUE_BLOCK) {
    const int m = npx - i0 < HUE_BLOCK ? (int)(npx - i0) : HUE_BLOCK;
    float *px = work + 3 * i0;
    for (int j = 0; j < m; ++j) {
      R[j] = px[3 * j];
      G[j] = px[3 * j + 1];
      B[j] = px[3 * j + 2];
    }
    hue_planar(R, G, B, m, shift);
    for (int j = 0; j < m; ++j) {
      px[3 * j] = R[j];
      px[3 * j + 1] = G[j];
      px[3 * j + 2] = B[j];
    }
  }
}

/* in, out: npx RGB pixels of uint8; work: npx * 3 floats of scratch.
 * order: a permutation of {0 brightness, 1 contrast, 2 saturation, 3 hue}.
 * A factor f blends as f * x + (1 - f) * y with both weights rounded to float
 * from double, as numpy does with a Python float and a float32 array. Gamma
 * follows; the result is clipped and rounded half to even (np.round). */
void tcs_color_jitter(const uint8_t *in, float *work, uint8_t *out, long npx,
                      const int *order, double brightness, double contrast,
                      double saturation, double hue, double gamma, double gain) {
  const long n = npx * 3;
  for (long i = 0; i < n; ++i) work[i] = (float)in[i];
  for (int k = 0; k < 4; ++k) {
    switch (order[k]) {
      case 0: {
        const float f = (float)brightness;  /* blended with black: (1 - f) * 0 */
        for (long i = 0; i < n; ++i) work[i] = clip255(f * work[i]);
        break;
      }
      case 1: {
        double acc = 0.0;
        for (long i = 0; i < npx; ++i) acc += gray(work + 3 * i);
        const float mean = (float)(acc / (double)npx);
        const float f = (float)contrast, g = (float)(1.0 - contrast);
        const float base = g * mean;
        for (long i = 0; i < n; ++i) work[i] = clip255(f * work[i] + base);
        break;
      }
      case 2: {
        const float f = (float)saturation, g = (float)(1.0 - saturation);
        for (long i = 0; i < npx; ++i) {
          float *p = work + 3 * i;
          const float base = g * gray(p);
          p[0] = clip255(f * p[0] + base);
          p[1] = clip255(f * p[1] + base);
          p[2] = clip255(f * p[2] + base);
        }
        break;
      }
      default:
        hue_rotate(work, npx, (float)hue);
        break;
    }
  }
  const float scale = (float)(255.0 * gain), gam = (float)gamma;
  if (gam == 1.f) {  /* powf(x, 1) is x: the recipes' default, without the call */
    for (long i = 0; i < n; ++i) out[i] = round_u8(clip255(scale * (work[i] / 255.f)));
  } else {
    for (long i = 0; i < n; ++i)
      out[i] = round_u8(clip255(scale * powf(work[i] / 255.f, gam)));
  }
}
