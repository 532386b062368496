/* refbench — the compiled-C single-core baseline for BASELINE.md.
 *
 * The honest denominator VERDICT.md asked for: the reference's own hot-loop
 * math, compiled -O3 -march=native and run single-threaded on this host.
 * Two kinds of code live in the resulting librefbench.so:
 *
 *  1. REAL reference code: the autogenerated ORC backup kernels, compiled
 *     straight from /root/reference/gst/.../gst*orc-dist.c translation units
 *     (listed in tools/ref_baseline.py's build command, -DDISABLE_ORC).
 *     gaudi_orc_burn is called below for the burn stage, so the headline
 *     graph contains genuine reference code — and tools/ref_baseline.py
 *     cross-checks golden/ against these functions.
 *
 *  2. C transcriptions (this file) of the reference's plain-C hot loops that
 *     cannot be compiled out of the tree without the whole GStreamer stack.
 *     Each function cites the reference file:line it transcribes; the math
 *     is identical to the verified golden/ numpy transcriptions, and
 *     tools/ref_baseline.py asserts bit-equality against golden/ output.
 *
 * Pixel layout: BGRx words as bytes [B,G,R,x] (little-endian guint32 view,
 * gstburn.c:80-84), i.e. R at byte offset 2, G at 1, B at 0, fill at 3.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

/* reference ORC backup kernel, linked from gstgaudieffectsorc-dist.c */
extern void gaudi_orc_burn(uint32_t *d1, const uint32_t *s1, int p1, int n);

static inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

/* ---- coloreffects preset LUT, luma path (gstcoloreffects.c:306-360) ---- */
void rb_coloreffects_luma(uint8_t *dst, const uint8_t *src, int n_pix,
                          const uint8_t *table /* 256*3 RGB rows */) {
  for (int i = 0; i < n_pix; i++) {
    const uint8_t *p = src + 4 * i;
    uint8_t *q = dst + 4 * i;
    int r = p[2], g = p[1], b = p[0];
    /* BT.709 fixed point (gstcoloreffects.c:330-334) */
    int luma = (((r << 8) * 54) + ((g << 8) * 183) + ((b << 8) * 19)) >> 16;
    q[2] = table[3 * luma + 0];
    q[1] = table[3 * luma + 1];
    q[0] = table[3 * luma + 2];
    q[3] = p[3];
  }
}

/* ---- solarize (gstsolarize.c:287-339) ---- */
void rb_solarize(uint8_t *dst, const uint8_t *src, int n_pix, int threshold,
                 int start, int end) {
  int period = (end != start) ? end - start : 1;
  int up_length = (threshold != start) ? threshold - start : 1;
  int down_length = (end != threshold) ? end - threshold : 1;
  for (int i = 0; i < n_pix; i++) {
    const uint8_t *p = src + 4 * i;
    uint8_t *q = dst + 4 * i;
    for (int ch = 0; ch < 3; ch++) {
      int param = ((int)p[ch] + 256 - start) % period;
      uint32_t col;
      if (param < up_length)
        col = ((uint32_t)param * 255u) / (uint32_t)up_length;
      else
        col = ((uint32_t)(down_length - (param - up_length)) * 255u) /
              (uint32_t)down_length; /* guint32 wraparound, gstsolarize.c */
      q[ch] = (uint8_t)(col > 255u ? 255u : col);
    }
    q[3] = 0;
  }
}

/* ---- chromium (gstchromium.c:283-360; typo'd pi at :102) ---- */
static int cos_table[1024];
static int cos_table_ready = 0;
static void setup_cos_table(void) {
  for (int i = 0; i < 1024; i++) {
    float rad = ((float)i / 512.0f) * 3.141582f; /* gstchromium.c:102 */
    cos_table[i] = (int)(cos((double)rad) * 512.0);
  }
  cos_table_ready = 1;
}

void rb_chromium(uint8_t *dst, const uint8_t *src, int n_pix, int edge_a,
                 int edge_b) {
  if (!cos_table_ready) setup_cos_table();
  for (int i = 0; i < n_pix; i++) {
    const uint8_t *p = src + 4 * i;
    uint8_t *q = dst + 4 * i;
    for (int ch = 0; ch < 3; ch++) {
      int c = p[ch];
      int idx = (c + edge_a + (c * edge_b) / 2) & 1023;
      int v = cos_table[idx];
      if (v < 0) v = -v;
      q[ch] = clamp255(v);
    }
    q[3] = 0;
  }
}

/* ---- dodge (gstdodge.c:232-255) ---- */
void rb_dodge(uint8_t *dst, const uint8_t *src, int n_pix) {
  for (int i = 0; i < n_pix; i++) {
    const uint8_t *p = src + 4 * i;
    uint8_t *q = dst + 4 * i;
    for (int ch = 0; ch < 3; ch++) {
      int c = p[ch];
      q[ch] = clamp255((256 * c) / (256 - c));
    }
    q[3] = 0;
  }
}

/* ---- exclusion (gstexclusion.c:257-290; green-in-red quirk) ---- */
void rb_exclusion(uint8_t *dst, const uint8_t *src, int n_pix, int factor) {
  int f = factor;
  for (int i = 0; i < n_pix; i++) {
    const uint8_t *p = src + 4 * i;
    uint8_t *q = dst + 4 * i;
    int r = p[2], g = p[1], b = p[0];
    int rr = f - (((f - r) * (f - r)) / f + (g * r) / f);
    int gg = f - (((f - g) * (f - g)) / f + (g * g) / f);
    int bb = f - (((f - b) * (f - b)) / f + (b * b) / f);
    q[2] = clamp255(rr);
    q[1] = clamp255(gg);
    q[0] = clamp255(bb);
    q[3] = 0;
  }
}

/* ---- dilate/erode (gstdilate.c:258-350) ----
 * Luminance 90r+115g+51b; compares src neighbors down, right, left (the
 * reference's `up < src` pointer compare is always true, so up never wins);
 * down clamps on the last row, right/left clamp at line ends. */
static inline int dilate_lum(const uint8_t *p) {
  return 90 * p[2] + 115 * p[1] + 51 * p[0];
}

void rb_dilate(uint8_t *dst, const uint8_t *src, int h, int w, int erode) {
  for (int y = 0; y < h; y++) {
    for (int x = 0; x < w; x++) {
      const uint8_t *self = src + 4 * (y * w + x);
      const uint8_t *down = src + 4 * ((y + 1 < h ? y + 1 : y) * w + x);
      const uint8_t *right = src + 4 * (y * w + (x + 1 < w ? x + 1 : x));
      const uint8_t *left = src + 4 * (y * w + (x > 0 ? x - 1 : 0));
      const uint8_t *best = self;
      int bl = dilate_lum(self);
      const uint8_t *cands[3] = {down, right, left};
      for (int k = 0; k < 3; k++) {
        int nl = dilate_lum(cands[k]);
        if (erode ? nl < bl : nl > bl) {
          bl = nl;
          best = cands[k];
        }
      }
      memcpy(dst + 4 * (y * w + x), best, 4);
    }
  }
}

/* ---- chromahold (gstchromahold.c:271-360) ---- */
static int rgb_to_hue(int r, int g, int b) {
  int m = r < g ? (r < b ? r : b) : (g < b ? g : b);
  int M = r > g ? (r > b ? r : b) : (g > b ? g : b);
  int C = M - m;
  if (C == 0) return -1; /* G_MAXUINT viewed as gint */
  int C2 = C >> 1;
  int hh;
  if (M == r)
    hh = (256 * 60 * (g - b) + C2) / C;
  else if (M == g)
    hh = (256 * 60 * (b - r) + C2) / C + 120 * 256;
  else
    hh = (256 * 60 * (r - g) + C2) / C + 240 * 256;
  hh >>= 8; /* arithmetic shift, floors negatives */
  if (hh >= 360) hh -= 360;
  if (hh < 0) hh += 360;
  return hh;
}

static int hue_dist(int h1, int h2) {
  int d1 = h1 - h2, d2 = h2 - h1;
  if (d1 < 0) d1 += 360;
  if (d2 < 0) d2 += 360;
  return d1 < d2 ? d1 : d2;
}

void rb_chromahold(uint8_t *dst, const uint8_t *src, int n_pix, int target_r,
                   int target_g, int target_b, int tolerance) {
  int h1 = rgb_to_hue(target_r, target_g, target_b);
  for (int i = 0; i < n_pix; i++) {
    const uint8_t *p = src + 4 * i;
    uint8_t *q = dst + 4 * i;
    int r = p[2], g = p[1], b = p[0];
    int h2 = rgb_to_hue(r, g, b);
    int make_grey = (h1 == -1) || (hue_dist(h1, h2) > tolerance);
    if (make_grey) {
      uint8_t grey = clamp255((13938 * r + 46869 * g + 4730 * b) >> 16);
      q[2] = q[1] = q[0] = grey;
    } else {
      q[2] = (uint8_t)r;
      q[1] = (uint8_t)g;
      q[0] = (uint8_t)b;
    }
    q[3] = p[3];
  }
}

/* ---- BGRx -> Y (videoconvert analog; COG_RGB_TO_YCBCR_8BIT_SDTV row,
 * gstcoloreffects.c:295-299) ---- */
void rb_rgb_to_y(uint8_t *ydst, const uint8_t *src, int n_pix) {
  for (int i = 0; i < n_pix; i++) {
    const uint8_t *p = src + 4 * i;
    int v = (66 * p[2] + 129 * p[1] + 25 * p[0] + 4096) >> 8;
    ydst[i] = clamp255(v);
  }
}

/* ---- zebrastripe on a luma plane (gstzebrastripe.c:145-148,205-253) ---- */
void rb_zebrastripe(uint8_t *y, int h, int w, int threshold_pct, int t) {
  int thr = 16 + (int)floor(0.5 + 2.19 * threshold_pct);
  for (int j = 0; j < h; j++)
    for (int i = 0; i < w; i++)
      if (y[j * w + i] >= thr && (((i + j + t) & 0x4) != 0))
        y[j * w + i] = 16;
}

/* ---- gaussianblur on AYUV (gstgaussblur.c:260-422) ---- */
void rb_gaussianblur(uint8_t *dst, const uint8_t *src, float *tmp, int h,
                     int w, float sigma) {
  if (sigma == 0.0f) {
    memcpy(dst, src, (size_t)h * w * 4);
    return;
  }
  float asig = sigma < 0 ? -sigma : sigma;
  int center = (int)ceil(2.5 * (double)asig);
  int window = 1 + 2 * center;
  float kern[128], ksum[128];
  if (window == 1) {
    kern[0] = 1.0f;
    ksum[0] = 1.0f;
  } else {
    float fe = (float)(-0.5 / ((double)sigma * (double)sigma));
    float dx = (float)(1.0 / ((double)sigma * sqrt(2 * M_PI)));
    kern[center] = dx;
    float s = dx;
    for (int i = 1; i <= center; i++) {
      float arg = (fe * (float)i) * (float)i;
      float fx = (float)((double)dx * pow(M_E, (double)arg));
      kern[center + i] = kern[center - i] = fx;
      s = s + 2.0f * fx;
    }
    if (sigma < 0) {
      s = -s;
      kern[center] = kern[center] + 2.0f * s;
    }
    for (int i = 0; i < window; i++) kern[i] = kern[i] / s;
    float acc = 0.0f;
    for (int i = 0; i < window; i++) {
      acc += kern[i];
      ksum[i] = acc;
    }
  }
  /* x pass into float tmp */
  for (int y = 0; y < h; y++) {
    for (int c = 0; c < w; c++) {
      int cc = center - c;
      int kmin = cc > 0 ? cc : 0;
      int base = c - center + kmin;
      int kmax = window < (w - base) ? window : (w - base);
      float ssum = ksum[kmax - 1] - (kmin ? ksum[kmin - 1] : 0.0f);
      for (int ch = 0; ch < 4; ch++) {
        float a = 0.0f;
        for (int k = kmin; k < kmax; k++)
          a += (float)src[4 * (y * w + base + (k - kmin)) + ch] * kern[k];
        tmp[4 * (y * w + c) + ch] = a / ssum;
      }
    }
  }
  /* y pass to dst with +0.5 round */
  for (int c = 0; c < h; c++) {
    int cc = center - c;
    int kmin = cc > 0 ? cc : 0;
    int base = c - center + kmin;
    int kmax = window < (h - base) ? window : (h - base);
    float ssum = ksum[kmax - 1] - (kmin ? ksum[kmin - 1] : 0.0f);
    for (int x = 0; x < w; x++) {
      for (int ch = 0; ch < 4; ch++) {
        float a = 0.0f;
        for (int k = kmin; k < kmax; k++)
          a += tmp[4 * ((base + (k - kmin)) * w + x) + ch] * kern[k];
        float v = a / ssum + 0.5f;
        dst[4 * (c * w + x) + ch] =
            (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
      }
    }
  }
}

/* ======================================================================
 * Config 3: the audio chain (audiomixmatrix -> freeverb)
 * ====================================================================== */

/* audiomixmatrix float path (gst/audiomixmatrix/gstaudiomixmatrix.c
 * PROCESS_TYPE(float): per-sample out[o] = sum_i in[i] * matrix[o][i]) */
void rb_mixmatrix_f32(float *dst, const float *src, int n_samples,
                      const float *matrix, int in_ch, int out_ch) {
  for (int s = 0; s < n_samples; s++) {
    for (int o = 0; o < out_ch; o++) {
      float acc = 0.0f;
      for (int i = 0; i < in_ch; i++)
        acc += src[s * in_ch + i] * matrix[o * in_ch + i];
      dst[s * out_ch + o] = acc;
    }
  }
}

/* freeverb (gst/freeverb/gstfreeverb.c:197-300 filter structs + :833-860
 * transform_s2s_float).  Delay lengths scale by rate/44100
 * (gstfreeverb.c:486-529); DC_OFFSET per the reference. */
#define RB_DC_OFFSET 1e-8f
#define RB_NCOMBS 8
#define RB_NAPS 4

typedef struct {
  float feedback, filterstore, damp1, damp2;
  float *buffer;
  int bufsize, bufidx;
} rb_comb;

typedef struct {
  float feedback;
  float *buffer;
  int bufsize, bufidx;
} rb_allpass;

static const int rb_combtuning[RB_NCOMBS] = {1116, 1188, 1277, 1356,
                                             1422, 1491, 1557, 1617};
static const int rb_aptuning[RB_NAPS] = {556, 441, 341, 225};

static void rb_comb_setup(rb_comb *c, int size, float feedback, float damp) {
  c->buffer = (float *)malloc(sizeof(float) * size);
  c->bufsize = size;
  c->bufidx = 0;
  c->filterstore = 0;
  c->feedback = feedback;
  c->damp1 = damp;
  c->damp2 = 1 - damp;
  for (int i = 0; i < size; i++) c->buffer[i] = RB_DC_OFFSET;
}

static void rb_ap_setup(rb_allpass *a, int size) {
  a->buffer = (float *)malloc(sizeof(float) * size);
  a->bufsize = size;
  a->bufidx = 0;
  a->feedback = 0.5f; /* gstfreeverb.c:520-529 */
  for (int i = 0; i < size; i++) a->buffer[i] = RB_DC_OFFSET;
}

/* Stereo in -> stereo out, element defaults (room-size .5, damping .2,
 * width 1, level .5 -> feedback .84, gstfreeverb.c:536-570).  Returns
 * seconds for reps passes over the n_samples block. */
double rb_freeverb_seconds(const float *in, float *out, int n_samples,
                           int rate, int reps) {
  float srf = (float)rate / 44100.0f;
  float feedback = 0.5f * 0.28f + 0.7f;
  float damp = 0.2f, width = 1.0f, level = 0.5f;
  float wet = level * 1.0f;
  float wet1 = wet * (width / 2.0f + 0.5f);
  float wet2 = wet * ((1.0f - width) / 2.0f);
  float dry = (1.0f - level) * 1.0f;
  float gain = 0.015f;
  rb_comb combL[RB_NCOMBS], combR[RB_NCOMBS];
  rb_allpass apL[RB_NAPS], apR[RB_NAPS];
  for (int i = 0; i < RB_NCOMBS; i++) {
    rb_comb_setup(&combL[i], (int)(rb_combtuning[i] * srf), feedback, damp);
    rb_comb_setup(&combR[i], (int)((rb_combtuning[i] + 23) * srf), feedback,
                  damp);
  }
  for (int i = 0; i < RB_NAPS; i++) {
    rb_ap_setup(&apL[i], (int)(rb_aptuning[i] * srf));
    rb_ap_setup(&apR[i], (int)((rb_aptuning[i] + 23) * srf));
  }
  struct timespec t0, t1;
  clock_gettime(CLOCK_MONOTONIC, &t0);
  for (int rep = 0; rep < reps; rep++) {
    const float *idata = in;
    float *odata = out;
    for (int k = 0; k < n_samples; k++) {
      float out_l1 = 0.0f, out_r1 = 0.0f;
      float in2l = *idata++;
      float in2r = *idata++;
      float in1l = (in2l + RB_DC_OFFSET) * gain;
      float in1r = (in2r + RB_DC_OFFSET) * gain;
      for (int i = 0; i < RB_NCOMBS; i++) {
        /* freeverb_comb_process, gstfreeverb.c:277-287 */
        rb_comb *c = &combL[i];
        float tmp = c->buffer[c->bufidx];
        c->filterstore = (tmp * c->damp2) + (c->filterstore * c->damp1);
        c->buffer[c->bufidx] = in1l + (c->filterstore * c->feedback);
        if (++c->bufidx >= c->bufsize) c->bufidx = 0;
        out_l1 += tmp;
        c = &combR[i];
        tmp = c->buffer[c->bufidx];
        c->filterstore = (tmp * c->damp2) + (c->filterstore * c->damp1);
        c->buffer[c->bufidx] = in1r + (c->filterstore * c->feedback);
        if (++c->bufidx >= c->bufsize) c->bufidx = 0;
        out_r1 += tmp;
      }
      for (int i = 0; i < RB_NAPS; i++) {
        /* freeverb_allpass_process, gstfreeverb.c:197-208 */
        rb_allpass *a = &apL[i];
        float bufout = a->buffer[a->bufidx];
        float o = bufout - out_l1;
        a->buffer[a->bufidx] = out_l1 + bufout * a->feedback;
        if (++a->bufidx >= a->bufsize) a->bufidx = 0;
        out_l1 = o;
        a = &apR[i];
        bufout = a->buffer[a->bufidx];
        o = bufout - out_r1;
        a->buffer[a->bufidx] = out_r1 + bufout * a->feedback;
        if (++a->bufidx >= a->bufsize) a->bufidx = 0;
        out_r1 = o;
      }
      out_l1 -= RB_DC_OFFSET;
      out_r1 -= RB_DC_OFFSET;
      *odata++ = out_l1 * wet1 + out_r1 * wet2 + in2l * dry;
      *odata++ = out_r1 * wet1 + out_l1 * wet2 + in2r * dry;
    }
  }
  clock_gettime(CLOCK_MONOTONIC, &t1);
  for (int i = 0; i < RB_NCOMBS; i++) {
    free(combL[i].buffer);
    free(combR[i].buffer);
  }
  for (int i = 0; i < RB_NAPS; i++) {
    free(apL[i].buffer);
    free(apR[i].buffer);
  }
  return (t1.tv_sec - t0.tv_sec) + (t1.tv_nsec - t0.tv_nsec) * 1e-9;
}

/* ======================================================================
 * Config 4: bayer2rgb + geometric warps
 * ====================================================================== */

/* per-frame remap (gstgeometrictransform.c:228-288 transform +
 * :168-207 do_map): the precalc map holds (in_x, in_y) doubles per output
 * pixel; per frame each is clamped, truncated and a 4-byte pixel copied. */
void rb_remap_clamp(uint8_t *dst, const uint8_t *src, const double *map,
                    int h, int w) {
  for (int y = 0; y < h; y++) {
    for (int x = 0; x < w; x++) {
      double in_x = map[2 * (y * w + x) + 0];
      double in_y = map[2 * (y * w + x) + 1];
      if (in_x < 0) in_x = 0;
      if (in_x > w - 1) in_x = w - 1;
      if (in_y < 0) in_y = 0;
      if (in_y > h - 1) in_y = h - 1;
      int tx = (int)in_x, ty = (int)in_y;
      if (tx >= 0 && tx < w && ty >= 0 && ty < h)
        memcpy(dst + 4 * (y * w + x), src + 4 * (ty * w + tx), 4);
    }
  }
}

/* bayer2rgb driver (gstbayer2rgb.c:354-447) over the REAL reference ORC
 * backup kernels (gstbayerorc-dist.c, -DDISABLE_ORC).  BGGR -> BGRA. */
extern void bayer_orc_horiz_upsample_unaligned(uint8_t *d0, uint8_t *d1,
                                               const uint8_t *s, int n);
extern void bayer_orc_merge_bg_bgra(uint8_t *d, const uint8_t *s0,
                                    const uint8_t *s1, const uint8_t *s2,
                                    const uint8_t *s3, const uint8_t *s4,
                                    const uint8_t *s5, int n);
extern void bayer_orc_merge_gr_bgra(uint8_t *d, const uint8_t *s0,
                                    const uint8_t *s1, const uint8_t *s2,
                                    const uint8_t *s3, const uint8_t *s4,
                                    const uint8_t *s5, int n);

static void rb_bayer_split(uint8_t *d0, uint8_t *d1, const uint8_t *src,
                           int n) {
  /* gst_bayer2rgb_split_and_upsample_horiz, gstbayer2rgb.c:354-380 */
  d0[0] = src[0];
  d1[0] = src[1];
  d0[1] = (uint8_t)((src[0] + src[2] + 1) >> 1);
  d1[1] = src[1];
  bayer_orc_horiz_upsample_unaligned(d0 + 2, d1 + 2, src + 1, (n - 4) >> 1);
  for (int i = n - 2; i < n; i++) {
    if ((i & 1) == 0) {
      d0[i] = src[i];
      d1[i] = src[i - 1];
    } else {
      d0[i] = src[i - 1];
      d1[i] = src[i];
    }
  }
}

#define RB_BLINE(x) (tmp + (((x) & 7)) * w)
void rb_bayer2rgb_bgra(uint8_t *dst, const uint8_t *src, uint8_t *tmp,
                       int h, int w) {
  /* gst_bayer2rgb_process line ring, gstbayer2rgb.c:387-447 (BGGR) */
  rb_bayer_split(RB_BLINE(3 * 2 + 0), RB_BLINE(3 * 2 + 1), src + 1 * w, w);
  rb_bayer_split(RB_BLINE(0), RB_BLINE(1), src + 0 * w, w);
  for (int j = 0; j < h; j++) {
    if (j < h - 1)
      rb_bayer_split(RB_BLINE((j + 1) * 2 + 0), RB_BLINE((j + 1) * 2 + 1),
                     src + (j + 1) * w, w);
    if ((j & 1) == 0)
      bayer_orc_merge_bg_bgra(dst + j * w * 4, RB_BLINE(j * 2 - 2),
                              RB_BLINE(j * 2 - 1), RB_BLINE(j * 2 + 0),
                              RB_BLINE(j * 2 + 1), RB_BLINE(j * 2 + 2),
                              RB_BLINE(j * 2 + 3), w >> 1);
    else
      bayer_orc_merge_gr_bgra(dst + j * w * 4, RB_BLINE(j * 2 - 2),
                              RB_BLINE(j * 2 - 1), RB_BLINE(j * 2 + 0),
                              RB_BLINE(j * 2 + 1), RB_BLINE(j * 2 + 2),
                              RB_BLINE(j * 2 + 3), w >> 1);
  }
}

/* ======================================================================
 * Config 5: the ivtc comb metric
 * ====================================================================== */

/* get_comb_score (gstivtc.c:687-731): 3-tap outlier + run-length chain
 * over interleaved fields; GET_LINE_IL picks odd lines from `bottom`. */
int rb_ivtc_comb_score(const uint8_t *top, const uint8_t *bottom, int h,
                       int w) {
  int score = 0;
  int *thisline = (int *)calloc(w, sizeof(int));
  for (int j = 2; j < h - 2; j++) {
    const uint8_t *src1 =
        ((((j - 1) & 1) ? bottom : top)) + (j - 1) * w;
    const uint8_t *src2 = (((j & 1) ? bottom : top)) + j * w;
    const uint8_t *src3 =
        ((((j + 1) & 1) ? bottom : top)) + (j + 1) * w;
    for (int i = 0; i < w; i++) {
      int lo = src1[i] < src3[i] ? src1[i] : src3[i];
      int hi = src1[i] > src3[i] ? src1[i] : src3[i];
      if (src2[i] < lo - 5 || src2[i] > hi + 5) {
        if (i > 0) thisline[i] += thisline[i - 1];
        thisline[i]++;
        if (thisline[i] > 1000) thisline[i] = 1000;
      } else {
        thisline[i] = 0;
      }
      if (thisline[i] > 100) score++;
    }
  }
  free(thisline);
  return score;
}

/* ---- the 10-element headline graph, timed in-process ----
 * Mirrors gstbad/models/benchmarks.py ten_element_graph:
 * sepia -> solarize -> chromium -> dodge -> burn -> exclusion -> dilate
 * -> chromahold -> convert-to-Y -> zebrastripe, element defaults.  burn is
 * the REAL reference ORC backup kernel. */
double rb_graph10_seconds(const uint8_t *frame, uint8_t *buf_a, uint8_t *buf_b,
                          uint8_t *ybuf, int h, int w,
                          const uint8_t *sepia_table, int reps) {
  int n = h * w;
  struct timespec t0, t1;
  clock_gettime(CLOCK_MONOTONIC, &t0);
  for (int rep = 0; rep < reps; rep++) {
    rb_coloreffects_luma(buf_a, frame, n, sepia_table);
    rb_solarize(buf_b, buf_a, n, 127, 50, 185);
    rb_chromium(buf_a, buf_b, n, 200, 1);
    rb_dodge(buf_b, buf_a, n);
    gaudi_orc_burn((uint32_t *)buf_a, (const uint32_t *)buf_b, 175, n);
    rb_exclusion(buf_b, buf_a, n, 175);
    rb_dilate(buf_a, buf_b, h, w, 0);
    rb_chromahold(buf_b, buf_a, n, 255, 0, 0, 30);
    rb_rgb_to_y(ybuf, buf_b, n);
    rb_zebrastripe(ybuf, h, w, 90, rep);
  }
  clock_gettime(CLOCK_MONOTONIC, &t1);
  return (t1.tv_sec - t0.tv_sec) + (t1.tv_nsec - t0.tv_nsec) * 1e-9;
}
