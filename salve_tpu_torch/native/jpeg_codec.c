/* A JPEG codec written by hand, for native/jpeg.py. It links no library.

   The decoder returns what `imageio.v2.imread` returns (Pillow's
   libjpeg-turbo at its defaults), byte for byte:
     * SOF0, SOF1 and SOF2 (progressive) at 8-bit precision, 1 or 3
       components at any sampling factors libjpeg accepts, 8- and 16-bit
       DQT tables, DRI and RSTn, 0xFF00 stuffing; APPn and COM are skipped;
     * the colour space of a 3-component file by libjpeg's rule
       (jdapimin.c, default_decompress_parms): a JFIF APP0 means YCbCr, an
       Adobe APP14 with transform 0 means RGB, component IDs 'R','G','B'
       mean RGB, anything else YCbCr;
     * the accurate integer IDCT (jidctint.c, ISLOW) and its range-limit
       table (jdmaster.c), indexed with & RANGE_MASK;
     * libjpeg-turbo's fancy upsampling (jdsample.c): h2v1 and h2v2 triangle
       filters with alternating biases, h1v2's own routine, pixel
       replication at other ratios; context rows clamp to the component's
       last real sample row, and the last real column repeats;
     * jdcolor.c's fixed-point YCbCr -> RGB tables.
   It refuses, naming it: arithmetic coding, lossless and hierarchical
   files, other precisions than 8 bits, 2 or 4 components (CMYK, YCCK), and
   a progressive file whose scans leave a coefficient's bits unsent (there
   libjpeg's block smoothing would change the pixels).

   The encoder returns the bytes of cv2.imencode(".jpg", bgr,
   [IMWRITE_JPEG_QUALITY, q]) (libjpeg-turbo at jpeg_set_defaults plus
   jpeg_set_quality(q, TRUE)): baseline, YCbCr 4:2:0, the standard Huffman
   tables, no restart markers; jccolor.c's RGB -> YCbCr, jcsample.c's h2v2
   downsample, jcprepct.c's bottom expansion, jfdctint.c's forward DCT,
   jccoefct.c's dummy blocks, and the markers in libjpeg's order.

   Build (done at first use by native/jpeg.py, into the git-ignored build/):
       cc -O2 -shared -fPIC jpeg_codec.c -o libjpeg_codec.so

   Entry points return 0, or -1 with a message in `msg` (MSG_BYTES bytes):
     salve_jpeg_info(data, size, &h, &w, &channels, msg)
     salve_jpeg_decode(data, size, out, out_size, msg)   h * w * channels bytes
     salve_jpeg_encode(rgb, h, w, quality, &out, &out_size, msg)
     salve_jpeg_free(out)                                frees the encoder's bytes */

#include <setjmp.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define MSG_BYTES 200

/* Zigzag position -> natural position, with libjpeg's 16 extra entries so
   that a corrupt run past 63 stays inside the block. */
static const int NATURAL[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

/* jidctint.c / jfdctint.c constants: FIX(x) at CONST_BITS 13. */
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
#define RANGE_MASK 1023 /* MAXJSAMPLE * 4 + 3 */
/* jdcolor.c / jccolor.c: FIX(x) at SCALEBITS 16. */
#define FIX16(x) ((int64_t)((x) * (1L << 16) + 0.5))

/* ---------------------------------------------------------------- errors */

typedef struct {
  jmp_buf jump;
  char *msg;
} err_t;

static void fail(err_t *e, const char *fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(e->msg, MSG_BYTES, fmt, ap);
  va_end(ap);
  longjmp(e->jump, 1);
}

/* ================================================================ decoder */

typedef struct {
  int present;
  uint8_t bits[17];
  uint8_t vals[256];
  int32_t maxcode[18];  /* largest code of each length, -1 if none */
  int32_t valoffset[18];
  uint16_t look[512];   /* 9-bit lookahead: (length << 8) | value, 0 = longer */
} dhuff_t;

typedef struct {
  int id, h, v, tq;
  int wib, hib;   /* width and height in blocks (libjpeg's width_in_blocks) */
  int bw, bh;     /* blocks held: whole MCUs */
  int dsw, dsh;   /* downsampled_width and downsampled_height */
  int16_t *coef;  /* bw * bh blocks of 64, natural order */
  uint8_t *plane; /* bw * 8 by bh * 8 samples after the IDCT */
  int coef_bits[64];
} dcomp_t;

typedef struct {
  const uint8_t *d;
  size_t n, pos;
  uint64_t acc; /* MSB-aligned bit buffer */
  int cnt;
  int marker;   /* hit a marker: pos is at its 0xFF, zeros are fed */
} bits_t;

typedef struct {
  err_t err;
  const uint8_t *d;
  size_t n, pos;
  int height, width, ncomp, progressive, max_h, max_v, mcux, mcuy;
  int jfif, adobe, adobe_transform, restart_interval, have_frame, eobrun;
  uint16_t q[4][64]; /* natural order */
  int q_present[4];
  dhuff_t dc[4], ac[4];
  dcomp_t comp[3];
} dec_t;

static void free_dec(dec_t *D) {
  for (int c = 0; c < 3; ++c) {
    free(D->comp[c].coef);
    free(D->comp[c].plane);
    D->comp[c].coef = NULL;
    D->comp[c].plane = NULL;
  }
}

static int u8(dec_t *D) {
  if (D->pos >= D->n) fail(&D->err, "JPEG stream ends early (byte %zu)", D->pos);
  return D->d[D->pos++];
}

static int u16(dec_t *D) {
  int a = u8(D);
  return (a << 8) | u8(D);
}

/* Next marker code at or after pos; skips fill bytes (and, as libjpeg does
   with a warning, any garbage before the 0xFF). */
static int next_marker(dec_t *D) {
  for (;;) {
    int c = u8(D);
    if (c != 0xFF) continue;
    do c = u8(D); while (c == 0xFF);
    if (c != 0) return c;
  }
}

/* jdhuff.c jpeg_make_d_derived_tbl. */
static void build_dhuff(dec_t *D, dhuff_t *t) {
  int huffsize[257], huffcode[257], p = 0, code = 0, si;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < t->bits[l]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  p = 0;
  si = huffsize[0];
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if ((int64_t)code >= ((int64_t)1 << si)) fail(&D->err, "bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t->bits[l]) {
      t->valoffset[l] = p - huffcode[p];
      p += t->bits[l];
      t->maxcode[l] = huffcode[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->maxcode[17] = 0x7FFFFFFF;
  memset(t->look, 0, sizeof t->look);
  p = 0;
  for (int l = 1; l <= 9; ++l)
    for (int i = 1; i <= t->bits[l]; ++i, ++p) {
      int lookbits = huffcode[p] << (9 - l);
      for (int ctr = 1 << (9 - l); ctr > 0; --ctr) t->look[lookbits++] = (uint16_t)((l << 8) | t->vals[p]);
    }
  t->present = 1;
}

static void read_dht(dec_t *D) {
  int len = u16(D) - 2;
  while (len > 16) {
    int index = u8(D), count = 0;
    if ((index & 0x0F) > 3 || (index >> 4) > 1) fail(&D->err, "bad DHT index %d", index);
    dhuff_t *t = (index & 0x10) ? &D->ac[index & 0x0F] : &D->dc[index & 0x0F];
    t->bits[0] = 0;
    for (int l = 1; l <= 16; ++l) count += (t->bits[l] = (uint8_t)u8(D));
    if (count > 256 || 17 + count > len) fail(&D->err, "bad Huffman table");
    for (int i = 0; i < count; ++i) t->vals[i] = (uint8_t)u8(D);
    len -= 17 + count;
    build_dhuff(D, t);
  }
  if (len != 0) fail(&D->err, "bad DHT length");
}

static void read_dqt(dec_t *D) {
  int len = u16(D) - 2;
  while (len > 0) {
    int pq = u8(D), tq = pq & 0x0F;
    pq >>= 4;
    if (tq > 3 || pq > 1) fail(&D->err, "bad DQT table %d precision %d", tq, pq);
    for (int k = 0; k < 64; ++k) D->q[tq][NATURAL[k]] = (uint16_t)(pq ? u16(D) : u8(D));
    D->q_present[tq] = 1;
    len -= 1 + 64 * (pq + 1);
  }
  if (len != 0) fail(&D->err, "bad DQT length");
}

static int jdiv_round_up(int64_t a, int64_t b) { return (int)((a + b - 1) / b); }

static void read_sof(dec_t *D, int marker) {
  int len = u16(D);
  int precision = u8(D);
  D->height = u16(D);
  D->width = u16(D);
  D->ncomp = u8(D);
  if (D->have_frame) fail(&D->err, "a second frame header");
  if (precision != 8) fail(&D->err, "%d-bit precision is not read (only 8-bit)", precision);
  if (D->ncomp == 4) fail(&D->err, "4 components (CMYK or YCCK) are not read");
  if (D->ncomp != 1 && D->ncomp != 3) fail(&D->err, "%d components are not read", D->ncomp);
  if (D->height <= 0 || D->width <= 0) fail(&D->err, "empty image (%d x %d; DNL is not read)", D->height, D->width);
  if (len != 8 + 3 * D->ncomp) fail(&D->err, "bad SOF length");
  D->progressive = marker == 0xC2;
  D->max_h = D->max_v = 1;
  for (int c = 0; c < D->ncomp; ++c) {
    dcomp_t *k = &D->comp[c];
    k->id = u8(D);
    int hv = u8(D);
    k->h = hv >> 4;
    k->v = hv & 15;
    k->tq = u8(D);
    if (k->h < 1 || k->h > 4 || k->v < 1 || k->v > 4 || k->tq > 3) fail(&D->err, "bad sampling factors or table");
    if (k->h > D->max_h) D->max_h = k->h;
    if (k->v > D->max_v) D->max_v = k->v;
  }
  for (int c = 0; c < D->ncomp; ++c)
    if (D->max_h % D->comp[c].h || D->max_v % D->comp[c].v)
      fail(&D->err, "fractional sampling factors are not read (libjpeg refuses them too)");
  D->mcux = jdiv_round_up(D->width, 8 * D->max_h);
  D->mcuy = jdiv_round_up(D->height, 8 * D->max_v);
  for (int c = 0; c < D->ncomp; ++c) {
    dcomp_t *k = &D->comp[c];
    k->wib = jdiv_round_up((int64_t)D->width * k->h, 8 * D->max_h);
    k->hib = jdiv_round_up((int64_t)D->height * k->v, 8 * D->max_v);
    k->dsw = jdiv_round_up((int64_t)D->width * k->h, D->max_h);
    k->dsh = jdiv_round_up((int64_t)D->height * k->v, D->max_v);
    k->bw = D->mcux * k->h;
    k->bh = D->mcuy * k->v;
    for (int i = 0; i < 64; ++i) k->coef_bits[i] = -1;
  }
  D->have_frame = 1;
}

/* APPn and COM: note JFIF and Adobe (libjpeg's examine_app0/app14), skip
   the rest. */
static void read_app(dec_t *D, int marker) {
  int len = u16(D) - 2;
  if (len < 0 || D->pos + (size_t)len > D->n) fail(&D->err, "marker 0x%02X runs past the stream", marker);
  const uint8_t *p = D->d + D->pos;
  if (marker == 0xE0 && len >= 14 && !memcmp(p, "JFIF\0", 5)) D->jfif = 1;
  if (marker == 0xEE && len >= 12 && !memcmp(p, "Adobe", 5)) {
    D->adobe = 1;
    D->adobe_transform = p[11];
  }
  D->pos += (size_t)len;
}

/* ------------------------------------------------------------ bit reader */

static void fill_bits(bits_t *b) {
  while (b->cnt <= 56) {
    unsigned c = 0;
    if (!b->marker && b->pos < b->n) {
      size_t at = b->pos;
      c = b->d[b->pos++];
      if (c == 0xFF) {
        do c = b->pos < b->n ? b->d[b->pos++] : 0xD9;
        while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          b->marker = 1;
          b->pos = at;
          c = 0;
        }
      }
    }
    b->acc |= (uint64_t)c << (56 - b->cnt);
    b->cnt += 8;
  }
}

static inline unsigned peek_bits(bits_t *b, int n) {
  if (b->cnt < n) fill_bits(b);
  return (unsigned)(b->acc >> (64 - n));
}

static inline void skip_bits(bits_t *b, int n) {
  b->acc <<= n;
  b->cnt -= n;
}

static inline int get_bits(bits_t *b, int n) {
  if (n == 0) return 0;
  unsigned v = peek_bits(b, n);
  skip_bits(b, n);
  return (int)v;
}

static inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (int)((unsigned)-1 << s) + 1 : v; }

static int huff_decode(dec_t *D, bits_t *b, const dhuff_t *t) {
  unsigned e = t->look[peek_bits(b, 9)];
  if (e) {
    skip_bits(b, (int)(e >> 8));
    return (int)(e & 0xFF);
  }
  for (int l = 10; l <= 16; ++l) {
    int32_t code = (int32_t)peek_bits(b, l);
    if (code <= t->maxcode[l]) {
      skip_bits(b, l);
      return t->vals[t->valoffset[l] + code];
    }
  }
  fail(&D->err, "corrupt JPEG data: bad Huffman code");
  return 0;
}

/* ----------------------------------------------------------------- scans */

typedef struct {
  int n, ci[4], td[4], ta[4];
  int ss, se, ah, al;
} scan_t;

static void decode_block_baseline(dec_t *D, bits_t *b, const scan_t *s, int i, int *pred, int16_t *blk) {
  int t = huff_decode(D, b, &D->dc[s->td[i]]);
  int diff = t ? extend(get_bits(b, t), t) : 0;
  *pred += diff;
  blk[0] = (int16_t)*pred;
  const dhuff_t *ac = &D->ac[s->ta[i]];
  for (int k = 1; k < 64; ++k) {
    int rs = huff_decode(D, b, ac), r = rs >> 4, sz = rs & 15;
    if (sz) {
      k += r;
      blk[NATURAL[k]] = (int16_t)extend(get_bits(b, sz), sz);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

/* jdphuff.c decode_mcu_DC_first / _DC_refine, one block. */
static void decode_block_dc(dec_t *D, bits_t *b, const scan_t *s, int i, int *pred, int16_t *blk) {
  if (s->ah == 0) {
    int t = huff_decode(D, b, &D->dc[s->td[i]]);
    int diff = t ? extend(get_bits(b, t), t) : 0;
    *pred += diff;
    blk[0] = (int16_t)(int)((unsigned)*pred << s->al);
  } else if (get_bits(b, 1)) {
    blk[0] = (int16_t)(blk[0] | (1 << s->al));
  }
}

/* jdphuff.c decode_mcu_AC_first. */
static void decode_block_ac_first(dec_t *D, bits_t *b, const scan_t *s, int16_t *blk) {
  if (D->eobrun > 0) {
    D->eobrun--;
    return;
  }
  const dhuff_t *ac = &D->ac[s->ta[0]];
  for (int k = s->ss; k <= s->se; ++k) {
    int rs = huff_decode(D, b, ac), r = rs >> 4, sz = rs & 15;
    if (sz) {
      k += r;
      int v = extend(get_bits(b, sz), sz);
      blk[NATURAL[k]] = (int16_t)(int)((unsigned)v << s->al);
    } else if (r == 15) {
      k += 15;
    } else {
      D->eobrun = 1 << r;
      if (r) D->eobrun += get_bits(b, r);
      D->eobrun--;
      break;
    }
  }
}

/* jdphuff.c decode_mcu_AC_refine. */
static void decode_block_ac_refine(dec_t *D, bits_t *b, const scan_t *s, int16_t *blk) {
  int p1 = 1 << s->al, m1 = (int)((unsigned)-1 << s->al);
  int k = s->ss;
  const dhuff_t *ac = &D->ac[s->ta[0]];
  if (D->eobrun == 0) {
    for (; k <= s->se; ++k) {
      int rs = huff_decode(D, b, ac), r = rs >> 4, sz = rs & 15;
      if (sz) {
        sz = get_bits(b, 1) ? p1 : m1;
      } else if (r != 15) {
        D->eobrun = 1 << r;
        if (r) D->eobrun += get_bits(b, r);
        break;
      }
      do {
        int16_t *c = blk + NATURAL[k];
        if (*c != 0) {
          if (get_bits(b, 1) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
        } else if (--r < 0) {
          break;
        }
        k++;
      } while (k <= s->se);
      if (sz) blk[NATURAL[k]] = (int16_t)sz;
    }
  }
  if (D->eobrun > 0) {
    for (; k <= s->se; ++k) {
      int16_t *c = blk + NATURAL[k];
      if (*c != 0 && get_bits(b, 1) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
    }
    D->eobrun--;
  }
}

static void decode_block(dec_t *D, bits_t *b, const scan_t *s, int i, int *pred, int16_t *blk) {
  if (!D->progressive)
    decode_block_baseline(D, b, s, i, pred, blk);
  else if (s->ss == 0)
    decode_block_dc(D, b, s, i, pred, blk);
  else if (s->ah == 0)
    decode_block_ac_first(D, b, s, blk);
  else
    decode_block_ac_refine(D, b, s, blk);
}

/* libjpeg's read_restart_marker: drop the bits left and take the RSTn; at
   another marker, resynchronize on it as libjpeg does for a missing RSTn. */
static void restart(dec_t *D, bits_t *b, int *preds) {
  size_t p = b->pos;
  while (p + 1 < b->n && !(b->d[p] == 0xFF && b->d[p + 1] != 0 && b->d[p + 1] != 0xFF)) ++p;
  if (p + 1 >= b->n) fail(&D->err, "JPEG stream ends before a restart marker");
  if (b->d[p + 1] >= 0xD0 && b->d[p + 1] <= 0xD7) p += 2;
  b->pos = p;
  b->acc = 0;
  b->cnt = 0;
  b->marker = 0;
  for (int i = 0; i < 4; ++i) preds[i] = 0;
  D->eobrun = 0;
}

static void read_scan(dec_t *D) {
  scan_t s;
  if (!D->have_frame) fail(&D->err, "SOS before a frame header");
  int len = u16(D);
  s.n = u8(D);
  if (s.n < 1 || s.n > 4 || len != 6 + 2 * s.n) fail(&D->err, "bad SOS");
  for (int i = 0; i < s.n; ++i) {
    int id = u8(D), t = u8(D), c;
    for (c = 0; c < D->ncomp && D->comp[c].id != id; ++c) {}
    if (c == D->ncomp) fail(&D->err, "SOS names component %d, which the frame lacks", id);
    s.ci[i] = c;
    s.td[i] = t >> 4;
    s.ta[i] = t & 15;
    if (s.td[i] > 3 || s.ta[i] > 3) fail(&D->err, "bad SOS table");
  }
  s.ss = u8(D);
  s.se = u8(D);
  int a = u8(D);
  s.ah = a >> 4;
  s.al = a & 15;
  if (!D->progressive) {
    s.ss = 0;
    s.se = 63;
    s.ah = s.al = 0;
  } else {
    if (s.ss > s.se || s.se > 63 || s.al > 13 || (s.ss == 0 && s.se != 0) || (s.ss > 0 && s.n != 1))
      fail(&D->err, "bad progressive scan parameters");
  }
  int blocks_in_mcu = 0;
  for (int i = 0; i < s.n; ++i) {
    dcomp_t *k = &D->comp[s.ci[i]];
    blocks_in_mcu += s.n > 1 ? k->h * k->v : 1;
    int need_dc = !D->progressive || (s.ss == 0 && s.ah == 0);
    int need_ac = !D->progressive ? 1 : s.ss > 0;
    if (need_dc && !D->dc[s.td[i]].present) fail(&D->err, "a scan uses an undefined DC Huffman table");
    if (need_ac && !D->ac[s.ta[i]].present) fail(&D->err, "a scan uses an undefined AC Huffman table");
    if (!k->coef) {
      k->coef = calloc((size_t)k->bw * k->bh * 64, sizeof(int16_t));
      if (!k->coef) fail(&D->err, "out of memory");
    }
    for (int j = s.ss; j <= s.se; ++j) k->coef_bits[j] = s.al;
  }
  if (blocks_in_mcu > 10) fail(&D->err, "more than 10 blocks in an MCU");

  bits_t b = {D->d, D->n, D->pos, 0, 0, 0};
  int preds[4] = {0, 0, 0, 0};
  int to_go = D->restart_interval;
  D->eobrun = 0;
  if (s.n == 1) {
    dcomp_t *k = &D->comp[s.ci[0]];
    for (int by = 0; by < k->hib; ++by)
      for (int bx = 0; bx < k->wib; ++bx) {
        if (D->restart_interval) {
          if (to_go == 0) {
            restart(D, &b, preds);
            to_go = D->restart_interval;
          }
          to_go--;
        }
        decode_block(D, &b, &s, 0, &preds[0], k->coef + ((size_t)by * k->bw + bx) * 64);
      }
  } else {
    for (int my = 0; my < D->mcuy; ++my)
      for (int mx = 0; mx < D->mcux; ++mx) {
        if (D->restart_interval) {
          if (to_go == 0) {
            restart(D, &b, preds);
            to_go = D->restart_interval;
          }
          to_go--;
        }
        for (int i = 0; i < s.n; ++i) {
          dcomp_t *k = &D->comp[s.ci[i]];
          for (int y = 0; y < k->v; ++y)
            for (int x = 0; x < k->h; ++x) {
              size_t blk = (size_t)(my * k->v + y) * k->bw + (size_t)(mx * k->h + x);
              decode_block(D, &b, &s, i, &preds[i], k->coef + blk * 64);
            }
        }
      }
  }
  /* Resume the marker parse where the entropy data ends. */
  D->pos = b.marker ? b.pos : (b.pos > D->pos ? b.pos : D->pos);
}

/* ---------------------------------------------------------------- output */

/* jdmaster.c prepare_range_limit_table, the IDCT's half: post[x & 1023]
   for x the descaled output minus CENTERJSAMPLE. */
static uint8_t IDCT_LIMIT[1024];

static void init_idct_limit(void) {
  for (int x = 0; x < 1024; ++x) {
    int v;
    if (x < 128) v = x + 128;
    else if (x < 512) v = 255;
    else if (x < 896) v = 0;
    else v = x - 896;
    IDCT_LIMIT[x] = (uint8_t)v;
  }
}

/* jidctint.c jpeg_idct_islow: dequantize, 8x8 inverse DCT, range limit. */
static void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t *ip = in + c;
    const uint16_t *qp = q + c;
    int *wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = (int)((unsigned)(ip[0] * qp[0]) << PASS1_BITS);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = (int64_t)ip[16] * qp[16];
    z3 = (int64_t)ip[48] * qp[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    t2 = z1 + z3 * -FIX_1_847759065;
    t3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    t0 = (z2 + z3) * ((int64_t)1 << CONST_BITS);
    t1 = (z2 - z3) * ((int64_t)1 << CONST_BITS);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = (int64_t)ip[56] * qp[56];
    t1 = (int64_t)ip[40] * qp[40];
    t2 = (int64_t)ip[24] * qp[24];
    t3 = (int64_t)ip[8] * qp[8];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * FIX_1_175875602;
    t0 *= FIX_0_298631336;
    t1 *= FIX_2_053119869;
    t2 *= FIX_3_072711026;
    t3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    wp[0] = (int)DESCALE(t10 + t3, CONST_BITS - PASS1_BITS);
    wp[56] = (int)DESCALE(t10 - t3, CONST_BITS - PASS1_BITS);
    wp[8] = (int)DESCALE(t11 + t2, CONST_BITS - PASS1_BITS);
    wp[48] = (int)DESCALE(t11 - t2, CONST_BITS - PASS1_BITS);
    wp[16] = (int)DESCALE(t12 + t1, CONST_BITS - PASS1_BITS);
    wp[40] = (int)DESCALE(t12 - t1, CONST_BITS - PASS1_BITS);
    wp[24] = (int)DESCALE(t13 + t0, CONST_BITS - PASS1_BITS);
    wp[32] = (int)DESCALE(t13 - t0, CONST_BITS - PASS1_BITS);
  }
  for (int r = 0; r < 8; ++r) {
    const int *wp = ws + 8 * r;
    uint8_t *op = out + (size_t)r * stride;
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    z2 = wp[2];
    z3 = wp[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    t2 = z1 + z3 * -FIX_1_847759065;
    t3 = z1 + z2 * FIX_0_765366865;
    t0 = ((int64_t)wp[0] + wp[4]) * ((int64_t)1 << CONST_BITS);
    t1 = ((int64_t)wp[0] - wp[4]) * ((int64_t)1 << CONST_BITS);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = wp[7];
    t1 = wp[5];
    t2 = wp[3];
    t3 = wp[1];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * FIX_1_175875602;
    t0 *= FIX_0_298631336;
    t1 *= FIX_2_053119869;
    t2 *= FIX_3_072711026;
    t3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    op[0] = IDCT_LIMIT[(int)DESCALE(t10 + t3, sh) & RANGE_MASK];
    op[7] = IDCT_LIMIT[(int)DESCALE(t10 - t3, sh) & RANGE_MASK];
    op[1] = IDCT_LIMIT[(int)DESCALE(t11 + t2, sh) & RANGE_MASK];
    op[6] = IDCT_LIMIT[(int)DESCALE(t11 - t2, sh) & RANGE_MASK];
    op[2] = IDCT_LIMIT[(int)DESCALE(t12 + t1, sh) & RANGE_MASK];
    op[5] = IDCT_LIMIT[(int)DESCALE(t12 - t1, sh) & RANGE_MASK];
    op[3] = IDCT_LIMIT[(int)DESCALE(t13 + t0, sh) & RANGE_MASK];
    op[4] = IDCT_LIMIT[(int)DESCALE(t13 - t0, sh) & RANGE_MASK];
  }
}

static inline int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

/* Upsample component `k` to full size, row `y` of the output image, into
   `out` (width samples): jdsample.c, libjpeg-turbo's variant of each ratio. */
static void upsample_row(const dec_t *D, const dcomp_t *k, int y, uint8_t *out) {
  const int stride = k->bw * 8, W = D->width;
  const int hr = D->max_h / k->h, vr = D->max_v / k->v;
  const int fancy_h2 = k->dsw > 2; /* h2v1 and h2v2 fancy need 3 columns */
  if (hr == 1 && vr == 1) {
    memcpy(out, k->plane + (size_t)y * stride, (size_t)W);
  } else if (hr == 2 && vr == 1 && fancy_h2) {
    const uint8_t *in = k->plane + (size_t)y * stride;
    int n = k->dsw, o = 0;
    uint8_t tmp[2];
    for (int i = 0; i < n && o < W; ++i) {
      if (i == 0) {
        tmp[0] = in[0];
        tmp[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
      } else if (i == n - 1) {
        tmp[0] = (uint8_t)((in[i] * 3 + in[i - 1] + 1) >> 2);
        tmp[1] = in[i];
      } else {
        int v = in[i] * 3;
        tmp[0] = (uint8_t)((v + in[i - 1] + 1) >> 2);
        tmp[1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
      }
      out[o++] = tmp[0];
      if (o < W) out[o++] = tmp[1];
    }
  } else if (hr == 1 && vr == 2) {
    int r = y >> 1, nb = clampi((y & 1) ? r + 1 : r - 1, 0, k->dsh - 1), bias = (y & 1) ? 2 : 1;
    const uint8_t *in0 = k->plane + (size_t)r * stride, *in1 = k->plane + (size_t)nb * stride;
    for (int x = 0; x < W; ++x) out[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
  } else if (hr == 2 && vr == 2 && fancy_h2) {
    int r = y >> 1, nb = clampi((y & 1) ? r + 1 : r - 1, 0, k->dsh - 1);
    const uint8_t *in0 = k->plane + (size_t)r * stride, *in1 = k->plane + (size_t)nb * stride;
    int n = k->dsw, o = 0;
    int last = 0, cur = in0[0] * 3 + in1[0], next;
    for (int i = 0; i < n && o < W; ++i) {
      uint8_t a, b;
      if (i == 0) {
        next = in0[1] * 3 + in1[1];
        a = (uint8_t)((cur * 4 + 8) >> 4);
        b = (uint8_t)((cur * 3 + next + 7) >> 4);
      } else if (i == n - 1) {
        a = (uint8_t)((cur * 3 + last + 8) >> 4);
        b = (uint8_t)((cur * 4 + 7) >> 4);
        next = cur;
      } else {
        next = in0[i + 1] * 3 + in1[i + 1];
        a = (uint8_t)((cur * 3 + last + 8) >> 4);
        b = (uint8_t)((cur * 3 + next + 7) >> 4);
      }
      out[o++] = a;
      if (o < W) out[o++] = b;
      last = cur;
      cur = next;
    }
  } else {
    const uint8_t *in = k->plane + (size_t)(y / vr) * stride;
    for (int x = 0; x < W; ++x) out[x] = in[x / hr];
  }
}

/* jdcolor.c build_ycc_rgb_table: SCALEBITS 16. */
static int CR_R[256], CB_B[256];
static int64_t CR_G[256], CB_G[256];

static void init_ycc_tables(void) {
  const int64_t half = (int64_t)1 << 15;
  for (int i = 0, x = -128; i < 256; ++i, ++x) {
    CR_R[i] = (int)((FIX16(1.40200) * x + half) >> 16);
    CB_B[i] = (int)((FIX16(1.77200) * x + half) >> 16);
    CR_G[i] = (-FIX16(0.71414)) * x;
    CB_G[i] = (-FIX16(0.34414)) * x + half;
  }
}

static inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

/* The constant tables are built once, when the library is loaded, so that
   threads decoding and encoding in parallel only read them. */
static void init_rgb_ycc(void);

__attribute__((constructor)) static void init_tables(void) {
  init_idct_limit();
  init_ycc_tables();
  init_rgb_ycc();
}

/* Parse markers up to the first scan (info) or the end of the image. */
static void parse(dec_t *D, int whole) {
  if (D->n < 2 || D->d[0] != 0xFF || D->d[1] != 0xD8) fail(&D->err, "not a JPEG stream (no SOI marker)");
  D->pos = 2;
  for (;;) {
    int m = next_marker(D);
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      read_sof(D, m);
      if (!whole) return;
    } else if (m == 0xC3) {
      fail(&D->err, "lossless JPEG (SOF3) is not read");
    } else if (m == 0xC9 || m == 0xCA || m == 0xCB || m == 0xCC || m == 0xCD || m == 0xCE || m == 0xCF) {
      fail(&D->err, "arithmetic coding (marker 0x%02X) is not read", m);
    } else if (m == 0xC5 || m == 0xC6 || m == 0xC7) {
      fail(&D->err, "hierarchical JPEG (marker 0x%02X) is not read", m);
    } else if (m == 0xC4) {
      read_dht(D);
    } else if (m == 0xDB) {
      read_dqt(D);
    } else if (m == 0xDD) {
      if (u16(D) != 4) fail(&D->err, "bad DRI length");
      D->restart_interval = u16(D);
    } else if (m == 0xDA) {
      read_scan(D);
    } else if (m == 0xD9) {
      if (!D->have_frame) fail(&D->err, "no frame header before EOI");
      return;
    } else if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      /* stray SOI, RSTn or TEM: no length */
    } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
      read_app(D, m);
    } else {
      int len = u16(D) - 2;
      if (len < 0 || D->pos + (size_t)len > D->n) fail(&D->err, "marker 0x%02X runs past the stream", m);
      D->pos += (size_t)len;
    }
  }
}

/* 3 components: RGB (no conversion) or YCbCr, by libjpeg's rule. */
static int is_rgb(const dec_t *D) {
  if (D->jfif) return 0;
  if (D->adobe) return D->adobe_transform == 0;
  return D->comp[0].id == 'R' && D->comp[1].id == 'G' && D->comp[2].id == 'B';
}

int salve_jpeg_info(const uint8_t *data, unsigned long size, int *height, int *width, int *channels, char *msg) {
  dec_t D;
  memset(&D, 0, sizeof D);
  msg[0] = '\0';
  D.err.msg = msg;
  D.d = data;
  D.n = size;
  if (setjmp(D.err.jump)) return -1;
  parse(&D, 0);
  if (!D.have_frame) fail(&D.err, "no frame header");
  *height = D.height;
  *width = D.width;
  *channels = D.ncomp;
  return 0;
}

int salve_jpeg_decode(const uint8_t *data, unsigned long size, uint8_t *out, unsigned long out_size, char *msg) {
  dec_t D;
  uint8_t *volatile rows = NULL;
  memset(&D, 0, sizeof D);
  msg[0] = '\0';
  D.err.msg = msg;
  D.d = data;
  D.n = size;
  if (setjmp(D.err.jump)) {
    free(rows);
    free_dec(&D);
    return -1;
  }
  parse(&D, 1);
  if ((unsigned long)D.height * D.width * D.ncomp != out_size) fail(&D.err, "output buffer size does not match the image");
  for (int c = 0; c < D.ncomp; ++c) {
    dcomp_t *k = &D.comp[c];
    if (!k->coef) fail(&D.err, "component %d has no scan", k->id);
    if (!D.q_present[k->tq]) fail(&D.err, "component %d uses an undefined quantization table", k->id);
    if (D.progressive)
      for (int i = 0; i < 64; ++i)
        if (k->coef_bits[i] != 0)
          fail(&D.err, "a progressive file whose scans leave coefficient %d of component %d %s is not read "
                       "(libjpeg would smooth its blocks)", i, k->id, k->coef_bits[i] < 0 ? "unsent" : "unrefined");
    int stride = k->bw * 8;
    k->plane = malloc((size_t)stride * k->bh * 8);
    if (!k->plane) fail(&D.err, "out of memory");
    for (int by = 0; by < k->bh; ++by)
      for (int bx = 0; bx < k->bw; ++bx)
        idct_islow(k->coef + ((size_t)by * k->bw + bx) * 64, D.q[k->tq],
                   k->plane + (size_t)by * 8 * stride + (size_t)bx * 8, stride);
  }
  const int W = D.width;
  rows = malloc((size_t)W * 3);
  if (!rows) fail(&D.err, "out of memory");
  const int rgb = D.ncomp == 3 && is_rgb(&D);
  for (int y = 0; y < D.height; ++y) {
    uint8_t *o = out + (size_t)y * W * D.ncomp;
    if (D.ncomp == 1) {
      upsample_row(&D, &D.comp[0], y, o);
      continue;
    }
    for (int c = 0; c < 3; ++c) upsample_row(&D, &D.comp[c], y, rows + (size_t)c * W);
    const uint8_t *Y = rows, *Cb = rows + W, *Cr = rows + 2 * (size_t)W;
    for (int x = 0; x < W; ++x, o += 3) {
      if (rgb) {
        o[0] = Y[x];
        o[1] = Cb[x];
        o[2] = Cr[x];
      } else {
        int yy = Y[x];
        o[0] = clamp255(yy + CR_R[Cr[x]]);
        o[1] = clamp255(yy + (int)((CB_G[Cb[x]] + CR_G[Cr[x]]) >> 16));
        o[2] = clamp255(yy + CB_B[Cb[x]]);
      }
    }
  }
  free(rows);
  free_dec(&D);
  return 0;
}

/* ================================================================ encoder */

/* jcparam.c: the Annex K tables, natural order. */
static const int STD_LUMA_Q[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,  14, 13, 16, 24, 40,  57,
    69, 56, 14, 17, 22,  29,  51,  87,  80, 62, 18, 22, 37,  56,  68,  109, 103, 77, 24, 35, 55, 64,
    81, 104, 113, 92, 49, 64,  78,  87,  103, 121, 120, 101, 72, 92, 95,  98,  112, 100, 103, 99};
static const int STD_CHROMA_Q[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99,
    99, 99, 47, 66, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

/* jstdhuff.c: bits[0..16] and values of the four standard tables. */
static const uint8_t DC_LUMA_BITS[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t DC_CHROMA_BITS[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t DC_VALS[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t AC_LUMA_BITS[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t AC_LUMA_VALS[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
    0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
static const uint8_t AC_CHROMA_BITS[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t AC_CHROMA_VALS[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
    0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
    0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

typedef struct {
  unsigned code[256];
  int size[256];
} ehuff_t;

typedef struct {
  err_t err;
  uint8_t *out;
  size_t len, cap;
  uint64_t acc; /* bits not yet written, right-aligned */
  int nacc;
} enc_t;

static void put_byte(enc_t *E, int b) {
  if (E->len == E->cap) {
    size_t cap = E->cap ? 2 * E->cap : 1 << 16;
    uint8_t *p = realloc(E->out, cap);
    if (!p) fail(&E->err, "out of memory");
    E->out = p;
    E->cap = cap;
  }
  E->out[E->len++] = (uint8_t)b;
}

static void put_u16(enc_t *E, int v) {
  put_byte(E, v >> 8);
  put_byte(E, v & 0xFF);
}

/* Entropy-coded bits, with a 0x00 stuffed after each 0xFF. */
static inline void put_bits(enc_t *E, unsigned code, int size) {
  E->acc = (E->acc << size) | (code & ((1u << size) - 1));
  E->nacc += size;
  while (E->nacc >= 8) {
    int b = (int)((E->acc >> (E->nacc - 8)) & 0xFF);
    put_byte(E, b);
    if (b == 0xFF) put_byte(E, 0);
    E->nacc -= 8;
  }
}

/* jchuff.c jpeg_make_c_derived_tbl. */
static void build_ehuff(const uint8_t *bits, const uint8_t *vals, ehuff_t *t) {
  int p = 0, code = 0;
  memset(t, 0, sizeof *t);
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++p) {
      t->code[vals[p]] = (unsigned)code++;
      t->size[vals[p]] = l;
    }
    code <<= 1;
  }
}

static void put_dht(enc_t *E, int index, const uint8_t *bits, const uint8_t *vals) {
  int count = 0;
  for (int l = 1; l <= 16; ++l) count += bits[l];
  put_byte(E, 0xFF);
  put_byte(E, 0xC4);
  put_u16(E, 2 + 1 + 16 + count);
  put_byte(E, index);
  for (int l = 1; l <= 16; ++l) put_byte(E, bits[l]);
  for (int i = 0; i < count; ++i) put_byte(E, vals[i]);
}

/* jfdctint.c jpeg_fdct_islow, in place on samples minus CENTERJSAMPLE. */
static void fdct_islow(int *data) {
  int *dp = data;
  for (int r = 0; r < 8; ++r, dp += 8) {
    int64_t t0 = dp[0] + dp[7], t7 = dp[0] - dp[7], t1 = dp[1] + dp[6], t6 = dp[1] - dp[6];
    int64_t t2 = dp[2] + dp[5], t5 = dp[2] - dp[5], t3 = dp[3] + dp[4], t4 = dp[3] - dp[4];
    int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    dp[0] = (int)((t10 + t11) * (1 << PASS1_BITS));
    dp[4] = (int)((t10 - t11) * (1 << PASS1_BITS));
    int64_t z1 = (t12 + t13) * FIX_0_541196100;
    dp[2] = (int)DESCALE(z1 + t13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
    dp[6] = (int)DESCALE(z1 + t12 * -FIX_1_847759065, CONST_BITS - PASS1_BITS);
    z1 = t4 + t7;
    int64_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    t4 *= FIX_0_298631336;
    t5 *= FIX_2_053119869;
    t6 *= FIX_3_072711026;
    t7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    dp[7] = (int)DESCALE(t4 + z1 + z3, CONST_BITS - PASS1_BITS);
    dp[5] = (int)DESCALE(t5 + z2 + z4, CONST_BITS - PASS1_BITS);
    dp[3] = (int)DESCALE(t6 + z2 + z3, CONST_BITS - PASS1_BITS);
    dp[1] = (int)DESCALE(t7 + z1 + z4, CONST_BITS - PASS1_BITS);
  }
  dp = data;
  for (int c = 0; c < 8; ++c, ++dp) {
    int64_t t0 = dp[0] + dp[56], t7 = dp[0] - dp[56], t1 = dp[8] + dp[48], t6 = dp[8] - dp[48];
    int64_t t2 = dp[16] + dp[40], t5 = dp[16] - dp[40], t3 = dp[24] + dp[32], t4 = dp[24] - dp[32];
    int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    dp[0] = (int)DESCALE(t10 + t11, PASS1_BITS);
    dp[32] = (int)DESCALE(t10 - t11, PASS1_BITS);
    int64_t z1 = (t12 + t13) * FIX_0_541196100;
    dp[16] = (int)DESCALE(z1 + t13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
    dp[48] = (int)DESCALE(z1 + t12 * -FIX_1_847759065, CONST_BITS + PASS1_BITS);
    z1 = t4 + t7;
    int64_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    t4 *= FIX_0_298631336;
    t5 *= FIX_2_053119869;
    t6 *= FIX_3_072711026;
    t7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    dp[56] = (int)DESCALE(t4 + z1 + z3, CONST_BITS + PASS1_BITS);
    dp[40] = (int)DESCALE(t5 + z2 + z4, CONST_BITS + PASS1_BITS);
    dp[24] = (int)DESCALE(t6 + z2 + z3, CONST_BITS + PASS1_BITS);
    dp[8] = (int)DESCALE(t7 + z1 + z4, CONST_BITS + PASS1_BITS);
  }
}

/* Forward DCT of the 8x8 block at (x0, y0) of a plane, then jcdctmgr.c's
   quantization: (|x| + d/2) / d with d = 8 q, the sign put back. */
static void fdct_block(const uint8_t *plane, int stride, int x0, int y0, const int *q, int16_t *out) {
  int ws[64];
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) ws[8 * r + c] = (int)plane[(size_t)(y0 + r) * stride + x0 + c] - 128;
  fdct_islow(ws);
  for (int i = 0; i < 64; ++i) {
    int d = q[i] * 8, t = ws[i];
    out[i] = (int16_t)(t < 0 ? -((-t + (d >> 1)) / d) : (t + (d >> 1)) / d);
  }
}

static void encode_block(enc_t *E, const int16_t *blk, int *last_dc, const ehuff_t *dc, const ehuff_t *ac) {
  int diff = blk[0] - *last_dc, t = diff, t2 = diff, nbits = 0;
  *last_dc = blk[0];
  if (t < 0) {
    t = -t;
    t2 = diff - 1;
  }
  while (t) {
    nbits++;
    t >>= 1;
  }
  put_bits(E, dc->code[nbits], dc->size[nbits]);
  if (nbits) put_bits(E, (unsigned)t2, nbits);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    int v = blk[NATURAL[k]];
    if (v == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      put_bits(E, ac->code[0xF0], ac->size[0xF0]);
      r -= 16;
    }
    int a = v < 0 ? -v : v, v2 = v < 0 ? v - 1 : v;
    nbits = 0;
    while (a) {
      nbits++;
      a >>= 1;
    }
    int sym = (r << 4) + nbits;
    put_bits(E, ac->code[sym], ac->size[sym]);
    put_bits(E, (unsigned)v2, nbits);
    r = 0;
  }
  if (r > 0) put_bits(E, ac->code[0], ac->size[0]);
}

/* jccolor.c rgb_ycc_start: SCALEBITS 16, CBCR_OFFSET, ONE_HALF - 1 in the
   Cb and Cr rows. */
static int64_t RGB_YCC[8 * 256];
#define R_Y 0
#define G_Y 256
#define B_Y 512
#define R_CB 768
#define G_CB 1024
#define B_CB 1280
#define R_CR B_CB
#define G_CR 1536
#define B_CR 1792

static void init_rgb_ycc(void) {
  const int64_t half = (int64_t)1 << 15, cbcr_offset = (int64_t)128 << 16;
  for (int i = 0; i < 256; ++i) {
    RGB_YCC[i + R_Y] = FIX16(0.29900) * i;
    RGB_YCC[i + G_Y] = FIX16(0.58700) * i;
    RGB_YCC[i + B_Y] = FIX16(0.11400) * i + half;
    RGB_YCC[i + R_CB] = (-FIX16(0.16874)) * i;
    RGB_YCC[i + G_CB] = (-FIX16(0.33126)) * i;
    RGB_YCC[i + B_CB] = FIX16(0.50000) * i + cbcr_offset + half - 1;
    RGB_YCC[i + G_CR] = (-FIX16(0.41869)) * i;
    RGB_YCC[i + B_CR] = (-FIX16(0.08131)) * i;
  }
}

int salve_jpeg_encode(const uint8_t *rgb, int height, int width, int quality_in, uint8_t **out, unsigned long *out_size,
                      char *msg) {
  enc_t E;
  uint8_t *volatile planes = NULL, *volatile cplanes = NULL;
  memset(&E, 0, sizeof E);
  msg[0] = '\0';
  E.err.msg = msg;
  *out = NULL;
  *out_size = 0;
  if (setjmp(E.err.jump)) {
    free(E.out);
    free(planes);
    free(cplanes);
    return -1;
  }
  if (height <= 0 || width <= 0 || height > 65535 || width > 65535)
    fail(&E.err, "image size %d x %d is outside 1..65535", height, width);

  /* jcparam.c jpeg_quality_scaling and jpeg_add_quant_table(force_baseline). */
  int quality = quality_in < 1 ? 1 : (quality_in > 100 ? 100 : quality_in);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  int q[2][64];
  for (int i = 0; i < 64; ++i) {
    long l = ((long)STD_LUMA_Q[i] * scale + 50L) / 100L, c = ((long)STD_CHROMA_Q[i] * scale + 50L) / 100L;
    q[0][i] = (int)(l < 1 ? 1 : (l > 255 ? 255 : l));
    q[1][i] = (int)(c < 1 ? 1 : (c > 255 ? 255 : c));
  }

  /* Block geometry (jcmaster.c initial_setup): Y 2x2, Cb and Cr 1x1. */
  const int W = width, H = height;
  const int mcux = jdiv_round_up(W, 16), mcuy = jdiv_round_up(H, 16);
  const int ywib = jdiv_round_up(W, 8), yhib = jdiv_round_up(H, 8);
  const int ys = ywib * 8, yrows = mcuy * 16; /* Y plane: width_in_blocks columns, whole iMCU rows */
  const int cs = mcux * 8, crows = mcuy * 8;
  planes = malloc((size_t)ys * yrows);
  cplanes = malloc((size_t)2 * cs * crows);
  if (!planes || !cplanes) fail(&E.err, "out of memory");

  /* Colour conversion, the right edge repeated (expand_right_edge), Y rows
     past the image copies of its last row (jcprepct.c). Cb and Cr: the
     h2v2 downsample of row pairs (the last row repeated to make a pair) with
     the bias alternating 1, 2 along a row, then rows past the last pair
     copies of the last chroma row. */
  const int crow_real = jdiv_round_up(H, 2);
  /* Two full-resolution rows of 2 * cs samples each for Cb, then for Cr. */
  int *cb = malloc(sizeof(int) * (size_t)8 * cs), *cr;
  if (!cb) fail(&E.err, "out of memory");
  cr = cb + (size_t)4 * cs;
  for (int y = 0; y < yrows; ++y) {
    uint8_t *yp = planes + (size_t)y * ys;
    if (y >= H) {
      memcpy(yp, planes + (size_t)(H - 1) * ys, (size_t)ys);
      continue;
    }
    const uint8_t *src = rgb + (size_t)y * W * 3;
    int *cbrow = cb + (size_t)(y & 1) * 2 * cs, *crrow = cr + (size_t)(y & 1) * 2 * cs;
    for (int x = 0; x < 2 * cs; ++x) {
      const uint8_t *p = src + 3 * (size_t)(x < W ? x : W - 1);
      int r = p[0], g = p[1], b = p[2];
      if (x < ys) yp[x] = (uint8_t)((RGB_YCC[r + R_Y] + RGB_YCC[g + G_Y] + RGB_YCC[b + B_Y]) >> 16);
      cbrow[x] = (int)((RGB_YCC[r + R_CB] + RGB_YCC[g + G_CB] + RGB_YCC[b + B_CB]) >> 16);
      crrow[x] = (int)((RGB_YCC[r + R_CR] + RGB_YCC[g + G_CR] + RGB_YCC[b + B_CR]) >> 16);
    }
    if ((y & 1) == 0 && y == H - 1) { /* odd height: the pair's second row repeats the first */
      memcpy(cb + 2 * (size_t)cs, cb, sizeof(int) * 2 * (size_t)cs);
      memcpy(cr + 2 * (size_t)cs, cr, sizeof(int) * 2 * (size_t)cs);
    }
    if ((y & 1) == 1 || y == H - 1) {
      int cy = y >> 1;
      uint8_t *cbo = cplanes + (size_t)cy * cs, *cro = cplanes + (size_t)cs * crows + (size_t)cy * cs;
      for (int cx = 0, bias = 1; cx < cs; ++cx, bias ^= 3) {
        const int *a = cb, *b = cb + 2 * (size_t)cs;
        cbo[cx] = (uint8_t)((a[2 * cx] + a[2 * cx + 1] + b[2 * cx] + b[2 * cx + 1] + bias) >> 2);
        a = cr;
        b = cr + 2 * (size_t)cs;
        cro[cx] = (uint8_t)((a[2 * cx] + a[2 * cx + 1] + b[2 * cx] + b[2 * cx + 1] + bias) >> 2);
      }
    }
  }
  free(cb);
  for (int c = 0; c < 2; ++c)
    for (int cy = crow_real; cy < crows; ++cy)
      memcpy(cplanes + (size_t)c * cs * crows + (size_t)cy * cs, cplanes + (size_t)c * cs * crows + (size_t)(crow_real - 1) * cs,
             (size_t)cs);

  /* Markers: SOI, JFIF APP0, DQT 0 and 1, SOF0, DHT (DC0, AC0, DC1, AC1), SOS. */
  static const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01,
                                 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  for (size_t i = 0; i < sizeof head; ++i) put_byte(&E, head[i]);
  for (int t = 0; t < 2; ++t) {
    put_byte(&E, 0xFF);
    put_byte(&E, 0xDB);
    put_u16(&E, 67);
    put_byte(&E, t);
    for (int k = 0; k < 64; ++k) put_byte(&E, q[t][NATURAL[k]]);
  }
  const uint8_t sof[] = {0xFF, 0xC0, 0x00, 17, 8, (uint8_t)(H >> 8), (uint8_t)H, (uint8_t)(W >> 8), (uint8_t)W, 3,
                         1,    0x22, 0,    2,  0x11, 1, 3, 0x11, 1};
  for (size_t i = 0; i < sizeof sof; ++i) put_byte(&E, sof[i]);
  put_dht(&E, 0x00, DC_LUMA_BITS, DC_VALS);
  put_dht(&E, 0x10, AC_LUMA_BITS, AC_LUMA_VALS);
  put_dht(&E, 0x01, DC_CHROMA_BITS, DC_VALS);
  put_dht(&E, 0x11, AC_CHROMA_BITS, AC_CHROMA_VALS);
  static const uint8_t sos[] = {0xFF, 0xDA, 0x00, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  for (size_t i = 0; i < sizeof sos; ++i) put_byte(&E, sos[i]);

  ehuff_t dc_l, ac_l, dc_c, ac_c;
  build_ehuff(DC_LUMA_BITS, DC_VALS, &dc_l);
  build_ehuff(AC_LUMA_BITS, AC_LUMA_VALS, &ac_l);
  build_ehuff(DC_CHROMA_BITS, DC_VALS, &dc_c);
  build_ehuff(AC_CHROMA_BITS, AC_CHROMA_VALS, &ac_c);

  /* jccoefct.c compress_data: an MCU is Y's 2x2 blocks, then Cb, then Cr.
     A Y block past the last block column takes the DC of the block to its
     left; a Y block row past the last block row takes, for each block, the
     DC of the MCU's block before it; every other coefficient is 0. */
  int16_t mcu[6][64];
  int last[3] = {0, 0, 0};
  const int last_col_w = ywib % 2 ? ywib % 2 : 2, last_row_h = yhib % 2 ? yhib % 2 : 2;
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx) {
      int blkn = 0;
      int cnt = mx < mcux - 1 ? 2 : last_col_w;
      for (int yi = 0; yi < 2; ++yi, blkn += 2) {
        if (my < mcuy - 1 || yi < last_row_h) {
          for (int bi = 0; bi < cnt; ++bi) fdct_block(planes, ys, (2 * mx + bi) * 8, (2 * my + yi) * 8, q[0], mcu[blkn + bi]);
          for (int bi = cnt; bi < 2; ++bi) {
            memset(mcu[blkn + bi], 0, sizeof mcu[0]);
            mcu[blkn + bi][0] = mcu[blkn + bi - 1][0];
          }
        } else {
          for (int bi = 0; bi < 2; ++bi) {
            memset(mcu[blkn + bi], 0, sizeof mcu[0]);
            mcu[blkn + bi][0] = mcu[blkn - 1][0];
          }
        }
      }
      fdct_block(cplanes, cs, mx * 8, my * 8, q[1], mcu[4]);
      fdct_block(cplanes + (size_t)cs * crows, cs, mx * 8, my * 8, q[1], mcu[5]);
      for (int b = 0; b < 4; ++b) encode_block(&E, mcu[b], &last[0], &dc_l, &ac_l);
      encode_block(&E, mcu[4], &last[1], &dc_c, &ac_c);
      encode_block(&E, mcu[5], &last[2], &dc_c, &ac_c);
    }
  put_bits(&E, 0x7F, 7); /* jchuff.c flush_bits: the last byte padded with 1s */
  E.nacc = 0;
  put_byte(&E, 0xFF);
  put_byte(&E, 0xD9);
  free(planes);
  free(cplanes);
  *out = E.out;
  *out_size = E.len;
  return 0;
}

void salve_jpeg_free(void *p) { free(p); }

/* ============================================================ batch loader */

/* The training loader's batch call: the port of salve_tpu/native/loader.py
   over native/jpeg_loader.cpp. Each file is read and decoded (grayscale
   becomes RGB by replication, as libjpeg's JCS_RGB output does), resized
   with jpeg_loader.cpp:74-108's float bilinear filter (cv2's pixel-centre
   sample positions, clamped edges, no antialiasing), and rounded to u8 as
   salve_tpu/dataset/bev_pairs.py:_load_batch_native does with
   np.clip(np.round(x), 0, 255): half to even. A pool of threads takes the
   files in turn, as decode_resize_batch's does.

   The library is built with -ffp-contract=off (native/build.py): otherwise
   a compiler for a target with FMA (aarch64) may fuse `top + wy * (bot -
   top)` into one rounding, where the x86-64 build of jpeg_loader.cpp (no
   FMA in the base ISA) rounds twice. floor and rint are written out so the
   library needs no libm. */

#include <pthread.h>
#include <unistd.h>

static inline int floor_to_int(float v) {
  int i = (int)v;
  return v < (float)i ? i - 1 : i;
}

/* Nearest integer, ties to even, for 0 <= v < 2^23: adding 2^23 leaves no
   fraction bits, so the add rounds in the current (nearest-even) mode. */
static inline int round_half_even(float v) {
  volatile float big = 8388608.0f;
  return (int)((v + big) - big);
}

static void resize_bilinear_u8(const uint8_t *src, int w, int h, int ch, uint8_t *dst, int out_w, int out_h,
                               int *x0s, int *x1s, float *wxs) {
  const float sx = (float)w / out_w;
  const float sy = (float)h / out_h;
  for (int ox = 0; ox < out_w; ++ox) {
    float fx = (ox + 0.5f) * sx - 0.5f;
    int x0 = floor_to_int(fx);
    wxs[ox] = fx - x0;
    int x1 = x0 + 1;
    x0s[ox] = clampi(x0, 0, w - 1);
    x1s[ox] = clampi(x1, 0, w - 1);
  }
  for (int oy = 0; oy < out_h; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    int y0 = floor_to_int(fy);
    float wy = fy - y0;
    int y1 = clampi(y0 + 1, 0, h - 1);
    y0 = clampi(y0, 0, h - 1);
    const uint8_t *r0 = src + (size_t)y0 * w * ch, *r1 = src + (size_t)y1 * w * ch;
    uint8_t *o = dst + (size_t)oy * out_w * 3;
    for (int ox = 0; ox < out_w; ++ox) {
      const float wx = wxs[ox];
      const int a = x0s[ox] * ch, b = x1s[ox] * ch;
      for (int c = 0; c < 3; ++c) {
        const int k = ch == 1 ? 0 : c;
        float v00 = r0[a + k], v01 = r0[b + k], v10 = r1[a + k], v11 = r1[b + k];
        float top = v00 + wx * (v01 - v00);
        float bot = v10 + wx * (v11 - v10);
        o[ox * 3 + c] = (uint8_t)clampi(round_half_even(top + wy * (bot - top)), 0, 255);
      }
    }
  }
}

/* Read and decode one file, then resize it into `dst`; 0, or -1 with `msg`. */
static int load_one(const char *path, int out_h, int out_w, uint8_t *dst, char *msg) {
  uint8_t *data = NULL, *pix = NULL;
  int *x0s = NULL, *x1s = NULL;
  float *wxs = NULL;
  int rc = -1, h, w, c;
  FILE *f = fopen(path, "rb");
  if (!f) {
    snprintf(msg, MSG_BYTES, "cannot open the file");
    return -1;
  }
  long size = fseek(f, 0, SEEK_END) == 0 ? ftell(f) : -1;
  if (size <= 0 || fseek(f, 0, SEEK_SET) != 0) {
    snprintf(msg, MSG_BYTES, "cannot read the file's size");
    goto done;
  }
  data = malloc((size_t)size);
  if (!data || fread(data, 1, (size_t)size, f) != (size_t)size) {
    snprintf(msg, MSG_BYTES, "cannot read the file");
    goto done;
  }
  if (salve_jpeg_info(data, (unsigned long)size, &h, &w, &c, msg)) goto done;
  pix = malloc((size_t)h * w * c);
  x0s = malloc(sizeof(int) * (size_t)out_w);
  x1s = malloc(sizeof(int) * (size_t)out_w);
  wxs = malloc(sizeof(float) * (size_t)out_w);
  if (!pix || !x0s || !x1s || !wxs) {
    snprintf(msg, MSG_BYTES, "out of memory");
    goto done;
  }
  if (salve_jpeg_decode(data, (unsigned long)size, pix, (unsigned long)h * w * c, msg)) goto done;
  resize_bilinear_u8(pix, w, h, c, dst, out_w, out_h, x0s, x1s, wxs);
  rc = 0;
done:
  fclose(f);
  free(data);
  free(pix);
  free(x0s);
  free(x1s);
  free(wxs);
  return rc;
}

typedef struct {
  const char *const *paths;
  int n, out_h, out_w;
  uint8_t *out;
  int *status;
  char *msgs;
  int next;
} batch_t;

static void *batch_worker(void *arg) {
  batch_t *B = arg;
  const size_t stride = (size_t)B->out_h * B->out_w * 3;
  for (;;) {
    int i = __atomic_fetch_add(&B->next, 1, __ATOMIC_RELAXED);
    if (i >= B->n) return NULL;
    B->status[i] = load_one(B->paths[i], B->out_h, B->out_w, B->out + stride * i, B->msgs + (size_t)i * MSG_BYTES);
  }
}

/* Decode `n` JPEG files and resize each to (out_h, out_w, 3) u8 in `out`;
   status[i] is 0, or -1 with a message at msgs + i * MSG_BYTES. Returns the
   number decoded. num_threads <= 0 takes one thread per online CPU. */
int salve_jpeg_decode_resize_batch(const char *const *paths, int n, int out_h, int out_w, uint8_t *out, int *status,
                                   char *msgs, int num_threads) {
  if (n <= 0) return 0;
  if (num_threads <= 0) num_threads = (int)sysconf(_SC_NPROCESSORS_ONLN);
  if (num_threads < 1) num_threads = 1;
  if (num_threads > n) num_threads = n;
  batch_t B = {paths, n, out_h, out_w, out, status, msgs, 0};
  pthread_t *threads = malloc(sizeof(pthread_t) * (size_t)num_threads);
  int started = 0;
  if (threads)
    for (; started < num_threads; ++started)
      if (pthread_create(&threads[started], NULL, batch_worker, &B)) break;
  if (started == 0) batch_worker(&B);
  for (int t = 0; t < started; ++t) pthread_join(threads[t], NULL);
  free(threads);
  int ok = 0;
  for (int i = 0; i < n; ++i) ok += status[i] == 0;
  return ok;
}
