// B2 — fused BEV hole fill + hallucination mask.
//
// Replaces salve_tpu/ops/pallas_fill.py:fill_and_mask_batched (kernel
// _fill_mask_kernel_batched; also covers the chunking wrapper
// fill_and_mask_any_batch and the single-image fill_and_mask). Oracle:
// salve_tpu/ops/bev.py:fill_holes + hallucination_mask.
//
// What it computes, per image and for all three channels at once:
//   FILL_ITERS = 6 rounds on a zero-padded plane, each
//     den  = box3(occ)            num_c = box3(img_c * occ)
//     fill = num_c / max(den, 1)  new_o = min(den, 1)
//     img_c = occ > 0 ? img_c : fill;  occ = max(occ, new_o)
//   then every cell with no support cell in its 11x11 window is zeroed
//   (support = all three channels of the u8-quantized sparse image > 0, given
//   by the caller).
//
// Exactness. Occupancy stays in {0, 1} in every round (den is an integer
// count 0..9, new_o = min(den, 1)), so den is an int here, exact in any order,
// and with finite non-negative colours img * occ is the select occ ? img : 0,
// bit for bit. Only the colour numerator's add order matters: rows first,
// (c + up) + down, then columns, (c + left) + right, as in
// pallas_fill.py:_box_sum, with __fadd_rn, and the quotient must be the IEEE
// one (never --use_fast_math). With den an integer 2..9 it is a product with
// the rounded reciprocal plus one FMA residual correction (div_small), equal
// to __fdiv_rn wherever it is used: a check kernel compares the two on the
// card for every finite float numerator. Support is binary, so the 11x11
// count > 0 is an OR over bit rows. The output matches the plain version bit
// for bit.
//
// What bounds it on an H100: each cell is read once (12 B of colour, 1 B of
// occupancy, 1 B of support) and written once (12 B): 26 B a cell of HBM
// traffic. The ~220 float operations a cell over the six rounds are far below
// the card's rate, so the bound is bytes; what a design has to keep low is
// the on-chip traffic of the six-round fixed point and the halo it recomputes.
//
// Design: register streaming, no shared-memory sweeps. One warp owns a strip
// of 64 stage columns (two adjacent columns a lane, so x +- 1 comes from the
// lane's other register or one __shfl_sync) and streams down a segment of
// rows. It keeps, for each of the six rounds, a window of that round's rows
// in registers: the centre row's colour and occupancy and the partial row sum
// (c + up). When the round below hands it a new row, the round finishes its
// centre row (+ down, then the column pass through shuffles, the select and
// the quotient) and hands that to the round above, so one input row in gives
// one output row, six rows behind, and round r's rows never leave registers.
// Each round's valid region shrinks by one column on each side: a 64-column
// strip writes its centre 52 columns (halo share 64/52 = 1.23, against
// 44^2/32^2 = 1.89 for a 32x32 tile with its six-cell halo). Rows above and
// below a segment are streamed in as warm-up, 12 extra rows a segment. The
// support test keeps an 11-row shift register of support bits per column;
// one __ballot_sync per column parity gives the strip's column bits, and the
// 11-column OR is a shift and a mask.
//
// Shared memory carries only the row loads and stores: a warp stages the
// colour row segment of 64 cells (768 B, 16-byte vector loads from a
// 16-byte-aligned start) and each lane reads its 24 bytes back; the output
// goes the same way out, with 16-byte stores in the middle and scalar stores
// at the ragged ends. That is 2 x 12 B in and 2 x 12 B out per stage cell a
// row, about 59 B per output cell, against about 1,400 B per output cell for
// a 32x32 tile that sweeps a 44^2 shared-memory stage twice in each of the
// six rounds (24x less). Colours never round-trip through shared memory
// between rounds.
//
// Launch shape: 64-thread blocks (2 warps), so that with the ~210 registers
// a thread that the round windows take, four blocks are resident on an SM
// (8 warps; capping the registers lower spills and ran slower). The launcher
// sizes the row segments so that all warps fit in one resident wave
// when the image allows (fewer, longer segments otherwise need more waves).

#include <cuda_runtime.h>

namespace {

constexpr int kIters = 6;  // salve_tpu/ops/bev.py:FILL_ITERS
constexpr int kMaskR = 5;  // DEFAULT_MASK_KERNEL = 11
constexpr int kCols = 2;   // stage columns a lane holds
constexpr int kStageW = 32 * kCols;            // 64
constexpr int kOutW = kStageW - 2 * kIters;    // 52
constexpr int kWarps = 2;                      // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMinSeg = 16;  // shortest row segment the launcher picks
constexpr int kBufV = (3 * kStageW + 3 + 3) / 4;  // float4s staged a row: 49
constexpr int kBufF = 4 * kBufV;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kIters >= kMaskR, "the stage halo must cover the mask radius");
static_assert(2 * kMaskR + 1 <= 32 - 1, "the support window fits a shift register");

// One round's window: centre row of that round's input, its occupancy, the
// partial row sum (centre + up) of the selected colours, and centre + up of
// the occupancy.
struct Round {
  float c[kCols][3];
  float a[kCols][3];
  int o[kCols];
  int ao[kCols];
};

// Raw loads of one input row, issued a row ahead of their use.
struct RowLoad {
  float4 v[2];
  int occ[kCols];
  int sup[kCols];
};

__device__ __forceinline__ float4 load4(const float* __restrict__ src, long long f,
                                        long long total) {
  if (f >= 0 && f + 4 <= total) return __ldg(reinterpret_cast<const float4*>(src + f));
  float e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = (f + i >= 0 && f + i < total) ? __ldg(src + f + i) : 0.f;
  return make_float4(e[0], e[1], e[2], e[3]);
}

// num / den for a den of 2..9 with y = RN(1 / den): q0 = RN(num * y), then one
// residual correction (Markstein). It equals __fdiv_rn(num, den) for every
// finite num >= kDivExactMin, which salve_fill_div_check tests on the card
// for all of them. Every non-zero numerator stays in that range when every
// occupied input colour is 0 or in [kInputExactMin, kInputExactMax]: a fill
// is at least the smallest non-zero value around it over 9, so six rounds
// stay above 2^-100 / 9^6 > 2^-120, and a sum of nine values of at most
// 2^120 is finite. A warp that loads any other colour takes __fdiv_rn.
constexpr float kDivExactMin = 0x1p-125f;
constexpr float kInputExactMin = 0x1p-100f;
constexpr float kInputExactMax = 0x1p120f;

__device__ __forceinline__ float div_small(float num, float fd, float y) {
  const float q0 = __fmul_rn(num, y);
  return __fmaf_rn(__fmaf_rn(-q0, fd, num), y, q0);
}

// 32 bits -> the even bits of a 64-bit word.
__device__ __forceinline__ unsigned long long spread_bits(unsigned x) {
  unsigned long long v = x;
  v = (v | (v << 16)) & 0x0000FFFF0000FFFFull;
  v = (v | (v << 8)) & 0x00FF00FF00FF00FFull;
  v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0Full;
  v = (v | (v << 2)) & 0x3333333333333333ull;
  v = (v | (v << 1)) & 0x5555555555555555ull;
  return v;
}

__global__ void __launch_bounds__(kThreads)
fill_mask_kernel(const float* __restrict__ sparse,
                 const unsigned char* __restrict__ occ_in,
                 const unsigned char* __restrict__ support,
                 float* __restrict__ out, int b, int h, int w, int n_strip,
                 int n_seg, int seg) {
  __shared__ __align__(16) float stage[kWarps][2][kBufF];
  __shared__ float rcp[10];  // RN(1 / den) for den = 0..9 (0, 1 unused)
  if (threadIdx.x < 10) rcp[threadIdx.x] = __fdiv_rn(1.f, (float)max((int)threadIdx.x, 1));
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gw = (long long)blockIdx.x * kWarps + warp;
  const int strip = (int)(gw % n_strip);
  const long long rest = gw / n_strip;
  const int segi = (int)(rest % n_seg);
  const long long img = rest / n_seg;
  if (img >= b) return;  // whole warp; the block never synchronises

  float* in_buf = stage[warp][0];
  float* out_buf = stage[warp][1];
  const long long total = 3LL * b * h * w;
  const long long img_base = img * h * w;
  const int xs = strip * kOutW - kIters;  // image column of stage column 0
  const int y0 = segi * seg;
  const int y1 = min(y0 + seg, h);
  bool cin[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int gx = xs + kCols * lane + j;
    cin[j] = gx >= 0 && gx < w;
  }

  auto fetch = [&](RowLoad& r, int y) {
    const bool row_ok = y >= 0 && y < h;
    const long long cell0 = img_base + (long long)y * w + xs;
    const long long a0 = (3 * cell0) & ~3LL;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int q = lane + 32 * k;
      r.v[k] = (row_ok && q < kBufV) ? load4(sparse, a0 + 4 * q, total) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const long long p = cell0 + kCols * lane + j;
      r.occ[j] = (row_ok && cin[j]) ? (__ldg(occ_in + p) != 0) : 0;
      r.sup[j] = (row_ok && cin[j]) ? (__ldg(support + p) != 0) : 0;
    }
  };

  Round rd[kIters];
#pragma unroll
  for (int r = 0; r < kIters; ++r) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
#pragma unroll
      for (int c = 0; c < 3; ++c) rd[r].c[j][c] = rd[r].a[j][c] = 0.f;
      rd[r].o[j] = rd[r].ao[j] = 0;
    }
  }
  unsigned sreg[kCols] = {0u, 0u};
  bool ieee_div = false;  // warp-uniform

  RowLoad nxt;
  fetch(nxt, y0 - kIters);
  for (int s = y0 - kIters; s < y1 + kIters; ++s) {
    // Row s of the input: through the stage into this lane's two columns.
    const long long cell0 = img_base + (long long)s * w + xs;
    const long long a0 = (3 * cell0) & ~3LL;
    const int off = (int)(3 * cell0 - a0) + 3 * kCols * lane;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int q = lane + 32 * k;
      if (q < kBufV) reinterpret_cast<float4*>(in_buf)[q] = nxt.v[k];
    }
    float ni[kCols][3];
    int no[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      no[j] = nxt.occ[j];
      sreg[j] = (sreg[j] << 1) | (unsigned)nxt.sup[j];
    }
    __syncwarp();
    bool odd = false;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        ni[j][c] = in_buf[off + 3 * j + c];
        odd |= no[j] && ni[j][c] != 0.f && !(ni[j][c] >= kInputExactMin && ni[j][c] <= kInputExactMax);
      }
    ieee_div = __any_sync(kFull, odd) || ieee_div;
    __syncwarp();
    if (s + 1 < y1 + kIters) fetch(nxt, s + 1);  // in flight during the rounds

    // Round r + 1 finishes row s - r - 1 from round r's rows s - r - 2 .. s - r.
#pragma unroll
    for (int r = 0; r < kIters; ++r) {
      Round& R = rd[r];
      float pn[kCols][3], v[kCols][3];
      int vo[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          pn[j][c] = no[j] ? ni[j][c] : 0.f;
          v[j][c] = __fadd_rn(R.a[j][c], pn[j][c]);  // (c + up) + down
        }
        vo[j] = R.ao[j] + no[j];
      }
      float num[kCols][3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float left = __shfl_up_sync(kFull, v[1][c], 1);
        const float right = __shfl_down_sync(kFull, v[0][c], 1);
        num[0][c] = __fadd_rn(__fadd_rn(v[0][c], left), v[1][c]);
        num[1][c] = __fadd_rn(__fadd_rn(v[1][c], v[0][c]), right);
      }
      const int lo = __shfl_up_sync(kFull, vo[1], 1);
      const int ro = __shfl_down_sync(kFull, vo[0], 1);
      const int den[kCols] = {vo[0] + lo + vo[1], vo[1] + vo[0] + ro};
      // The quotients num / den, IEEE-exact: div_small, or __fdiv_rn in a
      // warp that has met a colour outside kInputExact.
      float q[kCols][3];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float fd = (float)den[j], y = rcp[den[j]];
#pragma unroll
        for (int c = 0; c < 3; ++c) q[j][c] = div_small(num[j][c], fd, y);
      }
      if (ieee_div) {
#pragma unroll
        for (int j = 0; j < kCols; ++j)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            if (den[j] > 1) q[j][c] = __fdiv_rn(num[j][c], (float)den[j]);
      }
      const int y = s - r - 1;
      const bool rin = y >= 0 && y < h;
      float nf[kCols][3];
      int nfo[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const bool keep = R.o[j] != 0;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          nf[j][c] = keep ? R.c[j][c] : (den[j] > 1 ? q[j][c] : num[j][c]);  // num / 1
          R.a[j][c] = __fadd_rn(pn[j][c], keep ? R.c[j][c] : 0.f);
          R.c[j][c] = ni[j][c];
        }
        nfo[j] = (keep || (den[j] > 0 && rin && cin[j])) ? 1 : 0;
        R.ao[j] = no[j] + R.o[j];
        R.o[j] = no[j];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        no[j] = nfo[j];
#pragma unroll
        for (int c = 0; c < 3; ++c) ni[j][c] = nf[j][c];
      }
    }

    // Round 6 now holds row s - 6: mask it and store the strip's centre.
    const int yo = s - kIters;
    if (yo >= y0 && yo < y1) {
      // Column bit per stage column: support in rows yo - 5 .. yo + 5.
      const unsigned win = (1u << (2 * kMaskR + 1)) - 1u;
      const unsigned long long cols =
          spread_bits(__ballot_sync(kFull, ((sreg[0] >> 1) & win) != 0)) |
          (spread_bits(__ballot_sync(kFull, ((sreg[1] >> 1) & win) != 0)) << 1);
      const long long ocell0 = img_base + (long long)yo * w + xs;
      const long long oa0 = (3 * ocell0) & ~3LL;
      const int ooff = (int)(3 * ocell0 - oa0) + 3 * kCols * lane;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int sc = kCols * lane + j;
        const int sh = max(sc - kMaskR, 0);
        const bool m = ((cols >> sh) & win) != 0ull;
#pragma unroll
        for (int c = 0; c < 3; ++c) out_buf[ooff + 3 * j + c] = m ? ni[j][c] : 0.f;
      }
      __syncwarp();
      // Floats [f0, f1): the strip's centre columns inside the image.
      const long long f0 = 3 * (ocell0 + kIters);
      const long long f1 = 3 * (img_base + (long long)yo * w + min(xs + kIters + kOutW, w));
      const long long v0 = (f0 + 3) & ~3LL, v1 = f1 & ~3LL;
      if (v0 < v1) {
        for (long long f = f0 + lane; f < v0; f += 32) out[f] = out_buf[f - oa0];
        for (long long f = v1 + lane; f < f1; f += 32) out[f] = out_buf[f - oa0];
        for (long long f = v0 + 4 * lane; f < v1; f += 128)
          *reinterpret_cast<float4*>(out + f) = *reinterpret_cast<const float4*>(out_buf + (f - oa0));
      } else {
        for (long long f = f0 + lane; f < f1; f += 32) out[f] = out_buf[f - oa0];
      }
      __syncwarp();
    }
  }
}

__global__ void div_check_kernel(unsigned long long* mismatches) {
  unsigned long long n = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {  // num = 0
    for (int den = 2; den <= 9; ++den)
      n += __float_as_uint(div_small(0.f, (float)den, __fdiv_rn(1.f, (float)den))) !=
           __float_as_uint(__fdiv_rn(0.f, (float)den));
  }
  const unsigned first = __float_as_uint(kDivExactMin), end = 0x7f800000u;  // to +inf
  for (unsigned long long bits = first + blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       bits < end; bits += (unsigned long long)gridDim.x * blockDim.x) {
    const float num = __uint_as_float((unsigned)bits);
#pragma unroll
    for (int den = 2; den <= 9; ++den) {
      const float fd = (float)den;
      n += __float_as_uint(div_small(num, fd, __fdiv_rn(1.f, fd))) != __float_as_uint(__fdiv_rn(num, fd));
    }
  }
  atomicAdd(mismatches, n);
}

}  // namespace

// Counts into *mismatches the (num, den) pairs, num 0 or any finite float
// from kDivExactMin up and den 2..9, where B2's quotient differs from
// __fdiv_rn.
extern "C" int salve_fill_div_check(unsigned long long* mismatches, void* stream) {
  div_check_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(mismatches);
  return (int)cudaGetLastError();
}

extern "C" int salve_fill_mask(const float* sparse, const unsigned char* occ,
                               const unsigned char* support, float* out, int b,
                               int h, int w, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0) return (int)cudaGetLastError();
  // Warps resident on the whole card at once (queried once a process: the
  // library serves one device).
  static long long resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fill_mask_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    resident = (long long)sms * per_sm * kWarps;
  }
  const int n_strip = (w + kOutW - 1) / kOutW;
  // Segments: as many as one resident wave holds, none shorter than kMinSeg
  // rows (each segment streams 12 warm-up rows).
  long long n_seg = resident / ((long long)b * n_strip);
  n_seg = n_seg < 1 ? 1 : n_seg;
  const long long max_seg = (h + kMinSeg - 1) / kMinSeg;
  n_seg = n_seg > max_seg ? max_seg : n_seg;
  const int seg = (int)((h + n_seg - 1) / n_seg);
  n_seg = (h + seg - 1) / seg;
  const long long warps = (long long)b * n_seg * n_strip;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  fill_mask_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      sparse, occ, support, out, b, h, w, n_strip, (int)n_seg, seg);
  return (int)cudaGetLastError();
}
