// Layout raster — the verifier's layout modality: each room polygon filled
// white, each W/D/O segment painted over it as a thick anti-aliased line,
// the image flipped vertically and cast to u8, every raster of a call in
// one launch.
//
// Replaces no Pallas kernel: salve_tpu's layout raster is plain XLA,
// salve_tpu/ops/raster.py polygon_mask, polyline_coverage and paint_rgb
// through salve_tpu/rendering/layout.py (rasterize_layout_device). Its
// plain PyTorch port (salve_tpu_torch/rendering/layout.py:
// rasterize_layout_plain over ops/raster.py) ran as about a thousand
// elementwise and reduce launches a batch of 32 rasters: a (32, 501, 501,
// 32) boolean crossing test and int32 sum for each of 19 chunks of edges,
// then a float64 FMA emulation over the whole image for each W/D/O slot.
// That layer read 0.0064% of its roofline on the H100 and took 89% of the
// layout cell's device time, so the kernel was added.
//
// What it computes: exactly the plain version's u8 bytes. Every float
// operation of the plain version is rounded where it rounds:
//   image space   fl32(fl64(fl64(p * 1.5) + half_m)) * fl32(1 / mpp)
//   fill          an edge (a, c) is live on row y when (a.y > y) != (c.y > y);
//                 x_int = a.x + ((y - a.y) * (c.x - a.x)) / den, den = c.y - a.y
//                 or 1e-12 where |c.y - a.y| < 1e-12, each step rounded; pixel
//                 x is inside when an odd number of live edges have x < x_int
//   lines         ab_len2 = fma(aby, aby, abx * abx + 0), dot the same way,
//                 t = clamp(dot / max(ab_len2, 1e-12), 0, 1), the clamped
//                 projection's distance through one FMA a coordinate and an
//                 IEEE sqrt, cov = clamp((top - dist) * fl32(1 / 1.25), 0, 1),
//                 painted in slot order as fma(img, 1 - cov, col * cov)
//   output        rint (half to even), clamp to [0, 255], u8, row H - 1 - y.
// nvcc contracts a * b + c into an FMA by default, so every step is an
// explicit __f*_rn / __d*_rn intrinsic, and an FMA only where the plain
// version calls fma_f32_exact.
//
// What bounds it on an H100: the rasters' bytes. A call writes B (S^2) 3
// bytes (24 MB at B = 32, S = 501: 7.6 us at 3.35 TB/s) and reads a few KB
// of vertices. The crossings are about B S V (9.3 M at V ~ 580) and the
// lines' bands a few thousand pixels a slot, both negligible at the card's
// rate. What a design must avoid is the plain version's per-pixel, per-edge
// work and its round trips of whole images through device memory.
//
// Design: a block owns one raster and a run of up to kRows rows. It stages
// the room's image-space vertices in shared memory kTile at a time (any V: a
// room of more vertices takes more tiles). Each thread takes an edge and the
// rows of the run the edge can be live on (from its ends' heights; the live
// test itself is the plain version's); a live edge's crossing x_int flips
// the parity of the first ceil(x_int) pixels of the row, which the block
// records as one bit (index ceil(x_int), clamped to [0, S]) in the row's
// toggle bitset, by atomicXor in shared memory: no per-pixel test, no cap on
// the crossings a row. A warp a row then turns the toggles into the row's
// inside bits by a suffix XOR (shifts within a word, a ballot across words).
// The W/D/O slots go through shared memory kSlots at a time, in paint
// order, as the vertices do: a tile's image-space ends, slope and colour,
// and for each row of the run the pixel span outside which a slot's
// coverage is exactly +0: the row's cut through the band of half width
// ceil(top) + 1 px around the segment's line, inside its box grown as much
// (float64, so the span holds every pixel whose float32 distance is below
// top). Outside it the paint is the identity and is skipped. A thread a
// pixel paints the pixel's three channels with every tile in turn (a room
// of at most kSlots W/D/Os, as every room drawn so far, stages its one tile
// once a block) into a shared copy of the run's output rows, which lie back
// to back in the flipped raster, and the block stores that copy with
// 16-byte stores at the same alignment as its place in the output. Nothing
// but the u8 rasters touches device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;        // most raster rows a block
constexpr int kTile = 1024;      // room vertices staged in shared memory at a time
constexpr int kSlots = 32;       // W/D/O slots staged in shared memory at a time: a warp's lanes
constexpr double kScale = 1.5;   // rendering/layout.py:HOHO_S_ZIND_SCALE_FACTOR
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 200 * 1024;  // dynamic shared memory a block may take
static_assert(kThreads % 32 == 0 && kSlots == 32, "a warp's ballot covers one row's tile of slots");

struct Params {
  // (B, 2V + 7K + 2) float32 rows of rendering/layout.py:pack_layouts: a
  // row's (V, 2) vertices in world metres, (K, 2, 2) segments, (K, 3)
  // colours, then its vertex and W/D/O counts as int32 bits.
  const float* packed;
  unsigned char* out;  // (B, S, S, 3)
  int v, k, side, words, rows, row_blocks, stage_bytes;
  float half_m, inv_mpp, top, inv_ramp, reach;
};

// One W/D/O line in image space.
struct Slot {
  float ax, ay, bx, by, abx, aby, den;  // den = max(|b - a|^2, 1e-12)
  float col[3];
  int x0, x1, y0, y1;  // its box grown by `reach`, clipped to the image (inclusive)
};

// torch.clamp: NaN stays NaN.
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// rendering/layout.py:_world_to_img.
__device__ __forceinline__ float to_img(float p, const Params& q) {
  return __fmul_rn(__double2float_rn(__dadd_rn(__dmul_rn((double)p, kScale), (double)q.half_m)), q.inv_mpp);
}

// First and last pixel of [lo, hi] on a line of `side` pixels (x1 < x0: none).
__device__ __forceinline__ int lo_px(double v, int side) {
  return v <= 0.0 ? 0 : (v >= (double)side ? side : (int)floor(v));
}

__device__ __forceinline__ int hi_px(double v, int side) {
  return v < 0.0 ? -1 : (v >= (double)(side - 1) ? side - 1 : (int)ceil(v));
}

// Row b of `packed`.
__device__ __forceinline__ const float* layout_row(const Params& q, int b) {
  return q.packed + (long long)b * (2 * q.v + 7 * q.k + 2);
}

__device__ Slot load_slot(const Params& q, int b, int k) {
  const float* s = layout_row(q, b) + 2 * q.v + 4 * k;
  const float* c = layout_row(q, b) + 2 * q.v + 4 * q.k + 3 * k;
  Slot o;
  o.ax = to_img(s[0], q);
  o.ay = to_img(s[1], q);
  o.bx = to_img(s[2], q);
  o.by = to_img(s[3], q);
  o.abx = __fsub_rn(o.bx, o.ax);
  o.aby = __fsub_rn(o.by, o.ay);
  const float len2 = __fmaf_rn(o.aby, o.aby, __fadd_rn(__fmul_rn(o.abx, o.abx), 0.f));
  o.den = len2 < 1e-12f ? 1e-12f : len2;
  for (int i = 0; i < 3; ++i) o.col[i] = c[i];
  if (isnan(o.ax) || isnan(o.ay) || isnan(o.bx) || isnan(o.by)) {
    o.x0 = o.y0 = 0;
    o.x1 = o.y1 = q.side - 1;
  } else {
    o.x0 = lo_px((double)fminf(o.ax, o.bx) - q.reach, q.side);
    o.x1 = hi_px((double)fmaxf(o.ax, o.bx) + q.reach, q.side);
    o.y0 = lo_px((double)fminf(o.ay, o.by) - q.reach, q.side);
    o.y1 = hi_px((double)fmaxf(o.ay, o.by) + q.reach, q.side);
  }
  return o;
}

// The pixels of row y that may have coverage from slot s, as (first, last):
// the row's cut through the band of half width `reach` around the segment's
// line (a superset of the points within `reach` of the segment), inside the
// slot's box.
__device__ int2 slot_span(const Slot& s, int y, const Params& q) {
  if (y < s.y0 || y > s.y1) return make_int2(0, -1);
  int2 span = make_int2(s.x0, s.x1);
  const double dx = (double)s.bx - s.ax, dy = (double)s.by - s.ay;
  if (dy != 0.0 && !isnan(dx) && !isnan(dy)) {
    const double xc = s.ax + ((double)y - s.ay) * dx / dy;
    const double half = q.reach * sqrt(dx * dx + dy * dy) / fabs(dy);
    if (!isnan(xc) && !isnan(half)) {
      span.x = max(span.x, lo_px(xc - half, q.side));
      span.y = min(span.y, hi_px(xc + half, q.side));
    }
  }
  return span;
}

// Pixel (x, y) painted by slot s, all three channels (ops/raster.py:
// polyline_coverage of the one segment, then paint_rgb).
__device__ __forceinline__ void paint(float* v, const Slot& s, float x, float y, const Params& q) {
  const float apx = __fsub_rn(x, s.ax), apy = __fsub_rn(y, s.ay);
  const float dot = __fmaf_rn(apy, s.aby, __fadd_rn(__fmul_rn(apx, s.abx), 0.f));
  const float t = clampf(__fdiv_rn(dot, s.den), 0.f, 1.f);
  const float dx = __fsub_rn(x, __fmaf_rn(t, s.abx, s.ax));
  const float dy = __fsub_rn(y, __fmaf_rn(t, s.aby, s.ay));
  const float dist = __fsqrt_rn(__fmaf_rn(dy, dy, __fadd_rn(__fmul_rn(dx, dx), 0.f)));
  const float cov = clampf(__fmul_rn(__fsub_rn(q.top, dist), q.inv_ramp), 0.f, 1.f);
  const float keep = __fsub_rn(1.f, cov);
  for (int ch = 0; ch < 3; ++ch) v[ch] = __fmaf_rn(v[ch], keep, __fmul_rn(s.col[ch], cov));
}

__device__ __forceinline__ unsigned char to_u8(float v) {
  const float r = clampf(rintf(v), 0.f, 255.f);
  return r == r ? (unsigned char)(int)r : 0;
}

// Slots s0 .. s0 + kSlots - 1 below nw into `slots`, each one's pixel span
// on each row of the run into `spans`, and a row's slots with a non-empty
// span as the bits of `painted`. Called by the whole block.
__device__ void stage_slots(const Params& q, int b, int s0, int nw, int r0, int rows, Slot* slots,
                            int2 (*spans)[kSlots], unsigned int* painted) {
  const int n = min(kSlots, nw - s0);
  __syncthreads();  // the tile before is painted
  for (int k = threadIdx.x; k < n; k += kThreads) slots[k] = load_slot(q, b, s0 + k);
  __syncthreads();
  // A warp a row, a lane a slot: every lane of a warp takes the same turns.
  for (int i = threadIdx.x; i < rows * kSlots; i += kThreads) {
    const int r = i / kSlots, k = i % kSlots;
    const int2 span = k < n ? slot_span(slots[k], r0 + r, q) : make_int2(0, -1);
    spans[r][k] = span;
    const unsigned int m = __ballot_sync(kFull, span.x <= span.y);
    if (k == 0) painted[r] = m;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) layout_raster_kernel(Params q) {
  // Dynamic: the run's output rows (stage_bytes, 16-byte aligned), then
  // rows x words bitsets: a row's toggles, then its inside bits.
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ float2 tile[kTile + 1];
  __shared__ Slot slots[kSlots];
  __shared__ int2 spans[kRows][kSlots];
  __shared__ unsigned int painted[kRows];  // the tile's slots with a non-empty span on the row

  unsigned char* stage = dyn;
  unsigned int* bits = reinterpret_cast<unsigned int*>(dyn + q.stage_bytes);
  const int b = blockIdx.x / q.row_blocks;
  const int r0 = (blockIdx.x - b * q.row_blocks) * q.rows;
  const int rows = min(q.rows, q.side - r0);
  const int tid = threadIdx.x;
  const float* vb = layout_row(q, b);
  const int* counts = reinterpret_cast<const int*>(vb + 2 * q.v + 7 * q.k);
  const int n = max(0, min(counts[0], q.v));
  const int nw = max(0, min(counts[1], q.k));

  for (int i = tid; i < rows * q.words; i += kThreads) bits[i] = 0u;

  // The fill's toggles: edge i runs from vertex i to vertex i + 1, the last
  // one back to vertex 0.
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int ne = min(kTile, n - t0);
    __syncthreads();  // the tile before is read (and the bitsets are zeroed)
    for (int i = tid; i <= ne; i += kThreads) {
      const int j = t0 + i < n ? t0 + i : 0;
      tile[i] = make_float2(to_img(vb[2 * j], q), to_img(vb[2 * j + 1], q));
    }
    __syncthreads();
    for (int e = tid; e < ne; e += kThreads) {
      const float2 a = tile[e], c = tile[e + 1];
      // Live rows lie in [ceil(min y), ceil(max y) - 1]; one row more on each
      // side, and every row of the run where a height is NaN.
      int first = 0, last = rows - 1;
      if (!isnan(a.y) && !isnan(c.y)) {
        const float lo = ceilf(fminf(a.y, c.y)) - (float)(r0 + 1);
        const float hi = ceilf(fmaxf(a.y, c.y)) - (float)r0;
        first = lo <= 0.f ? 0 : (lo >= (float)rows ? rows : (int)lo);
        last = hi < 0.f ? -1 : (hi >= (float)(rows - 1) ? rows - 1 : (int)hi);
      }
      for (int r = first; r <= last; ++r) {
        const float y = (float)(r0 + r);
        if ((a.y > y) != (c.y > y)) {
          const float dy = __fsub_rn(c.y, a.y);
          const float den = fabsf(dy) < 1e-12f ? 1e-12f : dy;
          const float xi = __fadd_rn(a.x, __fdiv_rn(__fmul_rn(__fsub_rn(y, a.y), __fsub_rn(c.x, a.x)), den));
          // Pixels x < xi: the first ceil(xi) of the row; none for xi <= 0 or NaN.
          const int cnt = !(xi > 0.f) ? 0 : (xi >= (float)q.side ? q.side : (int)ceilf(xi));
          if (cnt > 0) atomicXor(&bits[r * q.words + (cnt >> 5)], 1u << (cnt & 31));
        }
      }
    }
  }
  __syncthreads();  // the toggles are ready

  // Pixel x is inside when the toggles above x are odd: a suffix XOR, from the
  // row's last word down.
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < rows; r += kWarps) {
    unsigned int* row = bits + r * q.words;
    unsigned int above = 0u;  // parity of the toggles in the chunks of 32 words done
    for (int base = ((q.words - 1) >> 5) << 5; base >= 0; base -= 32) {
      const int w = base + lane;
      const unsigned int t = w < q.words ? row[w] : 0u;
      unsigned int s = t;  // bit i: XOR of t's bits i..31
      s ^= s >> 1;
      s ^= s >> 2;
      s ^= s >> 4;
      s ^= s >> 8;
      s ^= s >> 16;
      const unsigned int odd = __ballot_sync(kFull, __popc(t) & 1);
      const unsigned int higher = lane == 31 ? 0u : odd >> (lane + 1);
      const unsigned int carry = above ^ (unsigned int)(__popc(higher) & 1);
      if (w < q.words) row[w] = (s >> 1) ^ (carry ? kFull : 0u);
      above ^= (unsigned int)(__popc(odd) & 1);
    }
  }
  __syncthreads();

  // The pixels into the staged output rows: row y lands at output row
  // S - 1 - y, so the run's rows sit back to back in reverse order, the first
  // at the same offset modulo 16 as in the output. The block takes its turns
  // together, since a room of more than kSlots W/D/Os stages its tiles anew
  // for each turn.
  const int row_bytes = 3 * q.side;
  const long long start = ((long long)b * q.side + (q.side - r0 - rows)) * row_bytes;
  const int skew = (int)(((unsigned long long)q.out + start) & 15);
  const int tiles = (nw + kSlots - 1) / kSlots;
  int staged = -1;  // the tile of slots in shared memory
  for (int r = 0; r < rows; ++r) {
    const float yf = (float)(r0 + r);
    const unsigned int* inside = bits + r * q.words;
    unsigned char* row = stage + skew + (rows - 1 - r) * row_bytes;
    for (int x0 = 0; x0 < q.side; x0 += kThreads) {
      const int x = x0 + tid;
      const bool mine = x < q.side;
      float v[3];
      v[0] = v[1] = v[2] = mine && ((inside[x >> 5] >> (x & 31)) & 1u) ? 255.f : 0.f;
      for (int t = 0; t < tiles; ++t) {
        if (t != staged) {
          stage_slots(q, b, t * kSlots, nw, r0, rows, slots, spans, painted);
          staged = t;
        }
        for (unsigned int m = mine ? painted[r] : 0u; m; m &= m - 1) {
          const int k = __ffs(m) - 1;
          if (spans[r][k].x <= x && x <= spans[r][k].y) paint(v, slots[k], (float)x, yf, q);
        }
      }
      if (mine) {
        row[3 * x] = to_u8(v[0]);
        row[3 * x + 1] = to_u8(v[1]);
        row[3 * x + 2] = to_u8(v[2]);
      }
    }
  }
  __syncthreads();

  // The staged rows out, 16-byte stores between the ragged ends.
  const int total = rows * row_bytes;
  const int head = min((16 - skew) & 15, total);
  const int body = (total - head) & ~15;
  unsigned char* out = q.out + start;
  for (int i = tid; i < head; i += kThreads) out[i] = stage[skew + i];
  for (int i = head + 16 * tid; i < head + body; i += 16 * kThreads)
    *reinterpret_cast<uint4*>(out + i) = *reinterpret_cast<const uint4*>(stage + skew + i);
  for (int i = head + body + tid; i < total; i += kThreads) out[i] = stage[skew + i];
}

}  // namespace

// Draw B layout rasters into `out` (B, side, side, 3) u8 from `packed`, B
// contiguous (2V + 7K + 2) float32 rows of rendering/layout.py:pack_layouts.
// half_m, inv_mpp, top, inv_ramp: the plain version's float32 constants;
// reach: ceil(top) + 1.
extern "C" int salve_layout_raster(const float* packed, unsigned char* out, int b, int v, int k, int side,
                                   float half_m, float inv_mpp, float top, float inv_ramp, float reach,
                                   void* stream) {
  if (b < 0 || v < 0 || k < 0 || side < 1) return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaGetLastError();
  Params q;
  q.packed = packed;
  q.out = out;
  q.v = v;
  q.k = k;
  q.side = side;
  q.words = (side >> 5) + 1;  // toggle bits 0..side
  q.half_m = half_m;
  q.inv_mpp = inv_mpp;
  q.top = top;
  q.inv_ramp = inv_ramp;
  q.reach = reach;
  // As many rows a block as fit (kRows at the rasters the port draws).
  size_t smem = 0;
  for (q.rows = kRows; q.rows >= 1; --q.rows) {
    q.stage_bytes = (int)(((long long)q.rows * 3 * side + 16 + 15) / 16 * 16);
    smem = (size_t)q.stage_bytes + (size_t)q.rows * q.words * sizeof(unsigned int);
    if (smem <= (size_t)kMaxSmem) break;
  }
  if (q.rows < 1) return (int)cudaErrorInvalidValue;
  q.row_blocks = (side + q.rows - 1) / q.rows;
  const long long blocks = (long long)b * q.row_blocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // The default cap on dynamic shared memory is 48 KB less the static
  // (about 14 KB), so the kernel opts in to kMaxSmem at every call.
  const cudaError_t err =
      cudaFuncSetAttribute(layout_raster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  layout_raster_kernel<<<(unsigned int)blocks, kThreads, smem, (cudaStream_t)stream>>>(q);
  return (int)cudaGetLastError();
}
