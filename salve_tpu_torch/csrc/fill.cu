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
//   then every cell whose 11x11 count of support cells is 0 is zeroed
//   (support = all three channels of the u8-quantized sparse image > 0, given
//   by the caller; the count is fused here).
// box3 keeps the add order of pallas_fill.py:_box_sum — rows first,
// (x[y] + x[y-1]) + x[y+1], then columns the same way — and every add,
// product and quotient is an explicitly rounded IEEE op (__fadd_rn, ...), so
// nvcc cannot contract them into FMAs: the output matches the plain version
// bit for bit. The library must not be built with --use_fast_math.
//
// What bounds it on an H100: each cell is read once (12 B of colour, 1 B of
// occupancy, 1 B of support) and written once (12 B); ~220 float operations a
// cell over the six rounds and the mask are far below the card's rate, so
// the bound is the ~26 B a cell of HBM traffic.
//
// Design: one block per 32x32 output tile of one image. The block stages a
// halo of FILL_ITERS cells (a 44x44 tile) of occupancy and the three colour
// planes in shared memory and runs all six rounds there, so the fixed point
// never round-trips through HBM (the same idea as the TPU kernel's VMEM
// residency, at a tile that fits an SM). Each round loses one valid ring at
// the stage border; after six rounds exactly the 32x32 centre is right.
// Cells outside the image stay unoccupied and zero in every round (the
// `valid` plane of the TPU kernel), which is what gives zero-padded
// convolution semantics at the image border.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kIters = 6;  // salve_tpu/ops/bev.py:FILL_ITERS
constexpr int kMaskR = 5;  // DEFAULT_MASK_KERNEL = 11
constexpr int kStage = kTile + 2 * kIters;  // 44
constexpr int kPlane = kStage * kStage;
constexpr int kThreads = 256;
constexpr size_t kSmemBytes = 8 * kPlane * sizeof(float) + kTile * kTile;

static_assert(kIters >= kMaskR, "the halo must cover the mask radius");

__device__ __forceinline__ float at(const float* p, int y, int x) {
  return (y < 0 || y >= kStage || x < 0 || x >= kStage) ? 0.f
                                                        : p[y * kStage + x];
}

__global__ void __launch_bounds__(kThreads)
fill_mask_kernel(const float* __restrict__ sparse,
                 const unsigned char* __restrict__ occ_in,
                 const unsigned char* __restrict__ support,
                 float* __restrict__ out, int h, int w) {
  extern __shared__ float smem[];
  float* o = smem;                 // occupancy
  float* im = smem + kPlane;       // 3 colour planes
  float* to = smem + 4 * kPlane;   // row sums of o (support, for the mask)
  float* tc = smem + 5 * kPlane;   // 3 row sums of im * o
  unsigned char* mask = reinterpret_cast<unsigned char*>(smem + 8 * kPlane);

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTile - kIters;
  const int x0 = blockIdx.x * kTile - kIters;
  const long long img_base = (long long)b * h * w;

  for (int i = threadIdx.x; i < kPlane; i += kThreads) {
    int gy = y0 + i / kStage, gx = x0 + i % kStage;
    float ov = 0.f, sv = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      long long p = img_base + (long long)gy * w + gx;
      ov = occ_in[p] ? 1.f : 0.f;
      sv = support[p] ? 1.f : 0.f;
      c0 = sparse[3 * p];
      c1 = sparse[3 * p + 1];
      c2 = sparse[3 * p + 2];
    }
    o[i] = ov;
    to[i] = sv;
    im[i] = c0;
    im[kPlane + i] = c1;
    im[2 * kPlane + i] = c2;
  }
  __syncthreads();

  // 11x11 support count of the output tile: column sums, then row sums.
  // 0/1 data, so the sums are exact in any order.
  for (int i = threadIdx.x; i < kTile * kStage; i += kThreads) {
    int sy = kIters + i / kStage, sx = i % kStage;
    float s = 0.f;
    for (int d = -kMaskR; d <= kMaskR; ++d) s += at(to, sy + d, sx);
    tc[sy * kStage + sx] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    int sy = kIters + i / kTile, sx = kIters + i % kTile;
    float s = 0.f;
    for (int d = -kMaskR; d <= kMaskR; ++d) s += tc[sy * kStage + sx + d];
    mask[i] = s > 0.5f;
  }
  __syncthreads();

  for (int it = 0; it < kIters; ++it) {
    // Row pass: (x[y] + x[y-1]) + x[y+1] of occ and of img_c * occ.
    for (int i = threadIdx.x; i < kPlane; i += kThreads) {
      int y = i / kStage, x = i % kStage;
      float om = at(o, y - 1, x), oc = o[i], op = at(o, y + 1, x);
      to[i] = __fadd_rn(__fadd_rn(oc, om), op);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* p = im + c * kPlane;
        float pc = __fmul_rn(p[i], oc);
        float pm = __fmul_rn(at(p, y - 1, x), om);
        float pp = __fmul_rn(at(p, y + 1, x), op);
        tc[c * kPlane + i] = __fadd_rn(__fadd_rn(pc, pm), pp);
      }
    }
    __syncthreads();
    // Column pass and update; each thread writes only its own cells.
    for (int i = threadIdx.x; i < kPlane; i += kThreads) {
      int y = i / kStage, x = i % kStage;
      int gy = y0 + y, gx = x0 + x;
      if (gy < 0 || gy >= h || gx < 0 || gx >= w) continue;  // stays 0
      float den = __fadd_rn(__fadd_rn(to[i], at(to, y, x - 1)), at(to, y, x + 1));
      float den1 = fmaxf(den, 1.f);
      bool keep = o[i] > 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* t = tc + c * kPlane;
        float num = __fadd_rn(__fadd_rn(t[i], at(t, y, x - 1)), at(t, y, x + 1));
        if (!keep) im[c * kPlane + i] = __fdiv_rn(num, den1);
      }
      o[i] = fmaxf(o[i], fminf(fmaxf(den, 0.f), 1.f));
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    int ty = i / kTile, tx = i % kTile;
    int gy = y0 + kIters + ty, gx = x0 + kIters + tx;
    if (gy >= h || gx >= w) continue;
    int s = (kIters + ty) * kStage + kIters + tx;
    long long p = img_base + (long long)gy * w + gx;
    bool m = mask[i];
    out[3 * p] = m ? im[s] : 0.f;
    out[3 * p + 1] = m ? im[kPlane + s] : 0.f;
    out[3 * p + 2] = m ? im[2 * kPlane + s] : 0.f;
  }
}

}  // namespace

extern "C" int salve_fill_mask(const float* sparse, const unsigned char* occ,
                               const unsigned char* support, float* out, int b,
                               int h, int w, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fill_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (b > 0 && h > 0 && w > 0) {
    dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, b);
    fill_mask_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        sparse, occ, support, out, h, w);
  }
  return (int)cudaGetLastError();
}
