// B3 — 3-shear nearest-neighbour Sim(2) warp of packed rgb888 banks.
//
// Replaces salve_tpu/ops/pallas_warp.py:warp_bank_sim2_shear_pallas_v2
// (kernel _warp_kernel_v2_factory; v1, warp_bank_sim2_shear_pallas, computes
// the same function). Oracle: salve_tpu/ops/warp.py:warp_bank_sim2_shear.
//
// What it computes: out[b] = unpack_u8(flip(rot90^n(T1))) where, with D the
// output side and S the bank side,
//   T1[v, u] = I2[v, u + starts3[v]]        0 unless 0 <= . < x3
//   I2[v, x] = I1[v + starts2[x], x]        0 unless 0 <= . < y2
//   I1[y, x] = srcp[row0 + y, x + starts1[y]], 0 outside the S x S source
//   srcp[r]  = bank[idx[b], S - 1 - r]
// The integer parameters (n, row0, starts1/2/3, x3, y2) come from the plain
// PyTorch port of salve_tpu/ops/warp.py:350-397 outside the kernel, as in
// JAX, so the kernel and the plain three-pass version agree element for
// element.
//
// What bounds it on an H100: it writes B*D*D*3 bytes and gathers at most
// B*D*D*4 bytes of bank (the per-row parameters are a few KB and stay in
// L1/L2) — tens of MB at B = 32, D = 501: a bandwidth-bound gather.
//
// Design: none of the TPU kernel's Mosaic workarounds (power-of-two lanes,
// barrel rolls, 128x128 VMEM transposes). One thread per stored output pixel
// follows the three passes backwards to its single source read, applying the
// same zero rule at every pass, and writes the three u8 channels. No
// intermediate plane touches memory. The bank is read in place through a
// (B,) row index, so no (B, S, S) copy of the per-hypothesis sources is made.

#include <cuda_runtime.h>

namespace {

__global__ void shear_warp_kernel(const int* __restrict__ bank,
                                  const long long* __restrict__ idx,
                                  const int* __restrict__ rot_n,
                                  const int* __restrict__ row0,
                                  const int* __restrict__ starts1,
                                  const int* __restrict__ starts2,
                                  const int* __restrict__ starts3,
                                  unsigned char* __restrict__ out,
                                  long long total, int p, int s, int d,
                                  int x3, int y2) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int col = (int)(t % d);
  const int row = (int)((t / d) % d);
  const int b = (int)(t / ((long long)d * d));

  // Stored row -> pre-flip row, then undo the rot90^n permutation.
  const int i = d - 1 - row, j = col;
  int v, u;
  switch (rot_n[b]) {
    case 0: v = i; u = j; break;
    case 1: v = j; u = d - 1 - i; break;
    case 2: v = d - 1 - i; u = d - 1 - j; break;
    default: v = d - 1 - j; u = i; break;
  }

  int val = 0;
  // A row outside the bank reads as empty, as in ops/warp.py:shear_warp_plain.
  const long long page = idx[b];
  const int x = u + starts3[(long long)b * d + v];  // pass 3
  if (x >= 0 && x < x3) {
    const int y = v + starts2[(long long)b * x3 + x];  // pass 2
    if (y >= 0 && y < y2) {
      const int sr = row0[b] + y;  // pass 1
      const int sc = x + starts1[(long long)b * y2 + y];
      if (page >= 0 && page < p && sr >= 0 && sr < s && sc >= 0 && sc < s) {
        val = bank[(page * s + (s - 1 - sr)) * (long long)s + sc];
      }
    }
  }
  out[3 * t] = (unsigned char)((val >> 16) & 0xFF);
  out[3 * t + 1] = (unsigned char)((val >> 8) & 0xFF);
  out[3 * t + 2] = (unsigned char)(val & 0xFF);
}

}  // namespace

extern "C" int salve_shear_warp(const int* bank, const long long* idx,
                                const int* rot_n, const int* row0,
                                const int* starts1, const int* starts2,
                                const int* starts3, unsigned char* out, int b,
                                int p, int s, int d, int x3, int y2,
                                void* stream) {
  long long total = (long long)b * d * d;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    shear_warp_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        bank, idx, rot_n, row0, starts1, starts2, starts3, out, total, p, s,
        d, x3, y2);
  }
  return (int)cudaGetLastError();
}
