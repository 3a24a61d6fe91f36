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
// element. One launch warps one or two banks (the ceiling and the floor of a
// batch) that share the rows and the parameters.
//
// What bounds it on an H100: it writes B*D*D*3 bytes a bank and gathers at
// most B*D*D*4 bytes of each bank (the per-row parameters are a few KB) —
// tens of MB at B = 32, D = 501: a bandwidth-bound gather.
//
// Design: tiles of T1 in its own (v, u) frame, 32x32, before the rot90 and
// the flip, lanes along u. Then starts3[v] is one value a warp row,
// x = u + starts3[v] runs over consecutive lanes, and starts2 moves by at
// most one between neighbouring x (|sin phi| <= sin 45 deg), so a warp reads
// neighbouring words of one or two bank rows. A block owns a band of 32 rows
// v and a run of kUTiles tiles along u. It first stages the hypothesis's
// whole starts2 and starts1 rows (x3 + y2 ints, 7 KB at D = 501) and the
// band's starts3 in shared memory, all in one round of loads, so the tile
// loop waits on nothing but the bank reads. Each thread follows the three
// passes back to one bank word for each of its four rows and reads it from
// every bank at the same offset, all reads issued together, and a tile's
// reads are in flight while the tile before it is stored. The packed
// results go to a shared tile; the tile lands at its rot90/flip-mapped place
// in the output, read back transposed for n = 1, 3: a warp writes a stored
// row segment as whole 4-byte words on neighbouring addresses (4 pixels in 3
// words), each assembled from the two tile pixels it overlaps; only the
// bytes that share a word with the next tile are written one by one. The
// kernel is compiled for one bank and for two, so a single-bank launch
// carries no second tile. (Measured on an H100: a per-block 32x32 tile with
// its own staging chain, or the output bytes staged in shared memory, ran
// slower; see PERF.md.)

#include <cuda_runtime.h>

namespace {

constexpr int kT = 32;         // tile side in T1's (v, u) frame
constexpr int kThreads = 256;  // 8 warps, 4 tile rows each
constexpr int kRowsPerWarp = kT / (kThreads / 32);
constexpr int kUTiles = 2;     // tiles a block walks along u
constexpr int kMaxBanks = 2;

// Packed 0x00RRGGBB -> its bytes in stored order: R, G, B from the low byte.
__device__ __forceinline__ unsigned stream_bytes(unsigned px) {
  return __byte_perm(px, 0u, 0x4012);
}

template <int kBanks>
__global__ void __launch_bounds__(kThreads)
shear_warp_kernel(const int* __restrict__ bank0, const int* __restrict__ bank1,
                  const long long* __restrict__ idx,
                  const int* __restrict__ rot_n,
                  const int* __restrict__ row0,
                  const int* __restrict__ starts1,
                  const int* __restrict__ starts2,
                  const int* __restrict__ starts3,
                  unsigned char* __restrict__ out0,
                  unsigned char* __restrict__ out1, int p, int s, int d,
                  int x3, int y2) {
  extern __shared__ int starts[];  // starts2[b] (x3 ints), then starts1[b] (y2 ints)
  __shared__ int s3[kT];
  __shared__ unsigned tile[kBanks][kT][kT + 1];
  int* s2 = starts;
  int* s1 = starts + x3;

  const int b = blockIdx.z;
  const int v0 = blockIdx.y * kT, nv = min(kT, d - v0);
  const int u_begin = blockIdx.x * kT * kUTiles, u_end = min(d, u_begin + kT * kUTiles);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < x3; i += kThreads) s2[i] = starts2[(long long)b * x3 + i];
  for (int i = tid; i < y2; i += kThreads) s1[i] = starts1[(long long)b * y2 + i];
  if (tid < kT) s3[tid] = tid < nv ? starts3[(long long)b * d + v0 + tid] : 0;
  const long long page = idx[b];
  const bool in_bank = page >= 0 && page < p;
  const int r0 = row0[b];
  const int n = rot_n[b];
  __syncthreads();

  // T1 over a tile, lanes along u: each thread's kRowsPerWarp bank words of
  // every bank, all loads issued before any is used.
  auto gather = [&](int u0, unsigned (&val)[kBanks][kRowsPerWarp]) {
    const int u = u0 + lane;
    long long off[kRowsPerWarp];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int vl = warp * kRowsPerWarp + k;
      const int v = v0 + vl;
      off[k] = -1;
      if (vl < nv && u < d && in_bank) {
        const int x = u + s3[vl];  // pass 3
        if (x >= 0 && x < x3) {
          const int y = v + s2[x];  // pass 2
          if (y >= 0 && y < y2) {
            const int sr = r0 + y;  // pass 1
            const int sc = x + s1[y];
            if (sr >= 0 && sr < s && sc >= 0 && sc < s)
              off[k] = (page * s + (s - 1 - sr)) * (long long)s + sc;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      val[0][k] = off[k] >= 0 ? (unsigned)__ldg(bank0 + off[k]) : 0u;
      if (kBanks > 1) val[kBanks - 1][k] = off[k] >= 0 ? (unsigned)__ldg(bank1 + off[k]) : 0u;
    }
  };

  unsigned val[kBanks][kRowsPerWarp];
  gather(u_begin, val);
  for (int u0 = u_begin; u0 < u_end; u0 += kT) {
    const int nu = min(kT, d - u0);
#pragma unroll
    for (int bk = 0; bk < kBanks; ++bk)
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) tile[bk][warp * kRowsPerWarp + k][lane] = val[bk][k];
    __syncthreads();
    // The next tile's bank reads are in flight while this one is stored.
    if (u0 + kT < u_end) gather(u0 + kT, val);

    // The tile's place in the stored output: rows [R0, R0 + nr) and columns
    // [C0, C0 + nc); the tile cell of its pixel (r, c) is vl * (kT + 1) + ul =
    // base + r * dr + c * dc (flip + rot90^n).
    const bool rows_are_v = (n & 1) == 0;
    const int nr = rows_are_v ? nv : nu, nc = rows_are_v ? nu : nv;
    constexpr int kP = kT + 1;
    int R0, C0, base, dr, dc;
    switch (n) {
      case 0: R0 = d - v0 - nv; C0 = u0; base = (nv - 1) * kP; dr = -kP; dc = 1; break;
      case 1: R0 = u0; C0 = v0; base = 0; dr = 1; dc = kP; break;
      case 2: R0 = v0; C0 = d - u0 - nu; base = nu - 1; dr = kP; dc = -1; break;
      default: R0 = d - u0 - nu; C0 = d - v0 - nv; base = (nv - 1) * kP + nu - 1; dr = -1; dc = -kP; break;
    }

    // One warp a stored row: each lane one whole 4-byte word, assembled from
    // the two tile pixels it overlaps; the bytes that share a word with the
    // next tile are written one by one.
    const long long B_first = 3 * (((long long)b * d + R0) * d + C0);  // row 0's first byte
    for (int r = warp; r < nr; r += kThreads / 32) {
      const long long B0 = B_first + 3LL * d * r, B1 = B0 + 3 * nc;
      const long long W0 = (B0 + 3) & ~3LL, W1 = B1 & ~3LL;
      const int n_words = W0 < W1 ? (int)((W1 - W0) >> 2) : 0;
      const int head = n_words ? (int)(W0 - B0) : (int)(B1 - B0);
      const int tail = n_words ? (int)(B1 - W1) : 0;
      const int a = base + r * dr;
      if (lane < n_words) {
        const int k = (int)(W0 - B0) + 4 * lane;  // byte of the row segment
        const int c = k / 3, j = k - 3 * c;
#pragma unroll
        for (int bk = 0; bk < kBanks; ++bk) {
          const unsigned* t = &tile[bk][0][0];
          const unsigned long long two =
              stream_bytes(t[a + c * dc]) | ((unsigned long long)stream_bytes(t[a + (c + 1) * dc]) << 24);
          *reinterpret_cast<unsigned*>((bk == 0 ? out0 : out1) + B0 + k) = (unsigned)(two >> (8 * j));
        }
      } else if (lane < n_words + head + tail) {
        const int e = lane - n_words;
        const int k = e < head ? e : (int)(W1 - B0) + (e - head);
#pragma unroll
        for (int bk = 0; bk < kBanks; ++bk)
          (bk == 0 ? out0 : out1)[B0 + k] =
              (unsigned char)(stream_bytes(tile[bk][0][a + (k / 3) * dc]) >> (8 * (k % 3)));
      }
    }
    __syncthreads();  // the next tile reuses the shared tile
  }
}

}  // namespace

extern "C" int salve_shear_warp(const int* bank0, const int* bank1,
                                const long long* idx, const int* rot_n,
                                const int* row0, const int* starts1,
                                const int* starts2, const int* starts3,
                                unsigned char* out0, unsigned char* out1,
                                int n_banks, int b, int p, int s, int d, int x3,
                                int y2, void* stream) {
  if (n_banks < 1 || n_banks > kMaxBanks) return (int)cudaErrorInvalidValue;
  if (b > 0 && d > 0) {
    const size_t smem = (size_t)(x3 + y2) * sizeof(int);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          shear_warp_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            shear_warp_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const int n_v = (d + kT - 1) / kT, n_u = (d + kT * kUTiles - 1) / (kT * kUTiles);
    dim3 grid(n_u, n_v, b);
    if (n_banks == 1)
      shear_warp_kernel<1><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
          bank0, bank0, idx, rot_n, row0, starts1, starts2, starts3, out0, out0, p, s, d, x3, y2);
    else
      shear_warp_kernel<2><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
          bank0, bank1, idx, rot_n, row0, starts1, starts2, starts3, out0, out1, p, s, d, x3, y2);
  }
  return (int)cudaGetLastError();
}
