// B1 — z-order splat: per-cell max of an int32 priority key.
//
// Replaces salve_tpu/ops/pallas_splat.py:splat_priority_grid_pallas (kernel
// _splat_kernel), whose per-image scalar read-modify-write loop never lowered
// on the TPU; the JAX package ran the same function as the XLA scatter-max of
// salve_tpu/ops/bev.py:splat_zorder_batched.
//
// What it computes: grid[b, c] = max over points i of image b with ok[b, i]
// and cell[b, i] == c of key[b, i]; the wrapper fills grid with -1 first.
// key = z_bin * N + i < 2^31 at every shape the path uses (N = 180,224).
//
// What bounds it on an H100: the points are read once (4 + 4 + 1 bytes each)
// and the grid is written once (4 bytes a cell), but every accepted point is
// an atomic read-modify-write on a random cell. A 501^2 or 1001^2 int32 grid
// (1-4 MB per image) stays in the 50 MB L2, so the rate of L2 atomics, not
// HBM bandwidth, is the expected limit.
//
// Design: one thread per point, coalesced reads of cell/key/ok, and one
// atomicMax per accepted point. Max is order-free, so the result is bit-exact
// whatever order the atomics land in.
//
// salve_l2_atomic_probe is not part of the port: it measures the card's rate
// of int32 atomicMax into an L2-resident grid (no other memory traffic), so
// a caller can state B1's L2-atomic bound beside its HBM bound.

#include <cuda_runtime.h>

namespace {

__global__ void splat_max_kernel(const int* __restrict__ cell,
                                 const int* __restrict__ key,
                                 const unsigned char* __restrict__ ok,
                                 int* __restrict__ grid,
                                 long long total, int n, int hw) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  if (!ok[i]) return;
  int c = cell[i];
  if (c < 0 || c >= hw) return;  // callers mask these; never write outside
  long long b = i / n;
  atomicMax(&grid[b * hw + c], key[i]);
}

// Atomic i goes to cell (i * stride) % cells: stride 1 packs a warp's 32
// atomics into adjacent words, a large prime stride spreads them over lines.
__global__ void l2_atomic_probe_kernel(int* __restrict__ grid, long long cells,
                                       long long total, long long stride) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  atomicMax(&grid[(i * stride) % cells], (int)(i & 0x7fffffff));
}

}  // namespace

extern "C" int salve_splat_max(const int* cell, const int* key,
                               const unsigned char* ok, int* grid, int b,
                               int n, int hw, void* stream) {
  long long total = (long long)b * n;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    splat_max_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        cell, key, ok, grid, total, n, hw);
  }
  return (int)cudaGetLastError();
}

extern "C" int salve_l2_atomic_probe(int* grid, long long cells,
                                     long long total, long long stride,
                                     void* stream) {
  if (total > 0 && cells > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    l2_atomic_probe_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(grid, cells, total,
                                                     stride);
  }
  return (int)cudaGetLastError();
}
