// B1 — z-order splat: per-cell max of an int32 priority key.
//
// Replaces salve_tpu/ops/pallas_splat.py:splat_priority_grid_pallas (kernel
// _splat_kernel), whose per-image scalar read-modify-write loop never lowered
// on the TPU; the JAX package ran the same function as the XLA scatter-max of
// salve_tpu/ops/bev.py:splat_zorder_batched.
//
// What it computes: grid[b, c] = max over points i of image b with ok[b, i]
// and cell[b, i] == c of key[b, i], and -1 where no point landed. The kernel
// writes every cell itself: the caller passes an uninitialised grid.
// key = z_bin * N + i < 2^31 at every shape the path uses (N = 180,224).
//
// What bounds it on an H100: the points are read once (4 + 4 + 1 bytes each)
// and the grid is written once (4 bytes a cell): 22.5 MB at 4x1001^2, 10.5 MB
// at 4x501^2, 84 MB at 32x501^2, 6.7 / 3.1 / 25.1 us at 3.35 TB/s. Every
// accepted point is also an atomic max on a cell (524,204 of 4x180,224
// points, on 224,133 cells). The card does about 4.2e11 atomicMax a second
// into L2 when a warp's 32 meet in one line, but only about 8.8e10 when
// they spread over lines (chip_smoke.py phase 4), and the splat's do
// spread: at that rate the accepted points alone take 6 us at B = 4 and
// 40-45 us at 32x501^2. A fill pass of its own in front of the atomics
// would pay the grid twice: once to write -1, once more when the atomics
// read, modify and write the same lines.
//
// Design: one cooperative launch of 3 blocks of 512 threads an SM, all
// resident at once (no separate fill pass, no second launch).
//   * Step 1: each block writes -1 over its stripe of the flat grid with
//     16-byte stores; then a grid-wide barrier (cg::this_grid().sync()), so
//     no atomic lands on a cell before it holds -1. Each warp loads its
//     first window of points before the barrier, so their latency hides
//     behind it.
//   * Step 2: each warp strides over windows of 128 consecutive points of
//     the flat (B * N) list, in 4 rounds of 32: lane l takes point
//     32 * round + l, so each load of cell, key and ok is one coalesced
//     request, and the three are issued together (no dependent chain),
//     marked evict-first so the streaming points do not push the grid out
//     of L2. A window may straddle two images; a point's image is its
//     index / N, and the last window stops at B * N.
//   * Neighbouring pano pixels often land in one cell, and an atomic into
//     L2 costs about as much whether 1 or 32 lanes' keys meet in it. So in
//     each round the lanes merge runs of equal (image, cell) with a
//     segmented max-scan over the warp (5 shuffle steps), and only the last
//     lane of a run sends one atomicMax, of the run's largest key: 524,204
//     accepted points at 4x1001^2 send 322,082 atomics. Max is order-free,
//     so the result is bit-exact whatever order the atomics land in.
//
// The design kept from two built and timed alike (PERF.md section 6): the other
// held an image's grid in a thread block cluster's distributed shared memory
// (one cluster of 16 blocks an image band, each point an atomicMax into the
// owning block's shared memory). It lost at every shape: remote atomics run
// at about 7.1e10 a second, no faster than spread L2 atomics, and at B = 4
// only 4 to 8 clusters, 64 to 128 SMs, share them.
//
// salve_l2_atomic_probe and salve_dsmem_atomic_probe are not part of the
// port: they measure the card's rate of int32 atomicMax into an L2-resident
// grid and into the shared memory of a cluster's blocks (no other memory
// traffic), so a caller can state B1's atomic bounds beside its byte bound.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
// Blocks an SM at most: a fourth fits (32 registers a thread) but makes the
// grid barrier dearer than it gains (timed on an H100).
constexpr int kBlocksPerSm = 3;
constexpr int kProbeThreads = 1024;

__device__ __forceinline__ bool kept(unsigned ok, int c, int hw) {
  return ok != 0 && c >= 0 && c < hw;  // callers mask these; never write
}

// One window: 4 rounds of 32 consecutive points, lane l holding point
// base + 32 * j + l of round j.
struct Window {
  int cell[4], key[4];
  bool ok[4];
};

__device__ __forceinline__ Window load_window(const int* __restrict__ cell,
                                              const int* __restrict__ key,
                                              const unsigned char* __restrict__ ok,
                                              unsigned base, unsigned total,
                                              unsigned lane) {
  Window w;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned i = base + 32 * j + lane;
    const bool in = i < total;
    w.cell[j] = in ? __ldcs(cell + i) : -1;
    w.key[j] = in ? __ldcs(key + i) : -1;
    w.ok[j] = in && __ldcs(ok + i);
  }
  return w;
}

// Each round: a segmented max-scan merges lanes of equal (image, cell)
// (g, the flat grid index); the last lane of each run sends the atomic.
// Warp-uniform: every lane of the warp calls it.
__device__ __forceinline__ void splat_window(int* __restrict__ grid, const Window& w,
                                             unsigned base, unsigned n, int hw,
                                             unsigned lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned i = base + 32 * j + lane;
    const bool kp = kept(w.ok[j], w.cell[j], hw);
    const int g = kp ? (int)(i / n) * hw + w.cell[j] : -1 - (int)lane;  // unique when dropped
    int v = w.key[j];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int g_up = __shfl_up_sync(0xffffffffu, g, d);
      const int v_up = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= (unsigned)d && g_up == g) v = max(v, v_up);
    }
    const int g_next = __shfl_down_sync(0xffffffffu, g, 1);
    if (kp && (lane == 31 || g_next != g)) atomicMax(grid + g, v);
  }
}

// Cooperative launch; B * N and B * H * W below 2^31 (salve_splat_max checks).
__global__ void __launch_bounds__(kThreads)
    splat_max_kernel(const int* __restrict__ cell, const int* __restrict__ key,
                     const unsigned char* __restrict__ ok,
                     int* __restrict__ grid, int b, int n, int hw) {
  const long long cells = (long long)b * hw;
  const unsigned total = (unsigned)b * (unsigned)n;
  const unsigned lane = threadIdx.x & 31;
  const unsigned warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const unsigned warps = (gridDim.x * blockDim.x) >> 5;
  Window w = load_window(cell, key, ok, warp * 128, total, lane);

  // Step 1: this block's stripe of the grid to -1.
  const long long quads = cells >> 2;
  const long long per = (quads + gridDim.x - 1) / gridDim.x;
  const long long q0 = blockIdx.x * per, q1 = min(q0 + per, quads);
  int4* grid4 = reinterpret_cast<int4*>(grid);
  for (long long q = q0 + threadIdx.x; q < q1; q += blockDim.x)
    grid4[q] = make_int4(-1, -1, -1, -1);
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t < (cells & 3)) grid[(cells & ~3LL) + t] = -1;
  cg::this_grid().sync();

  // Step 2: the points, a window of 128 a warp at a time.
  for (unsigned base = warp * 128; base < total; base += warps * 128) {
    if (base != warp * 128) w = load_window(cell, key, ok, base, total, lane);
    splat_window(grid, w, base, (unsigned)n, hw, lane);
  }
}

// Atomic i goes to cell (i * stride) % cells: stride 1 packs a warp's 32
// atomics into adjacent words, a large prime stride spreads them over lines.
__global__ void l2_atomic_probe_kernel(int* __restrict__ grid, long long cells,
                                       long long total, long long stride) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  atomicMax(&grid[(i * stride) % cells], (int)(i & 0x7fffffff));
}

// Each thread sends `per_thread` atomicMax to pseudo-random cells of
// pseudo-random blocks of its cluster (block_cells int32 a block).
__global__ void __launch_bounds__(kProbeThreads)
    dsmem_atomic_probe_kernel(int block_cells, int per_thread) {
  extern __shared__ int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned csize = cluster.num_blocks();
  for (int j = threadIdx.x; j < block_cells; j += blockDim.x) smem[j] = 0;
  cluster.sync();
  unsigned h = (blockIdx.x * blockDim.x + threadIdx.x) * 2654435761u + 1u;
#pragma unroll 4
  for (int i = 0; i < per_thread; ++i) {
    h = h * 1664525u + 1013904223u;
    int* owner = cluster.map_shared_rank(smem, __umulhi(h, csize));
    atomicMax(owner + __umulhi(h * 2654435761u, (unsigned)block_cells), i);
  }
  cluster.sync();  // no block leaves while another may write into it
}

cudaError_t resident_blocks(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, splat_max_kernel,
                                                        kThreads, 0);
  *out = sms * min(per_sm, kBlocksPerSm);
  return err;
}

}  // namespace

// One cooperative launch of SMs x (resident blocks an SM, at most 3) blocks.
extern "C" int salve_splat_max(const int* cell, const int* key,
                               const unsigned char* ok, int* grid, int b,
                               int n, int hw, void* stream) {
  if (b <= 0 || hw <= 0) return 0;
  if ((long long)b * n >= (1LL << 31) || (long long)b * hw >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = resident_blocks(&blocks);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&cell, (void*)&key, (void*)&ok, (void*)&grid,
                  (void*)&b,    (void*)&n,   (void*)&hw};
  err = cudaLaunchCooperativeKernel((void*)splat_max_kernel, dim3(blocks),
                                    dim3(kThreads), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The number of blocks B1 launches.
extern "C" int salve_splat_max_blocks(int* out) { return (int)resident_blocks(out); }

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

// As many clusters of `cluster` blocks (block_cells int32 of shared memory
// each) as the card holds at once, each of their 1024 threads sending
// per_thread atomics; *n_clusters gets the number of clusters launched.
extern "C" int salve_dsmem_atomic_probe(int cluster, int block_cells,
                                        int per_thread, int* n_clusters,
                                        void* stream) {
  const int smem = block_cells * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      dsmem_atomic_probe_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dsmem_atomic_probe_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3(kProbeThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(n_clusters, (void*)dsmem_atomic_probe_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (*n_clusters <= 0) return (int)cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3((unsigned)(cluster * *n_clusters), 1, 1);
  err = cudaLaunchKernelEx(&cfg, dsmem_atomic_probe_kernel, block_cells, per_thread);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
