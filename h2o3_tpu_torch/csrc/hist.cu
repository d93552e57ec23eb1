// Kernel B1: per-(node, column, bin) histogram of the row stat lanes.
//
// Replaces the Pallas TPU kernel h2o3_tpu/ops/hist_pallas.py::_hist_kernel
// (driven by hist_pallas_local). That kernel recasts the scatter as a
// one-hot x stats product on the TPU's 128x128 matrix unit; on Hopper that
// would turn a scatter into wasted tensor-core work, so B1 is a scatter into
// shared memory (the gpu_hist shape, arXiv:1706.08359).
//
// out[node, col, bin, s] = sum of stats[row, s] over the rows with
//     nid[row] == node and bins[row, col] == bin
// Rows with nid < 0 or nid >= N add nothing, and neither do codes >= B.
//
// Layout: bins u8 (n, C) row-major, nid i32 (n,), stats f32 (n, S) with
// 1 <= S <= 4, out f32 (N, C, B, S) - the dense layout the split kernels
// (B2, B3) read with one thread block per (node, column).
//
// What bounds it on an H100: by bytes, 4n for nid read once (a lower bound:
// the compaction below reads it three times) plus C + 4S for each active
// row and 4NCBS written (44 MB at 1M x 28, S = 3, all rows active:
// ~13 us at 3.35 TB/s). In practice the C x S shared-memory float atomics
// of each active row bound it: on sm_90 each is a compare-and-swap loop
// (ATOMS.CAST.SPIN), and the card runs 410-430 of them per ns. The first
// design also walked every row of its stripe once per node tile (reading
// nid 28x at 32 nodes), loaded codes at a 28-byte stride per thread, and
// merged with ~6M contended global float atomics per launch. The design
// here, one launch being four kernels on the caller's stream:
//
// 1. b1_compact_count / b1_compact_scatter (the compaction, a kernel of its
//    own with its own wrapper): count the rows of each node, scan the counts,
//    and scatter the row ids grouped by node. The two kernels read nid three
//    times in all (count; count again, then scatter), 12n bytes against the
//    old design's once per node tile; a dead sibling row costs those reads
//    and nothing more.
// 2. b1_hist_tile: the active rows are cut into equal ranges of compacted
//    positions, one per thread-block cluster, so the work is balanced
//    whatever the node sizes. The wrapper sizes the grid to Q clusters, one
//    wave of the card; only the first min(Q, n_active) take rows, so every
//    cluster that takes part has a non-empty range. A cluster walks the node
//    tiles its range touches (nt nodes x cg columns of shared-memory
//    histogram per block); its blocks split each node's rows, lanes of a
//    warp read neighbouring 4-byte words of one row's codes, and every
//    update is a shared-memory atomic. Per tile the cluster sums its blocks'
//    histograms through distributed shared memory and one partial goes to
//    scratch, at slot (cluster + tile): a cluster's range and a tile's rows
//    are both contiguous, so no two (cluster, tile) pairs that meet share a
//    slot.
// 3. b1_hist_reduce: each output cell sums the partials of the clusters that
//    met its tile, in cluster order, and writes the cell: no global atomics
//    and no memset of the output.
// The float sums are not reproducible from run to run: the scatter reserves
// each block's run inside a node with a global atomic, so which rows a
// cluster sums changes between runs, and the shared-memory atomics inside a
// block add in any order. Sums of integer-valued stats are exact.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace coop = cooperative_groups;

namespace {

// Shared memory over one block's limit is refused by cudaFuncSetAttribute;
// the wrapper (ops/hist_cuda.py) holds the limit and checks it first.
constexpr int kHistThreads = 512;

// ---- compaction -----------------------------------------------------------

constexpr int kCompactUnroll = 4;  // nid loads in flight per thread

// Loads the nids of rows b0 + u * blockDim.x + threadIdx.x (u < unroll),
// -1 past r1 and for rows outside [0, N).
__device__ __forceinline__ void load_nids(const int32_t* __restrict__ nid,
                                          long long b0, long long r1, int N,
                                          int* v) {
#pragma unroll
  for (int u = 0; u < kCompactUnroll; ++u) {
    const long long r = b0 + (long long)u * blockDim.x + threadIdx.x;
    v[u] = r < r1 ? nid[r] : -1;
    if ((unsigned)v[u] >= (unsigned)N) v[u] = -1;
  }
}

// Adds the rows [r0, r1) with 0 <= nid < N into the shared counters `cnt`,
// one atomic per distinct node of each warp. The loop is uniform over the
// block, so every lane of a warp reaches the match.
__device__ __forceinline__ void count_rows(const int32_t* __restrict__ nid,
                                           long long r0, long long r1, int N,
                                           int* cnt) {
  const int lane = threadIdx.x & 31;
  for (long long b0 = r0; b0 < r1; b0 += kCompactUnroll * blockDim.x) {
    int v[kCompactUnroll];
    load_nids(nid, b0, r1, N, v);
#pragma unroll
    for (int u = 0; u < kCompactUnroll; ++u) {
      const unsigned peers = __match_any_sync(0xffffffffu, v[u]);
      if (v[u] >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(cnt + v[u], __popc(peers));
    }
  }
}

// Exclusive prefix sum of src[0, N) into dst[0, N) by the whole block;
// returns the total to every thread.
__device__ int block_exclusive_scan(const int* src, int* dst, int N,
                                    int* warp_sums) {
  const int per = (N + blockDim.x - 1) / blockDim.x;
  const int i0 = min(N, (int)threadIdx.x * per), i1 = min(N, i0 + per);
  int s = 0;
  for (int i = i0; i < i1; ++i) s += src[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = s;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  int run = x - s + (warp ? warp_sums[warp - 1] : 0);
  for (int i = i0; i < i1; ++i) {
    const int c = src[i];
    dst[i] = run;
    run += c;
  }
  const int total = warp_sums[(blockDim.x >> 5) - 1];
  __syncthreads();
  return total;
}

// Per block of `chunk` rows: its rows per node, added into counts[N].
__global__ void b1_compact_count(const int32_t* __restrict__ nid, long long n,
                                 int N, long long chunk,
                                 int* __restrict__ counts) {
  extern __shared__ int count_smem[];
  int* cnt = count_smem;
  for (int i = threadIdx.x; i < N; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * chunk;
  count_rows(nid, r0, min(n, r0 + chunk), N, cnt);
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    if (cnt[i]) atomicAdd(counts + i, cnt[i]);
}

// Per block of `chunk` rows: scan the totals into node offsets (block 0
// publishes them as start[0..N]), reserve the block's run inside each node
// from `cursor`, then write the row ids there, in row order within a warp.
__global__ void b1_compact_scatter(const int32_t* __restrict__ nid,
                                   long long n, int N, long long chunk,
                                   const int* __restrict__ counts,
                                   int* __restrict__ cursor,
                                   int32_t* __restrict__ start,
                                   int32_t* __restrict__ rows) {
  extern __shared__ int scatter_smem[];
  __shared__ int warp_sums[32];
  int* cnt = scatter_smem;       // this block's rows of each node
  int* base = scatter_smem + N;  // where its next row of each node goes
  for (int i = threadIdx.x; i < N; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * chunk;
  const long long r1 = min(n, r0 + chunk);
  count_rows(nid, r0, r1, N, cnt);
  const int total = block_exclusive_scan(counts, base, N, warp_sums);
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < N; i += blockDim.x) start[i] = base[i];
    if (threadIdx.x == 0) start[N] = total;
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    if (cnt[i]) base[i] += atomicAdd(cursor + i, cnt[i]);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (long long b0 = r0; b0 < r1; b0 += kCompactUnroll * blockDim.x) {
    int v[kCompactUnroll];
    load_nids(nid, b0, r1, N, v);
#pragma unroll
    for (int u = 0; u < kCompactUnroll; ++u) {
      const unsigned peers = __match_any_sync(0xffffffffu, v[u]);
      const int leader = __ffs(peers) - 1;
      int off = 0;
      if (v[u] >= 0 && lane == leader) off = atomicAdd(base + v[u],
                                                      __popc(peers));
      off = __shfl_sync(0xffffffffu, off, leader);
      if (v[u] >= 0)
        rows[off + __popc(peers & below)] =
            (int32_t)(b0 + (long long)u * blockDim.x + threadIdx.x);
    }
  }
}

// ---- histogram ------------------------------------------------------------

// Adds the compacted positions [a, b) - rows of one node - into that node's
// shared-memory histogram h (cg columns x B bins x S lanes). A row is read
// by L = ceil(ncols / 4) neighbouring lanes, one 4-byte word of codes each.
template <int S>
__device__ __forceinline__ void add_rows(float* h,
                                         const uint8_t* __restrict__ bins,
                                         const float* __restrict__ stats,
                                         const int32_t* __restrict__ rows,
                                         long long a, long long b, int C,
                                         int col0, int ncols, int B,
                                         int vec4) {
  const int L = (ncols + 3) >> 2;
  const int rpw = 32 / L;  // rows per warp step
  const int lane = threadIdx.x & 31;
  const int rs = lane / L;
  if (rs >= rpw) return;
  const int c4 = (lane - rs * L) * 4;  // this lane's first column
  const long long step = (long long)(blockDim.x >> 5) * rpw;
  for (long long p = a + (threadIdx.x >> 5) * rpw + rs; p < b; p += step) {
    const long long row = rows[p];
    float st[S];
#pragma unroll
    for (int s = 0; s < S; ++s) st[s] = stats[row * S + s];
    const uint8_t* src = bins + row * C + col0 + c4;
    uint32_t w = 0;
    if (vec4) {
      w = *reinterpret_cast<const uint32_t*>(src);
    } else {
      for (int j = 0; j < 4 && c4 + j < ncols; ++j)
        w |= (uint32_t)src[j] << (8 * j);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned code = (w >> (8 * j)) & 255u;
      if (c4 + j < ncols && code < (unsigned)B) {
        float* cell = h + ((c4 + j) * B + code) * S;
#pragma unroll
        for (int s = 0; s < S; ++s) atomicAdd(cell + s, st[s]);
      }
    }
  }
}

// Clusters that take rows: at most one per active row, so that each of
// them has a non-empty range [c*n_act/Qe, (c+1)*n_act/Qe).
__device__ __forceinline__ long long active_clusters(int Q, long long n_act) {
  return min((long long)Q, n_act);
}

// The cluster owning compacted position p < n_act: the last c with
// c*n_act/Qe <= p.
__device__ __forceinline__ long long owner(long long p, long long n_act,
                                           long long Qe) {
  return ((p + 1) * Qe - 1) / n_act;
}

// The node tile holding compacted position p < n_act: the last tile whose
// first row is at or before p (empty tiles before it share its start).
__device__ __forceinline__ int tile_of(const int32_t* __restrict__ start,
                                       long long p, int nt, int T) {
  int lo = 0, hi = T - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid * nt] <= p) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// grid (Q * cluster, column groups), clusters of (cluster, 1, 1) blocks.
// part: (column groups, slots, nt, cg, B, S) partial histograms.
// Three blocks per SM (at most 42 registers a thread): a float atomicAdd
// on shared memory is a compare-and-swap loop on sm_90, and more warps in
// flight measured faster than unrolled loads in fewer (PERF.md).
template <int S>
__global__ void __launch_bounds__(kHistThreads, 3)
b1_hist_tile(const uint8_t* __restrict__ bins, const float* __restrict__ stats,
             const int32_t* __restrict__ rows,
             const int32_t* __restrict__ start, float* __restrict__ part,
             int C, int N, int B, int nt, int cg, int Q, int slots,
             int vec4) {
  extern __shared__ float hist_smem[];
  float* sh = hist_smem;
  coop::cluster_group cluster = coop::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / CS;
  const int g = blockIdx.y;
  const int col0 = g * cg, ncols = min(cg, C - col0);
  const int per_node = cg * B * S;
  const int cells = nt * per_node;
  const int T = (N + nt - 1) / nt;
  const long long n_act = start[N];
  const long long Qe = active_clusters(Q, n_act);
  if (c >= Qe) return;  // the whole cluster leaves together
  const long long lo = c * n_act / Qe;
  const long long hi = (c + 1) * n_act / Qe;  // > lo, as Qe <= n_act
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();
  const int t1 = tile_of(start, hi - 1, nt, T);
  for (int t = tile_of(start, lo, nt, T); t <= t1; ++t) {
    const int node0 = t * nt, nn = min(nt, N - node0);
    if (start[node0] == start[node0 + nn]) continue;  // empty tile
    for (int k = 0; k < nn; ++k) {
      const long long a = max(lo, (long long)start[node0 + k]);
      const long long b = min(hi, (long long)start[node0 + k + 1]);
      if (a >= b) continue;
      const long long len = b - a;
      add_rows<S>(sh + k * per_node, bins, stats, rows, a + len * rank / CS,
                  a + len * (rank + 1) / CS, C, col0, ncols, B, vec4);
    }
    cluster.sync();  // every block of the cluster has filled its histogram
    float* dst = part + ((long long)g * slots + c + t) * cells;
    for (int i = rank * blockDim.x + threadIdx.x; i < cells;
         i += CS * blockDim.x) {
      float v = 0.f;
      for (int q = 0; q < CS; ++q) v += cluster.map_shared_rank(sh, q)[i];
      dst[i] = v;
    }
    cluster.sync();  // no block clears what another still reads
    if (t < t1) {
      for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = 0.f;
      __syncthreads();
    }
  }
}

// One thread per output cell: the sum, in cluster order, of the partials of
// the clusters whose range met the cell's node tile (zero for an empty tile).
__global__ void b1_hist_reduce(const float* __restrict__ part,
                               const int32_t* __restrict__ start,
                               float* __restrict__ out, int C, int N, int B,
                               int S, int nt, int cg, int Q, int slots) {
  const int BS = B * S;
  const long long total = (long long)N * C * BS;
  const long long cells = (long long)nt * cg * BS;
  const long long n_act = start[N];
  const long long Qe = active_clusters(Q, n_act);
  for (long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       o < total; o += (long long)gridDim.x * blockDim.x) {
    const int bs = (int)(o % BS);
    const long long rest = o / BS;
    const int col = (int)(rest % C), node = (int)(rest / C);
    const int t = node / nt, k = node - t * nt, g = col / cg, j = col - g * cg;
    const long long s_t = start[t * nt], e_t = start[min((t + 1) * nt, N)];
    float v = 0.f;
    if (e_t > s_t) {
      const float* src = part + ((long long)g * slots + t) * cells
                         + ((long long)k * cg + j) * BS + bs;
      const long long c1 = owner(e_t - 1, n_act, Qe);
      long long cc = owner(s_t, n_act, Qe);
      for (; cc + 8 <= c1 + 1; cc += 8) {  // eight loads in flight
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = src[(cc + u) * cells];
#pragma unroll
        for (int u = 0; u < 8; ++u) v += x[u];
      }
      for (; cc <= c1; ++cc) v += src[cc * cells];
    }
    out[o] = v;
  }
}

template <int S>
cudaError_t wave_clusters(int smem, int cluster, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      b1_hist_tile<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3(kHistThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, b1_hist_tile<S>, &cfg);
}

template <int S>
cudaError_t launch_hist(const void* bins, const void* stats, const void* rows,
                        const void* start, void* part, void* out, int C,
                        int N, int B, int nt, int cg, int Q, int CS,
                        int slots, int vec4, cudaStream_t stream) {
  const size_t smem = (size_t)nt * cg * B * S * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      b1_hist_tile<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(Q * CS), (unsigned)((C + cg - 1) / cg), 1);
  cfg.blockDim = dim3(kHistThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, b1_hist_tile<S>, (const uint8_t*)bins,
                         (const float*)stats, (const int32_t*)rows,
                         (const int32_t*)start, (float*)part, C, N, B, nt, cg,
                         Q, slots, vec4);
  if (e != cudaSuccess) return e;
  const long long total = (long long)N * C * B * S;
  const long long blocks = min((total + 255) / 256, 4096LL);  // grid-stride
  b1_hist_reduce<<<(unsigned)blocks, 256, 0, stream>>>(
      (const float*)part, (const int32_t*)start, (float*)out, C, N, B, S, nt,
      cg, Q, slots);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* h2o3_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Compaction on `stream`: rows[0, start[N]) receives the ids of the rows
// with 0 <= nid < N grouped by node, start[0..N] the node offsets. Blocks
// take `chunk` rows each; `work` holds 2N ints of scratch (zeroed here).
// Returns the cudaError_t.
int h2o3_compact_launch(const void* nid, long long n, int N, long long chunk,
                        int threads, void* rows, void* start, void* work,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int* counts = (int*)work;
  cudaError_t e = cudaMemsetAsync(work, 0, 2 * (size_t)N * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return (int)cudaMemsetAsync(start, 0, (N + 1) * sizeof(int), s);
  const size_t count_smem = (size_t)N * sizeof(int);
  const size_t smem = 2 * count_smem;
  e = cudaFuncSetAttribute(b1_compact_scatter,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(b1_compact_count,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)count_smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((n + chunk - 1) / chunk);
  b1_compact_count<<<blocks, threads, count_smem, s>>>(
      (const int32_t*)nid, n, N, chunk, counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  b1_compact_scatter<<<blocks, threads, smem, s>>>(
      (const int32_t*)nid, n, N, chunk, counts, counts + N, (int32_t*)start,
      (int32_t*)rows);
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` histogram blocks with `smem` bytes of
// shared memory each the card holds at once (one wave), into *out.
int h2o3_hist_wave_clusters(int S, int smem, int cluster, int* out) {
  switch (S) {
    case 1: return (int)wave_clusters<1>(smem, cluster, out);
    case 2: return (int)wave_clusters<2>(smem, cluster, out);
    case 3: return (int)wave_clusters<3>(smem, cluster, out);
    case 4: return (int)wave_clusters<4>(smem, cluster, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Histogram of compacted rows on `stream`: b1_hist_tile into `part`, then
// b1_hist_reduce into `out` (every cell written). Returns the cudaError_t.
int h2o3_hist_launch(const void* bins, const void* stats, const void* rows,
                     const void* start, void* part, void* out, int C, int N,
                     int B, int S, int nt, int cg, int Q, int cluster,
                     int slots, int vec4, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (S) {
    case 1: return (int)launch_hist<1>(bins, stats, rows, start, part, out, C,
                                       N, B, nt, cg, Q, cluster, slots, vec4, s);
    case 2: return (int)launch_hist<2>(bins, stats, rows, start, part, out, C,
                                       N, B, nt, cg, Q, cluster, slots, vec4, s);
    case 3: return (int)launch_hist<3>(bins, stats, rows, start, part, out, C,
                                       N, B, nt, cg, Q, cluster, slots, vec4, s);
    case 4: return (int)launch_hist<4>(bins, stats, rows, start, part, out, C,
                                       N, B, nt, cg, Q, cluster, slots, vec4, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
