// Kernel B1: per-(node, column, bin) histogram of the row stat lanes.
//
// Replaces the Pallas TPU kernel h2o3_tpu/ops/hist_pallas.py::_hist_kernel
// (driven by hist_pallas_local). That kernel recasts the scatter as a
// one-hot x stats product on the TPU's 128x128 matrix unit; on Hopper that
// would turn a scatter into wasted tensor-core work, so this is the
// gpu_hist shape instead (arXiv:1706.08359): a shared-memory histogram
// privatized to each block, filled with float atomics, then merged into
// the zeroed output with one global atomic per non-empty cell.
//
// out[node, col, bin, s] += stats[row, s]   for every row with
//     nid[row] == node (rows with nid < 0 add nothing) and bins[row, col] == bin
//
// Layout: bins u8 (n, C) row-major, nid i32 (n,), stats f32 (n, S) with
// S <= 4, out f32 (N, C, B, S) - the dense layout the split kernel (B2)
// reads with one warp per (node, column).
//
// What bounds it on an H100: each level reads n*(C + 4 + 4S) bytes (44 MB
// at 1M x 28, S=3: ~13 us at 3.35 TB/s) and does n*C*S adds; in practice
// the shared-memory atomics (84M at the headline shape) and the per-block
// merge bound it. The design keeps every row's update in shared memory,
// loads four u8 codes per 32-bit word where the row segment is aligned,
// skips rows outside the block's node tile before touching their codes,
// and sizes the grid (column group x node tile x row stripe) so the
// merge's global atomics stay a small fraction of the row updates.
// Global atomics make the float summation order vary from run to run;
// sums of integer-valued stats are exact in any order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void add_code(float* cell_base, int B, int S,
                                         int col, unsigned code,
                                         const float* st) {
  if (code >= (unsigned)B) return;  // out-of-range codes add nothing
  float* cell = cell_base + ((size_t)col * B + code) * S;
  for (int s = 0; s < S; ++s) atomicAdd(cell + s, st[s]);
}

__global__ void hist_kernel(const uint8_t* __restrict__ bins,
                            const int32_t* __restrict__ nid,
                            const float* __restrict__ stats,
                            float* __restrict__ out, long long n, int C, int N,
                            int B, int S, int nt, int cg,
                            long long rows_per_block, int vec4) {
  extern __shared__ float sh[];
  const int col0 = blockIdx.y * cg;
  const int ncols = min(cg, C - col0);
  const int node0 = blockIdx.z * nt;
  const int nnodes = min(nt, N - node0);
  const int per_node = ncols * B * S;
  const int cells = nnodes * per_node;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();

  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int node = nid[r] - node0;  // nid < 0 lands below 0: skipped
    if (node < 0 || node >= nnodes) continue;
    float st[4];
    for (int s = 0; s < S; ++s) st[s] = stats[r * S + s];
    const uint8_t* row = bins + r * C + col0;
    float* base = sh + node * per_node;
    int c = 0;
    if (vec4) {
      for (; c + 4 <= ncols; c += 4) {
        const uchar4 v = *reinterpret_cast<const uchar4*>(row + c);
        add_code(base, B, S, c + 0, v.x, st);
        add_code(base, B, S, c + 1, v.y, st);
        add_code(base, B, S, c + 2, v.z, st);
        add_code(base, B, S, c + 3, v.w, st);
      }
    }
    for (; c < ncols; ++c) add_code(base, B, S, c, row[c], st);
  }
  __syncthreads();

  // merge: one global atomic per non-empty cell of this block's tile
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const float v = sh[i];
    if (v == 0.f) continue;
    const int node = i / per_node;
    const int rest = i - node * per_node;  // (col, bin, s) inside the tile
    const int col = rest / (B * S);
    const int bs = rest - col * (B * S);
    atomicAdd(out + (((size_t)(node0 + node) * C + col0 + col) * B * S + bs), v);
  }
}

}  // namespace

extern "C" {

const char* h2o3_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch on `stream`; `out` must be zeroed by the caller. Returns the
// cudaError_t of the launch (0 on success).
int h2o3_hist_launch(const void* bins, const void* nid, const void* stats,
                     void* out, long long n, int C, int N, int B, int S,
                     int nt, int cg, long long rows_per_block, int vec4,
                     int threads, void* stream) {
  if (n <= 0 || N <= 0 || C <= 0) return 0;
  const size_t smem = (size_t)nt * cg * B * S * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((n + rows_per_block - 1) / rows_per_block),
                  (unsigned)((C + cg - 1) / cg), (unsigned)((N + nt - 1) / nt));
  hist_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bins, (const int32_t*)nid, (const float*)stats,
      (float*)out, n, C, N, B, S, nt, cg, rows_per_block, vec4);
  return (int)cudaGetLastError();
}

}  // extern "C"
