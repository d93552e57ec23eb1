// Kernel B2: per-(node, numeric column) best split candidate of a histogram.
//
// Replaces the Pallas TPU kernel h2o3_tpu/ops/split_pallas.py::_split_kernel
// (driven by split_candidates). That kernel scans the histogram kernel's
// blocked VMEM tiles; here the input is the dense (N, C, B, 3) histogram the
// port's histogram kernel (B1) writes. Per (node, column):
//
//   - the inclusive prefix sums cum[t] over data bins 1..B-1;
//   - candidate t (split after data bin t + 1, t = 0..B-3) has left = cum[t],
//     right = cum[B-2] - cum[t]; the NA bin (bin 0) is tried on the left and
//     on the right, both children must carry w >= min_rows, and
//     gain = fit(parent) - fit(L) - fit(R) with fit(s) = -wy^2/max(w, 1e-30)
//     (0 where w <= 0) against the caller's node totals, kNeg = -1e30 where
//     infeasible - the arithmetic of shared_tree._split_scan, op for op;
//   - the best candidate, ties broken toward the LOWER t (jnp.argmax /
//     torch.argmax semantics); na_left is g_nal >= g_nar at the winner, and
//     the folded child stats Lraw + (na_left ? na : 0), Rraw + (!na_left ?
//     na : 0). Every output is written, also when no candidate is feasible
//     (t = 0, gain kNeg, na_left true), so the wrapper zeroes nothing.
//
// What bounds it on an H100: it reads the histogram once (N*C*B*3*4 bytes,
// 2.75 MB at N=32, C=28, B=256: ~0.8 us at 3.35 TB/s, most of it still in
// L2 from B1) and writes O(N*C) results; a candidate costs ~24 flops and 4
// IEEE divides. Its time is latency: the dependent chain of one (node,
// column) and how many of those chains are in flight. The design cuts the
// chain and spreads it over a block:
//
//   - one block per (node, column), a one-dimensional grid of N*C blocks
//     (a frontier of 2048 nodes stays far from any grid limit), of
//     round_up(B-1, 32) <= 256 threads; thread d owns data bin d + 1 and
//     candidate t = d. The wrapper computes this geometry
//     (split_cuda.split_geometry) and the launch checks it;
//   - coalesced loads: neighbouring threads read neighbouring 12-byte cells
//     of the contiguous B x 3 slab; the NA cell is one broadcast load;
//   - a block-wide inclusive scan: a __shfl_up_sync scan in each warp, the
//     <= 8 warp totals through shared memory, one __syncthreads, then lanes
//     0..7 of every warp scan those totals with shuffles and each thread
//     adds its warp's prefix (every warp scans the same values in the same
//     order, so all agree on cum[B-2]);
//   - one candidate per thread: no serial candidate loop, no register
//     arrays;
//   - a block argmax on (gain, t): a warp shuffle reduce, the <= 8 warp
//     winners through shared memory, and a butterfly over lanes 0..7 of
//     every warp. The winning thread holds its prefix sums and its two NA
//     gains in registers and writes all five outputs of its (node, column).
//
// Threads past the last candidate carry gain -INFINITY and take part in
// every shuffle and barrier; a NaN gain counts as -INFINITY, so the winner
// is always a real candidate. Build with -fmad=false so the gains round
// exactly as the plain PyTorch version's separate multiply, divide and
// subtract do: on integer-exact data (the tie suites) every summation order
// is exact, and the kernel and the plain version decide bit-identically.
//
// Kernel B3 (kMono = true): the same kernel with monotone feasibility. It
// replaces h2o3_tpu/ops/split_pallas.py::_split_kernel_mono (the branch at
// :96-116). With its column's direction mono in {-1,0,1} and its node's
// [lo, hi], before fmaxf(g_nal, g_nar) each side is masked to kNeg where
//   mono != 0 and (float)mono * (v(right side) - v(left side)) < 0,
// v(s) = clip(wy/max(wh, 1e-30) if wh > 0 else 0, lo, hi), the clip being
// fminf(fmaxf(v, lo), hi) so that +-inf bounds (the root, unconstrained
// nodes) pass v through: 4 more divides per candidate. The tie rule is
// unchanged.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // one thread per data bin: B <= 257
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float fit(float w, float wy) {
  return -(w > 0.f ? (wy * wy) / fmaxf(w, 1e-30f) : 0.f);
}

// Newton child value wy/wh, 0 where wh <= 0, clipped to [lo, hi]
__device__ __forceinline__ float child_val(float wy, float wh, float lo,
                                           float hi) {
  const float v = wh > 0.f ? wy / fmaxf(wh, 1e-30f) : 0.f;
  return fminf(fmaxf(v, lo), hi);
}

// mono * (vr - vl) >= 0, or no constraint on the column
__device__ __forceinline__ bool mono_ok(int m, float vl, float vr) {
  return m == 0 || (float)m * (vr - vl) >= 0.f;
}

// (g, t) beats (bg, bt): the higher gain, the lower t among equal gains
__device__ __forceinline__ bool beats(float g, int t, float bg, int bt) {
  return g > bg || (g == bg && t < bt);
}

template <bool kMono>
__global__ void __launch_bounds__(kMaxThreads)
split_kernel(const float* __restrict__ hist, const float* __restrict__ tot,
             float min_rows, const int32_t* __restrict__ mono,
             const float* __restrict__ node_lo,
             const float* __restrict__ node_hi, int C, int B,
             float* __restrict__ gain_out, int32_t* __restrict__ t_out,
             uint8_t* __restrict__ nal_out, float* __restrict__ lst_out,
             float* __restrict__ rst_out) {
  __shared__ float warp_sum[kMaxWarps][3];
  __shared__ float warp_gain[kMaxWarps];
  __shared__ int warp_t[kMaxWarps];

  const int pair = blockIdx.x;  // node * C + column
  const int node = pair / C;
  const int d = threadIdx.x;  // data bin d + 1, candidate t = d
  const int lane = d & 31, warp = d >> 5;
  const int n_warps = blockDim.x >> 5;
  const int D = B - 1;  // data bins; candidates t = 0..D-2
  const float* h = hist + (size_t)pair * B * 3;

  float cw = 0.f, cy = 0.f, ch = 0.f;
  if (d < D) {
    const float* cell = h + (d + 1) * 3;
    cw = cell[0];
    cy = cell[1];
    ch = cell[2];
  }
  const float naw = h[0], nay = h[1], nah = h[2];

  // inclusive scan within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float vw = __shfl_up_sync(kFull, cw, o);
    const float vy = __shfl_up_sync(kFull, cy, o);
    const float vh = __shfl_up_sync(kFull, ch, o);
    if (lane >= o) {
      cw = vw + cw;
      cy = vy + cy;
      ch = vh + ch;
    }
  }
  if (lane == 31) {
    warp_sum[warp][0] = cw;
    warp_sum[warp][1] = cy;
    warp_sum[warp][2] = ch;
  }
  __syncthreads();
  // lane j < n_warps of every warp takes warp j's total; an inclusive scan
  // over those lanes gives this warp's exclusive prefix (at lane warp - 1)
  // and the total over all data bins (at lane n_warps - 1)
  float sw = 0.f, sy = 0.f, sh = 0.f;
  if (lane < n_warps) {
    sw = warp_sum[lane][0];
    sy = warp_sum[lane][1];
    sh = warp_sum[lane][2];
  }
#pragma unroll
  for (int o = 1; o < kMaxWarps; o <<= 1) {
    const float vw = __shfl_up_sync(kFull, sw, o);
    const float vy = __shfl_up_sync(kFull, sy, o);
    const float vh = __shfl_up_sync(kFull, sh, o);
    if (lane >= o) {
      sw = vw + sw;
      sy = vy + sy;
      sh = vh + sh;
    }
  }
  const int prev = warp > 0 ? warp - 1 : 0;
  float pw = __shfl_sync(kFull, sw, prev);
  float py = __shfl_sync(kFull, sy, prev);
  float ph = __shfl_sync(kFull, sh, prev);
  if (warp == 0) pw = py = ph = 0.f;
  const float tw = __shfl_sync(kFull, sw, n_warps - 1);
  const float ty = __shfl_sync(kFull, sy, n_warps - 1);
  const float th = __shfl_sync(kFull, sh, n_warps - 1);
  cw = pw + cw;
  cy = py + cy;
  ch = ph + ch;

  float g = -INFINITY, g_nal = kNeg, g_nar = kNeg;
  if (d < D - 1) {
    const float pf = fit(tot[node * 3 + 0], tot[node * 3 + 1]);
    const float rw = tw - cw, ry = ty - cy;
    const float aw = cw + naw, ay = cy + nay;  // NA left
    const float bw = rw + naw, by = ry + nay;  // NA right
    g_nal = (aw >= min_rows && rw >= min_rows)
                ? (pf - fit(aw, ay)) - fit(rw, ry)
                : kNeg;
    g_nar = (cw >= min_rows && bw >= min_rows)
                ? (pf - fit(cw, cy)) - fit(bw, by)
                : kNeg;
    if constexpr (kMono) {
      const int m = mono[pair - node * C];
      const float lo = node_lo[node], hi = node_hi[node];
      const float rh = th - ch;
      const float ah = ch + nah, bh = rh + nah;
      // NA left: children (left + na, right); NA right: (left, right + na)
      if (!mono_ok(m, child_val(ay, ah, lo, hi), child_val(ry, rh, lo, hi)))
        g_nal = kNeg;
      if (!mono_ok(m, child_val(cy, ch, lo, hi), child_val(by, bh, lo, hi)))
        g_nar = kNeg;
    }
    g = fmaxf(g_nal, g_nar);
    if (!(g > -INFINITY)) g = -INFINITY;  // NaN never wins
  }

  // block argmax on (gain, t): warp butterfly, then the warp winners
  float bg = g;
  int bt = d;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float og = __shfl_xor_sync(kFull, bg, o);
    const int ot = __shfl_xor_sync(kFull, bt, o);
    if (beats(og, ot, bg, bt)) {
      bg = og;
      bt = ot;
    }
  }
  if (lane == 0) {
    warp_gain[warp] = bg;
    warp_t[warp] = bt;
  }
  __syncthreads();
  // lane j < n_warps takes warp j's winner; a butterfly over lanes 0..7
  float wg = -INFINITY;
  int wt = INT_MAX;
  if (lane < n_warps) {
    wg = warp_gain[lane];
    wt = warp_t[lane];
  }
#pragma unroll
  for (int o = kMaxWarps / 2; o > 0; o >>= 1) {
    const float og = __shfl_xor_sync(kFull, wg, o);
    const int ot = __shfl_xor_sync(kFull, wt, o);
    if (beats(og, ot, wg, wt)) {
      wg = og;
      wt = ot;
    }
  }
  bg = __shfl_sync(kFull, wg, 0);
  bt = __shfl_sync(kFull, wt, 0);
  if (d != bt) return;

  // the winning thread writes its (node, column): gain, t, na_left, and
  // Lraw + where(nal, na, 0), Rraw + where(!nal, na, 0), as the scan
  const bool nal = g_nal >= g_nar;
  gain_out[pair] = bg;
  t_out[pair] = bt;
  nal_out[pair] = (uint8_t)nal;
  float* L = lst_out + (size_t)pair * 3;
  float* R = rst_out + (size_t)pair * 3;
  L[0] = cw + (nal ? naw : 0.f);
  L[1] = cy + (nal ? nay : 0.f);
  L[2] = ch + (nal ? nah : 0.f);
  R[0] = (tw - cw) + (nal ? 0.f : naw);
  R[1] = (ty - cy) + (nal ? 0.f : nay);
  R[2] = (th - ch) + (nal ? 0.f : nah);
}

// The geometry split_cuda.split_geometry computes: a grid of N*C blocks of
// round_up(B-1, 32) <= 256 threads.
bool geometry_ok(int N, int C, int B, long long grid, int threads) {
  return N > 0 && C > 0 && B >= 3 && B <= kMaxThreads + 1 &&
         grid == (long long)N * C && grid <= INT_MAX &&
         threads == (B - 1 + 31) / 32 * 32;
}

}  // namespace

extern "C" {

const char* h2o3_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch on `stream`. hist f32 (N, C, B, 3), tot f32 (N, 3); outputs gain f32
// (N, C), t i32 (N, C), nal u8 (N, C), lst/rst f32 (N, C, 3). `grid` and
// `threads` are split_cuda.split_geometry's. Requires N, C >= 1 and
// 3 <= B <= 257. Returns the cudaError_t of the launch (0 on success).
int h2o3_split_launch(const void* hist, const void* tot, float min_rows, int N,
                      int C, int B, long long grid, int threads, void* gain,
                      void* t, void* nal, void* lst, void* rst, void* stream) {
  if (!geometry_ok(N, C, B, grid, threads)) return (int)cudaErrorInvalidValue;
  split_kernel<false><<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)hist, (const float*)tot, min_rows, nullptr, nullptr,
      nullptr, C, B, (float*)gain, (int32_t*)t, (uint8_t*)nal, (float*)lst,
      (float*)rst);
  return (int)cudaGetLastError();
}

// Kernel B3: as h2o3_split_launch, plus mono i32 (C,) in {-1,0,1} and the
// node bounds lo/hi f32 (N,) (+-inf where a node is unbounded).
int h2o3_split_mono_launch(const void* hist, const void* tot, float min_rows,
                           const void* mono, const void* lo, const void* hi,
                           int N, int C, int B, long long grid, int threads,
                           void* gain, void* t, void* nal, void* lst,
                           void* rst, void* stream) {
  if (!geometry_ok(N, C, B, grid, threads)) return (int)cudaErrorInvalidValue;
  split_kernel<true><<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)hist, (const float*)tot, min_rows, (const int32_t*)mono,
      (const float*)lo, (const float*)hi, C, B, (float*)gain, (int32_t*)t,
      (uint8_t*)nal, (float*)lst, (float*)rst);
  return (int)cudaGetLastError();
}

}  // extern "C"
