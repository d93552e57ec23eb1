// Kernel B2: per-(node, numeric column) best split candidate of a histogram.
//
// Replaces the Pallas TPU kernel h2o3_tpu/ops/split_pallas.py::_split_kernel
// (driven by split_candidates). That kernel scans the histogram kernel's
// blocked VMEM tiles; here the input is the dense (N, C, B, 3) histogram the
// port's histogram kernel (B1) writes, and one warp owns one (node, column):
//
//   - data bins 1..B-1 are dealt to the 32 lanes in runs of K = ceil((B-1)/32)
//     consecutive bins; each lane sums its run serially, an exclusive warp
//     scan (__shfl_up_sync) of the lane totals gives every lane its prefix,
//     so every lane holds the inclusive prefix sums cum[t] of its bins;
//   - candidate t (split after data bin t, t = 0..B-3) has left = cum[t],
//     right = cum[B-2] - cum[t]; the NA bin (bin 0) is tried on the left and
//     on the right, both children must carry w >= min_rows, and
//     gain = fit(parent) - fit(L) - fit(R) with fit(s) = -wy^2/max(w, 1e-30)
//     (0 where w <= 0) against the caller's node totals, _NEG = -1e30 where
//     infeasible - the arithmetic of shared_tree._split_scan, op for op;
//   - a warp-shuffle argmax reduces to the best candidate, ties broken toward
//     the LOWER t (jnp.argmax / torch.argmax semantics); na_left is
//     g_nal >= g_nar at the winner, and the owning lane writes the folded
//     child stats Lst/Rst.
//
// What bounds it on an H100: it reads the histogram once (N*C*B*3*4 bytes,
// 2.75 MB at N=32, C=28, B=256: ~0.8 us at 3.35 TB/s) and writes O(N*C)
// results; the per-bin arithmetic is a few flops. So it is memory- and
// latency-bound, and its design keeps every intermediate (prefix sums, gains,
// the running argmax) in registers: no shared memory, no second pass, one
// launch for all (node, column) pairs. Build with -fmad=false so the gains
// round exactly as the plain PyTorch version's separate multiply, divide and
// subtract do - the integer-exact tie suites then decide bit-identically.
//
// Kernel B3 (kMono = true): the same kernel with monotone feasibility. It
// replaces h2o3_tpu/ops/split_pallas.py::_split_kernel_mono (the branch at
// :96-116). Each lane also keeps the wh prefix at every candidate, the warp
// loads its column's direction mono in {-1,0,1} and its node's [lo, hi]
// once, and before fmaxf(g_nal, g_nar) each side is masked to kNeg where
//   mono != 0 and (float)mono * (v(right side) - v(left side)) < 0,
// v(s) = clip(wy/max(wh, 1e-30) if wh > 0 else 0, lo, hi), the clip being
// fminf(fmaxf(v, lo), hi) so that +-inf bounds (the root, unconstrained
// nodes) pass v through. It reads 12 more bytes per (node, column) and does
// a few more flops per candidate than B2: still memory- and latency-bound,
// still one pass in registers. The tie rule is unchanged.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxRun = 8;  // data bins per lane: B <= 1 + 32 * 8 = 257
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

template <bool kMono>
__global__ void split_kernel(const float* __restrict__ hist,
                             const float* __restrict__ tot, float min_rows,
                             const int32_t* __restrict__ mono,
                             const float* __restrict__ node_lo,
                             const float* __restrict__ node_hi,
                             int N, int C, int B, float* __restrict__ gain_out,
                             int32_t* __restrict__ t_out,
                             uint8_t* __restrict__ nal_out,
                             float* __restrict__ lst_out,
                             float* __restrict__ rst_out) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)N * C) return;  // whole warps leave together
  const int node = (int)(warp / C);
  const float* h = hist + warp * (long long)B * 3;
  [[maybe_unused]] int m = 0;
  [[maybe_unused]] float lo = 0.f, hi = 0.f;
  if constexpr (kMono) {  // column direction and node bounds, once per warp
    m = mono[warp % C];
    lo = node_lo[node];
    hi = node_hi[node];
  }

  const int D = B - 1;              // data bins 1..B-1 -> data index 0..D-1
  const int K = (D + 31) / 32;      // data bins per lane
  const int d0 = lane * K;          // this lane's first data index
  const float naw = h[0], nay = h[1], nah = h[2];

  // serial inclusive prefix over this lane's run
  float cw[kMaxRun], cy[kMaxRun], ch[kMaxRun];
  float sw = 0.f, sy = 0.f, sh = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxRun; ++k) {
    const int d = d0 + k;
    if (k < K && d < D) {
      const float* cell = h + (size_t)(d + 1) * 3;
      sw = sw + cell[0];
      sy = sy + cell[1];
      sh = sh + cell[2];
    }
    cw[k] = sw;
    cy[k] = sy;
    ch[k] = sh;
  }
  // inclusive warp scan of the run totals, shifted by one lane = exclusive
  float iw = sw, iy = sy, ih = sh;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float vw = __shfl_up_sync(kFull, iw, o);
    const float vy = __shfl_up_sync(kFull, iy, o);
    const float vh = __shfl_up_sync(kFull, ih, o);
    if (lane >= o) {
      iw = vw + iw;
      iy = vy + iy;
      ih = vh + ih;
    }
  }
  float ew = __shfl_up_sync(kFull, iw, 1);
  float ey = __shfl_up_sync(kFull, iy, 1);
  float eh = __shfl_up_sync(kFull, ih, 1);
  if (lane == 0) ew = ey = eh = 0.f;
  const float tw = __shfl_sync(kFull, iw, 31);  // all data bins: cum[D-1]
  const float ty = __shfl_sync(kFull, iy, 31);
  const float th = __shfl_sync(kFull, ih, 31);

  const float pf = fit(tot[node * 3 + 0], tot[node * 3 + 1]);
  float best = -INFINITY;
  int best_t = 0x7fffffff;
  int best_nal = 0;
#pragma unroll
  for (int k = 0; k < kMaxRun; ++k) {
    const int t = d0 + k;
    if (k < K && t < D - 1) {  // candidates t = 0..D-2
      cw[k] = ew + cw[k];
      cy[k] = ey + cy[k];
      ch[k] = eh + ch[k];
      const float lw = cw[k], ly = cy[k];
      const float rw = tw - lw, ry = ty - ly;
      const float aw = lw + naw, ay = ly + nay;  // NA left
      const float bw = rw + naw, by = ry + nay;  // NA right
      float g_nal = (aw >= min_rows && rw >= min_rows)
                        ? (pf - fit(aw, ay)) - fit(rw, ry)
                        : kNeg;
      float g_nar = (lw >= min_rows && bw >= min_rows)
                        ? (pf - fit(lw, ly)) - fit(bw, by)
                        : kNeg;
      if constexpr (kMono) {
        const float lh = ch[k], rh = th - lh;
        const float ah = lh + nah, bh = rh + nah;
        // NA left: children (left + na, right); NA right: (left, right + na)
        if (!mono_ok(m, child_val(ay, ah, lo, hi), child_val(ry, rh, lo, hi)))
          g_nal = kNeg;
        if (!mono_ok(m, child_val(ly, lh, lo, hi), child_val(by, bh, lo, hi)))
          g_nar = kNeg;
      }
      const float g = fmaxf(g_nal, g_nar);
      if (g > best) {  // strict: the lowest t wins among equal gains
        best = g;
        best_t = t;
        best_nal = g_nal >= g_nar;
      }
    }
  }
  // warp argmax, ties toward the lower candidate index
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float og = __shfl_down_sync(kFull, best, o);
    const int ot = __shfl_down_sync(kFull, best_t, o);
    const int on = __shfl_down_sync(kFull, best_nal, o);
    if (og > best || (og == best && ot < best_t)) {
      best = og;
      best_t = ot;
      best_nal = on;
    }
  }
  best = __shfl_sync(kFull, best, 0);
  best_t = __shfl_sync(kFull, best_t, 0);
  best_nal = __shfl_sync(kFull, best_nal, 0);

  if (lane == 0) {
    gain_out[warp] = best;
    t_out[warp] = best_t;
    nal_out[warp] = (uint8_t)best_nal;
  }
  // the lane that owns the winning candidate folds and writes the children
#pragma unroll
  for (int k = 0; k < kMaxRun; ++k) {
    if (k < K && d0 + k == best_t) {
      const float lw = cw[k], ly = cy[k], lh = ch[k];
      float* L = lst_out + warp * 3;
      float* R = rst_out + warp * 3;
      // Lraw + where(nal, na, 0), Rraw + where(!nal, na, 0), as the scan
      L[0] = lw + (best_nal ? naw : 0.f);
      L[1] = ly + (best_nal ? nay : 0.f);
      L[2] = lh + (best_nal ? nah : 0.f);
      const float rw = tw - lw, ry = ty - ly, rh = th - lh;
      R[0] = rw + (best_nal ? 0.f : naw);
      R[1] = ry + (best_nal ? 0.f : nay);
      R[2] = rh + (best_nal ? 0.f : nah);
    }
  }
}

}  // namespace

extern "C" {

const char* h2o3_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch on `stream`. hist f32 (N, C, B, 3), tot f32 (N, 3); outputs gain f32
// (N, C), t i32 (N, C), nal u8 (N, C), lst/rst f32 (N, C, 3). Requires
// 3 <= B <= 257. Returns the cudaError_t of the launch (0 on success).
int h2o3_split_launch(const void* hist, const void* tot, float min_rows, int N,
                      int C, int B, void* gain, void* t, void* nal, void* lst,
                      void* rst, void* stream) {
  if (N <= 0 || C <= 0) return 0;
  if (B < 3 || B > 1 + 32 * kMaxRun) return (int)cudaErrorInvalidValue;
  const int threads = 128;  // 4 warps = 4 (node, column) pairs per block
  const long long warps = (long long)N * C;
  const unsigned blocks = (unsigned)((warps * 32 + threads - 1) / threads);
  split_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)hist, (const float*)tot, min_rows, nullptr, nullptr,
      nullptr, N, C, B, (float*)gain, (int32_t*)t, (uint8_t*)nal,
      (float*)lst, (float*)rst);
  return (int)cudaGetLastError();
}

// Kernel B3: as h2o3_split_launch, plus mono i32 (C,) in {-1,0,1} and the
// node bounds lo/hi f32 (N,) (+-inf where a node is unbounded).
int h2o3_split_mono_launch(const void* hist, const void* tot, float min_rows,
                           const void* mono, const void* lo, const void* hi,
                           int N, int C, int B, void* gain, void* t, void* nal,
                           void* lst, void* rst, void* stream) {
  if (N <= 0 || C <= 0) return 0;
  if (B < 3 || B > 1 + 32 * kMaxRun) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const long long warps = (long long)N * C;
  const unsigned blocks = (unsigned)((warps * 32 + threads - 1) / threads);
  split_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)hist, (const float*)tot, min_rows, (const int32_t*)mono,
      (const float*)lo, (const float*)hi, N, C, B, (float*)gain, (int32_t*)t,
      (uint8_t*)nal, (float*)lst, (float*)rst);
  return (int)cudaGetLastError();
}

}  // extern "C"
