// Shared helpers for the port's streaming-fold kernels (fed_reduce,
// fed_aggregate).
//
// A thread owns one quad: four consecutive f32 columns starting at a
// multiple of 4.  Rows of a packed (M, N) matrix start wherever m * N puts
// them, so each row's quad takes the widest load its own address allows (16,
// 8 or 4 bytes), decided per row and not per call, and the last N % 4
// columns are a masked tail.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fedk {

// Threads a block: block_threads picks a multiple of 32 in this range.
constexpr int kMaxThreads = 192;
constexpr int kMinThreads = 128;

// Columns [c, c + nv) of one row, p pointing at column c (a multiple of 4):
// nv >= 4 is a whole quad, 0 < nv < 4 the masked tail (zeros past it), nv <= 0
// no load at all.
__device__ __forceinline__ float4 load_quad(const float* p, int nv) {
  const std::uintptr_t a = reinterpret_cast<std::uintptr_t>(p);
  if (nv >= 4) {
    if ((a & 15) == 0) return __ldg(reinterpret_cast<const float4*>(p));
    if ((a & 7) == 0) {
      const float2 lo = __ldg(reinterpret_cast<const float2*>(p));
      const float2 hi = __ldg(reinterpret_cast<const float2*>(p + 2));
      return make_float4(lo.x, lo.y, hi.x, hi.y);
    }
    return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  }
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (nv > 0) v.x = __ldg(p);
  if (nv > 1) v.y = __ldg(p + 1);
  if (nv > 2) v.z = __ldg(p + 2);
  return v;
}

__device__ __forceinline__ void store_quad(float* p, int nv, const float4& v) {
  const std::uintptr_t a = reinterpret_cast<std::uintptr_t>(p);
  if (nv >= 4) {
    if ((a & 15) == 0) {
      *reinterpret_cast<float4*>(p) = v;
    } else if ((a & 7) == 0) {
      reinterpret_cast<float2*>(p)[0] = make_float2(v.x, v.y);
      reinterpret_cast<float2*>(p)[1] = make_float2(v.z, v.w);
    } else {
      p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
    }
    return;
  }
  if (nv > 0) p[0] = v.x;
  if (nv > 1) p[1] = v.y;
  if (nv > 2) p[2] = v.z;
}

// acc += wk * v, the product rounded before the add: never an FMA.
__device__ __forceinline__ void fold_quad(float4& acc, float wk, const float4& v) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(wk, v.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(wk, v.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(wk, v.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(wk, v.w));
}

__device__ __forceinline__ void add_quad(float4& acc, const float4& v) {
  acc.x = __fadd_rn(acc.x, v.x);
  acc.y = __fadd_rn(acc.y, v.y);
  acc.z = __fadd_rn(acc.z, v.z);
  acc.w = __fadd_rn(acc.w, v.w);
}

// Threads a block (a multiple of 32 in [kMinThreads, kMaxThreads]) for
// `quads` quads: the size that puts the fewest threads on the busiest SM
// when the blocks are dealt out over `sms` SMs, so the grid is whole waves;
// the larger size on a tie.
inline int block_threads(long long quads, int sms) {
  int best = kMaxThreads;
  long long best_load = -1;
  for (int per = kMaxThreads; per >= kMinThreads; per -= 32) {
    const long long blocks = (quads + per - 1) / per;
    const long long load = (blocks + sms - 1) / sms * per;
    if (best_load < 0 || load < best_load) {
      best = per;
      best_load = load;
    }
  }
  return best;
}

}  // namespace fedk
