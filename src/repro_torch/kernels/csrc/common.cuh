// Shared helpers for the port's streaming-fold kernels.
//
// A thread owns VEC consecutive f32 columns (VEC = 4, 2 or 1).  The host
// entry points pick the widest VEC that divides N and matches the pointers'
// alignment, so every row of a (M, N) row-major matrix starts on a VEC
// boundary and no thread ever straddles the ragged edge of a row.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fedk {

constexpr int kThreads = 256;

template <int VEC>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(src));
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(src));
    dst[0] = t.x; dst[1] = t.y;
  } else {
    dst[0] = __ldg(src);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* dst, const float* src) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
    dst[0] = src[0];
  }
}

inline bool aligned_to(const void* p, std::uintptr_t bytes) {
  return p == nullptr || reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

// Widest vector width that divides n and that every pointer is aligned for.
inline int pick_vec(int n, const void* a, const void* b, const void* c) {
  if (n % 4 == 0 && aligned_to(a, 16) && aligned_to(b, 16) && aligned_to(c, 16)) return 4;
  if (n % 2 == 0 && aligned_to(a, 8) && aligned_to(b, 8) && aligned_to(c, 8)) return 2;
  return 1;
}

}  // namespace fedk
