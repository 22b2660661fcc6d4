// fed_aggregate for Hopper (sm_90a): weighted aggregation of M rows into one.
//
//   out[n] = base[n] + sum_{m = 0..M-1} w[m] * delta[m, n]
//
// Replaces the Pallas TPU kernel src/repro/kernels/fed_aggregate.py::_kernel.
// Its caller on the main path is the FedAsync mix of async mode (M = 1:
// a * theta_k + (1 - a) * theta).
//
// What bounds it: bytes.  Each delta element is read once for one multiply
// and one add (0.5 FLOP per byte), so the design streams the rows once: a
// thread owns VEC columns, loads them with one vector load per row and keeps
// the fold in registers.  The fold starts at 0.0f and adds __fmul_rn(w, d)
// with __fadd_rn in row order, then adds base: no FMA contraction, so it
// equals the plain version (kernels/ref.py::fed_aggregate_ref) bit for bit.

#include "common.cuh"

namespace fedk {

template <int VEC>
__global__ void __launch_bounds__(kThreads)
fed_aggregate_kernel(const float* __restrict__ w, const float* __restrict__ x,
                     const float* __restrict__ base, float* __restrict__ out,
                     int M, int N) {
  const long long col = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (col >= N) return;
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
#pragma unroll 4
  for (int m = 0; m < M; ++m) {
    const float wm = __ldg(w + m);
    float xv[VEC];
    load_vec<VEC>(xv, x + static_cast<long long>(m) * N + col);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = __fadd_rn(acc[v], __fmul_rn(wm, xv[v]));
  }
  if (base != nullptr) {
    float bv[VEC];
    load_vec<VEC>(bv, base + col);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = __fadd_rn(acc[v], bv[v]);
  }
  store_vec<VEC>(out + col, acc);
}

}  // namespace fedk

// w: (M,) f32, x: (M, N) f32, base: (N,) f32 or null, out: (N,) f32; all
// device pointers, contiguous.  Launches on `stream` and returns
// cudaGetLastError().  Allocates nothing.
extern "C" int fed_aggregate_f32(const void* w, const void* x, const void* base,
                                 void* out, int M, int N, int device,
                                 void* stream) {
  using namespace fedk;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M < 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = pick_vec(N, x, base, out);
  const int cols_per_block = kThreads * vec;
  const dim3 grid((N + cols_per_block - 1) / cols_per_block);
  auto s = static_cast<cudaStream_t>(stream);
  auto fw = static_cast<const float*>(w);
  auto fx = static_cast<const float*>(x);
  auto fb = static_cast<const float*>(base);
  auto fo = static_cast<float*>(out);
  if (vec == 4) {
    fed_aggregate_kernel<4><<<grid, kThreads, 0, s>>>(fw, fx, fb, fo, M, N);
  } else if (vec == 2) {
    fed_aggregate_kernel<2><<<grid, kThreads, 0, s>>>(fw, fx, fb, fo, M, N);
  } else {
    fed_aggregate_kernel<1><<<grid, kThreads, 0, s>>>(fw, fx, fb, fo, M, N);
  }
  return static_cast<int>(cudaGetLastError());
}
