// fed_aggregate for Hopper (sm_90a): weighted aggregation of M rows into one.
//
//   out[n] = base[n] + sum_{m = 0..M-1} w[m] * delta[m, n]
//
// Replaces the Pallas TPU kernel src/repro/kernels/fed_aggregate.py::_kernel.
// Its caller on the main path is the FedAsync mix of async mode (M = 1:
// a * theta_k + (1 - a) * theta).
//
// What bounds it: bytes (0.5 FLOP per byte), and at the main path's M = 1
// (2 MB) the launch more than the bytes.  So nothing waits before the loads
// go out: a thread owns one quad of four columns (common.cuh: 16-, 8- or
// 4-byte loads chosen per row by the row's own alignment, so a 16-byte
// aligned row takes 16-byte loads whatever N % 4 is, and a masked tail), and
// issues base, a batch of up to 16 rows and their weights together into
// registers before it folds any of them; each weight is loaded once, as a
// register beside its row.  The grid is whole waves over the SMs
// (common.cuh::block_threads).
//
// The fold starts at 0.0f and adds __fmul_rn(w, d) with __fadd_rn in row
// order, then adds base: no FMA contraction, so it equals the plain version
// (kernels/ref.py::fed_aggregate_ref) bit for bit.

#include "common.cuh"

namespace fedk {

// A thread loads a batch of R rows (and their weights) before it folds any
// of them: R = 1 for the main path's one row, so it runs no code for rows
// it does not have, and R = 16 otherwise.
template <int R>
__global__ void __launch_bounds__(kMaxThreads, 2)
fed_aggregate_kernel(const float* __restrict__ w, const float* __restrict__ x,
                     const float* __restrict__ base, float* __restrict__ out,
                     int M, long long N) {
  const long long c0 = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  const int nv = static_cast<int>(N - c0 < 4 ? N - c0 : 4);
  if (nv <= 0) return;
  const float4 bv = base != nullptr ? load_quad(base + c0, nv)
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k0 = 0; k0 < M; k0 += R) {
    float4 v[R];
    float wk[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (k0 + i < M) {
        wk[i] = __ldg(w + k0 + i);
        v[i] = load_quad(x + static_cast<long long>(k0 + i) * N + c0, nv);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (k0 + i < M) fold_quad(acc, wk[i], v[i]);
    }
  }
  if (base != nullptr) add_quad(acc, bv);
  store_quad(out + c0, nv, acc);
}

}  // namespace fedk

// w: (M,) f32, x: (M, N) f32, base: (N,) f32 or null, out: (N,) f32; all
// device pointers, contiguous, any alignment of 4 bytes.  Launches on
// `stream` and returns cudaGetLastError().  Allocates nothing.
extern "C" int fed_aggregate_f32(const void* w, const void* x, const void* base,
                                 void* out, int M, int N, int device,
                                 void* stream) {
  using namespace fedk;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M < 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long quads = (static_cast<long long>(N) + 3) / 4;
  const int threads = block_threads(quads, sms);
  const long long blocks = (quads + threads - 1) / threads;
  auto fw = static_cast<const float*>(w);
  auto fx = static_cast<const float*>(x);
  auto fb = static_cast<const float*>(base);
  auto fo = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (M <= 1) {
    fed_aggregate_kernel<1><<<grid, threads, 0, s>>>(fw, fx, fb, fo, M, N);
  } else {
    fed_aggregate_kernel<16><<<grid, threads, 0, s>>>(fw, fx, fb, fo, M, N);
  }
  return static_cast<int>(cudaGetLastError());
}
