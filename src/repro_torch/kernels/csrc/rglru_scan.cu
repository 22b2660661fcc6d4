// rglru_scan for Hopper (sm_90a): the RG-LRU diagonal linear recurrence
//
//   h[b, t, w] = a[b, t, w] * h[b, t-1, w] + x[b, t, w],   h[b, -1, w] = 0
//
// with every h_t written out.  Replaces the Pallas TPU kernel
// src/repro/kernels/rglru_scan.py::_kernel (its grid walks time chunks in
// order and carries h in VMEM scratch).  On the serving path it is the
// prefill of every RG-LRU layer of recurrentgemma-9b (B=2, T=4096, W=4096).
//
// What bounds it: bytes.  a and x are read once and h written once (12
// bytes and 2 FLOP per element), so the least time is the bytes over the
// HBM rate.  There is no parallelism along t without changing the
// arithmetic (a chunked or associative scan rounds in another order), so
// the design gives one thread to each (b, w) channel: consecutive threads
// take consecutive channels, so every load and store of a warp is one
// coalesced 128-byte line per time step.  The time loop is unrolled by
// kUnroll with all of a chunk's loads issued before its dependent chain,
// to keep more bytes in flight than the B*W threads alone would.  Blocks
// are small (kThreads = 64) so that B*W = 8192 channels spread over 128
// SMs instead of 32.  That still leaves the card mostly idle: the kernel is
// latency-bound, far above its byte bound (see PERF.md).
//
// Each step is __fmul_rn then __fadd_rn from h = 0, so nothing is contracted
// into an FMA and the result equals the sequential plain version
// (kernels/ref.py::rglru_scan_ref) bit for bit.

#include <cuda_runtime.h>

namespace fedk {

constexpr int kScanThreads = 64;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kScanThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                  float* __restrict__ h_out, int B, int T, int W) {
  const long long chan = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (chan >= static_cast<long long>(B) * W) return;
  const long long b = chan / W;
  const long long w = chan - b * W;
  const long long base = b * T * W + w;
  float h = 0.0f;
  int t = 0;
  for (; t + kUnroll <= T; t += kUnroll) {
    float av[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = base + static_cast<long long>(t + u) * W;
      av[u] = __ldg(a + off);
      xv[u] = __ldg(x + off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), xv[u]);
      h_out[base + static_cast<long long>(t + u) * W] = h;
    }
  }
  for (; t < T; ++t) {
    const long long off = base + static_cast<long long>(t) * W;
    h = __fadd_rn(__fmul_rn(__ldg(a + off), h), __ldg(x + off));
    h_out[off] = h;
  }
}

}  // namespace fedk

// a, x, h: (B, T, W) f32, contiguous, on the device.  Launches on `stream`
// and returns cudaGetLastError().  Allocates nothing.
extern "C" int rglru_scan_f32(const void* a, const void* x, void* h, int B,
                              int T, int W, int device, void* stream) {
  using namespace fedk;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || T <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long chans = static_cast<long long>(B) * W;
  const dim3 grid(static_cast<unsigned>((chans + kScanThreads - 1) / kScanThreads));
  rglru_scan_kernel<<<grid, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<float*>(h), B, T, W);
  return static_cast<int>(cudaGetLastError());
}
