// fed_reduce for Hopper (sm_90a): fused segment aggregation over a packed
// cohort of M flat parameter rows.
//
//   out[t, n] = base[t, n] + sum_{m : seg[m] == t, in pack order} w~[m] * x[m, n]
//   w~[m]     = w[m] / tot[seg[m]]   (normalize; tot folded in pack order,
//                                     tot <= 0 becomes 1)  or  w[m]
//
// Replaces the Pallas TPU kernel src/repro/kernels/fed_reduce.py::_kernel
// and the weight-normalisation pre-pass that runs in the same jit
// (src/repro/kernels/ref.py::_norm_weights).  The int8 round trip stays a
// plain pre-pass before the kernel, as it is outside the pallas_call in JAX.
//
// What bounds it: bytes.  Each row element is read once and costs one
// multiply and one add (0.5 FLOP per byte), far below the ~20 FLOP/B at
// which f32 arithmetic would bound an H100.  So the design streams every row
// exactly once: a block owns one column tile of one segment t (grid
// (ceil(N / tile), T)), loads VEC columns per thread with one vector load
// per row, and keeps the fold in registers.  Rows of other segments are
// skipped before they are loaded: the block's prologue stages seg and w in
// shared memory and lists its own segment's rows once.
//
// Bit-exactness with the plain version (kernels/ref.py): the fold starts at
// 0.0f and adds __fmul_rn(w~, x) with __fadd_rn in pack order, so nothing is
// contracted into an FMA; the weight total is the same sequential fold and
// the normalisation an IEEE division (__fdiv_rn).  No --use_fast_math.

#include "common.cuh"

namespace fedk {

template <int VEC>
__global__ void __launch_bounds__(kThreads)
fed_reduce_kernel(const float* __restrict__ w, const float* __restrict__ x,
                  const int* __restrict__ seg, const float* __restrict__ base,
                  float* __restrict__ out, int M, int N, int normalize) {
  extern __shared__ float smem[];
  float* s_w = smem;                                    // M raw weights
  int* s_seg = reinterpret_cast<int*>(s_w + M);         // M segment ids
  int* s_row = s_seg + M;                               // this segment's rows
  float* s_wk = reinterpret_cast<float*>(s_row + M);    // ... and weights
  __shared__ int s_count;
  __shared__ float s_tot;
  const int t = blockIdx.y;

  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    s_w[m] = __ldg(w + m);
    s_seg[m] = __ldg(seg + m);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // one sequential pass in pack order: the segment's rows, and its weight
    // total folded left to right exactly like ref._seg_fold
    int count = 0;
    float tot = 0.0f;
    for (int m = 0; m < M; ++m) {
      if (s_seg[m] == t) {
        s_row[count] = m;
        s_wk[count] = s_w[m];
        tot = __fadd_rn(tot, s_w[m]);
        ++count;
      }
    }
    s_count = count;
    s_tot = tot > 0.0f ? tot : 1.0f;
  }
  __syncthreads();
  const int count = s_count;
  if (normalize) {
    const float tot = s_tot;
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
      s_wk[k] = __fdiv_rn(s_wk[k], tot);
    }
    __syncthreads();
  }

  const long long col = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (col >= N) return;
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < count; ++k) {
    const float wk = s_wk[k];
    float xv[VEC];
    load_vec<VEC>(xv, x + static_cast<long long>(s_row[k]) * N + col);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = __fadd_rn(acc[v], __fmul_rn(wk, xv[v]));
  }
  const long long o = static_cast<long long>(t) * N + col;
  if (base != nullptr) {
    float bv[VEC];
    load_vec<VEC>(bv, base + o);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = __fadd_rn(acc[v], bv[v]);
  }
  store_vec<VEC>(out + o, acc);
}

}  // namespace fedk

// w: (M,) f32, x: (M, N) f32, seg: (M,) i32, base: (T, N) f32 or null,
// out: (T, N) f32; all device pointers, row-major and contiguous.  Launches
// on `stream` and returns cudaGetLastError().  Allocates nothing.
extern "C" int fed_reduce_f32(const void* w, const void* x, const void* seg,
                              const void* base, void* out, int M, int N, int T,
                              int normalize, int device, void* stream) {
  using namespace fedk;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M < 0 || N <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = pick_vec(N, x, base, out);
  const int cols_per_block = kThreads * vec;
  const dim3 grid((N + cols_per_block - 1) / cols_per_block, T);
  const size_t smem = static_cast<size_t>(M) * 16;
  auto s = static_cast<cudaStream_t>(stream);
  auto fw = static_cast<const float*>(w);
  auto fx = static_cast<const float*>(x);
  auto iseg = static_cast<const int*>(seg);
  auto fb = static_cast<const float*>(base);
  auto fo = static_cast<float*>(out);
  if (vec == 4) {
    fed_reduce_kernel<4><<<grid, kThreads, smem, s>>>(fw, fx, iseg, fb, fo, M, N, normalize);
  } else if (vec == 2) {
    fed_reduce_kernel<2><<<grid, kThreads, smem, s>>>(fw, fx, iseg, fb, fo, M, N, normalize);
  } else {
    fed_reduce_kernel<1><<<grid, kThreads, smem, s>>>(fw, fx, iseg, fb, fo, M, N, normalize);
  }
  return static_cast<int>(cudaGetLastError());
}
