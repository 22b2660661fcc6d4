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
// HBM rate: 403 MB, 0.120 ms at that shape.  The arithmetic is not the
// limit: one channel's chain is 4,096 steps of a dependent multiply and add
// (~8 cycles a step, ~20 us).  What limits a scan with one thread per
// channel is bytes in flight: B*W = 8,192 channels are only ~2 warps an SM,
// and HBM needs ~2.5-3 MB in flight across the card to run near its rate.
// A chunked or associative scan would add parallelism along t but rounds
// in another order, so it cannot stay bitwise equal to the sequential
// reference.  The design keeps the sequential arithmetic and raises the
// bytes in flight instead:
//
//  * A block is one warp and owns kScanCh = 32 consecutive channels of one
//    batch row (lane = channel), so every row segment it reads is one
//    128-byte line.
//  * Time is staged through a shared-memory ring of kScanStages = 5 stages
//    of kChunk = 32 steps: a and x of a stage are 2 x 32 x 32 f32 = 8 KB.
//    The copies are cp.async, 16 bytes a lane (cp.async.cg) when W % 4 == 0
//    and both inputs are 16-byte aligned, else 4 bytes a lane
//    (cp.async.ca; W = 4099, whose rows are not 16-byte aligned, takes
//    this path inside the same kernel).  While the lanes walk one stage,
//    the next four are in flight: 32 KB a block, 256 blocks at B=2,
//    W=4096 (~2 an SM), ~8 MB across the card.
//  * Shared memory: 40 KB a block (static, under the 48 KB limit).
//  * Stores of h are direct: each step one coalesced 128-byte line a warp.
//  * Ragged T: the last stage copies and walks only its T % kChunk steps;
//    ragged W: lanes past W copy and store nothing.
//
// Each step is __fmul_rn then __fadd_rn from h = 0, in time order, so
// nothing is contracted into an FMA and the result equals the sequential
// plain version (kernels/ref.py::rglru_scan_ref) bit for bit.
//
// The backward (rglru_scan_bwd_kernel, entry point rglru_scan_bwd_f32) is
// the reverse scan of the gradient, for training:
//
//   g_t = dh_t + a_{t+1} * g_{t+1}   (from a_T = g_T = 0),
//   db_t = g_t,   da_t = g_t * h_{t-1}   (h_{-1} = 0).
//
// The reference takes it by autodiff of its associative scan
// (src/repro/models/recurrent.py::rglru_scan); no Pallas kernel has a
// backward.  It is bound by bytes too: a, h and dh read once, da and db
// written once (20 bytes an element: 671 MB, 0.200 ms at B=2, T=4096,
// W=4096).  Same design as the forward walked backwards: a lane per
// (batch, channel), time chunks of a, h (shifted one step back, so a chunk
// holds the h_{t-1} its steps need) and dh streamed through a cp.async ring
// from the last chunk to the first, a_{t+1} carried in a register across
// chunks, __fmul_rn then __fadd_rn, so it equals the sequential plain
// version (kernels/ref.py::rglru_scan_bwd_ref) bit for bit.  Shared memory:
// 4 stages x 3 arrays x 32 x 32 f32 = 48 KB (static).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fedk {

constexpr int kScanCh = 32;       // channels of a block: one warp, a lane each
constexpr int kChunk = 32;        // time steps of a stage
constexpr int kScanStages = 5;

__device__ __forceinline__ void scan_cp16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void scan_cp4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

template <bool kVec16>
__global__ void __launch_bounds__(kScanCh)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                  float* __restrict__ h_out, int T, int W) {
  __shared__ __align__(16) float sa[kScanStages][kChunk][kScanCh];
  __shared__ __align__(16) float sx[kScanStages][kChunk][kScanCh];
  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * kScanCh;
  const int wn = min(kScanCh, W - w0);        // live channels of the block
  const long long row0 = static_cast<long long>(blockIdx.y) * T;
  const int n_chunks = (T + kChunk - 1) / kChunk;

  auto load = [&](int c) {
    const int st = c % kScanStages;
    const int t0 = c * kChunk;
    const int tn = min(kChunk, T - t0);
    if constexpr (kVec16) {
      // 8 pieces of 4 channels a row; W % 4 == 0, so wn % 4 == 0
      for (int i = lane; i < tn * 8; i += kScanCh) {
        const int r = i >> 3, q = (i & 7) * 4;
        if (q < wn) {
          const long long off = (row0 + t0 + r) * W + w0 + q;
          scan_cp16(&sa[st][r][q], a + off);
          scan_cp16(&sx[st][r][q], x + off);
        }
      }
    } else {
      if (lane < wn) {
        for (int r = 0; r < tn; ++r) {
          const long long off = (row0 + t0 + r) * W + w0 + lane;
          scan_cp4(&sa[st][r][lane], a + off);
          scan_cp4(&sx[st][r][lane], x + off);
        }
      }
    }
  };

#pragma unroll
  for (int c = 0; c < kScanStages - 1; ++c) {
    if (c < n_chunks) load(c);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  float h = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kScanStages - 2) : "memory");
    __syncthreads();                  // stage c landed; stage c-1 consumed
    if (c + kScanStages - 1 < n_chunks) load(c + kScanStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (lane >= wn) continue;
    const int st = c % kScanStages;
    const int t0 = c * kChunk;
    float* dst = h_out + (row0 + t0) * W + w0 + lane;
    if (T - t0 >= kChunk) {
#pragma unroll
      for (int r = 0; r < kChunk; ++r) {
        h = __fadd_rn(__fmul_rn(sa[st][r][lane], h), sx[st][r][lane]);
        dst[static_cast<long long>(r) * W] = h;
      }
    } else {
      for (int r = 0; r < T - t0; ++r) {
        h = __fadd_rn(__fmul_rn(sa[st][r][lane], h), sx[st][r][lane]);
        dst[static_cast<long long>(r) * W] = h;
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The bf16 forward (rglru_scan_bf16_kernel, entry point rglru_scan_bf16):
// the same recurrence on bf16 a and x, as the Pallas kernel runs it at
// bf16 (src/repro/kernels/rglru_scan.py:34-36, :63): each step casts a_t
// and x_t to f32, the state h stays f32, and each h_t is rounded to bf16
// (to nearest even) at its store only.  Bound by bytes: 6 bytes an element
// (0.060 ms at B=2, T=4096, W=4096).  The same ring, of bf16 stages: a
// 16-byte cp.async carries 8 channels when W % 8 == 0 and both inputs are
// 16-byte aligned; otherwise (W = 4099: rows 2 bytes apart from 16-byte
// alignment) the lanes copy their own 2-byte values with plain loads.
// __fmul_rn then __fadd_rn in time order, so it equals the plain version
// (kernels/ref.py::rglru_scan_ref on bf16 inputs) bit for bit.
template <bool kVec16>
__global__ void __launch_bounds__(kScanCh)
rglru_scan_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                       const __nv_bfloat16* __restrict__ x,
                       __nv_bfloat16* __restrict__ h_out, int T, int W) {
  __shared__ __align__(16) __nv_bfloat16 sa[kScanStages][kChunk][kScanCh];
  __shared__ __align__(16) __nv_bfloat16 sx[kScanStages][kChunk][kScanCh];
  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * kScanCh;
  const int wn = min(kScanCh, W - w0);
  const long long row0 = static_cast<long long>(blockIdx.y) * T;
  const int n_chunks = (T + kChunk - 1) / kChunk;

  auto load = [&](int c) {
    const int st = c % kScanStages;
    const int t0 = c * kChunk;
    const int tn = min(kChunk, T - t0);
    if constexpr (kVec16) {
      // 4 pieces of 8 channels a row; W % 8 == 0, so wn % 8 == 0
      for (int i = lane; i < tn * 4; i += kScanCh) {
        const int r = i >> 2, q = (i & 3) * 8;
        if (q < wn) {
          const long long off = (row0 + t0 + r) * W + w0 + q;
          scan_cp16(reinterpret_cast<float*>(&sa[st][r][q]),
                    reinterpret_cast<const float*>(a + off));
          scan_cp16(reinterpret_cast<float*>(&sx[st][r][q]),
                    reinterpret_cast<const float*>(x + off));
        }
      }
    } else {
      if (lane < wn) {
        for (int r = 0; r < tn; ++r) {
          const long long off = (row0 + t0 + r) * W + w0 + lane;
          sa[st][r][lane] = a[off];
          sx[st][r][lane] = x[off];
        }
      }
    }
  };

#pragma unroll
  for (int c = 0; c < kScanStages - 1; ++c) {
    if (c < n_chunks) load(c);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  float h = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kScanStages - 2) : "memory");
    __syncthreads();                  // stage c landed; stage c-1 consumed
    if (c + kScanStages - 1 < n_chunks) load(c + kScanStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (lane >= wn) continue;
    const int st = c % kScanStages;
    const int t0 = c * kChunk;
    const int tn = min(kChunk, T - t0);
    __nv_bfloat16* dst = h_out + (row0 + t0) * W + w0 + lane;
    for (int r = 0; r < tn; ++r) {
      h = __fadd_rn(__fmul_rn(__bfloat162float(sa[st][r][lane]), h),
                    __bfloat162float(sx[st][r][lane]));
      dst[static_cast<long long>(r) * W] = __float2bfloat16_rn(h);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

constexpr int kBwdStages = 4;

template <bool kVec16>
__global__ void __launch_bounds__(kScanCh)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                      const float* __restrict__ dh, float* __restrict__ da,
                      float* __restrict__ db, int T, int W) {
  __shared__ __align__(16) float sa[kBwdStages][kChunk][kScanCh];
  __shared__ __align__(16) float shp[kBwdStages][kChunk][kScanCh];  // h_{t-1}
  __shared__ __align__(16) float sd[kBwdStages][kChunk][kScanCh];
  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * kScanCh;
  const int wn = min(kScanCh, W - w0);
  const long long row0 = static_cast<long long>(blockIdx.y) * T;
  const int n_chunks = (T + kChunk - 1) / kChunk;

  // the i-th chunk walked is chunk n_chunks - 1 - i, into stage i % stages;
  // row r of a stage is step t0 + r (h: step t0 + r - 1, none before 0)
  auto load = [&](int i) {
    const int st = i % kBwdStages;
    const int c = n_chunks - 1 - i;
    const int t0 = c * kChunk;
    const int tn = min(kChunk, T - t0);
    if constexpr (kVec16) {
      for (int j = lane; j < tn * 8; j += kScanCh) {
        const int r = j >> 3, q = (j & 7) * 4;
        if (q < wn) {
          const long long off = (row0 + t0 + r) * W + w0 + q;
          scan_cp16(&sa[st][r][q], a + off);
          scan_cp16(&sd[st][r][q], dh + off);
          if (t0 + r > 0) scan_cp16(&shp[st][r][q], h + off - W);
        }
      }
    } else {
      if (lane < wn) {
        for (int r = 0; r < tn; ++r) {
          const long long off = (row0 + t0 + r) * W + w0 + lane;
          scan_cp4(&sa[st][r][lane], a + off);
          scan_cp4(&sd[st][r][lane], dh + off);
          if (t0 + r > 0) scan_cp4(&shp[st][r][lane], h + off - W);
        }
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kBwdStages - 1; ++i) {
    if (i < n_chunks) load(i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  float g = 0.0f, a_next = 0.0f;
  for (int i = 0; i < n_chunks; ++i) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kBwdStages - 2) : "memory");
    __syncthreads();                  // stage i landed; stage i-1 consumed
    if (i + kBwdStages - 1 < n_chunks) load(i + kBwdStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (lane >= wn) continue;
    const int st = i % kBwdStages;
    const int t0 = (n_chunks - 1 - i) * kChunk;
    const int tn = min(kChunk, T - t0);
    const long long base = (row0 + t0) * W + w0 + lane;
    for (int r = tn - 1; r >= 0; --r) {
      g = __fadd_rn(sd[st][r][lane], __fmul_rn(a_next, g));
      const float hp = t0 + r > 0 ? shp[st][r][lane] : 0.0f;
      const long long o = base + static_cast<long long>(r) * W;
      db[o] = g;
      da[o] = __fmul_rn(g, hp);
      a_next = sa[st][r][lane];
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace fedk

// a, x, h: (B, T, W) f32, contiguous, on the device.  Launches on `stream`
// and returns cudaGetLastError().  Allocates nothing.
extern "C" int rglru_scan_f32(const void* a, const void* x, void* h, int B,
                              int T, int W, int device, void* stream) {
  using namespace fedk;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || T <= 0 || W <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((W + kScanCh - 1) / kScanCh),
                  static_cast<unsigned>(B));
  const bool vec16 = W % 4 == 0 && reinterpret_cast<std::uintptr_t>(a) % 16 == 0 &&
                     reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (vec16)
    rglru_scan_kernel<true><<<grid, kScanCh, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(x),
        static_cast<float*>(h), T, W);
  else
    rglru_scan_kernel<false><<<grid, kScanCh, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(x),
        static_cast<float*>(h), T, W);
  return static_cast<int>(cudaGetLastError());
}

// a, x, h: (B, T, W) bf16, contiguous, on the device.  Launches the bf16
// forward on `stream` and returns cudaGetLastError().  Allocates nothing.
extern "C" int rglru_scan_bf16(const void* a, const void* x, void* h, int B,
                               int T, int W, int device, void* stream) {
  using namespace fedk;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || T <= 0 || W <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((W + kScanCh - 1) / kScanCh),
                  static_cast<unsigned>(B));
  const bool vec16 = W % 8 == 0 && reinterpret_cast<std::uintptr_t>(a) % 16 == 0 &&
                     reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ab = static_cast<const __nv_bfloat16*>(a);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  if (vec16)
    rglru_scan_bf16_kernel<true><<<grid, kScanCh, 0, s>>>(ab, xb, hb, T, W);
  else
    rglru_scan_bf16_kernel<false><<<grid, kScanCh, 0, s>>>(ab, xb, hb, T, W);
  return static_cast<int>(cudaGetLastError());
}

// a, h, dh, da, db: (B, T, W) f32, contiguous, on the device (h the
// forward's output, dh its gradient).  Launches the reverse scan on `stream`
// and returns cudaGetLastError().  Allocates nothing.
extern "C" int rglru_scan_bwd_f32(const void* a, const void* h,
                                  const void* dh, void* da, void* db, int B,
                                  int T, int W, int device, void* stream) {
  using namespace fedk;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || T <= 0 || W <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((W + kScanCh - 1) / kScanCh),
                  static_cast<unsigned>(B));
  auto al16 = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  const bool vec16 = W % 4 == 0 && al16(a) && al16(h) && al16(dh);
  auto s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* hf = static_cast<const float*>(h);
  const float* df = static_cast<const float*>(dh);
  float* daf = static_cast<float*>(da);
  float* dbf = static_cast<float*>(db);
  if (vec16)
    rglru_scan_bwd_kernel<true><<<grid, kScanCh, 0, s>>>(af, hf, df, daf, dbf,
                                                         T, W);
  else
    rglru_scan_bwd_kernel<false><<<grid, kScanCh, 0, s>>>(af, hf, df, daf,
                                                          dbf, T, W);
  return static_cast<int>(cudaGetLastError());
}
