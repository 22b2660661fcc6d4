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
// which f32 arithmetic would bound an H100.  A bytes-bound kernel is as fast
// as the bytes it keeps in flight and as slow as whatever stands between its
// launch and its first row load, so the design is about those two:
//
// * A block owns one column tile of one segment t, a thread one quad of four
//   columns (common.cuh: 16-, 8- or 4-byte loads chosen per row by the row's
//   own alignment, a masked tail for the last N % 4 columns).
// * Rows in flight: each thread keeps a ring of kStages row slots in shared
//   memory and has the copies (cp.async, no registers held) of its next
//   kStages - 1 rows in flight while it folds one, so the bytes in flight do
//   not depend on the register budget and five blocks share an SM.  At
//   T = 1 the row list is the identity and the first copies go out at the
//   top of the kernel, before anything waits.
// * The prologue: the block lists its segment's rows in pack order with warp
//   ballots over chunks of seg (one seg entry a thread, a popc prefix per
//   warp, a prefix over the warps), so no thread walks M rows alone.  Thread
//   0 folds the segment's weight total from the chunk's matches while the
//   row copies are in flight; then the listed weights are divided once, in
//   shared memory, by as many threads as there are rows.  At T > 1 the first
//   copies go out as soon as the scan has listed their rows.
// * No row limit: the list lives in shared memory in pieces of kListCap rows
//   (8 KB), and a segment with more rows is folded piece by piece, the scan
//   resuming after the last listed row.  Offsets are 64-bit.
// * The grid (common.cuh::block_threads) is whole waves over the SMs.
//
// Bit-exactness with the plain version (kernels/ref.py): each column's fold
// starts at 0.0f and adds __fmul_rn(w~, x) with __fadd_rn in pack order,
// then adds base, so nothing is contracted into an FMA; the weight total is
// the same sequential fold and the normalisation an IEEE division
// (__fdiv_rn).  No --use_fast_math.

#include "common.cuh"

namespace fedk {

constexpr int kStages = 8;        // ring slots a thread: kStages - 1 rows in flight
constexpr int kListCap = 1024;    // listed rows a block holds at a time

// The chunk's matches, counted over the block: returns their number and sets
// `prefix` to this thread's position among them in pack order.  Every
// thread of the block calls it (blockDim.x is a multiple of 32).
__device__ __forceinline__ int block_prefix(bool match, int* s_wc, int& prefix) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(0xffffffffu, match);
  if (lane == 0) s_wc[warp] = __popc(bal);
  __syncthreads();
  int before = 0, total = 0;
  const int warps = blockDim.x >> 5;
  for (int i = 0; i < warps; ++i) {
    const int c = s_wc[i];
    before += i < warp ? c : 0;
    total += c;
  }
  prefix = before + __popc(bal & ((1u << lane) - 1u));
  return total;
}

__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src) : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" :: "r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Copies a row's quad (common.cuh's layout) into the thread's ring slot with
// the widest copies its address allows; past the tail the slot keeps
// whatever it held, and those columns are never stored.
__device__ __forceinline__ void copy_quad(float* dst, const float* src, int nv) {
  const std::uintptr_t a = reinterpret_cast<std::uintptr_t>(src);
  if (nv >= 4 && (a & 15) == 0) {
    cp_async(dst, src, 16);
  } else if (nv >= 4 && (a & 7) == 0) {
    cp_async(dst, src, 8);
    cp_async(dst + 2, src + 2, 8);
  } else {
    for (int i = 0; i < nv && i < 4; ++i) cp_async(dst + i, src + i, 4);
  }
}

// One commit group for list entry k (an empty one past n): its row, list[k]
// or, with no list, row k, into ring slot k % kStages.
__device__ __forceinline__ void issue(float4* ring, const float* x, const int* list,
                                      int k, int n, long long N, long long c0, int nv) {
  if (k < n) {
    const long long row = list != nullptr ? list[k] : k;
    copy_quad(reinterpret_cast<float*>(ring + (k % kStages) * blockDim.x + threadIdx.x),
              x + row * N + c0, nv);
  }
  commit();
}

// Folds listed entries [0, n) into acc through the thread's ring of kStages
// slots: the copies of the next kStages - 1 rows are in flight while a row
// is folded.  With `issued`, the first kStages - 1 groups are out already.
// A thread reads only its own slots, so no barrier is needed.
__device__ __forceinline__ void fold_piece(float4& acc, float4* ring, bool issued,
                                           const float* x, const int* s_row,
                                           const float* s_w, int n, long long N,
                                           long long c0, int nv) {
  if (!issued) {
    for (int k = 0; k < kStages - 1; ++k) issue(ring, x, s_row, k, n, N, c0, nv);
  }
  for (int k = 0; k < n; ++k) {
    issue(ring, x, s_row, k + kStages - 1, n, N, c0, nv);
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
    fold_quad(acc, s_w[k], ring[(k % kStages) * blockDim.x + threadIdx.x]);
  }
}

__global__ void __launch_bounds__(kMaxThreads, 5)
fed_reduce_kernel(const float* __restrict__ w, const float* __restrict__ x,
                  const int* __restrict__ seg, const float* __restrict__ base,
                  float* __restrict__ out, int M, long long N, int T,
                  int col_blocks, int normalize) {
  __shared__ __align__(16) float4 s_ring[kStages * kMaxThreads];
  __shared__ int s_row[kListCap];
  __shared__ float s_w[kListCap];
  __shared__ float s_stage[kMaxThreads];
  __shared__ int s_wc[kMaxThreads / 32];
  __shared__ float s_tot;
  __shared__ int s_resume;

  const int t = blockIdx.x / col_blocks;
  const long long c0 =
      (static_cast<long long>(blockIdx.x % col_blocks) * blockDim.x + threadIdx.x) * 4;
  const int nv = static_cast<int>(N - c0 < 4 ? N - c0 : 4);   // <= 0: no columns
  const bool dense = T == 1;                                  // every row is t's

  bool issued = false;
  if (dense) {
    for (int k = 0; k < kStages - 1; ++k) issue(s_ring, x, nullptr, k, M, N, c0, nv);
    issued = true;
  }
  const float4 bv = base != nullptr ? load_quad(base + t * N + c0, nv)
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // Scan seg in chunks of one entry a thread: list the first kListCap rows
  // of segment t and, to normalise, fold its weight total over all of them.
  // The next chunk's seg and w are loaded before this chunk is counted.
  int count = 0;
  float tot = 0.0f;                                           // thread 0's
  int k0 = 0;
  int sg = 0;
  float wv = 0.0f;
  if (static_cast<int>(threadIdx.x) < M) {
    if (!dense) sg = __ldg(seg + threadIdx.x);
    wv = __ldg(w + threadIdx.x);
  }
  for (; k0 < M; k0 += blockDim.x) {
    const int m = k0 + threadIdx.x;
    const bool match = m < M && (dense || sg == t);
    const float wm = wv;
    if (m + static_cast<int>(blockDim.x) < M) {
      if (!dense) sg = __ldg(seg + m + blockDim.x);
      wv = __ldg(w + m + blockDim.x);
    }
    int prefix;
    const int total = block_prefix(match, s_wc, prefix);
    if (match) {
      const int pos = count + prefix;
      if (pos < kListCap) {
        s_row[pos] = m;
        s_w[pos] = wm;
      } else if (pos == kListCap) {
        s_resume = m;                                         // first row not listed
      }
      if (normalize) s_stage[prefix] = wm;
    }
    __syncthreads();
    if (normalize && threadIdx.x == 0) {
      for (int i = 0; i < total; ++i) tot = __fadd_rn(tot, s_stage[i]);
    }
    count += total;
    if (!issued && count >= kStages - 1) {
      for (int k = 0; k < kStages - 1; ++k) issue(s_ring, x, s_row, k, count, N, c0, nv);
      issued = true;
    }
    if (!normalize && count >= kListCap) {
      k0 += blockDim.x;
      break;
    }
  }
  int resume = count > kListCap ? s_resume : k0;
  const int listed = count < kListCap ? count : kListCap;

  float wtot = 1.0f;
  if (normalize) {
    if (threadIdx.x == 0) s_tot = tot > 0.0f ? tot : 1.0f;
    __syncthreads();
    wtot = s_tot;
    for (int i = threadIdx.x; i < listed; i += blockDim.x) s_w[i] = __fdiv_rn(s_w[i], wtot);
    __syncthreads();
  }
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  fold_piece(acc, s_ring, issued, x, s_row, s_w, listed, N, c0, nv);

  // Segments of more than kListCap rows: list and fold the rest piece by
  // piece, in pack order.
  while (resume < M) {
    __syncthreads();                                          // last piece folded
    int n = 0;
    int k = resume;
    for (; k < M && n + static_cast<int>(blockDim.x) <= kListCap; k += blockDim.x) {
      const int m = k + threadIdx.x;
      const bool match = m < M && (dense || __ldg(seg + m) == t);
      int prefix;
      const int total = block_prefix(match, s_wc, prefix);
      if (match) {
        const float wm = __ldg(w + m);
        s_row[n + prefix] = m;
        s_w[n + prefix] = normalize ? __fdiv_rn(wm, wtot) : wm;
      }
      n += total;
      __syncthreads();
    }
    resume = k;
    fold_piece(acc, s_ring, false, x, s_row, s_w, n, N, c0, nv);
  }

  if (nv > 0) {
    if (base != nullptr) add_quad(acc, bv);
    store_quad(out + t * N + c0, nv, acc);
  }
}

}  // namespace fedk

// w: (M,) f32, x: (M, N) f32, seg: (M,) i32 with values in [0, T), base:
// (T, N) f32 or null, out: (T, N) f32; all device pointers, row-major and
// contiguous, any alignment of 4 bytes.  At T = 1 every row is segment 0's
// and seg is not read.  Launches on `stream` and returns cudaGetLastError().
// Allocates nothing.
extern "C" int fed_reduce_f32(const void* w, const void* x, const void* seg,
                              const void* base, void* out, int M, int N, int T,
                              int normalize, int device, void* stream) {
  using namespace fedk;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M < 0 || N <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long quads = (static_cast<long long>(N) + 3) / 4;
  const int threads = block_threads(quads, sms);
  const long long col_blocks = (quads + threads - 1) / threads;
  if (col_blocks * T > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fed_reduce_kernel<<<static_cast<unsigned>(col_blocks * T), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(x),
      static_cast<const int*>(seg), static_cast<const float*>(base),
      static_cast<float*>(out), M, N, T, static_cast<int>(col_blocks), normalize);
  return static_cast<int>(cudaGetLastError());
}
