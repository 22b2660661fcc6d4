// fed_reduce for Hopper (sm_90a): fused segment aggregation over a packed
// cohort of M flat parameter rows.
//
//   out[t, n] = base[t, n] + sum_{m : seg[m] == t, in pack order} w~[m] * x'[m, n]
//   w~[m]     = w[m] / tot[seg[m]]   (normalize; tot folded in pack order,
//                                     tot <= 0 becomes 1)  or  w[m]
//   x'[m, n]  = x[m, n], or with the int8 upload round trip (quant, row m
//               enabled) the dequantised row (below)
//
// Replaces the Pallas TPU kernel src/repro/kernels/fed_reduce.py::_kernel
// and the two pre-passes that run in the same jit before it:
// src/repro/kernels/ref.py::_norm_weights and ::_quant_rows, the int8 round
// trip (fed_reduce_quant_f32 below).
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
//
// The int8 round trip (fed_reduce_quant_f32).  For row m of segment
// s = seg[m] and column n of leaf l, with g = quant_ref[s, n]:
//
//   d     = x[m, n] - g                                   (__fsub_rn)
//   amax  = max over leaf l's columns of |d|               (exact)
//   scale = max(amax * RECIP_127, 1e-12)                  (__fmul_rn)
//   q     = clamp(rint(d / scale), -127, 127)              (__fdiv_rn, half to even)
//   x'    = q * scale + g, one fused multiply-add          (__fmaf_rn)
//
// the reference's jitted graph as XLA compiles it (the division by 127 a
// multiply by its f32 reciprocal, the dequantisation contracted into an
// FMA; kernels/ref.py::_quant_rows).  A scale reduces over a whole leaf of
// a row, across column tiles, so it takes a pass of its own: two launches.
//
// * quant_absmax_kernel reads each enabled row once; a disabled row costs
//   a block one byte of mask.  A block takes the same columns of several
//   rows (one wave of blocks): it finds its columns' leaves once,
//   and loads each row's mask and segment a row ahead.  A warp takes 4 x
//   128 contiguous columns; while they lie in one leaf it keeps a running max,
//   reduces it over the warp and flushes it with one atomicMax on the
//   unsigned bits of scratch[m, leaf] (non-negative floats order as their
//   bits, so any split and any order give the same max; a NaN orders above
//   every number and propagates, as in the reference).  A warp that
//   straddles a leaf boundary flushes each thread's columns leaf by leaf.
//   The scratch is zeroed first (0 is the identity of |d|).
// * The fold is the kernel above instantiated with kQuant: before the row
//   ring starts a thread loads quant_ref[t, its quad] and finds each of its
//   four columns' leaf by a binary search over the leaf offsets (per
//   column: a 35- or 62-wide leaf puts boundaries inside quads).  With
//   each row's copy into the ring goes a 4-byte copy of the row's max for
//   the thread's first leaf, so the scale has landed when the row has (at
//   T = 1 the first rows' copies go out before the leaves are known, and
//   their maxes are loaded once they are); a column of another leaf reads
//   its max with __ldg.  An enabled row is
//   round-tripped in registers as it leaves its slot, a disabled one folded
//   as it is; the rounded rows never touch memory.  The list keeps each
//   row's mask beside its index and weight, piece by piece.
// * What bounds it: bytes still.  The fold reads what it read without the
//   round trip plus quant_ref's T x N (once a block, from L2 after the
//   first); the absmax pass re-reads the enabled rows, which at the main
//   path's sizes (<= 27 MB) the fold can find in the 50 MB L2.

#include "common.cuh"

namespace fedk {

constexpr int kStages = 8;        // ring slots a thread: kStages - 1 rows in flight
constexpr int kListCap = 1024;    // listed rows a block holds at a time
constexpr int kLeafCap = 256;     // leaf offsets a block stages in shared memory
constexpr float kRecip127 = 1.0f / 127.0f;   // the f32 reciprocal XLA multiplies by

// The int8 round trip's inputs (kQuant only).
struct QuantArgs {
  const float* ref;                // (T, N) reference rows
  const unsigned char* enabled;    // (M,) 0/1, or null: every row
  const int* leaf_off;             // (L + 1,) the leaves' first columns, then N
  const unsigned* amax;            // (M, L) max |d| as bits (quant_absmax_kernel)
  int L;
};

// The round trip's shared memory, a block's: each ring slot's max (its row's
// at the thread's first leaf), each listed row's mask, the leaf offsets.
// Declared here so that only the kQuant instantiation has it.
struct QuantShared {
  unsigned slot_amax[kStages * kMaxThreads];
  int off[kLeafCap + 1];
  unsigned char en[kListCap];
};

__device__ __forceinline__ QuantShared& quant_shared() {
  __shared__ QuantShared s;
  return s;
}

// The leaf of column c: the last l in [0, L) with off[l] <= c (off[0] = 0,
// every leaf non-empty).
__device__ __forceinline__ int leaf_of(const int* off, int L, long long c) {
  int lo = 0, hi = L;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= c) lo = mid; else hi = mid;
  }
  return lo;
}

// Stages the leaf offsets in `s_off` when there are at most kLeafCap leaves
// and returns where to search them (generic loads: shared or global).
__device__ __forceinline__ const int* stage_offsets(int* s_off, const int* leaf_off, int L) {
  if (L > kLeafCap) return leaf_off;
  for (int i = threadIdx.x; i <= L; i += blockDim.x) s_off[i] = __ldg(leaf_off + i);
  __syncthreads();
  return s_off;
}

// scale = max(amax * RECIP_127, 1e-12); a NaN max stays NaN (jnp.maximum).
__device__ __forceinline__ float leaf_scale(unsigned amax_bits) {
  const float s = __fmul_rn(__uint_as_float(amax_bits), kRecip127);
  return s < 1e-12f ? 1e-12f : s;
}

// x' = clamp(rint((x - g) / scale), -127, 127) * scale + g, the product and
// the sum rounded once.  The int conversion rounds half to even, saturates,
// and turns -0 into +0 as the reference's int8 cast does.
__device__ __forceinline__ float round_trip(float x, float g, float scale) {
  const float d = __fsub_rn(x, g);
  const int q = min(max(__float2int_rn(__fdiv_rn(d, scale)), -127), 127);
  return __fmaf_rn(__int2float_rn(q), scale, g);
}

// A thread's fixed round-trip state in the fold: its quad of quant_ref[t]
// and the leaves of its four columns.
struct QuantThread {
  float4 g;
  int lf0, lf1, lf2, lf3;
};

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

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
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
// or, with no list, row k, into ring slot k % kStages; with kQuant and
// `with_max` also the row's max at the thread's first leaf (`amax_lf0` =
// amax + lf0, rows L apart) into the same slot of the max ring.
template <bool kQuant>
__device__ __forceinline__ void issue(float4* ring, const float* x, const int* list,
                                      int k, int n, long long N, long long c0, int nv,
                                      const unsigned* amax_lf0, int L,
                                      bool with_max = true) {
  if (k < n) {
    const long long row = list != nullptr ? list[k] : k;
    const int slot = (k % kStages) * blockDim.x + threadIdx.x;
    copy_quad(reinterpret_cast<float*>(ring + slot), x + row * N + c0, nv);
    if constexpr (kQuant) {
      if (with_max) cp_async(&quant_shared().slot_amax[slot], amax_lf0 + row * L, 4);
    }
  }
  commit();
}

// Folds listed entries [0, n) into acc through the thread's ring of kStages
// slots: the copies of the next kStages - 1 rows are in flight while a row
// is folded.  With `issued`, the first kStages - 1 groups are out already.
// A thread reads only its own slots, so no barrier is needed.  With kQuant
// an enabled row is round-tripped as it leaves its slot.
template <bool kQuant>
__device__ __forceinline__ void fold_piece(float4& acc, float4* ring, bool issued,
                                           const float* x, const int* s_row,
                                           const float* s_w, int n, long long N,
                                           long long c0, int nv, const QuantArgs& q,
                                           const QuantThread& qt) {
  const unsigned* amax_lf0 = kQuant ? q.amax + qt.lf0 : nullptr;
  if (!issued) {
    for (int k = 0; k < kStages - 1; ++k)
      issue<kQuant>(ring, x, s_row, k, n, N, c0, nv, amax_lf0, q.L);
  }
  for (int k = 0; k < n; ++k) {
    issue<kQuant>(ring, x, s_row, k + kStages - 1, n, N, c0, nv, amax_lf0, q.L);
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
    const int slot = (k % kStages) * blockDim.x + threadIdx.x;
    float4 v = ring[slot];
    if constexpr (kQuant) {
      const QuantShared& qs = quant_shared();
      if (qs.en[k]) {
        const unsigned* arow = q.amax + static_cast<long long>(s_row[k]) * q.L;
        const float s0 = leaf_scale(qs.slot_amax[slot]);
        const float s1 = qt.lf1 == qt.lf0 ? s0 : leaf_scale(__ldg(arow + qt.lf1));
        const float s2 = qt.lf2 == qt.lf1 ? s1 : leaf_scale(__ldg(arow + qt.lf2));
        const float s3 = qt.lf3 == qt.lf2 ? s2 : leaf_scale(__ldg(arow + qt.lf3));
        v.x = round_trip(v.x, qt.g.x, s0);
        v.y = round_trip(v.y, qt.g.y, s1);
        v.z = round_trip(v.z, qt.g.z, s2);
        v.w = round_trip(v.w, qt.g.w, s3);
      }
    }
    fold_quad(acc, s_w[k], v);
  }
}

template <bool kQuant>
__global__ void __launch_bounds__(kMaxThreads, kQuant ? 4 : 5)
fed_reduce_kernel(const float* __restrict__ w, const float* __restrict__ x,
                  const int* __restrict__ seg, const float* __restrict__ base,
                  float* __restrict__ out, int M, long long N, int T,
                  int col_blocks, int normalize, QuantArgs q) {
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
    // with kQuant the rows' maxes wait for the leaves, below
    for (int k = 0; k < kStages - 1; ++k)
      issue<kQuant>(s_ring, x, nullptr, k, M, N, c0, nv, nullptr, q.L, false);
    issued = true;
  }

  // The round trip's per-thread state, fixed for the block: quant_ref[t]'s
  // quad and each column's leaf (a column past N takes its left neighbour's).
  QuantThread qt{};
  if constexpr (kQuant) {
    const int* off = stage_offsets(quant_shared().off, q.leaf_off, q.L);
    qt.lf0 = nv > 0 ? leaf_of(off, q.L, c0) : 0;
    qt.lf1 = nv > 1 ? leaf_of(off, q.L, c0 + 1) : qt.lf0;
    qt.lf2 = nv > 2 ? leaf_of(off, q.L, c0 + 2) : qt.lf1;
    qt.lf3 = nv > 3 ? leaf_of(off, q.L, c0 + 3) : qt.lf2;
    qt.g = load_quad(q.ref + t * N + c0, nv);
    if (dense) {                  // the maxes of the rows already in flight
      for (int k = 0; k < kStages - 1 && k < M; ++k)
        quant_shared().slot_amax[k * blockDim.x + threadIdx.x] =
            __ldg(q.amax + static_cast<long long>(k) * q.L + qt.lf0);
    }
  }
  const unsigned* amax_lf0 = kQuant ? q.amax + qt.lf0 : nullptr;
  const float4 bv = base != nullptr ? load_quad(base + t * N + c0, nv)
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // Scan seg in chunks of one entry a thread: list the first kListCap rows
  // of segment t and, to normalise, fold its weight total over all of them.
  // The next chunk's seg, w and mask are loaded before this chunk is
  // counted.
  int count = 0;
  float tot = 0.0f;                                           // thread 0's
  int k0 = 0;
  int sg = 0;
  float wv = 0.0f;
  unsigned char ev = 1;
  if (static_cast<int>(threadIdx.x) < M) {
    if (!dense) sg = __ldg(seg + threadIdx.x);
    wv = __ldg(w + threadIdx.x);
    if (kQuant && q.enabled != nullptr) ev = __ldg(q.enabled + threadIdx.x);
  }
  for (; k0 < M; k0 += blockDim.x) {
    const int m = k0 + threadIdx.x;
    const bool match = m < M && (dense || sg == t);
    const float wm = wv;
    const unsigned char em = ev;
    if (m + static_cast<int>(blockDim.x) < M) {
      if (!dense) sg = __ldg(seg + m + blockDim.x);
      wv = __ldg(w + m + blockDim.x);
      if (kQuant && q.enabled != nullptr) ev = __ldg(q.enabled + m + blockDim.x);
    }
    int prefix;
    const int total = block_prefix(match, s_wc, prefix);
    if (match) {
      const int pos = count + prefix;
      if (pos < kListCap) {
        s_row[pos] = m;
        s_w[pos] = wm;
        if constexpr (kQuant) quant_shared().en[pos] = em;
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
      for (int k = 0; k < kStages - 1; ++k)
        issue<kQuant>(s_ring, x, s_row, k, count, N, c0, nv, amax_lf0, q.L);
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
  fold_piece<kQuant>(acc, s_ring, issued, x, s_row, s_w, listed, N, c0, nv, q, qt);

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
        if constexpr (kQuant) {
          quant_shared().en[n + prefix] = q.enabled != nullptr ? __ldg(q.enabled + m) : 1;
        }
      }
      n += total;
      __syncthreads();
    }
    resume = k;
    fold_piece<kQuant>(acc, s_ring, false, x, s_row, s_w, n, N, c0, nv, q, qt);
  }

  if (nv > 0) {
    if (base != nullptr) add_quad(acc, bv);
    store_quad(out + t * N + c0, nv, acc);
  }
}

constexpr int kAbsThreads = 256;
constexpr int kAbsQuads = 4;      // a warp's span: kAbsQuads x 128 contiguous columns

// Flushes a warp's running max (bits) of leaf `leaf` (warp-uniform; -1:
// none) into arow[leaf]: a max over the warp, then one atomicMax.
__device__ __forceinline__ void flush_run(unsigned* arow, int leaf, unsigned run) {
  if (leaf < 0) return;
  for (int o = 16; o > 0; o >>= 1) run = max(run, __shfl_xor_sync(0xffffffffu, run, o));
  if ((threadIdx.x & 31) == 0 && run != 0u) atomicMax(arow + leaf, run);
}

// amax[m, l] = max over leaf l's columns of |x[m, n] - ref[seg[m], n]| as
// bits, for every enabled row m (amax zeroed before).  A block takes
// kAbsThreads / 32 warps' spans of columns, the same for each of its rows
// blockIdx.y, blockIdx.y + gridDim.y, ... (one wave of blocks, no tail):
// the columns' leaves are found once, and each row's mask and segment are
// loaded a row ahead, so a row costs its loads and a few shuffles.
__global__ void __launch_bounds__(kAbsThreads)
quant_absmax_kernel(const float* __restrict__ x, const int* __restrict__ seg,
                    const float* __restrict__ ref,
                    const unsigned char* __restrict__ enabled,
                    const int* __restrict__ leaf_off, int L,
                    unsigned* __restrict__ amax, int M, long long N, int T) {
  __shared__ int s_off[kLeafCap + 1];
  const int lane = threadIdx.x & 31;
  const long long q0 =                                        // the warp's first quad
      (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5))
      * (32 * kAbsQuads);
  int m = blockIdx.y;
  unsigned char en = enabled != nullptr && m < M ? __ldg(enabled + m) : 1;
  int s = T > 1 && m < M ? __ldg(seg + m) : 0;
  const int* off = stage_offsets(s_off, leaf_off, L);

  // Each quad's first and last column's leaf, and per quad whether the
  // warp's 128 columns lie in one leaf (warp-uniform; quads past N are
  // never read).
  int first[kAbsQuads], last[kAbsQuads];
  unsigned one_leaf = 0u;
#pragma unroll
  for (int i = 0; i < kAbsQuads; ++i) {
    const long long c = (q0 + i * 32 + lane) * 4;
    const int nv = static_cast<int>(N - c < 4 ? N - c : 4);
    first[i] = nv > 0 ? leaf_of(off, L, c) : -1;
    last[i] = nv > 1 ? leaf_of(off, L, c + nv - 1) : first[i];
    const int lead = __shfl_sync(0xffffffffu, first[i], 0);
    if (__all_sync(0xffffffffu, nv <= 0 || (first[i] == lead && last[i] == lead)))
      one_leaf |= 1u << i;
  }

  for (; m < M; m += gridDim.y) {
    const int mn = m + gridDim.y;                             // the next row's, in flight
    const unsigned char en_next = enabled != nullptr && mn < M ? __ldg(enabled + mn) : 1;
    const int s_next = T > 1 && mn < M ? __ldg(seg + mn) : 0;
    if (en) {                                                 // block-uniform
      const float* xr = x + static_cast<long long>(m) * N;
      const float* gr = ref + static_cast<long long>(s) * N;
      float4 xv[kAbsQuads], gv[kAbsQuads];
#pragma unroll
      for (int i = 0; i < kAbsQuads; ++i) {
        const long long c = (q0 + i * 32 + lane) * 4;
        const int nv = static_cast<int>(N - c < 4 ? N - c : 4);
        xv[i] = load_quad(xr + c, nv);
        gv[i] = load_quad(gr + c, nv);
      }
      unsigned* arow = amax + static_cast<long long>(m) * L;
      int run_leaf = -1;
      unsigned run = 0u;
#pragma unroll
      for (int i = 0; i < kAbsQuads; ++i) {
        if ((q0 + i * 32) * 4 >= N) break;                   // warp-uniform
        const long long c = (q0 + i * 32 + lane) * 4;
        const int nv = static_cast<int>(N - c < 4 ? N - c : 4);
        unsigned a[4];
        a[0] = nv > 0 ? __float_as_uint(fabsf(__fsub_rn(xv[i].x, gv[i].x))) : 0u;
        a[1] = nv > 1 ? __float_as_uint(fabsf(__fsub_rn(xv[i].y, gv[i].y))) : 0u;
        a[2] = nv > 2 ? __float_as_uint(fabsf(__fsub_rn(xv[i].z, gv[i].z))) : 0u;
        a[3] = nv > 3 ? __float_as_uint(fabsf(__fsub_rn(xv[i].w, gv[i].w))) : 0u;
        if (one_leaf & (1u << i)) {
          const int lead = __shfl_sync(0xffffffffu, first[i], 0);
          if (lead != run_leaf) {
            flush_run(arow, run_leaf, run);
            run_leaf = lead;
            run = 0u;
          }
          run = max(run, max(max(a[0], a[1]), max(a[2], a[3])));
        } else {
          // the warp straddles a leaf boundary: each thread flushes its
          // own columns, leaf by leaf, walking the offsets from its first
          flush_run(arow, run_leaf, run);
          run_leaf = -1;
          run = 0u;
          int leaf = first[i];
          unsigned r = 0u;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < nv) {
              int lj = leaf;
              while (lj + 1 < L && off[lj + 1] <= c + j) ++lj;
              if (lj != leaf) {
                if (r != 0u) atomicMax(arow + leaf, r);
                leaf = lj;
                r = 0u;
              }
              r = max(r, a[j]);
            }
          }
          if (nv > 0 && r != 0u) atomicMax(arow + leaf, r);
        }
      }
      flush_run(arow, run_leaf, run);
    }
    en = en_next;
    s = s_next;
  }
}

template <bool kQuant>
int launch_fold(const float* w, const float* x, const int* seg, const float* base,
                float* out, int M, int N, int T, int normalize, const QuantArgs& q,
                int device, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long quads = (static_cast<long long>(N) + 3) / 4;
  const int threads = block_threads(quads, sms);
  const long long col_blocks = (quads + threads - 1) / threads;
  if (col_blocks * T > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fed_reduce_kernel<kQuant><<<static_cast<unsigned>(col_blocks * T), threads, 0, stream>>>(
      w, x, seg, base, out, M, N, T, static_cast<int>(col_blocks), normalize, q);
  return static_cast<int>(cudaGetLastError());
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
  return launch_fold<false>(
      static_cast<const float*>(w), static_cast<const float*>(x),
      static_cast<const int*>(seg), static_cast<const float*>(base),
      static_cast<float*>(out), M, N, T, normalize, QuantArgs{},
      device, static_cast<cudaStream_t>(stream));
}

// The int8 round trip's first pass alone: zeroes scratch (M, L) 4-byte
// words (cudaMemsetAsync) and fills scratch[m, l] with the bits of max |x[m,
// n] - quant_ref[seg[m], n]| over leaf l's columns, for every enabled row m
// (the rest stay 0).  quant_ref: (T, N) f32; enabled: (M,) uint8 0/1, or
// null for every row; leaf_off: (L + 1,) i32 on the device, 0 = off[0] <
// off[1] < ... < off[L] = N.  One launch on `stream`; returns the first
// CUDA error.  Allocates nothing.
extern "C" int fed_reduce_quant_absmax_f32(const void* x, const void* seg,
                                           const void* quant_ref, const void* enabled,
                                           const void* leaf_off, int L, void* scratch,
                                           int M, int N, int T, int device, void* stream) {
  using namespace fedk;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M < 0 || N <= 0 || T <= 0 || L <= 0 || L > N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(M) * L * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quant_absmax_kernel,
                                                      kAbsThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long quads = (static_cast<long long>(N) + 3) / 4;
  const long long span = static_cast<long long>(kAbsThreads / 32) * 32 * kAbsQuads;
  const long long tiles = (quads + span - 1) / span;
  long long rows = static_cast<long long>(per_sm) * sms / tiles;   // one wave
  rows = rows < 1 ? 1 : (rows < M ? rows : M);
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(rows < 65535 ? rows : 65535));
  quant_absmax_kernel<<<grid, kAbsThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const int*>(seg),
      static_cast<const float*>(quant_ref), static_cast<const unsigned char*>(enabled),
      static_cast<const int*>(leaf_off), L, static_cast<unsigned*>(scratch), M, N, T);
  return static_cast<int>(cudaGetLastError());
}

// fed_reduce_f32 with the int8 upload round trip of the enabled rows
// against quant_ref (the header's note; the arguments as for
// fed_reduce_quant_absmax_f32, whose pass runs first and fills scratch).
// Two launches on `stream` (the absmax pass, then the fold) after the
// memset; returns the first CUDA error.  Allocates nothing.
extern "C" int fed_reduce_quant_f32(const void* w, const void* x, const void* seg,
                                    const void* base, void* out, const void* quant_ref,
                                    const void* enabled, const void* leaf_off, int L,
                                    void* scratch, int M, int N, int T, int normalize,
                                    int device, void* stream) {
  using namespace fedk;
  const int err = fed_reduce_quant_absmax_f32(x, seg, quant_ref, enabled, leaf_off, L,
                                              scratch, M, N, T, device, stream);
  if (err != 0) return err;
  const QuantArgs q{static_cast<const float*>(quant_ref),
                    static_cast<const unsigned char*>(enabled),
                    static_cast<const int*>(leaf_off),
                    static_cast<const unsigned*>(scratch), L};
  return launch_fold<true>(
      static_cast<const float*>(w), static_cast<const float*>(x),
      static_cast<const int*>(seg), static_cast<const float*>(base),
      static_cast<float*>(out), M, N, T, normalize, q, device,
      static_cast<cudaStream_t>(stream));
}
