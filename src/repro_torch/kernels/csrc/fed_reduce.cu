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
// a row, across column tiles, so the fold cannot start before every block
// has read the rows once.  fed_reduce_quant_kernel does it all in one
// cooperative launch (no memset, no second kernel): a persistent grid of
// the blocks that fit on the card at once (4 an SM) runs three phases with
// a grid barrier (cooperative_groups' grid sync) after each of the first
// two.
//
// * Zero.  The blocks zero the scratch, a slice each: the (M, L) maxes
//   and, after them, the fold's item counter.
// * Absmax.  A unit is one enabled row's run of column tiles: each block
//   lists the enabled rows with warp ballots, each row's tiles are cut
//   into S = (blocks) / (enabled rows) units, and block b takes units b,
//   b + blocks, ... of them, so that the enabled rows fill the grid
//   evenly whatever the mask (a sweep's int8 lanes are every other lane,
//   160 of 512 rows).  A block streams its unit's row and the quant_ref
//   row beside it through a cp.async ring of slot pairs (kAbsPairs - 1
//   tiles in flight a thread, no registers held); a thread keeps a running
//   max of |d| for the leaf its columns are in, folds it into the block's
//   per-leaf maxes in shared memory (atomicMax on the bits) when the leaf
//   changes, and the block flushes one atomicMax a leaf into scratch[m,
//   leaf].  Non-negative floats order as their bits, so any split and any
//   order give the same max; a NaN orders above every number and
//   propagates, as in the reference.  One global atomic a (unit, leaf):
//   one a warp and row would queue on the scratch's few cache lines, whose
//   same-line atomics the L2 takes one after another.  The first unit's
//   copies go out before the zeroing and the first barrier.
// * Fold.  The blocks walk the fold's (segment, column tile) items: item
//   blockIdx.x first, then each the next from the counter (T = 16 has more
//   items than blocks, and the sweep pads segment 0 to 224 of its 512
//   rows, whose items take the longest).  An item is the kernel above: its ballot lists, weight totals, row ring
//   and pack order, two rows at a time.  For the first item the list and
//   the first row copies go out before the second barrier; after it each
//   piece of listed rows has (scale, 1/scale) staged in shared memory, one
//   pair per (listed row, leaf of the tile), from scratch read with
//   ld.global.cg (the maxes were written in this launch, so never through
//   the non-coherent or L1 path), a disabled row's scale -1.  A piece holds
//   at most kScaleCap / (the tile's leaves) rows, so a tile across many
//   narrow leaves folds in more, smaller pieces.  An enabled row is
//   round-tripped in registers as it leaves its ring slot (round_trip: the
//   quotient from the staged reciprocal wherever that provably rounds as
//   __fdiv_rn does, __fdiv_rn near a half-integer), a disabled one folded
//   as it is; the rounded rows never touch memory.
// * What bounds it: bytes.  The least is the fold's (rows, base, out) plus
//   quant_ref; the absmax phase reads the enabled rows a second time, which
//   at the main path's sizes (<= 27 MB) the fold then finds in the 50 MB
//   L2.  In PERF.md's measurements the launch's fixed costs (the two
//   barriers, the dependent loads before the first) and, at T = 1, the
//   fold's few warps an SM (one tile's quads) weigh more than the bytes.
// * Bit-exactness: each max is order-free, each column's fold is the plain
//   fold in pack order whatever the grid and the pieces, and the round
//   trip's q is rint of the IEEE quotient.
// * Residency: a grid barrier needs every block resident, which the
//   cooperative launch guarantees or refuses (the error is returned; no
//   other path is taken).  Calls back to back on a stream may reuse one
//   scratch: each call zeroes it before any block takes a max.

#include <cooperative_groups.h>

#include "common.cuh"

namespace fedk {

constexpr int kStages = 8;        // ring slots a thread: kStages - 1 rows in flight
constexpr int kListCap = 1024;    // listed rows a block holds at a time
constexpr int kLeafCap = 256;     // leaf offsets a block stages in shared memory
constexpr float kRecip127 = 1.0f / 127.0f;   // the f32 reciprocal XLA multiplies by

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

// Waits until at most kStages - 1 commit groups of this thread are in flight.
__device__ __forceinline__ void wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
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
    const int slot = (k % kStages) * blockDim.x + threadIdx.x;
    copy_quad(reinterpret_cast<float*>(ring + slot), x + row * N + c0, nv);
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
    wait_ring();
    const int slot = (k % kStages) * blockDim.x + threadIdx.x;
    fold_quad(acc, s_w[k], ring[slot]);
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

// ---------------------------------------------------------------------------
// The int8 round trip: one cooperative launch (the header's note)
// ---------------------------------------------------------------------------

constexpr int kScaleCap = 1536;   // staged (scale, 1/scale) pairs a block: rows x leaves of a tile
constexpr int kAbsPairs = 6;      // the absmax ring: slot pairs a thread, kAbsPairs - 1 waves in flight
constexpr int kUnitLeaves = 512;  // a unit's leaf maxes a block keeps in shared memory
constexpr float kTieMargin = 1.0f / 1024.0f;   // see round_trip

struct FoldArgs {
  const float* w;                  // (M,) weights
  const float* x;                  // (M, N) rows
  const int* seg;                  // (M,) segments (not read at T = 1)
  const float* base;               // (T, N) or null
  float* out;                      // (T, N)
  int M;
  long long N;
  int T;
  int normalize;
};

struct QuantArgs {
  const float* ref;                // (T, N) reference rows
  const unsigned char* enabled;    // (M,) 0/1, or null: every row
  const int* leaf_off;             // (L + 1,) the leaves' first columns, then N
  unsigned* amax;                  // (M, L) scratch: max |d| as bits, zeroed here
  int L;
};

// A block's shared memory in the round trip's kernel: the absmax phase's
// deeper ring and a unit's leaf maxes, or the fold's ring, lists and staged
// scales (a block is in one phase at a time).
struct QuantSmem {
  union {
    struct {
      float4 ring[2 * kAbsPairs * kMaxThreads];
      unsigned amax[kUnitLeaves];  // the unit's first leaf at 0
      int rows[kListCap];          // the enabled rows in pack order, while they fit
    } absmax;
    struct {
      float4 ring[kStages * kMaxThreads];
      int row[kListCap];
      float w[kListCap];
      float2 scale[kScaleCap];     // (listed row, leaf of the tile) -> (scale, 1/scale); x < 0: raw
    } fold;
  };
  float stage[kMaxThreads];
  int off[kLeafCap + 1];
  int wc[kMaxThreads / 32];
  float tot;
  int resume;
  int next[2];                     // the fold's next item, fetched one item ahead
};

__device__ __forceinline__ void grid_sync() {
  cooperative_groups::this_grid().sync();
}

// Zeroes the scratch, the (M, L) maxes and the fold's item counter after
// them, a grid-strided slice a block.
__device__ __forceinline__ void zero_maxes(const QuantArgs& q, int M) {
  const long long words = static_cast<long long>(M) * q.L + 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < words; i += stride)
    q.amax[i] = 0u;
}

__device__ __forceinline__ unsigned abs_bits(float x, float g) {
  return __float_as_uint(fabsf(__fsub_rn(x, g)));
}

// Folds a thread's running max of leaf `leaf` into the unit's maxes in
// shared memory (leaf lu at 0), or, past kUnitLeaves of them, straight into
// scratch.
__device__ __forceinline__ void flush_max(QuantSmem& s, unsigned* arow, int lu, int leaf,
                                          unsigned run) {
  if (run == 0u) return;
  if (leaf - lu < kUnitLeaves) atomicMax(&s.absmax.amax[leaf - lu], run);
  else atomicMax(arow + leaf, run);
}

// Phase 2 for one unit: row m's (of segment sm) tiles [t0, t1), a wave of
// blockDim quads each.  Each wave's quads of the row and of quant_ref[sm]
// stream through the ring in pairs of slots, kAbsPairs - 1 waves in flight; a
// thread keeps a running max for the leaf it is in (columns go left to
// right, so its leaf only moves forward) and folds it into the block's
// per-leaf maxes in shared memory when the leaf changes; the block then
// flushes one atomicMax a leaf into scratch[m].  The first unit's copies go
// out before the zeroing and the grid barrier that `synced` records.
__device__ __forceinline__ void absmax_unit(QuantSmem& s, const FoldArgs& a,
                                            const QuantArgs& q, const int* off, int m,
                                            int sm, int t0, int t1, bool& synced) {
  const float* xr = a.x + static_cast<long long>(m) * a.N;
  const float* gr = q.ref + static_cast<long long>(sm) * a.N;
  const long long width = static_cast<long long>(blockDim.x) * 4;
  const long long cu = t0 * width;                            // the unit's first column
  const long long ce = t1 * width < a.N ? t1 * width : a.N;
  const int lu = leaf_of(off, q.L, cu);
  const int nlu = leaf_of(off, q.L, ce - 1) - lu + 1;
  const int waves = t1 - t0;
  const long long cf = cu + threadIdx.x * 4;                  // the thread's first column
  unsigned* arow = q.amax + static_cast<long long>(m) * q.L;

  auto issue_wave = [&](int j) {
    if (j < waves) {
      const long long c0 = cf + j * width;
      const int nv = static_cast<int>(a.N - c0 < 4 ? a.N - c0 : 4);
      const int slot = 2 * (j % kAbsPairs) * blockDim.x + threadIdx.x;
      copy_quad(reinterpret_cast<float*>(s.absmax.ring + slot), xr + c0, nv);
      copy_quad(reinterpret_cast<float*>(s.absmax.ring + slot + blockDim.x), gr + c0, nv);
    }
    commit();
  };
  for (int j = 0; j < kAbsPairs - 1; ++j) issue_wave(j);
  if (!synced) {
    zero_maxes(q, a.M);
    grid_sync();                                              // scratch is zero
    synced = true;
  }
  int lf = cf < ce ? leaf_of(off, q.L, cf) : lu;              // the thread's leaf, moving forward
  int run_leaf = lf;
  unsigned run = 0u;
  for (int j = 0; j < waves; ++j) {
    issue_wave(j + kAbsPairs - 1);
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kAbsPairs - 1) : "memory");
    const long long c0 = cf + j * width;
    const int nv = static_cast<int>(a.N - c0 < 4 ? a.N - c0 : 4);
    if (nv <= 0) continue;
    const int slot = 2 * (j % kAbsPairs) * blockDim.x + threadIdx.x;
    const float4 x = s.absmax.ring[slot];
    const float4 g = s.absmax.ring[slot + blockDim.x];
    unsigned d[4];
    d[0] = abs_bits(x.x, g.x);
    d[1] = nv > 1 ? abs_bits(x.y, g.y) : 0u;
    d[2] = nv > 2 ? abs_bits(x.z, g.z) : 0u;
    d[3] = nv > 3 ? abs_bits(x.w, g.w) : 0u;
    const long long next = lf + 1 < q.L ? off[lf + 1] : a.N;  // the column after leaf lf
    if (c0 + nv <= next) {                                    // the quad lies in leaf lf
      run = max(run, max(max(d[0], d[1]), max(d[2], d[3])));
      continue;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c < nv) {
        while (lf + 1 < q.L && off[lf + 1] <= c0 + c) ++lf;
        if (lf != run_leaf) {
          flush_max(s, arow, lu, run_leaf, run);
          run_leaf = lf;
          run = 0u;
        }
        run = max(run, d[c]);
      }
    }
  }
  flush_max(s, arow, lu, run_leaf, run);
  __syncthreads();
  for (int i = threadIdx.x; i < nlu && i < kUnitLeaves; i += blockDim.x) {
    const unsigned v = s.absmax.amax[i];
    if (v != 0u) {
      atomicMax(arow + lu + i, v);
      s.absmax.amax[i] = 0u;
    }
  }
  __syncthreads();                                            // the maxes are zero again
}

// Lists the enabled rows in pack order into s.absmax.rows (while they fit
// in kListCap) with warp ballots, `ev` this thread's mask byte of the first
// chunk (loaded by the caller); returns their number.
__device__ __forceinline__ int list_enabled(QuantSmem& s, const FoldArgs& a,
                                            const QuantArgs& q, unsigned char ev) {
  int count = 0;
  for (int k = 0; k < a.M; k += blockDim.x) {
    const int m = k + threadIdx.x;
    const bool match = m < a.M && ev != 0;
    if (m + static_cast<int>(blockDim.x) < a.M) ev = __ldg(q.enabled + m + blockDim.x);
    int prefix;
    const int n = block_prefix(match, s.wc, prefix);
    if (match && count + prefix < kListCap) s.absmax.rows[count + prefix] = m;
    count += n;
    __syncthreads();
  }
  return count;
}

// Phase 2: every enabled row's max |d| per leaf into scratch.  A row's
// tiles are cut into S = gridDim.x / E units (E enabled rows; at most one
// a tile), and block b takes units b, b + gridDim.x, ... of the E x S
// (enabled row, segment) units, so that whatever rows the mask picks
// their units fill the grid evenly.  With more enabled rows than
// kListCap (so S = 1), the units are the M rows', a disabled row's
// skipped.  A leaf across units gets one atomicMax from each.  `ev` is
// this thread's mask byte of the first chunk.
__device__ __forceinline__ void absmax_phase(QuantSmem& s, const FoldArgs& a,
                                             const QuantArgs& q, const int* off,
                                             int col_blocks, unsigned char ev,
                                             bool& synced) {
  const int enabled = q.enabled != nullptr ? list_enabled(s, a, q, ev) : a.M;
  const bool listed = q.enabled != nullptr && enabled <= kListCap;
  for (int i = threadIdx.x; i < kUnitLeaves; i += blockDim.x) s.absmax.amax[i] = 0u;
  __syncthreads();
  int units = enabled > 0 ? static_cast<int>(gridDim.x) / enabled : 1;
  units = units < 1 ? 1 : (units > col_blocks ? col_blocks : units);
  const long long total =
      static_cast<long long>(listed || q.enabled == nullptr ? enabled : a.M) * units;
  for (long long u = blockIdx.x; u < total; u += gridDim.x) {
    const int r = static_cast<int>(u / units);
    const int m = listed ? s.absmax.rows[r] : r;
    const int sm = a.T > 1 ? __ldg(a.seg + m) : 0;
    if (!listed && q.enabled != nullptr && __ldg(q.enabled + m) == 0) continue;   // block-uniform
    const long long k = u % units;
    absmax_unit(s, a, q, off, m, sm, static_cast<int>(col_blocks * k / units),
                static_cast<int>(col_blocks * (k + 1) / units), synced);
  }
}

// This thread's entry of the chunk of rows from k: its segment (0 when
// dense) and weight, or 0 past M.
__device__ __forceinline__ void load_chunk(const FoldArgs& a, int k, bool dense, int& sg,
                                           float& wv) {
  sg = 0;
  wv = 0.0f;
  if (k + static_cast<int>(threadIdx.x) < a.M) {
    if (!dense) sg = __ldg(a.seg + k + threadIdx.x);
    wv = __ldg(a.w + k + threadIdx.x);
  }
}

// Lists, in pack order, rows m >= k of segment t (every row when dense)
// into the fold's row and weight lists at positions < cap; the match at
// position cap, if any, goes to s.resume.  (sg, wv) is the chunk from k
// (load_chunk).  With `total` the scan runs to M and thread 0 folds every
// match's weight into `tot`; without, it stops after the chunk that
// reaches cap.  Unless `issued`, the ring's first kStages - 1 copies go
// out as soon as that many rows are listed.  Returns the matches seen and
// leaves `k` where the scan stopped.
__device__ __forceinline__ int list_rows(QuantSmem& s, const FoldArgs& a, int t, bool dense,
                                         int cap, bool total, int& k, int sg, float wv,
                                         float& tot, bool& issued, long long c0, int nv) {
  int count = 0;
  for (; k < a.M; k += blockDim.x) {
    const int m = k + threadIdx.x;
    const bool match = m < a.M && (dense || sg == t);
    const float wm = wv;
    if (m + static_cast<int>(blockDim.x) < a.M) {
      if (!dense) sg = __ldg(a.seg + m + blockDim.x);
      wv = __ldg(a.w + m + blockDim.x);
    }
    int prefix;
    const int n = block_prefix(match, s.wc, prefix);
    if (match) {
      const int pos = count + prefix;
      if (pos < cap) {
        s.fold.row[pos] = m;
        s.fold.w[pos] = wm;
      } else if (pos == cap) {
        s.resume = m;                                         // first row not listed
      }
      if (total) s.stage[prefix] = wm;
    }
    __syncthreads();
    if (total && threadIdx.x == 0) {
      for (int i = 0; i < n; ++i) tot = __fadd_rn(tot, s.stage[i]);
    }
    count += n;
    const int listed = count < cap ? count : cap;
    if (!issued && listed >= kStages - 1) {
      for (int j = 0; j < kStages - 1; ++j)
        issue(s.fold.ring, a.x, s.fold.row, j, listed, a.N, c0, nv);
      issued = true;
    }
    if (!total && count >= cap) {
      k += blockDim.x;
      break;
    }
  }
  return count;
}

// Each listed row's (scale, 1/scale) for each leaf of the tile (leaves la
// .. la + nl - 1), from the maxes this launch wrote (ld.global.cg: never a
// cached copy from before the barrier); a disabled row's scale -1.  With
// normalize, also divides the listed weights by the segment's total.
__device__ __forceinline__ void stage_piece(QuantSmem& s, const QuantArgs& q, int listed,
                                            int la, int nl, int normalize, float wtot) {
  for (int i = threadIdx.x; i < listed * nl; i += blockDim.x) {
    const int k = i / nl;
    const long long row = s.fold.row[k];
    const bool en = q.enabled == nullptr || __ldg(q.enabled + row) != 0;
    const float sc = leaf_scale(__ldcg(q.amax + row * q.L + la + (i - k * nl)));
    s.fold.scale[i] = en ? make_float2(sc, __frcp_rn(sc)) : make_float2(-1.0f, 0.0f);
  }
  if (normalize) {
    for (int i = threadIdx.x; i < listed; i += blockDim.x)
      s.fold.w[i] = __fdiv_rn(s.fold.w[i], wtot);
  }
}

// x' = clamp(rint((x - g) / scale), -127, 127) * scale + g for a quad, each
// column with its leaf's (scale, 1/scale); the product and the sum rounded
// once.  rint rounds half to even; the clamp is taken on the float, and
// adding +0 turns -0 into +0, as the reference's int8 cast does (a NaN
// quotient becomes 0, as that cast makes it).  The quotient d / scale is
// taken as d * (1/scale) where that rounds to the same integer: |d| <=
// amax and scale >= RN(amax * RN(1/127)) (or 1e-12 with amax below
// 1.27e-10), so the exact quotient Q has |Q| < 128; RN(1/scale) and the
// product are each within 2^-24 of their exact values, so d * (1/scale)
// lies within 3 * 2^-24 * 128 < 2.3e-5 of the IEEE quotient RN(Q).  rint
// is constant between half-integers, so wherever d * (1/scale) is farther
// than kTieMargin (~1e-3) from every half-integer the two give the same q.
// A quotient near a half-integer (an exact tie among them), and any NaN,
// takes the IEEE division (__fdiv_rn); the common case is one straight run
// of arithmetic for the four columns.
__device__ __forceinline__ void round_trip(float4& v, const float4& g, const float2 (&sr)[4]) {
  constexpr float kFar = 0.5f - kTieMargin;  // |quot - rint(quot)| below it: no tie near
  const float gq[4] = {g.x, g.y, g.z, g.w};
  float d[4] = {v.x, v.y, v.z, v.w};
  float quot[4], q[4];
  bool near = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d[i] = __fsub_rn(d[i], gq[i]);
    quot[i] = __fmul_rn(d[i], sr[i].y);
    q[i] = rintf(quot[i]);
    near |= !(fabsf(quot[i] - q[i]) < kFar);
  }
  if (near) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!(fabsf(quot[i] - q[i]) < kFar)) {
        const float exact = __fdiv_rn(d[i], sr[i].x);
        q[i] = isnan(exact) ? 0.0f : rintf(exact);
      }
    }
  }
  float x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float qc = __fadd_rn(fminf(fmaxf(q[i], -127.0f), 127.0f), 0.0f);
    x[i] = __fmaf_rn(qc, sr[i].x, gq[i]);
  }
  v = make_float4(x[0], x[1], x[2], x[3]);
}

// The round trip of list entry k's quad from the staged scales: the thread's
// quad of quant_ref[t] and its four columns' leaves, relative to the tile's
// first leaf.
struct StagedRoundTrip {
  const float2* scale;
  int nl;
  int r0, r1, r2, r3;
  float4 g;
  __device__ __forceinline__ void operator()(float4& v, int k) const {
    const float2* sc = scale + k * nl;
    float2 sr[4];
    sr[0] = sc[r0];
    if (sr[0].x < 0.0f) return;                               // sent raw
    sr[1] = r1 == r0 ? sr[0] : sc[r1];
    sr[2] = r2 == r1 ? sr[1] : sc[r2];
    sr[3] = r3 == r2 ? sr[2] : sc[r3];
    round_trip(v, g, sr);
  }
};

// fold_piece with the round trip, two rows at a time so that their round
// trips (eight independent columns) overlap; the sum keeps pack order.
// kStages - 2 rows beyond the pair are in flight.
__device__ __forceinline__ void fold_piece_rt(float4& acc, float4* ring, bool issued,
                                              const float* x, const int* s_row,
                                              const float* s_w, int n, long long N,
                                              long long c0, int nv,
                                              const StagedRoundTrip& rt) {
  if (!issued) {
    for (int k = 0; k < kStages - 1; ++k) issue(ring, x, s_row, k, n, N, c0, nv);
  }
  int k = 0;
  for (; k + 1 < n; k += 2) {
    issue(ring, x, s_row, k + kStages - 1, n, N, c0, nv);   // into row k - 1's slot
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2) : "memory");
    float4 v0 = ring[(k % kStages) * blockDim.x + threadIdx.x];
    float4 v1 = ring[((k + 1) % kStages) * blockDim.x + threadIdx.x];
    issue(ring, x, s_row, k + kStages, n, N, c0, nv);       // into row k's slot
    rt(v0, k);
    rt(v1, k + 1);
    fold_quad(acc, s_w[k], v0);
    fold_quad(acc, s_w[k + 1], v1);
  }
  if (k < n) {
    issue(ring, x, s_row, k + kStages - 1, n, N, c0, nv);
    wait_ring();
    float4 v = ring[(k % kStages) * blockDim.x + threadIdx.x];
    rt(v, k);
    fold_quad(acc, s_w[k], v);
  }
}

// Phase 3 for one (segment, column tile) item: fed_reduce_kernel's fold with
// each enabled row round-tripped.  The first item waits at the grid barrier
// (`synced`) after its first list and copies are out, and takes its first
// chunk of segments and weights as loaded at the top of the kernel
// (sg0, w0).
__device__ __forceinline__ void fold_item(QuantSmem& s, const FoldArgs& a, const QuantArgs& q,
                                          const int* off, int col_blocks, int item,
                                          int sg0, float w0, bool& synced) {
  const int t = item / col_blocks;
  const long long width = static_cast<long long>(blockDim.x) * 4;
  const long long ct = (item % col_blocks) * width;           // the tile's first column
  const long long c0 = ct + threadIdx.x * 4;
  const int nv = static_cast<int>(a.N - c0 < 4 ? a.N - c0 : 4);   // <= 0: no columns
  const long long ce = ct + width < a.N ? ct + width : a.N;
  const bool dense = a.T == 1;                                // every row is t's

  __syncthreads();                           // the last item's lists and scales are read out
  const int la = leaf_of(off, q.L, ct);
  const int nl = leaf_of(off, q.L, ce - 1) - la + 1;
  const int cap = kScaleCap / nl < kListCap ? kScaleCap / nl : kListCap;
  bool issued = false;
  if (dense) {
    const int n0 = a.M < cap ? a.M : cap;
    for (int j = 0; j < kStages - 1; ++j)
      issue(s.fold.ring, a.x, nullptr, j, n0, a.N, c0, nv);
    issued = true;
  }
  // quant_ref[t]'s quad and each column's leaf (a column past N takes its
  // left neighbour's)
  StagedRoundTrip rt;
  rt.scale = s.fold.scale;
  rt.nl = nl;
  rt.r0 = nv > 0 ? leaf_of(off, q.L, c0) - la : 0;
  rt.r1 = nv > 1 ? leaf_of(off, q.L, c0 + 1) - la : rt.r0;
  rt.r2 = nv > 2 ? leaf_of(off, q.L, c0 + 2) - la : rt.r1;
  rt.r3 = nv > 3 ? leaf_of(off, q.L, c0 + 3) - la : rt.r2;
  rt.g = load_quad(q.ref + t * a.N + c0, nv);
  const float4 bv = a.base != nullptr ? load_quad(a.base + t * a.N + c0, nv)
                                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  float tot = 0.0f;                                           // thread 0's
  int k = 0;
  int sg = sg0;
  float wv = w0;
  if (synced) load_chunk(a, k, dense, sg, wv);
  int count = list_rows(s, a, t, dense, cap, a.normalize != 0, k, sg, wv, tot, issued, c0,
                        nv);
  int resume = count > cap ? s.resume : k;
  int listed = count < cap ? count : cap;
  if (a.normalize && threadIdx.x == 0) s.tot = tot > 0.0f ? tot : 1.0f;
  __syncthreads();
  const float wtot = a.normalize ? s.tot : 1.0f;
  if (!synced) {
    grid_sync();                                              // every max is in scratch
    synced = true;
  }
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (;;) {
    stage_piece(s, q, listed, la, nl, a.normalize, wtot);
    __syncthreads();
    fold_piece_rt(acc, s.fold.ring, issued, a.x, s.fold.row, s.fold.w, listed, a.N, c0, nv, rt);
    if (resume >= a.M) break;
    // more rows than one piece holds: list and fold the rest piece by
    // piece, in pack order
    __syncthreads();                                          // the piece is folded
    issued = false;
    k = resume;
    load_chunk(a, k, dense, sg, wv);
    count = list_rows(s, a, t, dense, cap, false, k, sg, wv, tot, issued, c0, nv);
    resume = count > cap ? s.resume : k;
    listed = count < cap ? count : cap;
  }

  if (nv > 0) {
    if (a.base != nullptr) add_quad(acc, bv);
    store_quad(a.out + t * a.N + c0, nv, acc);
  }
}

// The blocks that fit on the card at once (a cooperative launch), each a
// tile of the fold's width: zero the scratch, the absmax phase, then, with
// `fold`, the fold over the (segment, tile) items; a grid barrier after
// each of the first two.
__global__ void __launch_bounds__(kMaxThreads, 4)
fed_reduce_quant_kernel(FoldArgs a, QuantArgs q, int col_blocks, int fold) {
  __shared__ __align__(16) QuantSmem s;
  // the loads that nothing before them decides, issued together: this
  // thread's mask byte of the first chunk, the fold's first chunk
  const unsigned char ev =
      q.enabled != nullptr && static_cast<int>(threadIdx.x) < a.M ? __ldg(q.enabled + threadIdx.x) : 0;
  int sg0 = 0;
  float w0 = 0.0f;
  if (fold) load_chunk(a, 0, a.T == 1, sg0, w0);
  const int* off = stage_offsets(s.off, q.leaf_off, q.L);
  bool synced = false;
  absmax_phase(s, a, q, off, col_blocks, ev, synced);
  if (!synced) {
    zero_maxes(q, a.M);
    grid_sync();
  }
  if (!fold) return;

  // items blockIdx.x first, then in turn from the counter after the maxes
  // (zeroed with them), so that a segment of many rows (the sweep pads
  // segment 0) holds up no block's later items
  synced = false;
  unsigned* counter = q.amax + static_cast<long long>(a.M) * q.L;
  int i = 0;
  for (int item = blockIdx.x; item < a.T * col_blocks; ++i) {
    if (threadIdx.x == 0) s.next[i & 1] = gridDim.x + static_cast<int>(atomicAdd(counter, 1u));
    fold_item(s, a, q, off, col_blocks, item, sg0, w0, synced);
    item = s.next[i & 1];                    // written before fold_item's first barrier
  }
  if (!synced) grid_sync();
}

int launch_fold(const float* w, const float* x, const int* seg, const float* base,
                float* out, int M, int N, int T, int normalize, int device,
                cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long quads = (static_cast<long long>(N) + 3) / 4;
  const int threads = block_threads(quads, sms);
  const long long col_blocks = (quads + threads - 1) / threads;
  if (col_blocks * T > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fed_reduce_kernel<<<static_cast<unsigned>(col_blocks * T), threads, 0, stream>>>(
      w, x, seg, base, out, M, N, T, static_cast<int>(col_blocks), normalize);
  return static_cast<int>(cudaGetLastError());
}

// One cooperative launch of fed_reduce_quant_kernel: a grid of the blocks
// that fit on the card at once, or fewer where the work has fewer (tile,
// row) pairs and (segment, tile) items.  Returns the launch's error; a
// grid the card cannot hold at once is refused, never split.
int launch_quant(const FoldArgs& a, const QuantArgs& q, int fold, int device,
                 cudaStream_t stream) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long quads = (a.N + 3) / 4;
  const int threads = block_threads(quads, sms);
  const long long col_blocks = (quads + threads - 1) / threads;
  if (col_blocks * (a.M > a.T ? a.M : a.T) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fed_reduce_quant_kernel,
                                                      threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long work = col_blocks * (a.M > a.T ? a.M : a.T);
  const long long grid = work < static_cast<long long>(per_sm) * sms
                             ? work : static_cast<long long>(per_sm) * sms;
  FoldArgs fa = a;
  QuantArgs qa = q;
  int cb = static_cast<int>(col_blocks);
  int fl = fold;
  void* args[] = {&fa, &qa, &cb, &fl};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fed_reduce_quant_kernel),
                                    dim3(static_cast<unsigned>(grid)), dim3(threads), args,
                                    0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  return launch_fold(
      static_cast<const float*>(w), static_cast<const float*>(x),
      static_cast<const int*>(seg), static_cast<const float*>(base),
      static_cast<float*>(out), M, N, T, normalize, device,
      static_cast<cudaStream_t>(stream));
}

// The int8 round trip's first two phases alone, through the same kernel:
// zeroes scratch, M * L + 1 4-byte words (the maxes, then the fold's item
// counter), and fills scratch[m * L + l] with the bits of max |x[m, n] -
// quant_ref[seg[m], n]| over leaf l's columns, for every enabled row m
// (the rest stay 0).  quant_ref: (T, N) f32; enabled: (M,)
// uint8 0/1, or null for every row; leaf_off: (L + 1,) i32 on the device,
// 0 = off[0] < off[1] < ... < off[L] = N.  One cooperative launch on
// `stream` (none at M = 0); returns its error.  Allocates nothing.
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
  const FoldArgs a{nullptr, static_cast<const float*>(x), static_cast<const int*>(seg),
                   nullptr, nullptr, M, N, T, 0};
  const QuantArgs q{static_cast<const float*>(quant_ref),
                    static_cast<const unsigned char*>(enabled),
                    static_cast<const int*>(leaf_off), static_cast<unsigned*>(scratch), L};
  return launch_quant(a, q, 0, device, static_cast<cudaStream_t>(stream));
}

// fed_reduce_f32 with the int8 upload round trip of the enabled rows
// against quant_ref (the header's note; the arguments as for
// fed_reduce_quant_absmax_f32, whose phases run first and fill scratch).
// One cooperative launch on `stream`, also at M = 0 (out = base or 0);
// returns its error.  Allocates nothing.
extern "C" int fed_reduce_quant_f32(const void* w, const void* x, const void* seg,
                                    const void* base, void* out, const void* quant_ref,
                                    const void* enabled, const void* leaf_off, int L,
                                    void* scratch, int M, int N, int T, int normalize,
                                    int device, void* stream) {
  using namespace fedk;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M < 0 || N <= 0 || T <= 0 || L <= 0 || L > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const FoldArgs a{static_cast<const float*>(w), static_cast<const float*>(x),
                   static_cast<const int*>(seg), static_cast<const float*>(base),
                   static_cast<float*>(out), M, N, T, normalize};
  const QuantArgs q{static_cast<const float*>(quant_ref),
                    static_cast<const unsigned char*>(enabled),
                    static_cast<const int*>(leaf_off), static_cast<unsigned*>(scratch), L};
  return launch_quant(a, q, 1, device, static_cast<cudaStream_t>(stream));
}
