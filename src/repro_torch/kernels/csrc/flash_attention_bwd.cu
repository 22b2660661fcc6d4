// flash_attention_bwd for Hopper (sm_90a): the gradient of the causal /
// sliding-window GQA attention with a tanh soft-cap that
// flash_attention.cu computes, from the forward's output and its per-row
// log-sum-exp.
//
//   s   = cap(scale * q . k),  P = exp(s - lse),  dP = dO . v
//   delta = rowsum(dO * O),    dS = P (dP - delta) * (1 - tanh^2)  (cap only)
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO
//
// with dS and P zero where the mask is off.  Query s sits at key position
// s + (T - S), as in the forward.  A kv head's dK and dV sum the rows of all
// G = H / Kh query heads of its group; rows are numbered f = position * G +
// g, as in the forward, so the causal frontier and the window bound a
// contiguous row range.
//
// Replaces, on the training path, the gradient the reference takes around
// the TPU kernel src/repro/kernels/flash_attention.py:32 (_kernel, whose
// forward this inverts): the jnp custom VJP of
// src/repro/models/attention.py:229 (_flash_backward: a q-major pass for dq
// and a kv-major pass for dk/dv, recomputing each block's P from the saved
// lse).  No Pallas kernel has a backward.
//
// What bounds it: operations.  Each live (query, key) pair costs five
// products of length D (S, dP, dV, dK, dQ): 10 D flops.  At gemma2-2b's
// global layer (B=2, H=8, S=T=4096, D=256, causal) that is 3.44e11 flops;
// run as 3xTF32 on the tensor cores (three TF32 products for each f32 one,
// 495 TFLOP/s) it takes at least 2.08 ms, against 0.40 GB of bytes.  Like
// the reference, this design recomputes S and dP for dQ (14 D flops a pair,
// 1.4x the bound's work): determinism rules out atomics, and a dQ partial
// per key tile would cost more bytes than the recompute.
//
// The design (deterministic: no atomics, every sum in a fixed order, so two
// calls give the same bits):
//
//  * Every product on the tensor cores as wgmma with split operands,
//    a b ~= a_hi b_hi + a_hi b_lo + a_lo b_hi, f32 accumulation, as the
//    forward: A_hi . [B_hi; B_lo] is one m64n64k8 (B's planes stacked) and
//    A_lo . B_hi one m64n32k8.  .tf32 wgmma reads B only K-major from shared
//    memory, so each product puts in B an operand that is split once per
//    call or made in the block:
//      S    = Q K^T,   dP = dO V^T    M = 64 rows, N = 32 keys, B = K or V
//      dV^T = dO^T P,  dK^T = Q^T dS  M = 64 dims, N = 32 keys, B = P or dS
//      dQ^T = K^T dS^T                M = 64 dims, N = 32 rows, B = dS
//    and takes A (Q, dO, their transposes, K^T) from registers.
//  * Operands split once.  A prep pass (attn_bwd_prep, the first launch of
//    the entry point) writes into scratch the wrapper allocates: every
//    32-key tile of K and V as hi/lo planes (x_hi = tf32_rna(x), x_lo =
//    tf32_rna(x - x_hi)) in wgmma's no-swizzle K-major layout, and every
//    64-row tile of Q and dO raw with the rows' lse and delta = rowsum(dO O)
//    (the prep computes it), both per 64-wide head-dim chunk, so a block
//    copies a tile as it is.  Q and dO stay raw, half the bytes of two
//    planes on the side that is streamed: a warp splits its A fragments as
//    it loads them (cut to TF32, split_a), each element once per product,
//    where mma.sync had every warp split its own fragments.  P and dS are
//    split once, as they are written.
//  * One launch (attn_bwd_main), two kinds of block of two warpgroups.
//    kv-major blocks own a 32-key tile of one (b, kv head) and walk, 64 rows
//    a step, every row of its G heads that sees one of its keys, keeping dK
//    and dV; q-major blocks own a 64-row tile and walk the key tiles its
//    rows see (the forward's tile skipping), keeping dQ.  In a step
//    warpgroup 0 computes S and warpgroup 1 dP; each hands the other half
//    of its 16 elements a thread (same fragment layout, thread for thread,
//    through shared memory), so both make P and dS for 8 of them and write
//    the planes; then warpgroup 0 accumulates dV^T and warpgroup 1 dK^T, or
//    each dQ^T for 32 of the 64 rows.
//  * An asynchronous ring.  The block's own tile (K and V planes, or its Q
//    and dO rows) arrives once by bulk copy (cp.async.bulk, the TMA
//    engine); the streamed tiles arrive one head-dim chunk at a time by
//    bulk copy into a ring of slots, each on a full and an empty mbarrier:
//    thread 0 starts the copy of load n + depth as soon as the 8 warps have
//    released load n.  Depth 4-8 at D <= 128, where a step's chunks stay in
//    the ring for the dV/dK (dQ) products while the next step's arrive; 2 at
//    D = 256, where the block's own tile (128 KB) leaves room for no more:
//    the last 2 of the 4 chunks stay, and the first 2 are copied again.
//  * The products run in batches of 4 k-steps, and the next batch's A
//    fragments are loaded and split while the tensor cores run this one
//    (two register sets).
//  * Accumulation: short sums in the tensor cores, running sums in f32.
//    The tensor cores' f32 accumulation truncates, so a gradient summed over
//    a whole walk inside them drifts (tests/test_torch_attn_bwd.py: 1.1e-4
//    of max-abs over recurrentgemma's 33,280-row walk).  The flush period
//    is one step: dV^T and dK^T are summed in the tensor cores over one
//    64-row step, dQ^T over one 32-key step, S and dP over one 64-wide
//    head-dim chunk, each from a fresh accumulator, and added to the running
//    sums on the f32 pipes (emulated: ~1.5e-6).  The transposed products
//    (M = D, N = 32) keep the running sums at D / 4 registers a thread.
//  * The grid.  The kind whose longest walk costs more goes first, each
//    kind ordered longest walk first (under a causal mask the first key
//    tiles and the last row tiles), so the hardware hands out the long
//    walks first and the short blocks fill the tail.  With MQA
//    (recurrentgemma, Kh = 1) the 256 kv-major blocks are followed by 2,048
//    q-major ones; nothing splits a walk.  At 1 block an SM on 132 SMs that
//    is 17.5 waves; gemma2-2b's layers give 15.5 (1,024 + 1,024 blocks) and
//    seamless-m4t's cross-attention 9.7 (256 q-major first, then 1,024).
//  * Shared memory (1 block an SM): at D = 256 the kv-major block holds its
//    K and V planes (128 KB), 2 ring slots of a row chunk (33,280 B each)
//    and the P and dS planes (32 KB): 230,440 B.
//
// Layout through strides: q, dq (B, H, S, D); k, v, dk, dv (B, Kh, T, D);
// out, dout (B, H, S, D); each addressed by (batch, head, position)
// strides with the head dim contiguous and rows 16-byte aligned.  lse is
// (B, H, S) contiguous.  Ragged S and T: rows past S G and keys past T are
// zero in the scratch and masked.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace fedk {
namespace attn_bwd {

constexpr int kBq = 64;             // rows of a row tile (one wgmma M)
constexpr int kBk = 32;             // keys of a key tile
constexpr int kThreads = 256;       // two warpgroups
constexpr int kSmemCap = 232448;    // the most a block may ask for
constexpr int kPlaneP = kBq * kBk;  // floats of one P or dS plane
// named barriers (0 is __syncthreads)
constexpr int kBarX = 1, kBarY = 2, kBarZ = 3;

// The deepest ring, at most 8 slots, that fits beside `base` bytes.
constexpr int ring_depth(size_t base, size_t slot) {
  int n = 8;
  while (n > 2 && base + n * slot > static_cast<size_t>(kSmemCap)) --n;
  return n;
}

template <int D>
struct Cfg {
  static constexpr int DC = D < 64 ? D : 64;      // head-dim chunk
  static constexpr int NC = D / DC;              // chunks
  // a row chunk block: lse[64], delta[64], Q[64][DC], dO[64][DC] (raw; the
  // 8-byte units of row r stored at u ^ 4 (r & 3))
  static constexpr int RCB = 2 * kBq + 2 * kBq * DC;
  // a key chunk block: K_hi, K_lo, V_hi, V_lo planes of 32 keys x DC
  static constexpr int KCB = 4 * kBk * DC;
  // shared memory: the block's own tile, its planes, 2 barriers a ring
  // slot and one for the own tile; the ring as deep as fits
  static constexpr size_t kKvBase =
      sizeof(float) * (static_cast<size_t>(NC) * KCB + 4 * kPlaneP) + 8;
  static constexpr size_t kKvSlot = sizeof(float) * RCB + 16;
  static constexpr size_t kQBase =
      sizeof(float) * (static_cast<size_t>(NC) * RCB + 3 * kPlaneP) + 8;
  static constexpr size_t kQSlot = sizeof(float) * KCB + 16;
  static constexpr int NR_KV = ring_depth(kKvBase, kKvSlot);
  static constexpr int NR_Q = ring_depth(kQBase, kQSlot);
  static constexpr size_t kKvBytes = kKvBase + NR_KV * kKvSlot;
  static constexpr size_t kQBytes = kQBase + NR_Q * kQSlot;
  static constexpr size_t kSmemBytes = kKvBytes > kQBytes ? kKvBytes : kQBytes;
  static_assert(kKvBytes <= kSmemCap && kQBytes <= kSmemCap,
                "two ring slots must fit");
};

struct Args {
  const float* q; const float* k; const float* v; const float* o;
  const float* dout; const float* lse;
  float* rows;                       // scratch: row chunk blocks
  float* keys;                       // scratch: key chunk blocks
  float* dq; float* dk; float* dv;
  // (batch, head, position) strides of q, k, v, o, dout, dq, dk, dv
  long long st[24];
  int B, H, KH, S, T, causal, window;
  int n_rt, n_kt;                    // row tiles, key tiles of a (b, kv head)
  long long n_dkv, n_dq;             // kv-major and q-major blocks
  int dq_first;                      // the q-major blocks come first
  float scale, cap;
};

enum { kQ = 0, kK = 3, kV = 6, kO = 9, kDO = 12, kDQ = 15, kDK = 18, kDV = 21 };

// ---- tensor-core, barrier and copy helpers ---------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
// Waits for the phase; a wait that never ends (a fault in the ring) traps
// after 2^26 tries, seconds after any real wait would have ended, so the
// launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  for (unsigned tries = 0;; ++tries) {
    unsigned done;
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(phase) : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// dst <- src (bytes, a multiple of 16), completing on `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  mbar_expect(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}
// The streamed side's ring of NR slots, each on a full and an empty
// mbarrier.  Load n goes to slot n % NR: src(n) and bytes(n) say what it
// copies.  The block's 8 warps release each load, and thread 0 refills the
// slot with load n + NR once all of them have.
template <int NR>
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  long long total;                   // loads of the walk
  float* slots;
  int slot_floats;

  __device__ __forceinline__ void init() const {
    for (int i = 0; i < NR; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);
    }
  }

  template <class Src, class Bytes>
  __device__ __forceinline__ void fill(long long n, int slot, Src src,
                                       Bytes bytes) const {
    mbar_expect(full + slot, bytes(n));
    bulk_copy(slots + slot * slot_floats, src(n), bytes(n), full + slot);
  }
  // thread 0: the first NR loads
  template <class Src, class Bytes>
  __device__ __forceinline__ void start(Src src, Bytes bytes) const {
    for (int n = 0; n < NR && n < total; ++n) fill(n, n, src, bytes);
  }
  __device__ __forceinline__ void wait(long long n) const {
    mbar_wait(full + n % NR, static_cast<int>((n / NR) & 1));
  }
  template <class Src, class Bytes>
  __device__ __forceinline__ void release(long long n, Src src, Bytes bytes) const {
    const int slot = static_cast<int>(n % NR);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + slot);
    if (threadIdx.x == 0 && n + NR < total) {
      mbar_wait(empty + slot, static_cast<int>((n / NR) & 1));
      fill(n + NR, slot, src, bytes);
    }
  }
};
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
// generic-proxy writes to shared memory, before wgmma reads them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cvt.rna.tf32.f32's rounding on the bit pattern, as flash_attention.cu.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, hi));
}
// The A fragments' split, made as they are loaded: hi is x cut to TF32,
// lo = x - hi (exact) cut to TF32 too.  Three operations, where split's
// rounding takes five; x - hi - lo < 2^-20 |x|, where split leaves 2^-22,
// both far below the 2^-11 of one TF32 pass.
__device__ __forceinline__ void split_a(float x, float& hi, float& lo) {
  hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  lo = __uint_as_float(__float_as_uint(__fsub_rn(x, hi)) & 0xffffe000u);
}

// wgmma shared-memory matrix descriptor, no swizzle: lbo is the byte step
// between core matrices along K, sbo between 8-row groups along N.
__device__ __forceinline__ uint64_t smem_desc(const float* p, int lbo, int sbo) {
  const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((a >> 4) & 0x3fff) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (64 x N, f32) += a (64 x 8, TF32, registers) . b (8 x N, TF32, shared
// memory); acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const float (&a)[4],
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const float (&a)[4],
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])), "l"(db), "r"(acc));
}

// One 3xTF32 product over KS k-steps into fresh accumulators, added to
// `run` on the f32 pipes: the B planes are [B_hi; B_lo] stacked as one
// N = 64 operand (lo 4 8-row groups after hi), so A_hi . [B_hi; B_lo] is one
// m64n64k8 and A_lo . B_hi one m64n32k8.  load(ks, ah, al) gives k-step ks's
// split A fragment; desc(ks) its B descriptor.  The k-steps go in batches of
// KB, and the next batch's fragments are loaded and split while the tensor
// cores run this one (two register sets).
template <int KS, int KB, class Load, class Desc>
__device__ __forceinline__ void product(float (&run)[16], Load load, Desc desc) {
  constexpr int NB = KS / KB;
  constexpr int SETS = NB > 1 ? 2 : 1;
  float hh[32], lh[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) hh[i] = hh[i + 16] = lh[i] = 0.0f;
  float ah[SETS][KB][4], al[SETS][KB][4];
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) load(kk, ah[0][kk], al[0][kk]);
#pragma unroll
  for (int bt = 0; bt < NB; ++bt) {
    const int set = bt % SETS;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const int ks = bt * KB + kk;
      const uint64_t db = desc(ks);
      wgmma_n64(hh, ah[set][kk], db, ks > 0);
      wgmma_n32(lh, al[set][kk], db, ks > 0);
    }
    wgmma_commit();
    if (bt + 1 < NB) {
      // the set the next batch loads into is free once at most this batch
      // is in flight (two sets) or none is (one)
      if (SETS == 2) wgmma_wait<1>();
      else wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < KB; ++kk)
        load((bt + 1) * KB + kk, ah[(bt + 1) % SETS][kk], al[(bt + 1) % SETS][kk]);
    }
  }
  wgmma_wait<0>();
  pin(hh);
  pin(lh);
#pragma unroll
  for (int i = 0; i < 16; ++i) run[i] += hh[i] + (hh[i + 16] + lh[i]);
}

// Offset of (key n, row r) in a kv-major P or dS plane (K = rows).
__device__ __forceinline__ int p_off(int n, int r) {
  return (n >> 3) * 512 + (r >> 3) * 64 + ((r & 7) >> 2) * 32 + (n & 7) * 4 +
         (r & 3);
}
// Offset of (row n, key j) in the q-major dS planes (K = keys): 8-row groups
// interleaved as [hi rows 0-31][lo rows 0-31][hi rows 32-63][lo rows 32-63],
// so each warpgroup's half is one stacked [hi; lo] operand.
__device__ __forceinline__ int ds_off(int n, int j, int lo) {
  return ((n >> 5) * 8 + lo * 4 + ((n & 31) >> 3)) * 256 + (j >> 3) * 64 +
         ((j & 7) >> 2) * 32 + (n & 7) * 4 + (j & 3);
}
// The raw row chunk: the 8-byte unit u of row r sits at u ^ 4 (r & 3), so
// both fragment loads below hit 32 distinct banks.
template <int DC>
__device__ __forceinline__ float2 row_pair(const float* rows, int r, int u) {
  return *reinterpret_cast<const float2*>(rows + r * DC + 2 * (u ^ (4 * (r & 3))));
}

// ---- the prep pass ---------------------------------------------------------

// A row tile: lse, delta and raw Q and dO of 64 rows, per chunk.  A key
// tile: the K and V planes of 32 keys, per chunk.  Stores are 16 bytes a
// thread at consecutive addresses.
template <int D>
__global__ void __launch_bounds__(256)
attn_bwd_prep(const Args p) {
  using C = Cfg<D>;
  constexpr int DC = C::DC, NC = C::NC, C4 = D / 4;
  const long long heads = static_cast<long long>(p.B) * p.KH;
  const long long n_row_blocks = heads * p.n_rt;
  const int G = p.H / p.KH, SG = p.S * G;
  const int tid = threadIdx.x;
  if (blockIdx.x < n_row_blocks) {
    const long long hb = blockIdx.x / p.n_rt;     // b * KH + kh
    const int rt = static_cast<int>(blockIdx.x - hb * p.n_rt);
    const long long b = hb / p.KH;
    const int kh = static_cast<int>(hb - b * p.KH);
    float* dst = p.rows + (hb * p.n_rt + rt) * NC * static_cast<long long>(C::RCB);
    // lse and delta: 4 threads a row, delta summed in a fixed order
    {
      const int r = tid >> 2, j = tid & 3;
      const int f = rt * kBq + r;
      float lse = 0.0f, acc = 0.0f;
      if (f < SG) {
        const int pos = f / G, h = kh * G + (f - pos * G);
        const float4* o = reinterpret_cast<const float4*>(
            p.o + b * p.st[kO] + h * p.st[kO + 1] + pos * p.st[kO + 2]);
        const float4* d = reinterpret_cast<const float4*>(
            p.dout + b * p.st[kDO] + h * p.st[kDO + 1] + pos * p.st[kDO + 2]);
        for (int c = j; c < C4; c += 4) {
          const float4 x = __ldg(o + c), y = __ldg(d + c);
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
          acc = fmaf(x.z, y.z, acc);
          acc = fmaf(x.w, y.w, acc);
        }
        lse = __ldg(p.lse + (b * p.H + h) * p.S + pos);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (j < NC) {
        dst[j * C::RCB + r] = lse;
        dst[j * C::RCB + kBq + r] = acc;
      }
      for (int c = j + 4; c < NC; c += 4) {
        dst[c * C::RCB + r] = lse;
        dst[c * C::RCB + kBq + r] = acc;
      }
    }
    // Q and dO, a 16-byte piece (two 8-byte units, kept adjacent by the
    // swizzle since 4 (r & 3) is even) a thread
    for (int i = tid; i < 2 * kBq * C4; i += 256) {
      const int which = i / (kBq * C4);           // 0: Q, 1: dO
      const int r = (i / C4) % kBq, c4 = i % C4;
      const int f = rt * kBq + r;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (f < SG) {
        const int pos = f / G, h = kh * G + (f - pos * G);
        const int base = which ? kDO : kQ;
        const float* src = (which ? p.dout : p.q) + b * p.st[base] +
                           h * p.st[base + 1] + pos * p.st[base + 2];
        x = __ldg(reinterpret_cast<const float4*>(src) + c4);
      }
      const int c = (c4 * 4) / DC, u = (c4 * 4 - c * DC) / 2;
      float* chunk = dst + c * C::RCB + 2 * kBq + which * kBq * DC;
      *reinterpret_cast<float4*>(chunk + r * DC + 2 * (u ^ (4 * (r & 3)))) = x;
    }
    return;
  }
  const long long x = blockIdx.x - n_row_blocks;
  const long long hb = x / p.n_kt;
  const int kt = static_cast<int>(x - hb * p.n_kt);
  const long long b = hb / p.KH;
  const int kh = static_cast<int>(hb - b * p.KH);
  float* dst = p.keys + (hb * p.n_kt + kt) * NC * static_cast<long long>(C::KCB);
  // A key chunk plane holds (key n, dim d) at (n >> 3) 8 DC + (d >> 3) 64 +
  // (d & 1) 32 + (n & 7) 4 + ((d & 7) >> 1): K-major core matrices of 8
  // keys x 4 dims, each 8 dims of a k-step held as 0, 2, 4, 6 | 1, 3, 5, 7,
  // so that the A fragment's k-columns (t, t + 4) are dims (2t, 2t + 1) of
  // a raw row, one 8-byte load.  So 4 consecutive floats o .. o + 3 are one
  // key and dims d0, d0 + 2, d0 + 4, d0 + 6.
  constexpr int PL = kBk * DC / 4;                // float4s of a plane
  for (int i = tid; i < 2 * NC * PL; i += 256) {
    const int which = i / (NC * PL);              // 0: K, 1: V
    const int c = (i / PL) % NC, o = 4 * (i % PL);
    const int n = (o / (8 * DC)) * 8 + ((o >> 2) & 7);
    const int d0 = c * DC + ((o % (8 * DC)) >> 6) * 8 + ((o >> 5) & 1);
    const int key = kt * kBk + n;
    float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (key < p.T) {
      const int base = which ? kV : kK;
      const float* src = (which ? p.v : p.k) + b * p.st[base] +
                         kh * p.st[base + 1] + key * p.st[base + 2] + d0;
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = __ldg(src + 2 * j);
    }
    float4 hi, lo;
    split(e[0], hi.x, lo.x);
    split(e[1], hi.y, lo.y);
    split(e[2], hi.z, lo.z);
    split(e[3], hi.w, lo.w);
    float* plane = dst + c * C::KCB + which * 2 * kBk * DC;
    *reinterpret_cast<float4*>(plane + o) = hi;
    *reinterpret_cast<float4*>(plane + kBk * DC + o) = lo;
  }
}

// ---- the main pass ---------------------------------------------------------

// S (warpgroup 0: Q, K) or dP (warpgroup 1: dO, V) += one chunk: A = 64 raw
// rows (split here), B = the chunk's [hi; lo] planes of 32 keys.
template <int DC>
__device__ __forceinline__ void scores_chunk(const float* arows, const float* bpl,
                                             float (&acc)[16], int w, int g, int t) {
  const int r0 = 16 * w + g;
  product<DC / 8, 4>(
      acc,
      [&](int ks, float (&ah)[4], float (&al)[4]) {
        // k-columns (t, t + 4) of k-step ks are dims 8 ks + 2t, + 1
        const float2 x0 = row_pair<DC>(arows, r0, 4 * ks + t);
        const float2 x1 = row_pair<DC>(arows, r0 + 8, 4 * ks + t);
        split_a(x0.x, ah[0], al[0]);
        split_a(x1.x, ah[1], al[1]);
        split_a(x0.y, ah[2], al[2]);
        split_a(x1.y, ah[3], al[3]);
      },
      [&](int ks) { return smem_desc(bpl + ks * 64, 128, DC * 32); });
}

// A thread's two rows (16 w + g and + 8): lse (times log2 e), delta, and
// the live keys [lo, hi] of each (none past S G).
struct RowStats {
  float lse2[2], delta[2];
  int lo[2], hi[2];
};

__device__ __forceinline__ RowStats row_stats(const Args& p, const float* head,
                                              int r0, int f0, int G, int SG) {
  RowStats rs;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = f0 + 8 * h;
    rs.lse2[h] = head[r0 + 8 * h] * 1.4426950408889634f;
    rs.delta[h] = head[kBq + r0 + 8 * h];
    rs.lo[h] = 1;
    rs.hi[h] = 0;
    if (f < SG) {
      const int qk = f / G + (p.T - p.S);
      rs.hi[h] = p.causal ? min(p.T - 1, qk) : p.T - 1;
      rs.lo[h] = p.window > 0 ? max(0, qk - p.window + 1) : 0;
    }
  }
  return rs;
}

// Elements 8 half .. 8 half + 7 of one step's 64 x 32 scores (fragment
// layout: element i is row 16 w + g + 8 ((i >> 1) & 1), key k0 + 8 (i >> 2)
// + 2 t + (i & 1)): P = exp(cap(scale S) - lse) and dS = P (dP - delta)
// (1 - tanh^2) scale, zero off the mask.
__device__ __forceinline__ void half_probs(const Args& p, const RowStats& rs,
                                           int half, int k0, int t,
                                           const float (&s)[8], const float (&dp)[8],
                                           float (&pr)[8], float (&ds)[8]) {
  constexpr float kLog2e = 1.4426950408889634f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int h = (j >> 1) & 1;
    const int key = k0 + 8 * (2 * half + (j >> 2)) + 2 * t + (j & 1);
    const bool live = key >= rs.lo[h] && key <= rs.hi[h];
    float x2, dcap = 1.0f;
    if (p.cap > 0.0f) {
      // tanh y = 1 - 2 / (e^{2y} + 1): off tanhf by ~1e-7 absolute
      const float e2y = exp2f(s[j] * (2.0f * kLog2e * p.scale / p.cap));
      const float th = 1.0f - __fdividef(2.0f, e2y + 1.0f);
      x2 = p.cap * th * kLog2e;
      dcap = 1.0f - th * th;
    } else {
      x2 = s[j] * (p.scale * kLog2e);
    }
    pr[j] = live ? exp2f(x2 - rs.lse2[h]) : 0.0f;
    ds[j] = pr[j] * dcap * (dp[j] - rs.delta[h]) * p.scale;
  }
}

// P and dS are computed half by each warpgroup: warpgroup 0 holds S and
// warpgroup 1 dP for all 16 elements, so each hands the other the half it
// does not compute (thread for thread, conflict-free) and takes elements
// 8 wg .. 8 wg + 7 of both.
__device__ __forceinline__ void cross_halves(const float (&sc)[16], int wg, int wt,
                                             float* xmine, const float* xother,
                                             float (&s8)[8], float (&dp8)[8],
                                             int bar_written) {
#pragma unroll
  for (int j = 0; j < 8; ++j) xmine[j * 128 + wt] = wg == 0 ? sc[8 + j] : sc[j];
  bar_sync(bar_written, 2 * 128);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float other = xother[j * 128 + wt];
    s8[j] = wg == 0 ? sc[j] : other;
    dp8[j] = wg == 0 ? other : sc[8 + j];
  }
}

// kv-major: one 32-key tile of (b, kv head); dV (warpgroup 0) and dK
// (warpgroup 1) over every 64-row tile whose rows see one of its keys.
template <int D>
__device__ __forceinline__ void dkv_block(const Args& p, long long x, float* smem) {
  using C = Cfg<D>;
  constexpr int DC = C::DC, NC = C::NC, NR = C::NR_KV;
  // the last KEEP chunks of the scores stay in the ring for the dV/dK
  // products; the first RB are copied again for them
  constexpr int KEEP = NR < NC ? NR : NC, RB = NC - KEEP;
  constexpr int LPS = NC + RB;                      // ring loads a step
  const long long heads = static_cast<long long>(p.B) * p.KH;
  const int kt = static_cast<int>(x / heads);       // longest walks first
  const long long hb = x - kt * heads;
  const long long b = hb / p.KH;
  const int kh = static_cast<int>(hb - b * p.KH);
  const int G = p.H / p.KH, SG = p.S * G, off = p.T - p.S;
  const int k0 = kt * kBk, k1 = min(k0 + kBk, p.T) - 1;
  // positions that see one of keys k0 .. k1, then whole 64-row tiles
  int i_lo = 0, i_hi = p.S - 1;
  if (p.causal) i_lo = max(0, k0 - off);
  if (p.window > 0)
    i_hi = static_cast<int>(min(static_cast<long long>(i_hi),
                                static_cast<long long>(k1) + p.window - 1 - off));
  const int rt0 = i_lo <= i_hi ? (i_lo * G) / kBq : 0;
  const int n_steps = i_lo <= i_hi ? ((i_hi + 1) * G - 1) / kBq - rt0 + 1 : 0;

  float* sKV = smem;                                // NC key chunk blocks
  float* sRing = sKV + NC * C::KCB;                 // NR row chunk blocks
  float* sPdS = sRing + NR * C::RCB;                // P_hi, P_lo, dS_hi, dS_lo
  uint64_t* bars = reinterpret_cast<uint64_t*>(sPdS + 4 * kPlaneP);
  // the ring: load n is chunk n % LPS % NC of row tile rt0 + n / LPS (the
  // scores' chunks 0 .. NC - 1, then the copies of chunks 0 .. RB - 1)
  const Ring<NR> ring{bars + 1, bars + 1 + NR, static_cast<long long>(n_steps) * LPS,
                      sRing, C::RCB};
  const float* rows = p.rows + (hb * p.n_rt + rt0) * NC * static_cast<long long>(C::RCB);
  auto src = [=](long long n) {
    const long long s = n / LPS;
    return rows + (s * NC + static_cast<int>(n - s * LPS) % NC) * C::RCB;
  };
  auto bytes = [](long long) { return static_cast<unsigned>(C::RCB * sizeof(float)); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bars, 1);
    ring.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    bulk_load(sKV, p.keys + (hb * p.n_kt + kt) * NC * static_cast<long long>(C::KCB),
              NC * C::KCB * sizeof(float), bars);
    ring.start(src, bytes);
  }

  const int wg = tid >> 7, wt = tid & 127, w = wt >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  float run[NC][16];                                // dV^T (wg 0), dK^T (wg 1)
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 16; ++i) run[c][i] = 0.0f;
  mbar_wait(bars, 0);

  for (int s = 0; s < n_steps; ++s) {
    // ---- S (wg 0) or dP (wg 1) over the head dim, chunk by chunk
    float sc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = 0.0f;
    RowStats rs;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const long long n = static_cast<long long>(s) * LPS + c;
      ring.wait(n);
      const float* rc = sRing + (n % NR) * C::RCB;
      if (c == 0) rs = row_stats(p, rc, 16 * w + g, (rt0 + s) * kBq + 16 * w + g, G, SG);
      scores_chunk<DC>(rc + 2 * kBq + wg * kBq * DC,
                                   sKV + c * C::KCB + wg * 2 * kBk * DC, sc, w, g, t);
      if (c < RB) ring.release(n, src, bytes);
    }
    // ---- P and dS into their planes, split once.  The crossing halves go
    // over the P_hi (from wg 0) and dS_hi (from wg 1) planes, each read in
    // the last step's products only by the warpgroup that now writes it.
    float s8[8], dp8[8], pr[8], ds[8];
    cross_halves(sc, wg, wt, sPdS + wg * 2 * kPlaneP, sPdS + (1 - wg) * 2 * kPlaneP,
                 s8, dp8, kBarX);
    bar_sync(kBarY, 2 * 128);                       // both halves read
    half_probs(p, rs, wg, k0, t, s8, dp8, pr, ds);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = 16 * w + g + 8 * ((j >> 1) & 1);
      const int n = 8 * (2 * wg + (j >> 2)) + 2 * t + (j & 1);
      float h, l;
      split_a(pr[j], h, l);
      sPdS[p_off(n, r)] = h;
      sPdS[kPlaneP + p_off(n, r)] = l;
      split_a(ds[j], h, l);
      sPdS[2 * kPlaneP + p_off(n, r)] = h;
      sPdS[3 * kPlaneP + p_off(n, r)] = l;
    }
    fence_async_smem();
    bar_sync(kBarZ, 2 * 128);
    // ---- dV^T += dO^T P (wg 0), dK^T += Q^T dS (wg 1), a chunk at a time:
    // A (64 dims x 8 rows) from the raw rows, B the P or dS planes
    const float* bpl = sPdS + wg * 2 * kPlaneP;
    const int dl = 16 * w + 2 * g;                  // dims of M rows g, g + 8
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      // the kept chunks RB .. NC - 1 first, then the copies of 0 .. RB - 1:
      // the loads in the order they were made
      const int c = i < KEEP ? RB + i : i - KEEP;
      const long long n = static_cast<long long>(s) * LPS + (i < KEEP ? c : NC + c);
      if (i >= KEEP) ring.wait(n);
      const float* arows = sRing + (n % NR) * C::RCB + 2 * kBq + (1 - wg) * kBq * DC;
      product<8, 4>(
          run[c],
          [&](int ks, float (&ah)[4], float (&al)[4]) {
            float2 x0 = make_float2(0.0f, 0.0f), x1 = x0;
            if (dl < DC) {                          // else padding (D = 32)
              x0 = row_pair<DC>(arows, 8 * ks + t, dl >> 1);
              x1 = row_pair<DC>(arows, 8 * ks + t + 4, dl >> 1);
            }
            split_a(x0.x, ah[0], al[0]);
            split_a(x0.y, ah[1], al[1]);
            split_a(x1.x, ah[2], al[2]);
            split_a(x1.y, ah[3], al[3]);
          },
          [&](int ks) { return smem_desc(bpl + ks * 64, 128, 2048); });
      ring.release(n, src, bytes);
    }
  }

  // run[c][4j + e]: dim 64 c + dl + (e >> 1), key k0 + 8 j + 2 t + (e & 1)
  const int dl = 16 * w + 2 * g;
  if (dl >= DC) return;
  const int o = wg ? kDK : kDV;
  float* out = (wg ? p.dk : p.dv) + b * p.st[o] + kh * p.st[o + 1];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + 8 * j + 2 * t + e;
      if (key >= p.T) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        *reinterpret_cast<float2*>(out + key * p.st[o + 2] + c * 64 + dl) =
            make_float2(run[c][4 * j + e], run[c][4 * j + e + 2]);
    }
}

// q-major: one 64-row tile of (b, kv head); dQ over every key tile its rows
// see.  Warpgroup w accumulates dQ^T for rows 32 w .. 32 w + 31.
template <int D>
__device__ __forceinline__ void dq_block(const Args& p, long long x, float* smem) {
  using C = Cfg<D>;
  constexpr int DC = C::DC, NC = C::NC, NR = C::NR_Q;
  constexpr int KEEP = NR < NC ? NR : NC, RB = NC - KEEP;   // as dkv_block
  constexpr int LPS = NC + RB;
  const long long heads = static_cast<long long>(p.B) * p.KH;
  const int q = static_cast<int>(x / heads);        // last rows first
  const int rt = p.n_rt - 1 - q;
  const long long hb = x - q * heads;
  const long long b = hb / p.KH;
  const int kh = static_cast<int>(hb - b * p.KH);
  const int G = p.H / p.KH, SG = p.S * G, off = p.T - p.S;
  const int fa = rt * kBq, fz = min(fa + kBq, SG) - 1;
  int k_lo = 0, k_hi = p.T - 1;
  if (p.causal) k_hi = min(k_hi, fz / G + off);
  if (p.window > 0) k_lo = max(0, fa / G + off - p.window + 1);
  const int kt0 = k_lo / kBk;
  const int n_steps = k_hi >= k_lo ? k_hi / kBk - kt0 + 1 : 0;

  float* sRows = smem;                              // NC row chunk blocks
  float* sRing = sRows + NC * C::RCB;               // NR key chunk blocks
  float* sDS = sRing + NR * C::KCB;                 // dS planes (hi/lo)
  float* sX = sDS + 2 * kPlaneP;                    // the crossing halves
  uint64_t* bars = reinterpret_cast<uint64_t*>(sX + kPlaneP);
  // the ring: load n is chunk n % LPS % NC of key tile kt0 + n / LPS, as
  // in dkv_block; the copies for the dQ products bring only the K planes
  const Ring<NR> ring{bars + 1, bars + 1 + NR, static_cast<long long>(n_steps) * LPS,
                      sRing, C::KCB};
  const float* keys = p.keys + (hb * p.n_kt + kt0) * NC * static_cast<long long>(C::KCB);
  auto src = [=](long long n) {
    const long long s = n / LPS;
    return keys + (s * NC + static_cast<int>(n - s * LPS) % NC) * C::KCB;
  };
  auto bytes = [](long long n) {
    return static_cast<unsigned>((n % LPS < NC ? C::KCB : C::KCB / 2) * sizeof(float));
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bars, 1);
    ring.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    bulk_load(sRows, p.rows + (hb * p.n_rt + rt) * NC * static_cast<long long>(C::RCB),
              NC * C::RCB * sizeof(float), bars);
    ring.start(src, bytes);
  }

  const int wg = tid >> 7, wt = tid & 127, w = wt >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  mbar_wait(bars, 0);
  const int f0 = fa + 16 * w + g;
  const RowStats rs = row_stats(p, sRows, 16 * w + g, f0, G, SG);
  // this thread's dims of M rows g and g + 8 in the K^T fragment: dims
  // da and da + 2 of the chunk, one 8-byte pair of a key plane row
  const int da = 16 * w + 8 * (g >> 2) + 4 * ((g >> 1) & 1) + (g & 1);
  const int da_off = (da >> 3) * 64 + (da & 1) * 32 + ((da & 7) >> 1);
  float run[NC][16];                                // dQ^T, rows 32 wg ..
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 16; ++i) run[c][i] = 0.0f;

  for (int s = 0; s < n_steps; ++s) {
    const int k0 = (kt0 + s) * kBk;
    float sc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const long long n = static_cast<long long>(s) * LPS + c;
      ring.wait(n);
      scores_chunk<DC>(sRows + c * C::RCB + 2 * kBq + wg * kBq * DC,
                                   sRing + (n % NR) * C::KCB + wg * 2 * kBk * DC,
                                   sc, w, g, t);
      if (c < RB) ring.release(n, src, bytes);
    }
    // ---- dS into its planes, split once, half by each warpgroup
    float s8[8], dp8[8], pr[8], ds[8];
    cross_halves(sc, wg, wt, sX + wg * 1024, sX + (1 - wg) * 1024, s8, dp8, kBarX);
    half_probs(p, rs, wg, k0, t, s8, dp8, pr, ds);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = 16 * w + g + 8 * ((j >> 1) & 1);
      const int jk = 8 * (2 * wg + (j >> 2)) + 2 * t + (j & 1);
      float h, l;
      split_a(ds[j], h, l);
      sDS[ds_off(r, jk, 0)] = h;
      sDS[ds_off(r, jk, 1)] = l;
    }
    fence_async_smem();
    bar_sync(kBarZ, 2 * 128);
    // ---- dQ^T += K^T dS^T over the tile's 32 keys, a chunk at a time
    const float* bpl = sDS + wg * 8 * 256;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      // the kept chunks RB .. NC - 1 first, then the copies of 0 .. RB - 1:
      // the loads in the order they were made
      const int c = i < KEEP ? RB + i : i - KEEP;
      const long long n = static_cast<long long>(s) * LPS + (i < KEEP ? c : NC + c);
      if (i >= KEEP) ring.wait(n);
      const float* khi = sRing + (n % NR) * C::KCB;
      product<4, 4>(
          run[c],
          [&](int ks, float (&ah)[4], float (&al)[4]) {
            float2 h0 = make_float2(0.0f, 0.0f), h1 = h0, l0 = h0, l1 = h0;
            if (da < DC) {                          // else padding (D = 32)
              // keys 8 ks + t and 8 ks + t + 4 (k-columns t, t + 4)
              const int o0 = ks * (DC * 8) + t * 4 + da_off;
              const int o1 = o0 + 16;
              h0 = *reinterpret_cast<const float2*>(khi + o0);
              h1 = *reinterpret_cast<const float2*>(khi + o1);
              l0 = *reinterpret_cast<const float2*>(khi + kBk * DC + o0);
              l1 = *reinterpret_cast<const float2*>(khi + kBk * DC + o1);
            }
            ah[0] = h0.x; ah[1] = h0.y; ah[2] = h1.x; ah[3] = h1.y;
            al[0] = l0.x; al[1] = l0.y; al[2] = l1.x; al[3] = l1.y;
          },
          [&](int ks) { return smem_desc(bpl + ks * 64, 128, 1024); });
      ring.release(n, src, bytes);
    }
  }

  // run[c][4j + e]: dim 64 c + (e >> 1 ? da + 2 : da), row 32 wg + 8 j +
  // 2 t + (e & 1) of the tile
  if (da >= DC) return;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int f = fa + 32 * wg + 8 * j + 2 * t + e;
      if (f >= SG) continue;
      const int pos = f / G, h = kh * G + (f - pos * G);
      float* out = p.dq + b * p.st[kDQ] + h * p.st[kDQ + 1] + pos * p.st[kDQ + 2];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        out[c * 64 + da] = run[c][4 * j + e];
        out[c * 64 + da + 2] = run[c][4 * j + e + 2];
      }
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_main(const Args p) {
  extern __shared__ __align__(128) float smem[];
  const long long x = blockIdx.x;
  if (p.dq_first) {
    if (x < p.n_dq) dq_block<D>(p, x, smem);
    else dkv_block<D>(p, x - p.n_dq, smem);
  } else {
    if (x < p.n_dkv) dkv_block<D>(p, x, smem);
    else dq_block<D>(p, x - p.n_dkv, smem);
  }
}

// The launch's shape: scratch floats, kv-major and q-major blocks, prep
// blocks, dynamic shared memory, and which kind goes first: the one whose
// longest walk costs more (a kv-major step is 4 products, a q-major one 3).
struct Plan {
  long long rows_floats, keys_floats, n_dkv, n_dq, n_prep;
  int n_rt, n_kt, dq_first;
  size_t smem;
};

template <int D>
Plan plan(int B, int H, int KH, int S, int T, int window) {
  using C = Cfg<D>;
  Plan pl{};
  const long long heads = static_cast<long long>(B) * KH;
  const long long sg = static_cast<long long>(S) * (H / KH);
  pl.n_rt = static_cast<int>((sg + kBq - 1) / kBq);
  pl.n_kt = static_cast<int>((static_cast<long long>(T) + kBk - 1) / kBk);
  pl.rows_floats = heads * pl.n_rt * C::NC * C::RCB;
  pl.keys_floats = heads * pl.n_kt * C::NC * C::KCB;
  pl.n_dkv = heads * pl.n_kt;
  pl.n_dq = heads * pl.n_rt;
  pl.n_prep = pl.n_dkv + pl.n_dq;
  pl.smem = C::kSmemBytes;
  // the longest walks: rows of the positions a key tile's keys reach, keys
  // a row tile's positions reach
  const long long G = H / KH, w = window > 0 ? window : 0;
  const long long pos = w ? std::min<long long>(S, w + kBk) : S;
  const long long keys = w ? std::min<long long>(T, w + (kBq + G - 1) / G) : T;
  const long long kv_steps = (pos * G + kBq - 1) / kBq + 1;
  const long long q_steps = (keys + kBk - 1) / kBk + 1;
  pl.dq_first = 3 * q_steps > 4 * kv_steps;
  return pl;
}

inline bool plan_for(int D, int B, int H, int KH, int S, int T, int window,
                     Plan& pl) {
  switch (D) {
    case 32: pl = plan<32>(B, H, KH, S, T, window); return true;
    case 64: pl = plan<64>(B, H, KH, S, T, window); return true;
    case 128: pl = plan<128>(B, H, KH, S, T, window); return true;
    case 256: pl = plan<256>(B, H, KH, S, T, window); return true;
    default: return false;
  }
}

inline bool valid(int B, int H, int KH, int S, int T, int causal) {
  return !(B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || S <= 0 || T <= 0 ||
           B > 65535 || KH > 65535 || (causal && S > T) ||
           static_cast<long long>(S) * (H / KH) > 2147483647LL - kBq ||
           static_cast<long long>(T) > 2147483647LL - kBk);
}

template <int D>
int launch_bwd(Args& a, const Plan& pl, cudaStream_t stream) {
  const int smem = static_cast<int>(pl.smem);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_main<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pl.n_prep > 2147483647LL || pl.n_dkv + pl.n_dq > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  attn_bwd_prep<D><<<static_cast<unsigned>(pl.n_prep), 256, 0, stream>>>(a);
  attn_bwd_main<D><<<static_cast<unsigned>(pl.n_dkv + pl.n_dq), kThreads, smem,
                     stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn_bwd
}  // namespace fedk

// The scratch and grid of one call: returns the scratch bytes the caller
// allocates for flash_attention_bwd_f32 (-1 for a shape it refuses) and
// fills info[0..4] with the kv-major blocks, the q-major blocks (one launch
// of both), the prep pass's blocks, the main launch's dynamic shared
// memory in bytes, and 1 where the q-major blocks come first.
extern "C" long long flash_attention_bwd_plan_f32(int B, int H, int KH, int S,
                                                  int T, int D, int window,
                                                  long long* info) {
  using namespace fedk::attn_bwd;
  Plan pl{};
  if (!valid(B, H, KH, S, T, 0) || !plan_for(D, B, H, KH, S, T, window, pl))
    return -1;
  info[0] = pl.n_dkv;
  info[1] = pl.n_dq;
  info[2] = pl.n_prep;
  info[3] = static_cast<long long>(pl.smem);
  info[4] = pl.dq_first;
  return 4 * (pl.rows_floats + pl.keys_floats);
}

// q, out, dout, dq: (B, H, S, D); k, v, dk, dv: (B, Kh, T, D); all f32 on
// the device, addressed through `strides` (host array of 24: the (batch,
// head, position) element strides of q, k, v, out, dout, dq, dk, dv in that
// order); the head dim is contiguous and every row 16-byte aligned.  lse:
// (B, H, S) f32 contiguous, the forward's; work: scratch of
// flash_attention_bwd_plan_f32's bytes, 16-byte aligned.  causal: 0 or 1;
// window <= 0 means none; cap <= 0 means none.  D is one of 32, 64, 128,
// 256.  Launches the prep pass and the main pass on `stream` and returns
// cudaGetLastError().  Allocates nothing.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* work, void* dq, void* dk,
    void* dv, const long long* strides, int B, int H, int KH, int S, int T,
    int D, int causal, int window, float scale, float cap, int device,
    void* stream) {
  using namespace fedk::attn_bwd;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan pl{};
  if (!valid(B, H, KH, S, T, causal) ||
      !plan_for(D, B, H, KH, S, T, window, pl))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(out);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.rows = static_cast<float*>(work);
  a.keys = a.rows + pl.rows_floats;
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  for (int i = 0; i < 24; ++i) a.st[i] = strides[i];
  a.B = B; a.H = H; a.KH = KH; a.S = S; a.T = T;
  a.causal = causal; a.window = window; a.scale = scale; a.cap = cap;
  a.n_rt = pl.n_rt; a.n_kt = pl.n_kt; a.n_dkv = pl.n_dkv; a.n_dq = pl.n_dq;
  a.dq_first = pl.dq_first;
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_bwd<32>(a, pl, s);
    case 64: return launch_bwd<64>(a, pl, s);
    case 128: return launch_bwd<128>(a, pl, s);
    case 256: return launch_bwd<256>(a, pl, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
