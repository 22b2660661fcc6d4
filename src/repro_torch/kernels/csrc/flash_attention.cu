// flash_attention for Hopper (sm_90a): causal / sliding-window GQA attention
// with an optional tanh soft-cap, online softmax in f32, both products on
// the tensor cores (wgmma) with split f32 operands (3xTF32).
//
//   out[b, h, s] = softmax_t( mask(cap(scale * q[b, h, s] . k[b, h/G, t])) ) v[b, h/G, t]
//
// scale = D^-0.5, cap(x) = cap * tanh(x / cap), G = H / Kh.  Query s sits
// at key position s + (T - S); with `causal` it sees keys t <= s + T - S,
// with `window` only keys t > s + T - S - window.  Masked scores are -1e30,
// not -inf, exactly as in the reference.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// _kernel (its grid walks kv blocks in order and keeps m, l, acc in VMEM
// scratch).  On the serving path it is the prefill of every local-attention
// layer of recurrentgemma-9b: B=2, H=16, Kh=1 (MQA, G=16), S=T=4096, D=256,
// window 2048, f32.
//
// What bounds it: operations.  At that shape the live (query, key) pairs
// need 206 GFLOP against 0.29 GB of inputs and output.  On the f32 SIMT
// pipes that is 3.08 ms at 67 TFLOP/s; the tensor cores run TF32 at 495
// TFLOP/s, and this kernel spends three TF32 products for each f32 one, so
// its own bound is 3 x 206 GFLOP / 495 TFLOP/s = 1.25 ms.
//
// Why three products (the error argument).  TF32 keeps 10 mantissa bits;
// one pass (a rounded to TF32 times b rounded to TF32) errs by about 2^-11
// of each product, ~1e-3 on the output at this shape, far outside the
// reference's 2e-5.  Each operand is split instead: x_hi = tf32_rna(x),
// x_lo = tf32_rna(x - x_hi) (the subtraction is exact), so x = x_hi + x_lo
// to within 2^-22 |x|, and
//     a b ~= a_hi b_hi + a_hi b_lo + a_lo b_hi,
// dropping a_lo b_lo (<= 2^-22 |a b|).  A TF32 product is exact in the
// tensor core's f32 accumulate, so a product errs by a few 2^-22 of |a b|,
// the order of an f32 FMA chain: ~2e-6 on the output in the CPU emulation
// (tests/test_torch_kernels.py, which also shows one pass missing 2e-5).
// Q, K, P and V are all split; tf32_rna is cvt.rna.tf32.f32's rounding
// done on the bit pattern, (bits + 0x1000) & ~0x1fff.
//
// The design:
//
//  * GQA without copies.  A block owns kRows = 64 consecutive (position,
//    group head) rows of one (b, kv head): row f is position f / G, head
//    kh * G + f % G.  With MQA a block is 4 positions x 16 heads, so every
//    K/V tile it loads serves all 16 heads, and its live key range is only
//    3 keys wider than one row's.
//  * wgmma, two warpgroups.  Warpgroup w owns head-dim half w (columns
//    128w.. at D = 256) of all 64 rows.  Scores: per 8 columns of its half,
//    Q_hi . [K_hi; K_lo] as one m64n32k8 and Q_lo . K_hi as an m64n16k8,
//    with Q_hi and Q_lo split once per block and kept in registers;
//    the two halves' partial scores are added through shared memory in one
//    fixed order, so both warpgroups hold the same scores bit for bit and
//    run the same online softmax.  P V: per 8 keys, three m64n(D/2)k8 with
//    P_hi or P_lo from registers and V^T_hi or V^T_lo from shared memory.
//    P never leaves registers: the accumulator holds keys (2t, 2t+1) of
//    rows (g, g+8) and the A fragment wants k-columns (t, t+4), so V^T's
//    planes hold each 8 keys in the order 0, 2, 4, 6, 1, 3, 5, 7.
//    wgmma over mma.sync: wgmma reads its B operand from shared memory
//    once for all 64 rows of a warpgroup, where mma.sync has every warp
//    load (and split) its own fragments; the m64n32k8 keeps the score
//    products' N from being the tile's 16 keys alone.
//  * Operands split once per call.  .tf32 wgmma reads B only K-major from
//    shared memory, so a split pass (flash_attention_kernel_split, a
//    second launch of the same entry point) first writes every 16-key tile
//    of K and V as four planes in the no-swizzle core-matrix layout, K_hi,
//    K_lo, V^T_hi, V^T_lo, contiguous in a scratch buffer the wrapper
//    allocates (twice the bytes of K and V).  Every block that visits a
//    tile then copies it as it is: the split's work is done once, not once
//    per block (at the recurrentgemma shape each tile is visited by 194
//    blocks on average).  Each block's tiles start on the 16-key grid;
//    the keys before its first live key are masked like any other.
//  * An asynchronous K/V ring.  One thread copies a whole tile's planes
//    (64 x D floats) into one of 2 stages with a 1-d bulk copy (the TMA
//    engine, cp.async.bulk) that completes on that stage's mbarrier; the
//    copy of tile it + 2 starts as soon as tile it's products are done,
//    so it lands while tile it + 1 runs.  Q comes in once with cp.async.
//  * Shared memory: 2 stages x 64 x D floats (raw Q lands in the second
//    and is split before the second tile is copied), the partial scores
//    (8 KB) and two mbarriers: 139,280 B at D = 256, 73,744 B at 128,
//    40,976 B at 64, 24,592 B at 32.
//  * Registers: Q_hi and Q_lo fragments (D/4 each), the output accumulator
//    (D/4), the scores (24) and P's fragments (16): 244 at D = 256, no
//    spills; ptxas's count for each D is printed by chip_smoke.py's build
//    phase.  The registers, not shared memory, hold a block per SM at
//    D = 256.
//  * Tile skipping.  The block visits only the kv tiles between the first
//    key its earliest row can see (window) and the last key its latest row
//    can see (causal): at S = 4096 and window 2048 about half of all tiles.
//    Blocks start from the last rows, which see the most keys, so the
//    longest blocks do not trail the grid.
//  * Layout through strides.  q, k, v and out are read and written through
//    their (b, head, position) strides with the head dim contiguous, so the
//    model's (B, S, H, D) tensors need no transposing copy.
//  * Ragged S and T: rows past S*G are zero and never stored; keys past T
//    are zero in the planes and masked, so any length works.
//
// A row whose first visited tile is all masked gets p = exp(0) = 1 there,
// which the next tile's alpha = exp(-1e30 - m) = 0 wipes out, as on the
// TPU; every row has a live key because the wrapper refuses causal S > T.
//
// For training the kernel also writes each row's log-sum-exp,
// lse = m + log(max(l, 1e-30)) as (B, H, S) f32 (the reference's
// _flash_forward saves the same), which flash_attention_bwd.cu reads; a
// null lse pointer (serving) writes nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace fedk {

constexpr int kRows = 64;           // query rows of a block (one wgmma M)
constexpr int kBK = 16;             // keys of a kv tile
constexpr int kAttnThreads = 256;   // 2 warpgroups: one per head-dim half
constexpr float kNegInf = -1e30f;

// Operand planes.  Each 16-key tile of a (b, kv head) is split once per
// call into four planes in wgmma's no-swizzle K-major layout (8-row x
// 16-byte core matrices, 128 B each; LBO is the byte step between core
// matrices along K, SBO between 8-row groups), stored contiguously so that
// one bulk copy brings a whole tile: K_hi, K_lo (rows = keys, K dim = head
// dim), then V^T_hi, V^T_lo (rows = head dim, K dim = keys).
template <int D>
struct AttnCfg {
  static constexpr int kPlane = kBK * D;                // floats
  static constexpr int kTile = 4 * kPlane;              // a tile's planes
  static constexpr int kKLbo = 128, kKSbo = (D / 4) * 128;
  static constexpr int kVLbo = 128, kVSbo = (kBK / 4) * 128;
  static constexpr int kX = (kAttnThreads / 32) * 8 * 32;
  static_assert(kRows * D <= kTile, "raw Q lands in the second stage");
  // two stages of tile planes, partial scores, a barrier a stage
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * static_cast<size_t>(kTile) + kX) +
      2 * sizeof(uint64_t);
};

struct AttnArgs {
  const float* q; const float* k; const float* v; float* out;
  float* lse;                        // (B, H, S) contiguous, or null
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_ss;
  int H, KH, S, T, causal, window;
  float scale, cap;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// mbarrier and 1-d bulk copy (the TMA engine): one thread posts the bytes
// a stage expects and copies the tile; consumers wait on the phase.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  asm volatile("{\n.reg .pred p;\nWAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
               "@!p bra WAIT;\n}\n"
               :: "r"(smem_u32(bar)), "r"(phase) : "memory");
}
// dst <- src (bytes, a multiple of 16), completing on `bar`
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// cvt.rna.tf32.f32's rounding (half away from zero to 10 mantissa bits),
// done on the f32 bit pattern with two integer operations.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// x = hi + lo with hi = tf32_rna(x) and lo = tf32_rna(x - hi) (exact sub).
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, hi));
}

__device__ __forceinline__ void split4(float4 v, float4& hi, float4& lo) {
  split_tf32(v.x, hi.x, lo.x);
  split_tf32(v.y, hi.y, lo.y);
  split_tf32(v.z, hi.z, lo.z);
  split_tf32(v.w, hi.w, lo.w);
}

// wgmma shared-memory matrix descriptor, no swizzle.
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving an accumulator while a wgmma owns it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (64 x N, f32) += a (64 x 8, TF32) . b (8 x N, TF32); a from registers,
// b from shared memory; acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const float (&a)[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const float (&a)[4],
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

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const float (&a)[4],
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

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const float (&a)[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const float (&a)[4],
                                         uint64_t db, int acc) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db, acc);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db, acc);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db, acc);
  else wgmma_rs_n128(d, a, db, acc);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The split pass: tile t16 of (b, kv head) -> its four planes.  Keys past
// T are zero.  K: a thread takes one 16-byte piece of a key row (one
// core-matrix row); V^T: a thread takes one head-dim column of keys
// {0, 2, 4, 6} or {1, 3, 5, 7} of an 8-key group, one core-matrix row of
// each plane, so each 8 keys are held in the order 0, 2, 4, 6, 1, 3, 5, 7
// (see the P V step).
template <int D>
__global__ void __launch_bounds__(kAttnThreads)
flash_attention_kernel_split(const AttnArgs p, float* planes, int n16) {
  using C = AttnCfg<D>;
  constexpr int CH = D / 4;
  const int t16 = blockIdx.x, kh = blockIdx.y;
  const long long b = blockIdx.z;
  float* out = planes + ((b * p.KH + kh) * n16 + t16) * C::kTile;
  const float* kbase = p.k + b * p.k_sb + kh * p.k_sh;
  const float* vbase = p.v + b * p.v_sb + kh * p.v_sh;
  const int kt = t16 * kBK;
  for (int i = threadIdx.x; i < kBK * CH; i += kAttnThreads) {
    const int jj = i & 7, c4 = (i >> 3) % CH, jg = (i >> 3) / CH;
    const int key = kt + jg * 8 + jj;
    const float4 x = key < p.T
        ? __ldg(reinterpret_cast<const float4*>(kbase + key * p.k_st + c4 * 4))
        : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 hi, lo;
    split4(x, hi, lo);
    const int o = jg * (C::kKSbo / 4) + c4 * 32 + jj * 4;
    *reinterpret_cast<float4*>(out + o) = hi;
    *reinterpret_cast<float4*>(out + C::kPlane + o) = lo;
  }
  for (int i = threadIdx.x; i < kBK * D / 4; i += kAttnThreads) {
    const int n = i % D, q = i / D;            // q: 4-key piece 0..3
    const int k0 = kt + (q >> 1) * 8 + (q & 1);
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      x[u] = k0 + 2 * u < p.T ? __ldg(vbase + (k0 + 2 * u) * p.v_st + n) : 0.0f;
    float4 hi, lo;
    split4(make_float4(x[0], x[1], x[2], x[3]), hi, lo);
    const int o = 2 * C::kPlane + (n >> 3) * (C::kVSbo / 4) + q * (C::kVLbo / 4) +
                  (n & 7) * 4;
    *reinterpret_cast<float4*>(out + o) = hi;
    *reinterpret_cast<float4*>(out + C::kPlane + o) = lo;
  }
}

template <int D>
__global__ void __launch_bounds__(kAttnThreads, 1)
flash_attention_kernel(const AttnArgs p, const float* planes, int n16) {
  using C = AttnCfg<D>;
  constexpr int DH = D / 2;            // head-dim half of a warpgroup
  constexpr int KS = DH / 8;           // k-steps of Q K^T in that half
  constexpr int CH = D / 4;            // 16-byte pieces of a row
  constexpr int PL = C::kPlane;
  extern __shared__ __align__(128) float smem[];
  float* sX = smem + 2 * C::kTile;                 // partial scores
  uint64_t* sBar = reinterpret_cast<uint64_t*>(sX + C::kX);   // a stage each
  float* sQraw = smem + C::kTile;                  // raw Q, until split

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rg = warp & 3;             // rows 16 rg .. 16 rg + 15 of the block
  const int dh = warp >> 2;            // warpgroup = head-dim half
  const int g = lane >> 2;             // fragment row group
  const int tq = lane & 3;             // thread in group
  const int kh = blockIdx.y;
  const long long b = blockIdx.z;
  const int G = p.H / p.KH;
  const int SG = p.S * G;
  // the last rows see the most keys under a causal mask: start them first
  const int f0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int f_last = min(f0 + kRows, SG) - 1;
  const int off = p.T - p.S;

  // ---- the live key range of this block, in whole 16-key tiles -------------
  const int s_lo = f0 / G, s_hi = f_last / G;
  int k_lo = 0, k_hi = p.T - 1;
  if (p.causal) k_hi = min(k_hi, s_hi + off);
  if (p.window > 0) k_lo = max(0, s_lo + off - p.window + 1);
  const int t_lo = k_lo / kBK;
  const int n_tiles = k_hi / kBK - t_lo + 1;
  const float* tiles = planes + ((b * p.KH + kh) * n16 + t_lo) * C::kTile;
  auto load_tile = [&](int it) {         // one thread: tile it -> stage it & 1
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_load(smem + (it & 1) * C::kTile, tiles + it * C::kTile,
              C::kTile * sizeof(float), sBar + (it & 1));
  };

  // ---- prologue: tile 0 in flight, Q split, tile 1 in flight ----------------
  if (tid == 0) {
    mbar_init(sBar);
    mbar_init(sBar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) load_tile(0);
  for (int i = tid; i < kRows * CH; i += kAttnThreads) {
    const int r = i / CH, c = (i - r * CH) * 4;
    const int f = f0 + r;
    const float* src = p.q;
    int bytes = 0;
    if (f < SG) {
      const int pos = f / G, h = kh * G + (f - pos * G);
      src = p.q + b * p.q_sb + h * p.q_sh + pos * p.q_ss + c;
      bytes = 16;
    }
    cp_async16(sQraw + r * D + c, src, bytes);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // this warp's Q fragments, hi and lo, in registers (the A operands)
  float qh[KS][4], ql[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rg * 16 + g + 8 * (e & 1);
      const int d = dh * DH + ks * 8 + tq + 4 * (e >> 1);
      split_tf32(sQraw[r * D + d], qh[ks][e], ql[ks][e]);
    }
  }
  __syncthreads();                     // raw Q read: its stage is free
  if (tid == 0 && n_tiles > 1) load_tile(1);

  // this thread's two rows (g and g + 8 of the warp's 16): key positions,
  // running max, partial sums over its own columns, output fragments
  const int r0 = f0 + rg * 16 + g;
  const int qk0 = r0 / G + off;
  const int qk1 = (r0 + 8) / G + off;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  float acc[DH / 2];                   // 64 x DH per warpgroup, wgmma layout
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  float* x_mine = sX + warp * 8 * 32 + lane;
  const float* x_pair = sX + (warp ^ 4) * 8 * 32 + lane;

  for (int it = 0; it < n_tiles; ++it) {
    const float* st = smem + (it & 1) * C::kTile;
    const int kt = (t_lo + it) * kBK;
    mbar_wait(sBar + (it & 1), (it >> 1) & 1);

    // ---- scores over this warpgroup's half of D ---------------------------
    // K_lo's plane follows K_hi's at one SBO per 8 keys, so [K_hi; K_lo] is
    // one 32-row operand: Q_hi . [K_hi; K_lo] gives hi.hi (keys 0-15) and
    // hi.lo (16-31) in one m64n32k8; Q_lo . K_hi is an m64n16k8.
    float shl[16], sb[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) shl[e] = shl[e + 8] = sb[e] = 0.0f;
    {
      const float* khi = st + dh * DH / 4 * 32;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint64_t dk = smem_desc(khi + ks * 64, C::kKLbo, C::kKSbo);
        wgmma_rs_n32(shl, qh[ks], dk, ks > 0);
        wgmma_rs_n16(sb, ql[ks], dk, ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(shl); pin(sb);
    }
    // the partner warp (same rows, other half of D) adds its partial; both
    // form lower half + upper half, so both hold the same scores bit for bit
    float s[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s[e] = shl[e] + (shl[e + 8] + sb[e]);
      x_mine[e * 32] = s[e];
    }
    asm volatile("bar.sync %0, 64;\n" :: "r"(1 + rg) : "memory");
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float other = x_pair[e * 32];
      s[e] = dh == 0 ? s[e] + other : other + s[e];
    }

    // ---- scale, cap, mask; online softmax ------------------------------------
    // s[4n + 0, 1]: row g, keys 8n + 2tq, +1; s[4n + 2, 3]: row g + 8
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int key = kt + (e >> 2) * 8 + 2 * tq + (e & 1);
      const int qk = (e & 2) ? qk1 : qk0;
      float x = s[e] * p.scale;
      if (p.cap > 0.0f) x = p.cap * tanhf(x / p.cap);
      bool live = key < p.T;
      if (p.causal) live = live && key <= qk;
      if (p.window > 0) live = live && key > qk - p.window;
      s[e] = live ? x : kNegInf;
      if (e & 2) mx1 = fmaxf(mx1, s[e]);
      else mx0 = fmaxf(mx0, s[e]);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s[e] = expf(s[e] - ((e & 2) ? mn1 : mn0));
      if (e & 2) ps1 += s[e];
      else ps0 += s[e];
    }
    l0 = l0 * alpha0 + ps0;            // this thread's columns only
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] *= (i & 2) ? alpha1 : alpha0;

    // ---- acc += P V.  The A fragment of k-step j wants k-columns (t, t+4)
    // of rows (g, g+8); the thread holds keys (2t, 2t+1) of those rows, so
    // k-column t is key 2t and t + 4 is key 2t + 1, which is the order in
    // which V^T's planes hold each 8 keys.  The sum over keys is unchanged.
    float ph[2][4], pl[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      split_tf32(s[4 * j + 0], ph[j][0], pl[j][0]);   // row g,     key 2t
      split_tf32(s[4 * j + 2], ph[j][1], pl[j][1]);   // row g + 8, key 2t
      split_tf32(s[4 * j + 1], ph[j][2], pl[j][2]);   // row g,     key 2t+1
      split_tf32(s[4 * j + 3], ph[j][3], pl[j][3]);   // row g + 8, key 2t+1
    }
    {
      const float* vhi = st + 2 * PL + (dh * DH / 8) * (C::kVSbo / 4);
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint64_t dvh = smem_desc(vhi + j * 2 * (C::kVLbo / 4), C::kVLbo, C::kVSbo);
        const uint64_t dvl = smem_desc(vhi + PL + j * 2 * (C::kVLbo / 4), C::kVLbo, C::kVSbo);
        wgmma_rs<DH>(acc, ph[j], dvl, 1);
        wgmma_rs<DH>(acc, pl[j], dvh, 1);
        wgmma_rs<DH>(acc, ph[j], dvh, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
    }
    __syncthreads();                   // stage it & 1 consumed by both
    if (tid == 0 && it + 2 < n_tiles) load_tile(it + 2);
  }

  // ---- normalise and store: acc[4n + e] is row g (e < 2) or g + 8, column
  // DH dh + 8n + 2tq + (e & 1)
  const float den0 = fmaxf(quad_sum(l0), 1e-30f);
  const float den1 = fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int f = r0 + 8 * half;
    if (f >= SG) continue;
    const int pos = f / G, h = kh * G + (f - pos * G);
    float* dst = p.out + b * p.o_sb + h * p.o_sh + pos * p.o_ss + dh * DH + 2 * tq;
    const float den = half ? den1 : den0;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) =
          make_float2(acc[4 * n + 2 * half] / den, acc[4 * n + 2 * half + 1] / den);
    if (p.lse != nullptr && dh == 0 && tq == 0)
      p.lse[(b * p.H + h) * p.S + pos] = (half ? m1 : m0) + logf(den);
  }
}

template <int D>
int launch_flash(const AttnArgs& a, int B, float* planes, cudaStream_t stream) {
  const size_t smem = AttnCfg<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n16 = (a.T + kBK - 1) / kBK;
  flash_attention_kernel_split<D><<<dim3(n16, a.KH, B), kAttnThreads, 0, stream>>>(
      a, planes, n16);
  const int G = a.H / a.KH;
  const long long rows = static_cast<long long>(a.S) * G;
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows),
                  static_cast<unsigned>(a.KH), static_cast<unsigned>(B));
  flash_attention_kernel<D><<<grid, kAttnThreads, smem, stream>>>(a, planes, n16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fedk

// q: (B, H, S, D), k, v: (B, Kh, T, D), out: (B, H, S, D), all f32 on the
// device, addressed through the given element strides (batch, head,
// position); the head dim is contiguous and every row 16-byte aligned.
// causal: 0 or 1; window <= 0 means none; cap <= 0 means none.  D is one of
// 32, 64, 128, 256.  planes: f32 scratch of B * Kh * ceil(T / 16) * 64 * D
// floats, 16-byte aligned (the split K/V tiles).  lse: (B, H, S) f32,
// contiguous, or null for none.  Launches the split pass and the attention
// kernel on `stream` and returns cudaGetLastError().  Allocates nothing.
extern "C" int flash_attention_f32(
    const void* q, const void* k, const void* v, void* out, void* planes,
    void* lse,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_ss,
    int B, int H, int KH, int S, int T, int D,
    int causal, int window, float scale, float cap,
    int device, void* stream) {
  using namespace fedk;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || S <= 0 || T <= 0 ||
      (causal && S > T) || static_cast<long long>(S) * (H / KH) > 2147483647LL - kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
             static_cast<const float*>(v), static_cast<float*>(out),
             static_cast<float*>(lse),
             q_sb, q_sh, q_ss, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
             o_sb, o_sh, o_ss, H, KH, S, T, causal, window, scale, cap};
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_flash<32>(a, B, static_cast<float*>(planes), s);
    case 64: return launch_flash<64>(a, B, static_cast<float*>(planes), s);
    case 128: return launch_flash<128>(a, B, static_cast<float*>(planes), s);
    case 256: return launch_flash<256>(a, B, static_cast<float*>(planes), s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
