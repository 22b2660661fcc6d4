// flash_attention for Hopper (sm_90a), bf16 inputs: causal / sliding-window
// GQA attention with an optional tanh soft-cap, f32 arithmetic, the output
// rounded once to bf16 at the store.
//
//   out[b, h, s] = softmax_t( mask(cap(scale * q[b, h, s] . k[b, h/G, t])) ) v[b, h/G, t]
//
// exactly the function of flash_attention.cu (scale = D^-0.5, cap(x) = cap *
// tanh(x / cap), query s at key position s + T - S, masked scores -1e30),
// on bf16 q, k and v.  Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py:32 (_kernel) at bf16, which casts
// its bf16 blocks to f32 inside (:59-61) and writes the output in the input
// dtype (:86).  On the bf16 path it is every prefill and training forward of
// the production steps (launch/steps.py at dtype=torch.bfloat16): gemma2-2b
// (B=2, H=8, Kh=4, S=T=4096, D=256, cap 50; global and window-4096 local
// layers) and recurrentgemma-9b's local layers (H=16, Kh=1, window 2048).
//
// What bounds it: operations.  Each live (query, key) pair costs 4 D flops
// (Q K^T and P V); at gemma2's global layer that is 1.38e11 flops against
// 0.067 GB of bf16 inputs and output: 0.139 ms at 989 TFLOP/s (the bf16
// tensor-core peak), 0.020 ms at 3.35 TB/s.
//
// The design (a simple kernel first):
//
//  * Q K^T is one bf16 wgmma chain (m64nBKk16 over D / 16 k-steps, Q and K
//    both from shared memory, K-major).  A product of two bf16 values is
//    exact in the f32 accumulator, so the split passes of the f32 kernel
//    (3xTF32 and their operand planes) are gone.
//  * P V: P is f32, as in the reference.  One bf16 pass would round every
//    probability by up to 2^-9 relative before the product, an error of the
//    order of half an output ulp on long flat rows, where the plain version
//    (f32 throughout, one rounding at the end) and the kernel must agree
//    element by element within 2 bf16 ulps plus 1e-3 of the row's max-abs
//    (and within 8e-3 of the output's max-abs).  So P is split
//    once in registers, P = P_hi + P_lo with P_hi = bf16(P) and P_lo =
//    bf16(P - P_hi), and P V runs as two passes (m64nDk16 with P from
//    registers): the product then errs by ~2^-17 of |P| |V|, and kernel and
//    plain version differ by at most the final rounding.  That costs one
//    more pass of P V: 6 D flops a pair instead of 4.
//  * V is read as it lies: wgmma takes a 16-bit B operand MN-major (the
//    transpose bit), so K and V are copied into shared memory in the same
//    layout (attn_bf16.cuh, "blocked") with 16-byte cp.async pieces, and no
//    transposed copy is ever made.
//  * The accumulator layout of Q K^T is the A-fragment layout of P V (a
//    thread holds keys 2t, 2t + 1 and + 8 of rows g and g + 8), so P never
//    leaves registers.
//  * GQA without copies, as the f32 kernel: a block owns 128 consecutive
//    (position, group head) rows of one (b, kv head), 64 for each of its two
//    warpgroups; every K/V tile it loads serves all heads of the group.
//    Each warpgroup keeps its rows' m, l and output (64 x D f32) in
//    registers: D / 2 a thread, 128 at D = 256.
//  * K/V tiles of 64 keys stream through two stages of cp.async copies;
//    the copy of tile it + 2 starts when tile it is done.  Tiles outside
//    the causal frontier or the window are never visited, and blocks start
//    from the last rows, which see the most keys.
//  * Shared memory: Q (128 x D) and two stages of K and V tiles: 196,608 B
//    at D = 256, 98,304 at 128, 49,152 at 64, 24,576 at 32.
//  * The P V sums stay in the tensor cores over the whole walk (scaled by
//    the online softmax's alpha on the f32 pipes every tile), as in the f32
//    kernel.  The tensor cores' truncating f32 accumulation loses at most
//    2^-23 of the running sum a k-step: under 2.5e-4 relative after the
//    2,048 k-steps of a 32,768-key walk, an eighth of bf16's half ulp at the
//    store.  (The backward, whose outputs are sums over whole walks of
//    products, flushes its tensor-core sums every step.)
//  * Ragged S and T: rows past S G are zero and never stored; keys past T
//    are zero-filled by the copy and masked.
//
// For training the kernel also writes each row's log-sum-exp, lse = m +
// log(max(l, 1e-30)) as (B, H, S) f32, which flash_attention_bwd_bf16.cu
// reads; a null lse pointer (serving) writes nothing.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_bf16.cuh"

namespace fedk {
namespace fa16 {

using namespace b16;

constexpr int kThreads = 256;       // two warpgroups
constexpr int kRows = 128;          // rows of a block, 64 a warpgroup
constexpr float kNegInf = -1e30f;

template <int D>
struct Cfg {
  static constexpr int BK = 64;                      // keys of a tile
  static constexpr int kQ = kRows * D;               // elements
  static constexpr int kKV = BK * D;                 // elements of K or V
  static constexpr size_t kSmem = 2 * (static_cast<size_t>(kQ) + 2 * 2 * kKV);
};

struct Args {
  const __nv_bfloat16* q; const __nv_bfloat16* k; const __nv_bfloat16* v;
  __nv_bfloat16* out;
  float* lse;                        // (B, H, S) contiguous, or null
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_ss;
  int H, KH, S, T, causal, window;
  float scale, cap;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bf16_kernel(const Args p) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  constexpr int CH = D / 8;            // 16-byte pieces of a row
  extern __shared__ __align__(128) __nv_bfloat16 sm[];
  __nv_bfloat16* sQ = sm;
  __nv_bfloat16* sKV = sm + C::kQ;     // stage st: K at 2 st kKV, V after it

  const int tid = threadIdx.x;
  const int wg = tid >> 7;             // warpgroup: rows 64 wg .. 64 wg + 63
  const int warp = (tid >> 5) & 3;     // rows 16 warp .. of the warpgroup
  const int lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int kh = blockIdx.y;
  const long long b = blockIdx.z;
  const int G = p.H / p.KH;
  const int SG = p.S * G;
  const int f0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int f_last = min(f0 + kRows, SG) - 1;
  const int off = p.T - p.S;

  // the live key range of the block, in whole tiles
  const int s_lo = f0 / G, s_hi = f_last / G;
  int k_lo = 0, k_hi = p.T - 1;
  if (p.causal) k_hi = min(k_hi, s_hi + off);
  if (p.window > 0) k_lo = max(0, s_lo + off - p.window + 1);
  const int t_lo = k_lo / BK;
  const int n_tiles = k_hi < k_lo ? 0 : k_hi / BK - t_lo + 1;

  const __nv_bfloat16* kbase = p.k + b * p.k_sb + kh * p.k_sh;
  const __nv_bfloat16* vbase = p.v + b * p.v_sb + kh * p.v_sh;
  auto load_tile = [&](int it) {
    __nv_bfloat16* dk = sKV + (it & 1) * 2 * C::kKV;
    __nv_bfloat16* dv = dk + C::kKV;
    const int kt = (t_lo + it) * BK;
    for (int i = tid; i < BK * CH; i += kThreads) {
      const int r = i / CH, c = (i - r * CH) * 8;
      const int key = kt + r;
      const bool in = key < p.T;
      cp16(dk + blk(r, c, D), in ? kbase + key * p.k_st + c : kbase, in ? 16 : 0);
      cp16(dv + blk(r, c, D), in ? vbase + key * p.v_st + c : vbase, in ? 16 : 0);
    }
  };

  // ---- prologue: Q and tile 0, then tile 1 ------------------------------
  for (int i = tid; i < kRows * CH; i += kThreads) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const int f = f0 + r;
    const __nv_bfloat16* src = p.q;
    int bytes = 0;
    if (f < SG) {
      const int pos = f / G, h = kh * G + (f - pos * G);
      src = p.q + b * p.q_sb + h * p.q_sh + pos * p.q_ss + c;
      bytes = 16;
    }
    cp16(sQ + blk(r, c, D), src, bytes);
  }
  if (n_tiles > 0) load_tile(0);
  cp_commit();
  if (n_tiles > 1) load_tile(1);
  cp_commit();

  // this thread's rows g and g + 8 of its warp: key positions, running max,
  // partial sums over its own columns, output fragments
  const int r0 = f0 + wg * 64 + warp * 16 + g;
  const int qk0 = r0 / G + off;
  const int qk1 = (r0 + 8) / G + off;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  const __nv_bfloat16* qw = sQ + wg * 64 * D;     // this warpgroup's rows

  for (int it = 0; it < n_tiles; ++it) {
    const __nv_bfloat16* sk = sKV + (it & 1) * 2 * C::kKV;
    const __nv_bfloat16* sv = sk + C::kKV;
    const int kt = (t_lo + it) * BK;
    cp_wait<1>();
    fence_async_smem();
    __syncthreads();

    // ---- S = Q K^T (64 x BK) --------------------------------------------
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<BK, 0, 0>(s, desc_k(qw + ks * 128, D), desc_k(sk + ks * 128, D),
                         ks > 0);
    wg_commit();
    wg_wait();
    pin(s);

    // ---- scale, cap, mask; online softmax --------------------------------
    // s[4n + 0, 1]: row g, keys 8n + 2tq, +1; s[4n + 2, 3]: row g + 8
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
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
    for (int e = 0; e < BK / 2; ++e) {
      s[e] = expf(s[e] - ((e & 2) ? mn1 : mn0));
      if (e & 2) ps1 += s[e];
      else ps0 += s[e];
    }
    l0 = l0 * alpha0 + ps0;            // this thread's columns only
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? alpha1 : alpha0;

    // ---- acc += P V, P = P_hi + P_lo.  k-step j covers keys 16j .. 16j+15:
    // its A fragment is s[8j .. 8j + 7] in order (rows g, g + 8; keys 2t,
    // 2t + 1, then + 8)
    uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[8 * j + 2 * e], y = s[8 * j + 2 * e + 1];
        ph[j][e] = pack_bf16(x, y);
        pl[j][e] = pack_bf16(x - bf16_lo(ph[j][e]), y - bf16_hi(ph[j][e]));
      }
    }
    pin(acc);
    wg_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint64_t dv = desc_mn(sv + j * 16 * D, D);
      wgmma_rs<D, 1>(acc, pl[j], dv, 1);
      wgmma_rs<D, 1>(acc, ph[j], dv, 1);
    }
    wg_commit();
    wg_wait();
    pin(acc);
    __syncthreads();                   // stage it & 1 consumed by both
    if (it + 2 < n_tiles) load_tile(it + 2);
    cp_commit();
  }
  cp_wait<0>();

  // ---- normalise and store: acc[4n + e] is row g (e < 2) or g + 8, column
  // 8n + 2tq + (e & 1)
  const float den0 = fmaxf(quad_sum(l0), 1e-30f);
  const float den1 = fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int f = r0 + 8 * half;
    if (f >= SG) continue;
    const int pos = f / G, h = kh * G + (f - pos * G);
    __nv_bfloat16* dst = p.out + b * p.o_sb + h * p.o_sh + pos * p.o_ss + 2 * tq;
    const float den = half ? den1 : den0;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(acc[4 * n + 2 * half] / den, acc[4 * n + 2 * half + 1] / den);
    if (p.lse != nullptr && tq == 0)
      p.lse[(b * p.H + h) * p.S + pos] = (half ? m1 : m0) + logf(den);
  }
}

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = Cfg<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(a.S) * (a.H / a.KH);
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows),
                  static_cast<unsigned>(a.KH), static_cast<unsigned>(B));
  flash_attention_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fa16
}  // namespace fedk

// q: (B, H, S, D), k, v: (B, Kh, T, D), out: (B, H, S, D), all bf16 on the
// device, addressed through the given element strides (batch, head,
// position); the head dim is contiguous and every row 16-byte aligned.
// causal: 0 or 1; window <= 0 means none; cap <= 0 means none.  D is one of
// 32, 64, 128, 256.  lse: (B, H, S) f32, contiguous, or null for none.
// Launches the kernel on `stream` and returns cudaGetLastError().
// Allocates nothing.
extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_ss,
    int B, int H, int KH, int S, int T, int D,
    int causal, int window, float scale, float cap,
    int device, void* stream) {
  using namespace fedk::fa16;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || S <= 0 || T <= 0 ||
      (causal && S > T) || static_cast<long long>(S) * (H / KH) > 2147483647LL - kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
         static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
         static_cast<float*>(lse),
         q_sb, q_sh, q_ss, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
         o_sb, o_sh, o_ss, H, KH, S, T, causal, window, scale, cap};
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(a, B, s);
    case 64: return launch<64>(a, B, s);
    case 128: return launch<128>(a, B, s);
    case 256: return launch<256>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
