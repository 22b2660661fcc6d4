// flash_attention_bwd for Hopper (sm_90a), bf16 inputs: the gradient of the
// bf16 attention of flash_attention_bf16.cu, from the forward's output and
// its per-row log-sum-exp, in f32 arithmetic, each gradient rounded once to
// bf16 at the store.
//
//   s   = cap(scale * q . k),  P = exp(s - lse),  dP = dO . v
//   delta = rowsum(dO * O),    dS = P (dP - delta) * (1 - tanh^2)  (cap only)
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO
//
// with dS and P zero where the mask is off, query s at key position s +
// (T - S), and a kv head's dK and dV summing the rows of all G = H / Kh
// query heads of its group (rows f = position * G + g, as in the forward):
// flash_attention_bwd.cu's function on bf16 q, k, v, out and dout, f32 lse.
//
// Replaces, on the bf16 training path, the gradient the reference takes
// around the TPU kernel src/repro/kernels/flash_attention.py:32: the jnp
// custom VJP of src/repro/models/attention.py:229 (_flash_backward, f32
// maths on bf16 inputs, gradients cast to the inputs' dtype).
//
// What bounds it: operations.  Each live (query, key) pair costs five
// products of length D (S, dP, dV, dK, dQ), 10 D flops, and this design
// recomputes S and dP for dQ (14 D, as the reference's two passes do); at
// gemma2-2b's global layer (B=2, H=8, S=T=4096, D=256, causal) 10 D flops
// a pair are 3.44e11 flops: 0.348 ms at 989 TFLOP/s (bf16 tensor cores),
// against 0.11 GB of bytes (0.033 ms at 3.35 TB/s).
//
// The design (a simple kernel first; deterministic: no atomics, every sum in
// a fixed order, so two calls give the same bits):
//
//  * Every product is a bf16 wgmma with f32 accumulation.  S = Q K^T and
//    dP = dO V^T are exact products of bf16 inputs.  P and dS are f32 and
//    enter dV, dK and dQ rounded once to bf16: an error of at most 2^-9 of
//    each term, which sums to ~2^-9 / sqrt(n) of a gradient over n terms of
//    random sign, against a tolerance of 2e-2 of each row's max-abs (a
//    query's dq, a key's dk and dv: 2.5-5 bf16 ulps at the row's max), so
//    no split pass (the forward splits P because its output is held
//    element by element within 2 ulps).
//  * Every operand is read as it lies.  Q, dO, K and V are copied into
//    shared memory in one layout (attn_bf16.cuh, "blocked") by 16-byte
//    cp.async pieces, and P and dS are written there by the threads that
//    make them; wgmma reads each tile K-major or MN-major (16-bit operands
//    take the transpose bit), so nothing is transposed or split:
//      S = Q K^T,  dP = dO V^T      M = 64 rows, N = 64 or 32 keys, K = D
//      dV^T = dO^T P, dK^T = Q^T dS M = 64 dims, N = 64 keys, K = 64 rows
//      dQ = dS K                    M = 64 rows, N = D / 2,  K = 32 keys
//  * Three launches: a delta pass (delta = rowsum(dO O) in f32, into the
//    scratch the wrapper allocates), then kv-major blocks (dK, dV) and
//    q-major blocks (dQ).  A kv-major block owns 64 keys of one (b, kv head)
//    and walks, 64 rows a step, every row of its G heads that sees one of
//    them; a q-major block owns 64 rows and walks the 32-key tiles they see
//    (the forward's tile skipping).  Each kind orders its blocks longest
//    walk first.  The kv-major walks re-read Q and dO once for every key
//    tile a row sees, from device memory once they outgrow the L2 (128 MB
//    of them at recurrentgemma-9b's layer), the largest cost at the
//    training shapes; so its key tiles are as wide as its registers allow,
//    64 keys, twice the q-major's.
//  * Two warpgroups a block.  In a step warpgroup 0 computes S and
//    warpgroup 1 dP; each hands the other half of its 16 elements a thread
//    through shared memory (same fragment layout, thread for thread), both
//    make P and dS for their 8 and write them as bf16 tiles; then
//    warpgroup 0 accumulates dV^T and warpgroup 1 dK^T (kv-major), or each
//    warpgroup dQ for half the head dim (q-major).  The rows' lse and
//    delta are loaded before the products, which hide their latency.
//  * Tensor-core sums flushed every step, as in the f32 backward: the
//    tensor cores' f32 accumulation truncates, so dV^T and dK^T are summed
//    there over one 64-row step (one 64-dim chunk at a time) and dQ over
//    one 32-key tile, each from a fresh accumulator, and added to running
//    sums on the f32 pipes.
//  * The streamed tiles (Q and dO rows, or K and V keys) come through two
//    stages of cp.async copies; the copy of step i + 2 starts when step i
//    is done.
//  * Shared memory at D = 256: kv-major 229,376 B (its K and V, two stages
//    of Q and dO rows, the P and dS tiles and the S exchange); q-major
//    143,360 B.  At D = 32 the row tiles are kept 64 columns wide (zero
//    beyond D), so that dV^T and dK^T still have M = 64 dims.
//
// Layout through strides: q, dq, out, dout (B, H, S, D); k, v, dk, dv
// (B, Kh, T, D); each addressed by (batch, head, position) strides with the
// head dim contiguous and rows 16-byte aligned.  lse is (B, H, S) f32
// contiguous.  Ragged S and T: rows past S G and keys past T are
// zero-filled by the copies and masked.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_bf16.cuh"

namespace fedk {
namespace fb16 {

using namespace b16;

constexpr int kThreads = 256;
constexpr int kBq = 64;             // rows of a row tile
constexpr int kBk = 32;             // keys of a q-major block's key tile
constexpr int kBkv = 64;            // keys of a kv-major block

struct Args {
  const __nv_bfloat16 *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;                      // (B, H, S) scratch
  __nv_bfloat16 *dq, *dk, *dv;
  long long s[24];                   // (b, head, position) strides, in the
                                     // order q, k, v, out, dout, dq, dk, dv
  int H, KH, S, T, causal, window;
  float scale, cap;
};

template <int D>
struct Cfg {
  static constexpr int DP = D < 64 ? 64 : D;           // row tiles' width
  static constexpr int kRowTile = kBq * DP;            // elements
  static constexpr int kKeyTile = kBk * D;             // q-major's
  static constexpr int kKvTile = kBkv * D;             // kv-major's own
  // kv-major: K, V; 2 stages of Q, dO; P, dS; the exchange (32 elements
  // a thread)
  static constexpr size_t kKvSmem =
      2 * (2 * static_cast<size_t>(kKvTile) + 4 * kRowTile + 2 * kBq * kBkv) +
      4 * 32 * 128;
  // q-major: Q, dO; 2 stages of K, V; dS; the exchange (16)
  static constexpr size_t kQSmem =
      2 * (2 * static_cast<size_t>(kRowTile) + 4 * kKeyTile + kBq * kBk) +
      4 * 16 * 128;
};

// delta[b, h, s] = sum_d dout * out, one warp a row, in f32
template <int D>
__global__ void __launch_bounds__(256)
attn16_bwd_delta(const Args p, int B) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(B) * p.H * p.S) return;
  const int pos = static_cast<int>(row % p.S);
  const long long bh = row / p.S;
  const int h = static_cast<int>(bh % p.H);
  const long long b = bh / p.H;
  const __nv_bfloat16* o = p.out + b * p.s[9] + h * p.s[10] + pos * p.s[11];
  const __nv_bfloat16* d = p.dout + b * p.s[12] + h * p.s[13] + pos * p.s[14];
  float acc = 0.0f;
#pragma unroll
  for (int i = lane; i < D; i += 32)
    acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(d[i]), __bfloat162float(o[i])));
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) p.delta[row] = acc;
}

// copies a 64-row tile of (position, group head) rows f0 .. f0 + 63 of x
// (strides sb, sh, ss) into `dst` (blocked, DP columns); rows past SG zero
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* x,
                                          long long sb, long long sh, long long ss,
                                          long long b, int kh, int G, int SG, int f0) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < kBq * CH; i += kThreads) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const int f = f0 + r;
    const __nv_bfloat16* src = x;
    int bytes = 0;
    if (f < SG) {
      const int pos = f / G, h = kh * G + (f - pos * G);
      src = x + b * sb + h * sh + pos * ss + c;
      bytes = 16;
    }
    cp16(dst + blk(r, c, Cfg<D>::DP), src, bytes);
  }
}

// copies keys kt .. kt + BK - 1 of x (a (b, kv head) base, key stride st)
// into `dst` (blocked, D columns); keys past T zero
template <int D, int BK>
__device__ __forceinline__ void load_keys(__nv_bfloat16* dst, const __nv_bfloat16* x,
                                          long long st, int kt, int T) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < BK * CH; i += kThreads) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const int key = kt + r;
    const bool in = key < T;
    cp16(dst + blk(r, c, D), in ? x + key * st + c : x, in ? 16 : 0);
  }
}

// S (or dP) = A B^T over the head dim: A a 64-row tile (DP columns), B a
// BK-key tile (D columns), both K-major
template <int D, int BK>
__device__ __forceinline__ void scores(float (&s)[BK / 2], const __nv_bfloat16* a,
                                       const __nv_bfloat16* bt) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss<BK, 0, 0>(s, desc_k(a + ks * 128, Cfg<D>::DP), desc_k(bt + ks * 128, D),
                       ks > 0);
  wg_commit();
  wg_wait();
  pin(s);
}

// P and dS of one element: the raw product s, dP, the row's lse and delta
struct Mask {
  int T, causal, window;
  __device__ __forceinline__ bool live(int key, int qk) const {
    bool ok = key < T;
    if (causal) ok = ok && key <= qk;
    if (window > 0) ok = ok && key > qk - window;
    return ok;
  }
};

__device__ __forceinline__ void p_ds(float s, float dp, float lse, float delta,
                                     float scale, float cap, bool live,
                                     float& pv, float& dsv) {
  float x = s * scale, dcap = 1.0f;
  if (cap > 0.0f) {
    const float th = tanhf(x / cap);
    x = cap * th;
    dcap = 1.0f - th * th;
  }
  pv = live ? expf(x - lse) : 0.0f;
  dsv = live ? pv * (dp - delta) * dcap : 0.0f;
}

// The rows' lse, delta, key position and validity for this thread's two
// rows (16 warp + g and + 8 of the 64-row tile at f0).
struct Rows {
  float lse[2], dl[2];
  int qk[2];
  bool rv[2];                          // rows past S G see no key
  __device__ __forceinline__ void load(const Args& p, long long b, int kh,
                                       int G, int SG, int off, int f0,
                                       int warp, int g) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int f = f0 + warp * 16 + g + 8 * hf;
      const int pos = f / G;
      qk[hf] = pos + off;
      rv[hf] = f < SG;
      lse[hf] = dl[hf] = 0.0f;
      if (rv[hf]) {
        const long long ix = (b * p.H + kh * G + (f - pos * G)) * p.S + pos;
        lse[hf] = p.lse[ix];
        dl[hf] = p.delta[ix];
      }
    }
  }
};

// Both warpgroups make P and dS of the 64 x BK tile.  A thread of
// warpgroup W holds S (W = 0) or dP (W = 1) in `s` (BK / 2 elements).
// give<W> hands the half that the other warpgroup makes through sX (same
// fragment layout, thread for thread: element e in row e of sX); after a
// barrier make_p_ds<W> makes elements W BK / 4 .. (keys W BK / 2 .. of the
// tile) and writes P (when sP is not null) and dS as bf16 tiles, then
// fences them for the async proxy.
template <int W, int BK>
__device__ __forceinline__ void give(const float (&s)[BK / 2], float* sX, int wt) {
  constexpr int kHalf = BK / 4;
  constexpr int kGive = W == 0 ? kHalf : 0;
#pragma unroll
  for (int e = 0; e < kHalf; ++e) sX[(kGive + e) * 128 + wt] = s[kGive + e];
}

template <int W, int BK>
__device__ __forceinline__ void make_p_ds(const float (&s)[BK / 2], const float* sX,
                                          int wt, int warp, int g, int tq, int kt,
                                          const Rows& r, const Mask& mask,
                                          float scale, float cap,
                                          __nv_bfloat16* sP, __nv_bfloat16* sdS) {
#pragma unroll
  for (int nn = 0; nn < BK / 16; ++nn) {
    const int n = W * BK / 16 + nn;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float pv[2], dsv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = 4 * n + 2 * hf + u;
        const float other = sX[e * 128 + wt];
        const int key = kt + 8 * n + 2 * tq + u;
        p_ds(W == 0 ? s[e] : other, W == 0 ? other : s[e], r.lse[hf],
             r.dl[hf], scale, cap, r.rv[hf] && mask.live(key, r.qk[hf]),
             pv[u], dsv[u]);
      }
      const int o = blk(warp * 16 + g + 8 * hf, 8 * n + 2 * tq, BK);
      if (sP != nullptr)
        *reinterpret_cast<uint32_t*>(sP + o) = pack_bf16(pv[0], pv[1]);
      *reinterpret_cast<uint32_t*>(sdS + o) = pack_bf16(dsv[0], dsv[1]);
    }
  }
  fence_async_smem();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn16_bwd_kv(const Args p) {
  using C = Cfg<D>;
  constexpr int DP = C::DP;
  constexpr int BK = kBkv;
  constexpr int NE = BK / 2;           // S or dP elements a thread
  extern __shared__ __align__(128) __nv_bfloat16 sm[];
  __nv_bfloat16* sK = sm;
  __nv_bfloat16* sV = sK + C::kKvTile;
  __nv_bfloat16* sRing = sV + C::kKvTile;               // stage st: Q, dO
  __nv_bfloat16* sP = sRing + 4 * C::kRowTile;
  __nv_bfloat16* sdS = sP + kBq * BK;
  float* sX = reinterpret_cast<float*>(sdS + kBq * BK);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  // under a causal mask the first key tiles see the most rows: first
  const int kt0 = blockIdx.x * BK;
  const int kh = blockIdx.y;
  const long long b = blockIdx.z;
  const int G = p.H / p.KH, SG = p.S * G, off = p.T - p.S;
  const Mask mask{p.T, p.causal, p.window};

  // the rows that see one of keys kt0 .. kt0 + BK - 1
  const int k_last = min(kt0 + BK, p.T) - 1;
  int pos_lo = 0, pos_hi = p.S - 1;
  if (p.causal) pos_lo = max(0, kt0 - off);
  if (p.window > 0) pos_hi = min(pos_hi, k_last + p.window - 1 - off);
  const int rt_lo = pos_lo * G / kBq;
  const int n_steps = pos_lo > pos_hi ? 0 : (pos_hi * G + G - 1) / kBq - rt_lo + 1;

  if constexpr (DP != D) {
    // the columns past D of the row tiles are never copied: zero, once
    for (int i = tid; i < 4 * C::kRowTile; i += kThreads) {
      const int e = i % C::kRowTile;
      const int j = (e / 64 % 8) * 8 + e % 8;      // the column of element e
      if (j >= D) sRing[i] = __float2bfloat16_rn(0.0f);
    }
  }
  const __nv_bfloat16* kb = p.k + b * p.s[3] + kh * p.s[4];
  const __nv_bfloat16* vb = p.v + b * p.s[6] + kh * p.s[7];
  load_keys<D, BK>(sK, kb, p.s[5], kt0, p.T);
  load_keys<D, BK>(sV, vb, p.s[8], kt0, p.T);
  auto load_step = [&](int i) {
    __nv_bfloat16* d = sRing + (i & 1) * 2 * C::kRowTile;
    const int f0 = (rt_lo + i) * kBq;
    load_rows<D>(d, p.q, p.s[0], p.s[1], p.s[2], b, kh, G, SG, f0);
    load_rows<D>(d + C::kRowTile, p.dout, p.s[12], p.s[13], p.s[14], b, kh, G, SG, f0);
  };
  if (n_steps > 0) load_step(0);
  cp_commit();
  if (n_steps > 1) load_step(1);
  cp_commit();

  // running sums: dV^T (warpgroup 0) or dK^T (1), M = DP dims in 64-dim
  // chunks, N = BK keys; run[c][4n + e] is dim 64c + 16 warp + g (+ 8 when
  // e & 2), key 8n + 2tq + (e & 1)
  constexpr int NC = DP / 64;
  float run[NC][NE];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < NE; ++i) run[c][i] = 0.0f;

  for (int i = 0; i < n_steps; ++i) {
    const __nv_bfloat16* sq = sRing + (i & 1) * 2 * C::kRowTile;
    const __nv_bfloat16* sdo = sq + C::kRowTile;
    const int f0 = (rt_lo + i) * kBq;
    cp_wait<1>();
    fence_async_smem();
    __syncthreads();

    // S (warpgroup 0) and dP (1); the 64 rows are f0 + 16 warp + g (+ 8),
    // their lse and delta loaded first (the loads overlap the products)
    Rows rows;
    rows.load(p, b, kh, G, SG, off, f0, warp, g);
    float s[NE];
    scores<D, BK>(s, wg == 0 ? sq : sdo, wg == 0 ? sK : sV);
    if (wg == 0) give<0, BK>(s, sX, wt);
    else give<1, BK>(s, sX, wt);
    __syncthreads();
    if (wg == 0)
      make_p_ds<0, BK>(s, sX, wt, warp, g, tq, kt0, rows, mask, p.scale,
                       p.cap, sP, sdS);
    else
      make_p_ds<1, BK>(s, sX, wt, warp, g, tq, kt0, rows, mask, p.scale,
                       p.cap, sP, sdS);
    __syncthreads();

    // dV^T += dO^T P (warpgroup 0), dK^T += Q^T dS (1), a 64-dim chunk at
    // a time: 4 k-steps of 16 rows into a fresh accumulator, added on the
    // f32 pipes
    const __nv_bfloat16* a = wg == 0 ? sdo : sq;
    const __nv_bfloat16* bb = wg == 0 ? sP : sdS;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float stp[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) stp[e] = 0.0f;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < kBq / 16; ++ks)
        wgmma_ss<BK, 1, 1>(stp, desc_mn(a + ks * 16 * DP + c * 8 * 64, DP),
                           desc_mn(bb + ks * 16 * BK, BK), ks > 0);
      wg_commit();
      wg_wait();
      pin(stp);
#pragma unroll
      for (int e = 0; e < NE; ++e) run[c][e] += stp[e];
    }
    __syncthreads();                   // stage i & 1, P and dS consumed
    if (i + 2 < n_steps) load_step(i + 2);
    cp_commit();
  }
  cp_wait<0>();

  // store: dV (warpgroup 0), dK = scale dK^T^T (1)
  __nv_bfloat16* out = wg == 0 ? p.dv + b * p.s[21] + kh * p.s[22]
                               : p.dk + b * p.s[18] + kh * p.s[19];
  const long long st = wg == 0 ? p.s[23] : p.s[20];
  const float mul = wg == 0 ? 1.0f : p.scale;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = 64 * c + 16 * warp + g + 8 * ((e >> 1) & 1);
      const int key = kt0 + 8 * (e >> 2) + 2 * tq + (e & 1);
      if (d < D && key < p.T)
        out[key * st + d] = __float2bfloat16_rn(run[c][e] * mul);
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn16_bwd_q(const Args p) {
  using C = Cfg<D>;
  constexpr int DP = C::DP;
  constexpr int DH = D / 2;            // dQ columns of a warpgroup
  extern __shared__ __align__(128) __nv_bfloat16 sm[];
  __nv_bfloat16* sQ = sm;
  __nv_bfloat16* sdO = sQ + C::kRowTile;
  __nv_bfloat16* sRing = sdO + C::kRowTile;             // stage st: K, V
  __nv_bfloat16* sdS = sRing + 4 * C::kKeyTile;
  float* sX = reinterpret_cast<float*>(sdS + kBq * kBk);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int kh = blockIdx.y;
  const long long b = blockIdx.z;
  const int G = p.H / p.KH, SG = p.S * G, off = p.T - p.S;
  const Mask mask{p.T, p.causal, p.window};
  // the last rows see the most keys under a causal mask: first
  const int f0 = (gridDim.x - 1 - blockIdx.x) * kBq;
  const int f_last = min(f0 + kBq, SG) - 1;
  const int s_lo = f0 / G, s_hi = f_last / G;
  int k_lo = 0, k_hi = p.T - 1;
  if (p.causal) k_hi = min(k_hi, s_hi + off);
  if (p.window > 0) k_lo = max(0, s_lo + off - p.window + 1);
  const int t_lo = k_lo / kBk;
  const int n_tiles = k_hi < k_lo ? 0 : k_hi / kBk - t_lo + 1;

  load_rows<D>(sQ, p.q, p.s[0], p.s[1], p.s[2], b, kh, G, SG, f0);
  load_rows<D>(sdO, p.dout, p.s[12], p.s[13], p.s[14], b, kh, G, SG, f0);
  const __nv_bfloat16* kb = p.k + b * p.s[3] + kh * p.s[4];
  const __nv_bfloat16* vb = p.v + b * p.s[6] + kh * p.s[7];
  auto load_tile = [&](int i) {
    __nv_bfloat16* d = sRing + (i & 1) * 2 * C::kKeyTile;
    const int kt = (t_lo + i) * kBk;
    load_keys<D, kBk>(d, kb, p.s[5], kt, p.T);
    load_keys<D, kBk>(d + C::kKeyTile, vb, p.s[8], kt, p.T);
  };
  if (n_tiles > 0) load_tile(0);
  cp_commit();
  if (n_tiles > 1) load_tile(1);
  cp_commit();

  Rows rows;                           // the block's rows: lse and delta
  rows.load(p, b, kh, G, SG, off, f0, warp, g);

  // running dQ for this warpgroup's DH columns: run[4n + e] is row
  // 16 warp + g (+ 8 when e & 2), column DH wg + 8n + 2tq + (e & 1)
  float run[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) run[i] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    const __nv_bfloat16* sk = sRing + (i & 1) * 2 * C::kKeyTile;
    const __nv_bfloat16* sv = sk + C::kKeyTile;
    const int kt = (t_lo + i) * kBk;
    cp_wait<1>();
    fence_async_smem();
    __syncthreads();

    float s[kBk / 2];
    scores<D, kBk>(s, wg == 0 ? sQ : sdO, wg == 0 ? sk : sv);
    if (wg == 0) give<0, kBk>(s, sX, wt);
    else give<1, kBk>(s, sX, wt);
    __syncthreads();
    if (wg == 0)
      make_p_ds<0, kBk>(s, sX, wt, warp, g, tq, kt, rows, mask, p.scale,
                        p.cap, nullptr, sdS);
    else
      make_p_ds<1, kBk>(s, sX, wt, warp, g, tq, kt, rows, mask, p.scale,
                        p.cap, nullptr, sdS);
    __syncthreads();

    // dQ[:, DH wg ..] += dS K: 2 k-steps of 16 keys, a fresh accumulator,
    // added on the f32 pipes
    {
      float stp[DH / 2];
#pragma unroll
      for (int e = 0; e < DH / 2; ++e) stp[e] = 0.0f;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < kBk / 16; ++ks)
        wgmma_ss<DH, 0, 1>(stp, desc_k(sdS + ks * 128, kBk),
                           desc_mn(sk + ks * 16 * D + wg * (DH / 8) * 64, D), ks > 0);
      wg_commit();
      wg_wait();
      pin(stp);
#pragma unroll
      for (int e = 0; e < DH / 2; ++e) run[e] += stp[e];
    }
    __syncthreads();                   // stage i & 1 and dS consumed
    if (i + 2 < n_tiles) load_tile(i + 2);
    cp_commit();
  }
  cp_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int f = f0 + warp * 16 + g + 8 * hf;
    if (f >= SG) continue;
    const int pos = f / G, h = kh * G + (f - pos * G);
    __nv_bfloat16* dst = p.dq + b * p.s[15] + h * p.s[16] + pos * p.s[17] +
                         DH * wg + 2 * tq;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack_bf16(run[4 * n + 2 * hf] * p.scale, run[4 * n + 2 * hf + 1] * p.scale);
  }
}

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      attn16_bwd_kv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kKvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn16_bwd_q<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kQSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(B) * a.H * a.S;
  attn16_bwd_delta<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(a, B);
  const int n_kt = (a.T + kBkv - 1) / kBkv;
  attn16_bwd_kv<D><<<dim3(n_kt, a.KH, B), kThreads, C::kKvSmem, stream>>>(a);
  const long long sg = static_cast<long long>(a.S) * (a.H / a.KH);
  attn16_bwd_q<D><<<dim3(static_cast<unsigned>((sg + kBq - 1) / kBq), a.KH, B),
                    kThreads, C::kQSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fb16
}  // namespace fedk

// q, out, dout, dq: (B, H, S, D); k, v, dk, dv: (B, Kh, T, D); all bf16 on
// the device, addressed through `strides` (24 element strides: batch, head,
// position of q, k, v, out, dout, dq, dk, dv in that order; the head dim
// contiguous, rows 16-byte aligned).  lse: (B, H, S) f32 contiguous.
// delta: f32 scratch of B * H * S floats.  causal: 0 or 1; window <= 0
// means none; cap <= 0 means none; D one of 32, 64, 128, 256.  Launches the
// delta pass and the kv-major and q-major kernels on `stream` and returns
// cudaGetLastError().  Allocates nothing.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const long long* strides, int B, int H, int KH, int S, int T,
    int D, int causal, int window, float scale, float cap, int device,
    void* stream) {
  using namespace fedk::fb16;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || S <= 0 || T <= 0 ||
      B > 65535 || KH > 65535 || (causal && S > T) ||
      static_cast<long long>(S) * (H / KH) > 2147483647LL - kBq)
    return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  Args a{};
  a.q = static_cast<const bf*>(q); a.k = static_cast<const bf*>(k);
  a.v = static_cast<const bf*>(v); a.out = static_cast<const bf*>(out);
  a.dout = static_cast<const bf*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<bf*>(dq); a.dk = static_cast<bf*>(dk); a.dv = static_cast<bf*>(dv);
  for (int i = 0; i < 24; ++i) a.s[i] = strides[i];
  a.H = H; a.KH = KH; a.S = S; a.T = T; a.causal = causal; a.window = window;
  a.scale = scale; a.cap = cap;
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(a, B, s);
    case 64: return launch<64>(a, B, s);
    case 128: return launch<128>(a, B, s);
    case 256: return launch<256>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
