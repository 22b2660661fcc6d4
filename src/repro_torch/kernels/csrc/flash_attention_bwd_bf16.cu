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
// recomputes S and dP for dQ (14 D, as the reference's two passes do:
// determinism rules out atomics, and a dQ partial per key tile would cost
// more bytes than the recompute); at gemma2-2b's global layer (B=2, H=8,
// S=T=4096, D=256, causal) 10 D flops a pair are 3.44e11 flops: 0.348 ms
// at 989 TFLOP/s (bf16 tensor cores), against 0.11 GB of bytes (0.033 ms
// at 3.35 TB/s).  Measured (chip_smoke.py phase 2e, NVIDIA H100 80GB HBM3,
// 700.00 W): 1.95 ms there (17.5% of the bound), 2.85 ms at
// recurrentgemma-9b's local layer (SDPA's backward: 6.98 ms).
//
// The design (deterministic: no atomics, every sum in a fixed order, so two
// calls give the same bits; warp-specialised, as attn_bf16.cuh sets out):
//
//  * Two launches a call.  A prep pass (attn16_bwd_prep) lays every 64-row
//    tile of Q and dO out in the blocked layout, with its rows' lse (times
//    log2 e) and delta = rowsum(dO O) (computed there, in f32), and every
//    64-key tile of K and V, in scratch the wrapper allocates (sized by
//    flash_attention_bwd_plan_bf16), so one bulk copy brings a whole tile.
//    Then one launch (attn16_bwd_main) holds both kinds of block:
//    kv-major blocks own a 64-key tile of one (b, kv head) and walk, 64
//    rows a step, every row of its G heads that sees one of its keys,
//    keeping dK and dV; q-major blocks own a 64-row tile and walk the
//    64-key tiles its rows see (the forward's tile skipping), keeping dQ.
//    The kind whose longest walk costs more goes first, each kind longest
//    walk first, so the short blocks fill the tail.
//  * 256 threads a block, two consumer warpgroups; thread 0 is also the
//    producer: it brings the block's own tile and then the streamed tiles
//    (row tiles, or K and V tiles as loads 2j and 2j + 1) by cp.async.bulk
//    into a ring on full and empty mbarriers, topping it up at each step
//    (attn_bf16.cuh, Ring); no thread computes an address of a copy.  Up
//    to 255 registers a thread at D >= 128, 127 at D <= 64, where two
//    blocks share an SM.  The ring holds 2 row tiles in a kv-major block
//    at D = 256 (its own K and V and the P/dS tiles leave room for no
//    more), 3-4 at D <= 128, and 5-8 K or V tiles in a q-major block.
//  * Each consumer warpgroup makes S and dP for its own 32 of the tile's 64
//    keys (m64n32k16, K = D; no exchange between the warpgroups), and P and
//    dS from them in registers: exp2 with log2 e folded into the scale and
//    into lse, the cap's tanh from exp2, the mask tested only on tiles that
//    are not wholly live, the rows' lse and delta read from the row tile.
//    kv-major: both write P and dS as bf16 tiles (double-buffered), meet
//    at one named barrier a step, and then warpgroup 0 accumulates dV +=
//    P^T dO and warpgroup 1 dK += dS^T Q (M = 64 keys, N = D, K = 64 rows;
//    P^T and dS^T read MN-major from the tiles).  q-major: dS stays in
//    registers as the A operand of dQ += dS K (M = 64 rows, N = D, K = its
//    32 keys), each warpgroup summing its own keys; the two halves are
//    added once at the end, in a fixed order.
//  * Products overlapped with the elementwise work: a step issues the next
//    step's S and dP, then this step's dV/dK (or dQ) product, waits for the
//    scores alone (wgmma wait_group 1) and makes the next P and dS while
//    the gradient product runs.
//  * Accuracy: S = Q K^T and dP = dO V^T are exact products of bf16 inputs.
//    P and dS are f32 and enter dV, dK and dQ rounded once to bf16: an
//    error of at most 2^-9 of each term, ~2^-9 / sqrt(n) of a gradient over
//    n terms of random sign, against the card's limit of 2e-2 of each row's
//    max-abs (a query's dq, a key's dk and dv).  The gradient sums stay in
//    the tensor cores over the whole walk (the flush period is the walk):
//    their truncating f32 accumulation loses at most 2^-23 of the running
//    sum a k-step: over recurrentgemma-9b's 2,080-k-step walk the
//    emulation of tests/test_torch_attn_bwd.py moves each gradient by
//    6e-5 of its max-abs, a sixtieth of a bf16 ulp at the max.
//  * Shared memory at D = 256: kv-major 230,440 B (its K and V, the two P
//    and dS tiles, 2 row tiles of 66,048 B); q-major 229,976 B (its row
//    tile, 5 K or V tiles of 32 KB).  At D <= 64 at most 113 KB, two blocks
//    an SM.
//
// Layout through strides: q, dq, out, dout (B, H, S, D); k, v, dk, dv
// (B, Kh, T, D); each addressed by (batch, head, position) strides with the
// head dim contiguous and rows 16-byte aligned.  lse is (B, H, S) f32
// contiguous.  Ragged S and T: rows past S G and keys past T are zero in
// the scratch and masked.

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_bf16.cuh"

namespace fedk {
namespace fb16 {

using namespace b16;
using bf = __nv_bfloat16;

constexpr int kThreads = 256;       // two consumer warpgroups
constexpr int kBq = 64;             // rows of a row tile
constexpr int kBk = 64;             // keys of a key tile
constexpr int kBarStep = 1;         // named barrier of the two consumers

enum { kQ = 0, kK = 3, kV = 6, kO = 9, kDO = 12, kDQ = 15, kDK = 18, kDV = 21 };

// The deepest ring, at most `most` slots, that fits beside `base` bytes.
constexpr int ring_depth(size_t base, size_t slot, size_t cap, int most) {
  int n = most;
  while (n > 2 && base + n * slot > cap) --n;
  return n;
}

template <int D>
struct Cfg {
  // a row tile: Q and dO (64 x D, blocked), lse * log2 e [64], delta [64]
  static constexpr int ROW = 2 * kBq * D * 2 + 2 * kBq * 4;
  // a key tile: K and V (64 x D, blocked); PART is one of them
  static constexpr int PART = kBk * D * 2;
  static constexpr int KEY = 2 * PART;
  static constexpr int PDS = 4 * kBq * kBk * 2;      // 2 buffers of P, dS
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;
  static constexpr size_t kCap = D <= 64 ? 115712 : 232448;
  static constexpr int NR_KV = ring_depth(KEY + PDS + 256, ROW, kCap, 4);
  static constexpr int NR_Q = ring_depth(ROW + 256, PART, kCap, 8);
  static constexpr size_t kKvBytes = KEY + PDS + static_cast<size_t>(NR_KV) * ROW + 16 * NR_KV + 8;
  static constexpr size_t kQBytes = ROW + static_cast<size_t>(NR_Q) * PART + 16 * NR_Q + 8;
  static constexpr size_t kSmem = kKvBytes > kQBytes ? kKvBytes : kQBytes;
  static_assert(kSmem <= kCap, "two ring slots must fit");
  static_assert(NR_Q * PART >= kBq * D * 4, "the dQ halves' exchange must fit the ring");
};

struct Args {
  const bf *q, *k, *v, *out, *dout;
  const float* lse;
  uint8_t* rows;                     // scratch: row tiles
  uint8_t* keys;                     // scratch: key tiles
  bf *dq, *dk, *dv;
  long long st[24];                  // (b, head, position) strides, in the
                                     // order q, k, v, out, dout, dq, dk, dv
  int B, H, KH, S, T, causal, window;
  int n_rt, n_kt;                    // row tiles, key tiles of a (b, kv head)
  long long n_kv, n_q;               // kv-major and q-major blocks
  int dq_first;                      // the q-major blocks come first
  float scale, cap;
};

// ---- the prep pass ----------------------------------------------------------

// Row tile rt of (b, kv head) hb: Q and dO blocked (rows past S G zero),
// lse * log2 e and delta = rowsum(dO O) (4 threads a row, a fixed order).
// Key tile kt: K and V blocked (keys past T zero).  16 bytes a thread.
template <int D>
__global__ void __launch_bounds__(256)
attn16_bwd_prep(const Args p) {
  using C = Cfg<D>;
  constexpr int CH = D / 8;                       // 16-byte pieces of a row
  const long long n_row_blocks = static_cast<long long>(p.B) * p.KH * p.n_rt;
  const int G = p.H / p.KH, SG = p.S * G;
  const int tid = threadIdx.x;
  if (blockIdx.x < n_row_blocks) {
    const long long hb = blockIdx.x / p.n_rt;     // b * KH + kh
    const int rt = static_cast<int>(blockIdx.x - hb * p.n_rt);
    const long long b = hb / p.KH;
    const int kh = static_cast<int>(hb - b * p.KH);
    uint8_t* dst = p.rows + (hb * p.n_rt + rt) * static_cast<long long>(C::ROW);
    for (int i = tid; i < 2 * kBq * CH; i += 256) {
      const int which = i / (kBq * CH);           // 0: Q, 1: dO
      const int r = (i / CH) % kBq, c8 = i % CH;
      const int f = rt * kBq + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (f < SG) {
        const int pos = f / G, h = kh * G + (f - pos * G);
        const int o = which ? kDO : kQ;
        x = __ldg(reinterpret_cast<const uint4*>(
            (which ? p.dout : p.q) + b * p.st[o] + h * p.st[o + 1] + pos * p.st[o + 2] +
            c8 * 8));
      }
      *reinterpret_cast<uint4*>(dst + which * kBq * D * 2 + blk(r, c8 * 8, D) * 2) = x;
    }
    const int r = tid >> 2, j = tid & 3;
    const int f = rt * kBq + r;
    float lse2 = 0.0f, acc = 0.0f;
    if (f < SG) {
      const int pos = f / G, h = kh * G + (f - pos * G);
      const bf* o = p.out + b * p.st[kO] + h * p.st[kO + 1] + pos * p.st[kO + 2];
      const bf* d = p.dout + b * p.st[kDO] + h * p.st[kDO + 1] + pos * p.st[kDO + 2];
      for (int c8 = j; c8 < CH; c8 += 4) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(o + c8 * 8));
        const uint4 y = __ldg(reinterpret_cast<const uint4*>(d + c8 * 8));
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc = fmaf(bf16_lo(xs[u]), bf16_lo(ys[u]), acc);
          acc = fmaf(bf16_hi(xs[u]), bf16_hi(ys[u]), acc);
        }
      }
      lse2 = __ldg(p.lse + (b * p.H + h) * p.S + pos) * kLog2e;
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (j == 0) {
      float* stats = reinterpret_cast<float*>(dst + 2 * kBq * D * 2);
      stats[r] = lse2;
      stats[kBq + r] = acc;
    }
    return;
  }
  const long long x = blockIdx.x - n_row_blocks;
  const long long hb = x / p.n_kt;
  const int kt = static_cast<int>(x - hb * p.n_kt);
  const long long b = hb / p.KH;
  const int kh = static_cast<int>(hb - b * p.KH);
  uint8_t* dst = p.keys + (hb * p.n_kt + kt) * static_cast<long long>(C::KEY);
  for (int i = tid; i < 2 * kBk * CH; i += 256) {
    const int which = i / (kBk * CH);             // 0: K, 1: V
    const int r = (i / CH) % kBk, c8 = i % CH;
    const int key = kt * kBk + r;
    uint4 y = make_uint4(0u, 0u, 0u, 0u);
    if (key < p.T) {
      const int o = which ? kV : kK;
      y = __ldg(reinterpret_cast<const uint4*>(
          (which ? p.v : p.k) + b * p.st[o] + kh * p.st[o + 1] + key * p.st[o + 2] + c8 * 8));
    }
    *reinterpret_cast<uint4*>(dst + which * C::PART + blk(r, c8 * 8, D) * 2) = y;
  }
}

// ---- the main pass ----------------------------------------------------------

// P and dS of one element from the raw product s, dP and the row's lse *
// log2 e and delta; tanh y = 1 - 2 / (e^{2y} + 1), off tanhf by ~1e-7
struct Elem {
  float c_scale, c_in, c_out;        // scale log2 e; cap: 2 log2 e scale / cap,
  bool capped;                       // cap log2 e
  __device__ __forceinline__ void operator()(float s, float dp, float lse2, float delta,
                                             float& pv, float& dsv) const {
    float x2, dcap = 1.0f;
    if (capped) {
      const float th = 1.0f - __fdividef(2.0f, ex2(s * c_in) + 1.0f);
      x2 = th * c_out;
      dcap = 1.0f - th * th;
    } else {
      x2 = s * c_scale;
    }
    pv = ex2(x2 - lse2);
    dsv = pv * (dp - delta) * dcap;
  }
};

// S (or dP) of this warpgroup's 32 keys: a 64-row tile times 32 key rows,
// both K-major, over the head dim, from their descriptors (a k-step is
// 256 bytes along K: + 16 in the descriptor)
template <int D>
__device__ __forceinline__ void scores32(float (&s)[16], uint64_t da, uint64_t db) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) wgmma_ss<32, 0, 0>(s, da + 16 * ks, db + 16 * ks, ks > 0);
}

// Whether every (row, key) of rows [fa, fa + 63] and keys [ka, ka + 31] is
// live: then the per-element mask test is skipped.
__device__ __forceinline__ bool all_live(const Args& p, int fa, int ka, int G, int SG) {
  if (fa + kBq - 1 >= SG || ka + 31 >= p.T) return false;
  const int off = p.T - p.S;
  if (p.causal && ka + 31 > fa / G + off) return false;
  if (p.window > 0 && ka <= (fa + kBq - 1) / G + off - p.window) return false;
  return true;
}

__device__ __forceinline__ bool live(const Args& p, int f, int key, int G, int SG) {
  const int qk = f / G + (p.T - p.S);
  bool ok = f < SG && key < p.T;
  if (p.causal) ok = ok && key <= qk;
  if (p.window > 0) ok = ok && key > qk - p.window;
  return ok;
}

// P and dS in place of s (P: only where `pv` is non-null) and dP for this
// thread's 16 elements: rows fa + 16 warp + g (+ 8 when e & 2), keys ka +
// 8 (e >> 2) + 2 tq + (e & 1); lse2 and delta of the two rows
__device__ __forceinline__ void probs(const Args& p, const Elem& el, float (&s)[16],
                                      float (&dp)[16], const float (&lse2)[2],
                                      const float (&dl)[2], int fa, int ka, int G,
                                      int SG, int warp, int g, int tq) {
  const bool full = all_live(p, fa, ka, G, SG);
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int hf = (e >> 1) & 1;
    float pv, dsv;
    el(s[e], dp[e], lse2[hf], dl[hf], pv, dsv);
    if (!full && !live(p, fa + 16 * warp + g + 8 * hf, ka + 8 * (e >> 2) + 2 * tq + (e & 1),
                       G, SG)) {
      pv = 0.0f;
      dsv = 0.0f;
    }
    s[e] = pv;
    dp[e] = dsv;
  }
}

// kv-major: one 64-key tile of (b, kv head); dV (warpgroup 0) and dK
// (warpgroup 1) over every 64-row tile whose rows see one of its keys.
template <int D>
__device__ __forceinline__ void kv_block(const Args& p, long long x, uint8_t* sm) {
  using C = Cfg<D>;
  constexpr int NR = C::NR_KV;
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
  const int n = i_lo <= i_hi ? ((i_hi + 1) * G - 1) / kBq - rt0 + 1 : 0;

  bf* sK = reinterpret_cast<bf*>(sm);               // own K, V
  bf* sPdS = sK + 2 * kBk * D;                       // buffer u: P, dS
  uint8_t* slots = reinterpret_cast<uint8_t*>(sPdS + 4 * kBq * kBk);
  uint64_t* own = reinterpret_cast<uint64_t*>(slots + NR * C::ROW);
  // row tile rt0 + i is load i of the ring, thread 0 the producer
  Ring<NR> ring{own + 1, own + 1 + NR, n, 0};
  const uint8_t* rows = p.rows + (hb * p.n_rt + rt0) * static_cast<long long>(C::ROW);
  auto issue = [&](int i, int slot) {
    bulk_load(slots + slot * C::ROW, rows + static_cast<long long>(i) * C::ROW, C::ROW,
              ring.full + slot);
  };
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(own, 1);
    ring.init();
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    bulk_load(sK, p.keys + (hb * p.n_kt + kt) * static_cast<long long>(C::KEY), C::KEY, own);
    ring.top_up(-1, issue);
  }
  const int wg = tid >> 7;
  const int wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const Elem el{p.scale * kLog2e, 2.0f * kLog2e * p.scale / p.cap, p.cap * kLog2e,
                p.cap > 0.0f};
  const int ka = k0 + 32 * wg;                       // this warpgroup's keys
  const bf* kw = sK + 32 * wg * D;
  const bf* vw = sK + kBk * D + 32 * wg * D;
  // dV (wg 0) or dK (wg 1): acc[4n + e] is key 16 warp + g (+ 8 when e & 2),
  // dim 8n + 2tq + (e & 1)
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  pin(acc);
  float s[16], dp[16];
  mbar_wait(own, 0);

  auto tile = [&](int i) { return reinterpret_cast<const bf*>(slots + (i % NR) * C::ROW); };
  auto sdp = [&](int i) {
    if (tid == 0) ring.top_up(i, issue);
    ring.wait(i);
    const bf* q = tile(i);
    const uint64_t dk = opaque(desc_k(kw, D)), dv = opaque(desc_k(vw, D));
    wg_fence();
    scores32<D>(s, desc_k(q, D), dk);
    scores32<D>(dp, desc_k(q + kBq * D, D), dv);
    wg_commit();
  };
  auto pds = [&](int i, int buf) {
    pin(s);
    pin(dp);
    const float* stats = reinterpret_cast<const float*>(tile(i) + 2 * kBq * D);
    const int r = 16 * warp + g;
    const float lse2[2] = {stats[r], stats[r + 8]};
    const float dl[2] = {stats[kBq + r], stats[kBq + r + 8]};
    probs(p, el, s, dp, lse2, dl, (rt0 + i) * kBq, ka, G, SG, warp, g, tq);
    bf* pb = sPdS + buf * 2 * kBq * kBk;
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int o = blk(r + 8 * hf, 32 * wg + 8 * nn + 2 * tq, kBk);
        *reinterpret_cast<uint32_t*>(pb + o) = pack_bf16(s[4 * nn + 2 * hf], s[4 * nn + 2 * hf + 1]);
        *reinterpret_cast<uint32_t*>(pb + kBq * kBk + o) =
            pack_bf16(dp[4 * nn + 2 * hf], dp[4 * nn + 2 * hf + 1]);
      }
  };
  // dV += P^T dO (wg 0), dK += dS^T Q (wg 1): M = 64 keys, K = 64 rows
  auto dvdk = [&](int i) {
    const bf* q = tile(i);
    const bf* a = sPdS + (i & 1) * 2 * kBq * kBk + wg * kBq * kBk;
    const bf* bb = wg == 0 ? q + kBq * D : q;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kBq / 16; ++ks)
      wgmma_ss<D, 1, 1>(acc, desc_mn(a + ks * 16 * kBk, kBk), desc_mn(bb + ks * 16 * D, D), 1);
    wg_commit();
  };
  auto release = [&](int i) { ring.release(i); };

  // Every step issues the next step's scores (the last step recomputes its
  // own into the buffer no product reads), so that no product is issued
  // under a runtime test.
  if (n > 0) {
    sdp(0);
    wg_wait<0>();
    pds(0, 0);
    fence_async_smem();
    bar_sync(kBarStep, 256);
  }
  for (int i = 0; i < n; ++i) {
    const int nx = min(i + 1, n - 1);
    sdp(nx);
    dvdk(i);
    wg_wait<1>();
    pds(nx, (i + 1) & 1);
    wg_wait<0>();
    pin(acc);
    // P/dS i + 1 to the async proxy, with no wgmma in flight: ptxas (CUDA
    // 12.8) crashes on this fence issued while one is
    fence_async_smem();
    release(i);
    bar_sync(kBarStep, 256);         // P/dS i + 1 written, buffer i & 1 free
    if (tid == 0) ring.top_up(-1, issue);           // row tile i's slot
  }

  const int o = wg ? kDK : kDV;
  bf* out = (wg ? p.dk : p.dv) + b * p.st[o] + kh * p.st[o + 1];
  const float mul = wg ? p.scale : 1.0f;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = k0 + 16 * warp + g + 8 * hf;
    if (key >= p.T) continue;
    bf* dst = out + key * p.st[o + 2] + 2 * tq;
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn)
      *reinterpret_cast<uint32_t*>(dst + 8 * nn) =
          pack_bf16(acc[4 * nn + 2 * hf] * mul, acc[4 * nn + 2 * hf + 1] * mul);
  }
}

// q-major: one 64-row tile of (b, kv head); dQ over every key tile its rows
// see.  Warpgroup w sums dS K over keys 32 w .. 32 w + 31 of each tile.
template <int D>
__device__ __forceinline__ void q_block(const Args& p, long long x, uint8_t* sm) {
  using C = Cfg<D>;
  constexpr int NR = C::NR_Q;
  const long long heads = static_cast<long long>(p.B) * p.KH;
  const int qi = static_cast<int>(x / heads);       // last rows first
  const int rt = p.n_rt - 1 - qi;
  const long long hb = x - qi * heads;
  const long long b = hb / p.KH;
  const int kh = static_cast<int>(hb - b * p.KH);
  const int G = p.H / p.KH, SG = p.S * G, off = p.T - p.S;
  const int fa = rt * kBq, fz = min(fa + kBq, SG) - 1;
  int k_lo = 0, k_hi = p.T - 1;
  if (p.causal) k_hi = min(k_hi, fz / G + off);
  if (p.window > 0) k_lo = max(0, fa / G + off - p.window + 1);
  const int kt0 = k_lo / kBk;
  const int n = k_hi >= k_lo ? k_hi / kBk - kt0 + 1 : 0;

  const bf* sQ = reinterpret_cast<const bf*>(sm);   // own Q, dO, stats
  uint8_t* slots = sm + C::ROW;                      // load 2j: K_j, 2j + 1: V_j
  uint64_t* own = reinterpret_cast<uint64_t*>(slots + NR * C::PART);
  Ring<NR> ring{own + 1, own + 1 + NR, 2 * n, 0};
  const uint8_t* keys = p.keys + (hb * p.n_kt + kt0) * static_cast<long long>(C::KEY);
  auto issue = [&](int ld, int slot) {
    bulk_load(slots + slot * C::PART, keys + static_cast<long long>(ld) * C::PART, C::PART,
              ring.full + slot);
  };
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(own, 1);
    ring.init();
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    bulk_load(sm, p.rows + (hb * p.n_rt + rt) * static_cast<long long>(C::ROW), C::ROW, own);
    ring.top_up(-1, issue);
  }
  const int wg = tid >> 7;
  const int wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const Elem el{p.scale * kLog2e, 2.0f * kLog2e * p.scale / p.cap, p.cap * kLog2e,
                p.cap > 0.0f};
  // dQ over this warpgroup's keys: acc[4n + e] is row 16 warp + g (+ 8 when
  // e & 2), dim 8n + 2tq + (e & 1)
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  pin(acc);
  float s[16], dp[16];
  uint32_t a[2][4];                                  // dS as A, 2 k-steps
  mbar_wait(own, 0);
  const float* stats = reinterpret_cast<const float*>(sQ + 2 * kBq * D);
  const int r = 16 * warp + g;
  const float lse2[2] = {stats[r], stats[r + 8]};
  const float dl[2] = {stats[kBq + r], stats[kBq + r + 8]};

  auto part = [&](int ld) { return reinterpret_cast<const bf*>(slots + (ld % NR) * C::PART); };
  auto release = [&](int ld) { ring.release(ld); };
  auto sdp = [&](int j) {
    if (tid == 0) ring.top_up(2 * j + 1, issue);
    ring.wait(2 * j);
    ring.wait(2 * j + 1);
    const uint64_t dq_ = opaque(desc_k(sQ, D)), ddo = opaque(desc_k(sQ + kBq * D, D));
    wg_fence();
    scores32<D>(s, dq_, desc_k(part(2 * j) + 32 * wg * D, D));
    scores32<D>(dp, ddo, desc_k(part(2 * j + 1) + 32 * wg * D, D));
    wg_commit();
  };
  auto ds = [&](int j) {
    pin(s);
    pin(dp);
    probs(p, el, s, dp, lse2, dl, fa, (kt0 + j) * kBk + 32 * wg, G, SG, warp, g, tq);
  };
  // k-step kk (keys 16kk .. of the warpgroup's 32): rows g, g + 8; keys
  // 2t, 2t + 1, then + 8: dp[8kk .. 8kk + 7] in order
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
    pin(a[0]);
    pin(a[1]);
  };
  auto dq = [&](int j) {
    const bf* kb = part(2 * j) + 32 * wg * D;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) wgmma_rs<D, 1>(acc, a[kk], desc_mn(kb + 16 * kk * D, D), 1);
    wg_commit();
  };

  // every step issues the next step's scores (the last step recomputes its
  // own, which nothing reads), so that no product is issued under a
  // runtime test; V_{n-1} is released once, and nothing refills its slot
  if (n > 0) {
    sdp(0);
    wg_wait<0>();
    release(1);
    ds(0);
    pack();
  }
  for (int j = 0; j < n; ++j) {
    const int nx = min(j + 1, n - 1);
    sdp(nx);
    dq(j);
    wg_wait<1>();
    if (j + 1 < n) release(2 * j + 3);               // V_{j+1}
    ds(nx);
    wg_wait<0>();
    pin(acc);
    release(2 * j);                                  // K_j
    pack();
  }

  // dQ = dQ(wg 0) + dQ(wg 1), then scaled: the halves meet in the ring
  float* sx = reinterpret_cast<float*>(slots);
  bar_sync(kBarStep, 256);                           // the ring is drained
  if (wg == 1) {
#pragma unroll
    for (int e = 0; e < D / 2; ++e) sx[e * 128 + wt] = acc[e];
  }
  bar_sync(kBarStep, 256);
  if (wg == 1) return;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int f = fa + r + 8 * hf;
    if (f >= SG) continue;
    const int pos = f / G, h = kh * G + (f - pos * G);
    bf* dst = p.dq + b * p.st[kDQ] + h * p.st[kDQ + 1] + pos * p.st[kDQ + 2] + 2 * tq;
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn) {
      const int e = 4 * nn + 2 * hf;
      *reinterpret_cast<uint32_t*>(dst + 8 * nn) =
          pack_bf16((acc[e] + sx[e * 128 + wt]) * p.scale,
                    (acc[e + 1] + sx[(e + 1) * 128 + wt]) * p.scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
attn16_bwd_main(const Args p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const long long x = blockIdx.x;
  if (p.dq_first) {
    if (x < p.n_q) q_block<D>(p, x, smem);
    else kv_block<D>(p, x - p.n_q, smem);
  } else {
    if (x < p.n_kv) kv_block<D>(p, x, smem);
    else q_block<D>(p, x - p.n_kv, smem);
  }
}

// The launch's shape: scratch bytes, kv-major and q-major blocks, prep
// blocks, dynamic shared memory, and which kind goes first: the one whose
// longest walk costs more (a kv-major step is 4 products, a q-major one 3).
struct Plan {
  long long rows_bytes, keys_bytes, n_kv, n_q, n_prep;
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
  pl.rows_bytes = heads * pl.n_rt * C::ROW;
  pl.keys_bytes = heads * pl.n_kt * C::KEY;
  pl.n_kv = heads * pl.n_kt;
  pl.n_q = heads * pl.n_rt;
  pl.n_prep = pl.n_kv + pl.n_q;
  pl.smem = C::kSmem;
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

inline bool plan_for(int D, int B, int H, int KH, int S, int T, int window, Plan& pl) {
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
int launch_bwd(const Args& a, const Plan& pl, cudaStream_t stream) {
  auto kernel = attn16_bwd_main<D>;
  const int smem = static_cast<int>(pl.smem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pl.n_prep > 2147483647LL || pl.n_kv + pl.n_q > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  attn16_bwd_prep<D><<<static_cast<unsigned>(pl.n_prep), 256, 0, stream>>>(a);
  kernel<<<static_cast<unsigned>(pl.n_kv + pl.n_q), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fb16
}  // namespace fedk

// The scratch and grid of one call: returns the scratch bytes the caller
// allocates for flash_attention_bwd_bf16 (-1 for a shape it refuses) and
// fills info[0..4] with the kv-major blocks, the q-major blocks (one launch
// of both), the prep pass's blocks, the main launch's dynamic shared
// memory in bytes, and 1 where the q-major blocks come first.
extern "C" long long flash_attention_bwd_plan_bf16(int B, int H, int KH, int S,
                                                   int T, int D, int window,
                                                   long long* info) {
  using namespace fedk::fb16;
  Plan pl{};
  if (!valid(B, H, KH, S, T, 0) || !plan_for(D, B, H, KH, S, T, window, pl))
    return -1;
  info[0] = pl.n_kv;
  info[1] = pl.n_q;
  info[2] = pl.n_prep;
  info[3] = static_cast<long long>(pl.smem);
  info[4] = pl.dq_first;
  return pl.rows_bytes + pl.keys_bytes;
}

// q, out, dout, dq: (B, H, S, D); k, v, dk, dv: (B, Kh, T, D); all bf16 on
// the device, addressed through `strides` (24 element strides: batch, head,
// position of q, k, v, out, dout, dq, dk, dv in that order; the head dim
// contiguous, rows 16-byte aligned).  lse: (B, H, S) f32 contiguous.
// work: scratch of flash_attention_bwd_plan_bf16's bytes, 16-byte aligned.
// causal: 0 or 1; window <= 0 means none; cap <= 0 means none; D one of 32,
// 64, 128, 256.  Launches the prep pass and the main pass on `stream` and
// returns cudaGetLastError().  Allocates nothing.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* work, void* dq, void* dk,
    void* dv, const long long* strides, int B, int H, int KH, int S, int T,
    int D, int causal, int window, float scale, float cap, int device,
    void* stream) {
  using namespace fedk::fb16;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan pl{};
  if (!valid(B, H, KH, S, T, causal) || !plan_for(D, B, H, KH, S, T, window, pl))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = static_cast<const bf*>(q); a.k = static_cast<const bf*>(k);
  a.v = static_cast<const bf*>(v); a.out = static_cast<const bf*>(out);
  a.dout = static_cast<const bf*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.rows = static_cast<uint8_t*>(work);
  a.keys = a.rows + pl.rows_bytes;
  a.dq = static_cast<bf*>(dq); a.dk = static_cast<bf*>(dk); a.dv = static_cast<bf*>(dv);
  for (int i = 0; i < 24; ++i) a.st[i] = strides[i];
  a.B = B; a.H = H; a.KH = KH; a.S = S; a.T = T;
  a.causal = causal; a.window = window; a.scale = scale; a.cap = cap;
  a.n_rt = pl.n_rt; a.n_kt = pl.n_kt; a.n_kv = pl.n_kv; a.n_q = pl.n_q;
  a.dq_first = pl.dq_first;
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_bwd<32>(a, pl, s);
    case 64: return launch_bwd<64>(a, pl, s);
    case 128: return launch_bwd<128>(a, pl, s);
    default: return launch_bwd<256>(a, pl, s);
  }
}
