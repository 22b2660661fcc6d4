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
// G = H / Kh query heads of its group.
//
// Replaces, on the training path, the gradient the reference takes around
// the TPU kernel src/repro/kernels/flash_attention.py::_kernel: the jnp
// custom VJP of src/repro/models/attention.py::_flash_backward (a q-major
// pass for dq and a kv-major pass for dk/dv, recomputing each block's P from
// the saved lse).  No Pallas kernel has a backward.
//
// What bounds it: operations.  Each live (query, key) pair costs five
// products of length D (S, dP, dV, dK, dQ): 10 D flops.  At gemma2-2b's
// global layer (B=2, H=8, S=T=4096, D=256, causal) that is 3.44e11 flops,
// 5.13 ms on the f32 SIMT pipes at 67 TFLOP/s (2.08 ms as 3xTF32 on the
// tensor cores), against 0.40 GB of bytes.  This design recomputes S and dP
// in its dQ pass (14 D flops a pair).
//
// The design (deterministic, no atomics):
//
//  * attn_bwd_delta: delta = rowsum(dO * O), one warp a row, (B, H, S) f32
//    into scratch the wrapper allocates.
//  * attn_bwd_dkv (kv-major): a block owns 32 keys of one (b, kv head) and
//    walks, 32 rows at a time, every (position, group head) row of its G
//    heads whose position can see one of its keys (rows are numbered
//    f = position * G + g, as in the forward, so the causal frontier and the
//    window bound a contiguous row range).  dK and dV of its keys stay in
//    registers across the walk and are written once: a group's heads are
//    summed inside the block, so no two blocks write the same row.
//  * attn_bwd_dq (q-major): a block owns 32 rows of one (b, kv head) and
//    walks the 32-key tiles between the first key its earliest row can see
//    (window) and the last key its latest row can see (causal), as the
//    forward skips tiles; dQ stays in registers.
//  * Every product runs on the tensor cores as warp-level mma.sync
//    m16n8k8 TF32 with f32 accumulation, three passes over split operands
//    (3xTF32: x = tf32(x) + tf32(x - tf32(x)), a b ~= a_lo b_hi +
//    a_hi b_lo + a_hi b_hi), which keeps f32 accuracy, as the forward.
//    Operands stay f32 in shared memory and are split as each fragment is
//    loaded.  The tensor cores' f32 accumulation truncates, so their sums
//    stay short (64 of D for a score, one 32-row step or 32-key tile for a
//    gradient) and are added to the running sums on the f32 pipes, which
//    round to nearest: a gradient summed over thousands of rows inside the
//    tensor cores drifts by ~1e-4 of its size.  The score step gives each of the 8 warps one 16-row x 8-key
//    block of S and of dP (the 32 x 32 tile is 2 x 4 such blocks), then
//    scale, cap, mask, P and dS (the scale folded in) in registers and into
//    shared memory.  The accumulation step gives a warp 16 keys (dK, dV) or
//    16 rows (dQ) and every fourth 8-column block of D.
//  * Shared memory rows are padded to D + 4 floats, so a fragment's 32
//    reads (row = lane / 4, column = lane % 4) hit 32 distinct banks; P and
//    dS are padded to 40 columns in the kv-major kernel (read transposed)
//    and to 36 in the q-major one, for the same reason.
//  * Copies are cp.async, double-buffered: the next 32 rows (dKV) or the
//    next key tile (dQ) land while the block computes on the current one.
//  * Shared memory: the block's own two 32 x (D + 4) tiles, two stages of
//    the two streamed tiles, P and dS (32 x 40 each) and two stages of the
//    rows' lse and delta: 210,432 B at D = 256, 112,128 B at 128, 62,976 B
//    at 64, 38,400 B at 32.
//  * Every sum runs in a fixed order, so two calls on the same inputs give
//    the same bits.
//
// Layout through strides: q, dq (B, H, S, D); k, v, dk, dv (B, Kh, T, D);
// out, dout (B, H, S, D); each addressed by (batch, head, position)
// strides with the head dim contiguous and rows 16-byte aligned.  lse and
// delta are (B, H, S) contiguous.

#include <cstdint>
#include <cuda_runtime.h>

namespace fedk {
namespace attn_bwd {

constexpr int kBq = 32;             // query rows of a step (dKV) or block (dQ)
constexpr int kBk = 32;             // keys of a tile (dQ) or block (dKV)
constexpr int kThreads = 256;       // 8 warps
constexpr int kPLdKV = 40;          // P / dS row stride, kv-major (read by key)
constexpr int kPLdQ = 36;           // dS row stride, q-major (read by row)
constexpr int kChunkD = 64;         // head-dim span of one tensor-core sum

template <int D>
struct Cfg {
  static constexpr int kLd = D + 4;                  // padded row stride
  static constexpr int kTile = kBq * kLd;            // floats of one tile
  // the block's own two tiles, two stages of the two streamed tiles,
  // P and dS, two stages of the rows' lse and delta
  static constexpr size_t kSmemBytes =
      sizeof(float) * (6 * static_cast<size_t>(kTile) + 2 * kBq * kPLdKV + 4 * kBq);
  static_assert(kBq == kBk, "square score tiles");
};

struct Args {
  const float* q; const float* k; const float* v; const float* o;
  const float* dout; const float* lse;
  float* delta; float* dq; float* dk; float* dv;
  // (batch, head, position) strides of q, k, v, o, dout, dq, dk, dv
  long long st[24];
  int H, KH, S, T, D, causal, window;
  float scale, cap;
};

enum { kQ = 0, kK = 3, kV = 6, kO = 9, kDO = 12, kDQ = 15, kDK = 18, kDV = 21 };

// cvt.rna.tf32.f32's rounding (half away from zero to 10 mantissa bits),
// on the bit pattern, as flash_attention.cu does it.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32 bit patterns (the subtraction is exact).
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// d (16 x 8, f32) += a (16 x 8) . b (8 x 8), TF32 operands.  Fragments
// (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (k = t, n = g), b1 (t + 4, g); d0 (g, 2t),
// d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32 from the split fragments: the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], unsigned bh0,
                                     unsigned bh1, unsigned bl0, unsigned bl1) {
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// The A fragment of rows r0.. r0 + 15, columns c0 .. c0 + 7 of a row-major
// shared array with row stride ld, split.
__device__ __forceinline__ void frag_a(const float* s, int ld, int r0, int c0,
                                       unsigned (&hi)[4], unsigned (&lo)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = s + (r0 + g) * ld + c0 + t;
  split(p[0], hi[0], lo[0]);
  split(p[8 * ld], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * ld + 4], hi[3], lo[3]);
}

// The A fragment of the TRANSPOSE of a row-major shared array: A (m, k) =
// s[k][m], rows m0 .. m0 + 15 of A, columns k0 .. k0 + 7, split.
__device__ __forceinline__ void frag_at(const float* s, int ld, int m0, int k0,
                                        unsigned (&hi)[4], unsigned (&lo)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = s + (k0 + t) * ld + m0 + g;
  split(p[0], hi[0], lo[0]);
  split(p[8], hi[1], lo[1]);
  split(p[4 * ld], hi[2], lo[2]);
  split(p[4 * ld + 8], hi[3], lo[3]);
}

// The B fragment (k, n) = s[n][k] (the rows of s are B's columns: K or V
// for the scores), n0 .. n0 + 7, k0 .. k0 + 7, split.
__device__ __forceinline__ void frag_b_nk(const float* s, int ld, int n0,
                                          int k0, unsigned& h0, unsigned& h1,
                                          unsigned& l0, unsigned& l1) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = s + (n0 + g) * ld + k0 + t;
  split(p[0], h0, l0);
  split(p[4], h1, l1);
}

// The B fragment (k, n) = s[k][n] (row-major K x N: dO, Q or K for the
// accumulations), k0 .. k0 + 7, n0 .. n0 + 7, split.
__device__ __forceinline__ void frag_b_kn(const float* s, int ld, int k0,
                                          int n0, unsigned& h0, unsigned& h1,
                                          unsigned& l0, unsigned& l1) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = s + (k0 + t) * ld + n0 + g;
  split(p[0], h0, l0);
  split(p[4 * ld], h1, l1);
}

// cp.async copies into shared memory, zero-filled where `valid` is false
// (src-size 0: nothing is read from `src`, which must still be a global
// address).
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts copying rows f0 .. f0 + 31 (f = position * G + g) of a
// (B, H, S, D) tensor of kv head kh into dst[32][D + 4]; rows at or past SG
// are zero.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* t,
                                          long long sb, long long sh,
                                          long long ss, long long b,
                                          int kh, int G, int f0, int SG) {
  constexpr int C4 = D / 4, LD = D + 4;
#pragma unroll
  for (int i = threadIdx.x; i < kBq * C4; i += kThreads) {
    const int r = i / C4, c = (i - r * C4) * 4;
    const int f = f0 + r;
    const bool valid = f < SG;
    const int pos = valid ? f / G : 0;
    const int h = kh * G + (valid ? f - pos * G : 0);
    cp16(dst + r * LD + c, valid ? t + b * sb + h * sh + pos * ss + c : t,
         valid);
  }
}

// Starts copying keys k0 .. k0 + 31 of kv head kh of a (B, Kh, T, D)
// tensor into dst[32][D + 4]; keys at or past T are zero.
template <int D>
__device__ __forceinline__ void load_keys(float* dst, const float* t,
                                          long long sb, long long sh,
                                          long long ss, long long b,
                                          int kh, int k0, int T) {
  constexpr int C4 = D / 4, LD = D + 4;
#pragma unroll
  for (int i = threadIdx.x; i < kBk * C4; i += kThreads) {
    const int r = i / C4, c = (i - r * C4) * 4;
    const int j = k0 + r;
    cp16(dst + r * LD + c, j < T ? t + b * sb + kh * sh + j * ss + c : t,
         j < T);
  }
}

// Starts copying the lse and delta of rows f0 .. f0 + 31 into sLse, sDel
// (0 past SG).
__device__ __forceinline__ void load_row_stats(float* sLse, float* sDel,
                                               const Args& p, long long b,
                                               int kh, int G, int f0, int SG) {
  const int r = threadIdx.x;
  if (r < kBq) {
    const int f = f0 + r;
    const bool valid = f < SG;
    long long i = 0;
    if (valid) {
      const int pos = f / G, h = kh * G + (f - pos * G);
      i = (b * p.H + h) * p.S + pos;
    }
    cp4(sLse + r, p.lse + i, valid);
    cp4(sDel + r, p.delta + i, valid);
  }
}

// The score step on a 32-row x 32-key tile: rows f0 + r, keys k0 + c.
// Warp w takes rows 16 (w & 1) .. + 15 and keys 8 (w >> 1) .. + 7:
// S = Q K^T and dP = dO V^T over D on the tensor cores, then scale, cap,
// mask, P = exp(s - lse) and dS = P (dP - delta) (times 1 - tanh^2 under a
// cap) times the scale.  P goes to sP (when given) and dS to sDS, both
// [32][PLD].
template <int D, int PLD>
__device__ __forceinline__ void score_step(
    const float* sQ, const float* sDO, const float* sK, const float* sV,
    const float* sLse, const float* sDel, float* sP, float* sDS,
    const Args& p, int G, int SG, int f0, int k0) {
  constexpr int LD = D + 4;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int m0 = 16 * (warp & 1), n0 = 8 * (warp >> 1);
  constexpr int KC = D < kChunkD ? D : kChunkD;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kc = 0; kc < D; kc += KC) {
    float ts[4] = {0.f, 0.f, 0.f, 0.f}, tdp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kd = kc; kd < kc + KC; kd += 8) {
      unsigned ah[4], al[4], bh0, bh1, bl0, bl1;
      frag_a(sQ, LD, m0, kd, ah, al);
      frag_b_nk(sK, LD, n0, kd, bh0, bh1, bl0, bl1);
      mma3(ts, ah, al, bh0, bh1, bl0, bl1);
      frag_a(sDO, LD, m0, kd, ah, al);
      frag_b_nk(sV, LD, n0, kd, bh0, bh1, bl0, bl1);
      mma3(tdp, ah, al, bh0, bh1, bl0, bl1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[e] += ts[e];
      dp[e] += tdp[e];
    }
  }
  const int off = p.T - p.S;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = m0 + g + 8 * (e >> 1);
    const int c = n0 + 2 * t + (e & 1);
    const int f = f0 + r;
    const int qk = (f < SG ? f / G : 0) + off;
    const int key = k0 + c;
    bool live = f < SG && key < p.T;
    if (p.causal) live = live && key <= qk;
    if (p.window > 0) live = live && key > qk - p.window;
    float x = s[e] * p.scale;
    float dcap = 1.0f;
    if (p.cap > 0.0f) {
      const float th = tanhf(x / p.cap);
      x = p.cap * th;
      dcap = 1.0f - th * th;
    }
    float pr = 0.0f, ds = 0.0f;
    if (live) {
      pr = expf(x - sLse[r]);
      ds = pr * (dp[e] - sDel[r]);
      if (p.cap > 0.0f) ds = ds * dcap;
      ds = ds * p.scale;
    }
    if (sP != nullptr) sP[r * PLD + c] = pr;
    sDS[r * PLD + c] = ds;
  }
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_delta(const Args p, long long rows) {
  const long long r = blockIdx.x * static_cast<long long>(kThreads / 32) +
                      (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long pos = r % p.S, bh = r / p.S;
  const long long h = bh % p.H, b = bh / p.H;
  const float* o = p.o + b * p.st[kO] + h * p.st[kO + 1] + pos * p.st[kO + 2];
  const float* d = p.dout + b * p.st[kDO] + h * p.st[kDO + 1] +
                   pos * p.st[kDO + 2];
  float acc = 0.0f;
  for (int c = lane; c < p.D; c += 32) acc = fmaf(__ldg(o + c), __ldg(d + c), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) p.delta[r] = acc;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkv(const Args p) {
  using C = Cfg<D>;
  constexpr int LD = D + 4, M = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + C::kTile;
  float* sQ = sV + C::kTile;                    // 2 stages
  float* sDO = sQ + 2 * C::kTile;               // 2 stages
  float* sP = sDO + 2 * C::kTile;
  float* sDS = sP + kBq * kPLdKV;
  float* sLse = sDS + kBq * kPLdKV;             // 2 stages
  float* sDel = sLse + 2 * kBq;                 // 2 stages

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int kh = blockIdx.y;
  const long long b = blockIdx.z;
  const int k0 = blockIdx.x * kBk;
  const int G = p.H / p.KH, SG = p.S * G, off = p.T - p.S;
  const int k1 = min(k0 + kBk, p.T) - 1;
  // positions that see one of keys k0 .. k1: rows [f_begin, f_end)
  int i_lo = 0, i_hi = p.S - 1;
  if (p.causal) i_lo = max(0, k0 - off);
  if (p.window > 0) i_hi = min(i_hi, k1 + p.window - 1 - off);
  const int f_begin = i_lo * G;
  const int n_steps = i_lo <= i_hi ? ((i_hi + 1) * G - f_begin + kBq - 1) / kBq : 0;

  auto load_step = [&](int it) {   // rows of step it -> stage it & 1
    const int st = it & 1, f0 = f_begin + it * kBq;
    load_rows<D>(sQ + st * C::kTile, p.q, p.st[kQ], p.st[kQ + 1],
                 p.st[kQ + 2], b, kh, G, f0, SG);
    load_rows<D>(sDO + st * C::kTile, p.dout, p.st[kDO], p.st[kDO + 1],
                 p.st[kDO + 2], b, kh, G, f0, SG);
    load_row_stats(sLse + st * kBq, sDel + st * kBq, p, b, kh, G, f0, SG);
  };

  load_keys<D>(sK, p.k, p.st[kK], p.st[kK + 1], p.st[kK + 2], b, kh, k0, p.T);
  load_keys<D>(sV, p.v, p.st[kV], p.st[kV + 1], p.st[kV + 2], b, kh, k0, p.T);
  if (n_steps > 0) load_step(0);
  cp_commit();

  // this warp: keys km .. km + 15 of the block, column blocks
  // 8 (nb + 4 j) .. + 7 of D for j < M
  const int km = 16 * (warp & 1), nb = warp >> 1;
  float dk[M][4], dv[M][4];
#pragma unroll
  for (int j = 0; j < M; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;
  for (int it = 0; it < n_steps; ++it) {
    cp_wait_all();
    __syncthreads();          // step it landed; step it - 1 fully consumed
    if (it + 1 < n_steps) load_step(it + 1);   // overlaps this step
    cp_commit();
    const int st = it & 1;
    const float* q = sQ + st * C::kTile;
    const float* dO = sDO + st * C::kTile;
    score_step<D, kPLdKV>(q, dO, sK, sV, sLse + st * kBq, sDel + st * kBq,
                          sP, sDS, p, G, SG, f_begin + it * kBq, k0);
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q over the step's 32 rows, summed on
    // the tensor cores, then added to the running sums on the f32 pipes
    float tdk[M][4], tdv[M][4];
#pragma unroll
    for (int j = 0; j < M; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tdk[j][e] = tdv[j][e] = 0.0f;
#pragma unroll
    for (int kr = 0; kr < kBq; kr += 8) {
      unsigned ph[4], pl[4], sh[4], sl[4];
      frag_at(sP, kPLdKV, km, kr, ph, pl);
      frag_at(sDS, kPLdKV, km, kr, sh, sl);
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int n0 = 8 * (nb + 4 * j);
        unsigned bh0, bh1, bl0, bl1;
        frag_b_kn(dO, LD, kr, n0, bh0, bh1, bl0, bl1);
        mma3(tdv[j], ph, pl, bh0, bh1, bl0, bl1);
        frag_b_kn(q, LD, kr, n0, bh0, bh1, bl0, bl1);
        mma3(tdk[j], sh, sl, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int j = 0; j < M; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[j][e] += tdk[j][e];
        dv[j][e] += tdv[j][e];
      }
  }
  cp_wait_all();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + km + g + 8 * half;
    if (key >= p.T) continue;
    float* dkr = p.dk + b * p.st[kDK] + kh * p.st[kDK + 1] + key * p.st[kDK + 2];
    float* dvr = p.dv + b * p.st[kDV] + kh * p.st[kDV + 1] + key * p.st[kDV + 2];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int c = 8 * (nb + 4 * j) + 2 * t;
      *reinterpret_cast<float2*>(dkr + c) =
          make_float2(dk[j][2 * half], dk[j][2 * half + 1]);
      *reinterpret_cast<float2*>(dvr + c) =
          make_float2(dv[j][2 * half], dv[j][2 * half + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq(const Args p) {
  using C = Cfg<D>;
  constexpr int LD = D + 4, M = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sDO = sQ + C::kTile;
  float* sK = sDO + C::kTile;                   // 2 stages
  float* sV = sK + 2 * C::kTile;                // 2 stages
  float* sDS = sV + 2 * C::kTile;
  float* sLse = sDS + kBq * kPLdQ;
  float* sDel = sLse + kBq;

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int kh = blockIdx.y;
  const long long b = blockIdx.z;
  const int G = p.H / p.KH, SG = p.S * G, off = p.T - p.S;
  const int f0 = blockIdx.x * kBq;
  const int f_last = min(f0 + kBq, SG) - 1;
  // keys that one of rows f0 .. f_last sees: whole tiles from kt0
  int k_lo = 0, k_hi = p.T - 1;
  if (p.causal) k_hi = min(k_hi, f_last / G + off);
  if (p.window > 0) k_lo = max(0, f0 / G + off - p.window + 1);
  const int kt0 = (k_lo / kBk) * kBk;
  const int n_tiles = k_hi >= kt0 ? (k_hi - kt0) / kBk + 1 : 0;

  auto load_tile = [&](int it) {   // keys of tile it -> stage it & 1
    const int st = it & 1, kt = kt0 + it * kBk;
    load_keys<D>(sK + st * C::kTile, p.k, p.st[kK], p.st[kK + 1],
                 p.st[kK + 2], b, kh, kt, p.T);
    load_keys<D>(sV + st * C::kTile, p.v, p.st[kV], p.st[kV + 1],
                 p.st[kV + 2], b, kh, kt, p.T);
  };

  load_rows<D>(sQ, p.q, p.st[kQ], p.st[kQ + 1], p.st[kQ + 2], b, kh, G, f0, SG);
  load_rows<D>(sDO, p.dout, p.st[kDO], p.st[kDO + 1], p.st[kDO + 2], b, kh, G,
               f0, SG);
  load_row_stats(sLse, sDel, p, b, kh, G, f0, SG);
  if (n_tiles > 0) load_tile(0);
  cp_commit();

  // this warp: rows rm .. rm + 15 of the block, column blocks
  // 8 (nb + 4 j) .. + 7 of D for j < M
  const int rm = 16 * (warp & 1), nb = warp >> 1;
  float dq[M][4];
#pragma unroll
  for (int j = 0; j < M; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.0f;
  for (int it = 0; it < n_tiles; ++it) {
    cp_wait_all();
    __syncthreads();          // tile it landed; tile it - 1 fully consumed
    if (it + 1 < n_tiles) load_tile(it + 1);   // overlaps this tile
    cp_commit();
    const int st = it & 1;
    const float* k = sK + st * C::kTile;
    score_step<D, kPLdQ>(sQ, sDO, k, sV + st * C::kTile, sLse, sDel, nullptr,
                         sDS, p, G, SG, f0, kt0 + it * kBk);
    __syncthreads();
    // dQ += dS K over the tile's 32 keys, summed on the tensor cores, then
    // added to the running sum on the f32 pipes
    float tdq[M][4];
#pragma unroll
    for (int j = 0; j < M; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tdq[j][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < kBk; kc += 8) {
      unsigned sh[4], sl[4];
      frag_a(sDS, kPLdQ, rm, kc, sh, sl);
#pragma unroll
      for (int j = 0; j < M; ++j) {
        unsigned bh0, bh1, bl0, bl1;
        frag_b_kn(k, LD, kc, 8 * (nb + 4 * j), bh0, bh1, bl0, bl1);
        mma3(tdq[j], sh, sl, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int j = 0; j < M; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[j][e] += tdq[j][e];
  }
  cp_wait_all();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int f = f0 + rm + g + 8 * half;
    if (f >= SG) continue;
    const int pos = f / G, h = kh * G + (f - pos * G);
    float* dqr = p.dq + b * p.st[kDQ] + h * p.st[kDQ + 1] + pos * p.st[kDQ + 2];
#pragma unroll
    for (int j = 0; j < M; ++j)
      *reinterpret_cast<float2*>(dqr + 8 * (nb + 4 * j) + 2 * t) =
          make_float2(dq[j][2 * half], dq[j][2 * half + 1]);
  }
}

template <int D>
int launch_bwd(const Args& a, int B, cudaStream_t stream) {
  const int smem = static_cast<int>(Cfg<D>::kSmemBytes);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      attn_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(B) * a.H * a.S;
  const int per = kThreads / 32;
  attn_bwd_delta<<<static_cast<unsigned>((rows + per - 1) / per), kThreads, 0,
                   stream>>>(a, rows);
  const dim3 grid_kv(static_cast<unsigned>((a.T + kBk - 1) / kBk),
                     static_cast<unsigned>(a.KH), static_cast<unsigned>(B));
  attn_bwd_dkv<D><<<grid_kv, kThreads, smem, stream>>>(a);
  const long long sg = static_cast<long long>(a.S) * (a.H / a.KH);
  const dim3 grid_q(static_cast<unsigned>((sg + kBq - 1) / kBq),
                    static_cast<unsigned>(a.KH), static_cast<unsigned>(B));
  attn_bwd_dq<D><<<grid_q, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn_bwd
}  // namespace fedk

// q, out, dout, dq: (B, H, S, D); k, v, dk, dv: (B, Kh, T, D); all f32 on
// the device, addressed through `strides` (host array of 24: the (batch,
// head, position) element strides of q, k, v, out, dout, dq, dk, dv in that
// order); the head dim is contiguous and every row 16-byte aligned.  lse:
// (B, H, S) f32 contiguous, the forward's; delta: (B, H, S) f32 scratch.
// causal: 0 or 1; window <= 0 means none; cap <= 0 means none.  D is one of
// 32, 64, 128, 256.  Launches the delta pass, the dK/dV kernel and the dQ
// kernel on `stream` and returns cudaGetLastError().  Allocates nothing.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const long long* strides, int B, int H, int KH, int S, int T,
    int D, int causal, int window, float scale, float cap, int device,
    void* stream) {
  using namespace fedk::attn_bwd;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || S <= 0 || T <= 0 ||
      B > 65535 || KH > 65535 || (causal && S > T) ||
      static_cast<long long>(S) * (H / KH) > 2147483647LL - kBq ||
      static_cast<long long>(T) > 2147483647LL - kBk)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(out);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  for (int i = 0; i < 24; ++i) a.st[i] = strides[i];
  a.H = H; a.KH = KH; a.S = S; a.T = T; a.D = D;
  a.causal = causal; a.window = window; a.scale = scale; a.cap = cap;
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_bwd<32>(a, B, s);
    case 64: return launch_bwd<64>(a, B, s);
    case 128: return launch_bwd<128>(a, B, s);
    case 256: return launch_bwd<256>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
