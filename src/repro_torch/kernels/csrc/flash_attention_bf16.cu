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
// tensor-core peak), 0.020 ms at 3.35 TB/s.  This kernel runs P V twice (P
// = hi + lo, below), 6 D flops a pair, so 0.208 ms is its own floor.
// Measured (chip_smoke.py phase 2e, NVIDIA H100 80GB HBM3, 700.00 W): 0.687
// ms there (20.2% of the 4 D bound), 15.85 ms on a 32k-token prefill.
//
// The design (warp-specialised, as attn_bf16.cuh sets out):
//
//  * A block owns 128 consecutive (position, group head) rows of one (b, kv
//    head), 64 for each of its two consumer warpgroups, so every K/V tile it
//    loads serves all heads of the group and no repeated K/V is ever made
//    (GQA without copies).  Blocks start from the last rows, which see the
//    most keys; tiles outside the causal frontier or the window are never
//    visited.
//  * One producer thread (thread 0) brings 64-key K and V tiles by TMA,
//    straight from k and v through their strides (two 4-d tensor maps
//    built per call; keys past T are zero-filled), into a ring of NR >= 3
//    slots (5 at D = 256, 8 below) on full and empty mbarriers: K_j and V_j
//    are loads 2j and 2j + 1, topped up at the start of warpgroup 0's every
//    step.  No thread computes an address of a copy.
//  * Products: Q K^T one bf16 wgmma chain (m64n64k16, Q and K from shared
//    memory, K-major); P V two (P split once in registers, P = P_hi + P_lo
//    with P_hi = bf16(P) and P_lo = bf16(P - P_hi), m64nDk16 with P from
//    registers and V MN-major as it lies), so the product errs by ~2^-17 of
//    |P| |V| and kernel and plain version differ by at most the final
//    rounding: within 2 bf16 ulps plus 1e-3 of the row's max-abs element by
//    element, as the card check holds it.  The accumulator layout of Q K^T
//    is the A-fragment layout of P V, so P never leaves registers.
//  * Overlap inside a warpgroup: step j issues S_j = Q K_j^T and then
//    O += P_{j-1} V_{j-1} back to back, waits for S_j alone (wgmma
//    wait_group 1) and runs the softmax of tile j while P V still runs.
//  * Overlap between the warpgroups ("ping-pong"): the issue sections of the
//    two take turns on two named barriers, so one's softmax runs while the
//    other's products run.
//  * Softmax in the log2 domain: exp2 on the SFU with log2(e) folded into
//    the scale, the cap's tanh from exp2 (tanh y = 1 - 2 / (e^{2y} + 1)),
//    and the mask tested only on tiles that are not wholly live.
//  * The P V sums stay in the tensor cores over the whole walk (scaled by
//    the online softmax's alpha on the f32 pipes every tile).  Their
//    truncating f32 accumulation loses at most 2^-23 of the running sum a
//    k-step: under 2.5e-4 relative after the 2,048 k-steps of a 32,768-key
//    walk, an eighth of bf16's half ulp at the store.
//  * Shared memory: Q (128 x D, 64 KB at D = 256, written by the consumers
//    with cp.async in the swizzled layout) and the ring, plus 1 KB to align
//    it and the barriers: 229,376 B at D = 256 (5 slots of 32 KB), 163,840
//    at 128, 81,920 at 64, 40,960 at 32 (8 slots).
//  * Ragged S and T: rows past S G are never stored; keys past T are zero
//    and masked.
//
// For training the kernel also writes each row's log-sum-exp, lse = m +
// log(max(l, 1e-30)) as (B, H, S) f32, which flash_attention_bwd_bf16.cu
// reads; a null lse pointer (serving) writes nothing.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <type_traits>

#include "attn_bf16.cuh"

namespace fedk {
namespace fa16 {

using namespace b16;

constexpr int kThreads = 256;       // two consumer warpgroups
constexpr int kRows = 128;          // rows of a block, 64 a consumer warpgroup
constexpr int kBk = 64;             // keys of a tile
constexpr int kSmemCap = 232448;    // the most a block may ask for
constexpr float kNegInf = -1e30f;
constexpr int kBarTurn = 1;         // ids 1, 2: warpgroup 0's, 1's turn to issue
constexpr int kBarQ = 3;            // ids 3, 4: a warpgroup's Q rows have landed

template <int D>
struct Cfg {
  static constexpr int CW = D < 64 ? D : 64;       // columns of a chunk
  static constexpr int SW = 2 * CW;                // its row bytes
  static constexpr int NCH = D / CW;               // chunks
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kSlot = kBk * D * 2;        // one K or V tile
  static constexpr int NR0 = (kSmemCap - 1024 - kQBytes - 256) / kSlot;
  static constexpr int NR = NR0 > 8 ? 8 : NR0;     // ring slots
  static_assert(NR >= 3, "three ring slots must fit");
  static constexpr size_t kSmem =
      1024 + static_cast<size_t>(kQBytes) + static_cast<size_t>(NR) * kSlot + 16 * NR;
};

struct Args {
  CUtensorMap kmap, vmap;            // k, v as (D, T, Kh, B) boxes of (CW, 64)
  const __nv_bfloat16* q;
  __nv_bfloat16* out;
  float* lse;                        // (B, H, S) contiguous, or null
  long long q_sb, q_sh, q_ss;
  long long o_sb, o_sh, o_ss;
  int H, KH, S, T, causal, window;
  float scale, cap;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bf16_kernel(const __grid_constant__ Args p) {
  using C = Cfg<D>;
  constexpr int CW = C::CW, SW = C::SW, NR = C::NR;
  constexpr int CH = D / 8;            // 16-byte pieces of a row
  extern __shared__ __align__(128) uint8_t sm_raw[];
  uint8_t* sm = sm_raw + ((1024 - (smem_u32(sm_raw) & 1023)) & 1023);
  uint8_t* sQ = sm;                    // chunk c: 128 rows of SW bytes
  uint8_t* slots = sm + C::kQBytes;    // slot s: NCH chunks of 64 rows
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + NR * C::kSlot);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;             // rows 64 wg .. of the block
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
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
  const int t_lo = k_lo / kBk;
  const int n = k_hi < k_lo ? 0 : k_hi / kBk - t_lo + 1;

  // K_j and V_j are loads 2j and 2j + 1 of the ring, thread 0 the producer
  Ring<NR> ring{bars, bars + NR, 2 * n, 0};
  auto issue = [&](int ld, int slot) {
    mbar_expect(ring.full + slot, C::kSlot);
    const void* map = (ld & 1) ? &p.vmap : &p.kmap;
    const int key = (t_lo + (ld >> 1)) * kBk;
    uint8_t* dst = slots + slot * C::kSlot;
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
      tma_load_4d(dst + c * kBk * SW, map, c * CW, key, kh, b, ring.full + slot);
  };
  if (tid == 0) {
    ring.init();
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) ring.top_up(-1, issue);

  const int wt = tid & 127;
  const int warp = wt >> 5;            // rows 16 warp .. of the warpgroup
  const int lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;

  // ---- this warpgroup's 64 Q rows, swizzled (zero past S G) ---------------
  for (int i = wt; i < 64 * CH; i += 128) {
    const int r = i / CH, c8 = i - r * CH;
    const int row = 64 * wg + r;
    const int f = f0 + row;
    const __nv_bfloat16* src = p.q;
    int bytes = 0;
    if (f < SG) {
      const int pos = f / G, h = kh * G + (f - pos * G);
      src = p.q + b * p.q_sb + h * p.q_sh + pos * p.q_ss + c8 * 8;
      bytes = 16;
    }
    const int u = c8 % (CW / 8);
    const int sw = SW == 128 ? (row & 7) : ((row >> 1) & 3);
    cp16(sQ + (c8 / (CW / 8)) * (kRows * SW) + row * SW + ((u ^ sw) << 4), src, bytes);
  }
  cp_commit();
  cp_wait<0>();
  fence_async_smem();
  bar_sync(kBarQ + wg, 128);

  // this thread's rows g and g + 8 of its warp: key positions, running max
  // (log2 domain), partial sums over its own columns, output fragments
  const int r0 = f0 + wg * 64 + warp * 16 + g;
  const int qk0 = r0 / G + off;
  const int qk1 = (r0 + 8) / G + off;
  // the warpgroup's rows, for the wholly-live test of a tile
  const int ra = f0 + 64 * wg, rz = min(ra + 63, SG - 1);
  const int qa = ra / G + off, qz = rz / G + off;
  const bool rows_ok = ra < SG;
  const bool capped = p.cap > 0.0f;
  const float c_scale = p.scale * kLog2e;                 // no cap
  const float c_in = 2.0f * kLog2e * p.scale / p.cap;     // cap: e^{2y}
  const float c_out = p.cap * kLog2e;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  float al0 = 1.0f, al1 = 1.0f;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  pin(o);
  float s[kBk / 2];
  uint32_t ph[kBk / 16][4], pl[kBk / 16][4];
  const uint8_t* qw = sQ + 64 * wg * SW;

  // Phase j issues S_j (j < n) and P_{j-1} V_{j-1} (j > 0), the first and
  // the last peeled so that no product is issued under a runtime test.
  auto issue_s = [&](int j) {
    ring.wait(2 * j);
    const uint8_t* sk = slots + ((2 * j) % NR) * C::kSlot;
    const uint64_t qd = opaque(desc_sw(qw, 16, 8 * SW, SW));
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int c = ks / (CW / 16), w = (ks % (CW / 16)) * 32;
      wgmma_ss<kBk, 0, 0>(s, qd + ((c * kRows * SW + w) >> 4),
                          desc_sw(sk + c * kBk * SW + w, 16, 8 * SW, SW), ks > 0);
    }
    wg_commit();
  };
  auto issue_pv = [&](int j) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? al1 : al0;
    pin(o);
    ring.wait(2 * j - 1);
    const uint8_t* sv = slots + ((2 * j - 1) % NR) * C::kSlot;
    wg_fence();
#pragma unroll
    for (int jj = 0; jj < kBk / 16; ++jj) {
      const uint64_t dv = desc_sw(sv + jj * 16 * SW, kBk * SW, 8 * SW, SW);
      wgmma_rs<D, 1>(o, pl[jj], dv, 1);
      wgmma_rs<D, 1>(o, ph[jj], dv, 1);
    }
    wg_commit();
  };
  auto pv_done = [&](int j) {
    wg_wait<0>();
    pin(o);
    ring.release(2 * j - 1);
  };
  auto phase = [&](int j, auto has_s_c, auto has_pv_c) {
    constexpr bool has_s = decltype(has_s_c)::value;
    constexpr bool has_pv = decltype(has_pv_c)::value;
    bar_sync(kBarTurn + wg, 256);
    if (tid == 0) ring.top_up(has_s ? 2 * j : 2 * j - 1, issue);
    if constexpr (has_s) issue_s(j);
    if constexpr (has_pv) issue_pv(j);
    if (wg == 0 || has_s) bar_arrive(kBarTurn + 1 - wg, 256);

    if constexpr (has_s) {
      if constexpr (has_pv) wg_wait<1>();
      else wg_wait<0>();
      pin(s);
      ring.release(2 * j);
      // ---- scale, cap, mask; online softmax (log2 domain) ------------------
      // s[4n + 0, 1]: row g, keys 8n + 2tq, +1; s[4n + 2, 3]: row g + 8
      const int kt = (t_lo + j) * kBk;
      const bool live_all = rows_ok && kt + kBk - 1 < p.T &&
                            (!p.causal || kt + kBk - 1 <= qa) &&
                            (p.window <= 0 || kt > qz - p.window);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int e = 0; e < kBk / 2; ++e) {
        float x;
        if (capped) {
          const float th = 1.0f - __fdividef(2.0f, ex2(s[e] * c_in) + 1.0f);
          x = th * c_out;
        } else {
          x = s[e] * c_scale;
        }
        if (!live_all) {
          const int key = kt + (e >> 2) * 8 + 2 * tq + (e & 1);
          const int qk = (e & 2) ? qk1 : qk0;
          bool live = key < p.T;
          if (p.causal) live = live && key <= qk;
          if (p.window > 0) live = live && key > qk - p.window;
          x = live ? x : kNegInf;
        }
        s[e] = x;
        if (e & 2) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      al0 = ex2(m0 - mn0);
      al1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int e = 0; e < kBk / 2; ++e) {
        s[e] = ex2(s[e] - ((e & 2) ? mn1 : mn0));
        if (e & 2) ps1 += s[e];
        else ps0 += s[e];
      }
      l0 = l0 * al0 + ps0;             // this thread's columns only
      l1 = l1 * al1 + ps1;
    }
    if constexpr (has_pv) pv_done(j);
    if constexpr (has_s) {
      // P = P_hi + P_lo for the next phase's P V.  k-step jj covers keys
      // 16jj .. 16jj+15: its A fragment is s[8jj .. 8jj + 7] in order (rows
      // g, g + 8; keys 2t, 2t + 1, then + 8)
#pragma unroll
      for (int jj = 0; jj < kBk / 16; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[8 * jj + 2 * e], y = s[8 * jj + 2 * e + 1];
          ph[jj][e] = pack_bf16(x, y);
          pl[jj][e] = pack_bf16(x - bf16_lo(ph[jj][e]), y - bf16_hi(ph[jj][e]));
        }
        pin(ph[jj]);
        pin(pl[jj]);
      }
    }
  };
  if (n > 0) {
    if (wg == 1) bar_arrive(kBarTurn, 256);        // warpgroup 0 issues first
    phase(0, std::true_type{}, std::false_type{});
    for (int j = 1; j < n; ++j) phase(j, std::true_type{}, std::true_type{});
    phase(n, std::false_type{}, std::true_type{});
  }

  // ---- normalise and store: o[4n + e] is row g (e < 2) or g + 8, column
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
    for (int nn = 0; nn < D / 8; ++nn)
      *reinterpret_cast<uint32_t*>(dst + nn * 8) =
          pack_bf16(o[4 * nn + 2 * half] / den, o[4 * nn + 2 * half + 1] / den);
    if (p.lse != nullptr && tq == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.S + pos] =
          ((half ? m1 : m0) + __log2f(den)) * 0.6931471805599453f;
  }
}

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  auto kernel = flash_attention_bf16_kernel<D>;
  const size_t smem = Cfg<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(a.S) * (a.H / a.KH);
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows),
                  static_cast<unsigned>(a.KH), static_cast<unsigned>(B));
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the driver's cuTensorMapEncodeTiled, from the libcuda the process has
// loaded (the runtime API has no stable way to it)
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave,
                              CUtensorMapSwizzle, CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

inline EncodeFn encode_fn() {
  static const EncodeFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : reinterpret_cast<EncodeFn>(dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// x (B, Kh, T, D) through its element strides, as TMA boxes of (CW, 64)
// in the swizzled layout; keys past T read as zeros
inline bool key_map(CUtensorMap* map, const void* x, int B, int KH, int T, int D,
                    long long sb, long long sh, long long st) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const int cw = D < 64 ? D : 64;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(KH), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cw), kBk, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
      B > 65535 || KH > 65535 || (causal && S > T) ||
      static_cast<long long>(S) * (H / KH) > 2147483647LL - kRows ||
      (D != 32 && D != 64 && D != 128 && D != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  if (!key_map(&a.kmap, k, B, KH, T, D, k_sb, k_sh, k_st) ||
      !key_map(&a.vmap, v, B, KH, T, D, v_sb, v_sh, v_st))
    return static_cast<int>(cudaErrorInvalidValue);
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse = static_cast<float*>(lse);
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.o_sb = o_sb; a.o_sh = o_sh; a.o_ss = o_ss;
  a.H = H; a.KH = KH; a.S = S; a.T = T; a.causal = causal; a.window = window;
  a.scale = scale; a.cap = cap;
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(a, B, s);
    case 64: return launch<64>(a, B, s);
    case 128: return launch<128>(a, B, s);
    default: return launch<256>(a, B, s);
  }
}
