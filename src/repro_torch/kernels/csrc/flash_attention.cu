// flash_attention for Hopper (sm_90a): causal / sliding-window GQA attention
// with an optional tanh soft-cap, online softmax in f32.
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
// need 206 GFLOP against 0.29 GB of inputs and output, far above the
// card's balance point, and the inputs are f32, so the rate to beat is the
// f32 rate outside the tensor cores.  (TF32 tensor cores would not hold the
// reference's tolerance.)  The design:
//
//  * GQA without copies.  A block owns ROWS = 64 consecutive (position,
//    group head) rows of one (b, kv head): row f is position f / G, head
//    kh * G + f % G.  With MQA a block is 4 positions x 16 heads, so every
//    K/V tile it loads from memory serves all 16 heads, and its live key
//    range is only 3 keys wider than one row's.
//  * Tile skipping.  The block visits only the kv tiles between the first
//    key its earliest row can see (window) and the last key its latest row
//    can see (causal): at S = 4096 and window 2048 about half of all tiles.
//  * Layout through strides.  q, k, v and out are read and written through
//    their (b, head, position) strides with the head dim contiguous, so the
//    model's (B, S, H, D) tensors need no transposing copy.
//  * Shared memory: the Q tile (64 x D), a K tile (64 x (D + 4), padded so
//    that lanes reading different keys hit different banks), a V tile
//    (64 x D) and the probabilities (64 x 64): 209 KB at D = 256, dynamic
//    shared memory above the 48 KB static limit, one block per SM.
//  * Registers: warp w owns rows 8w..8w+7 in both products.  For Q K^T a
//    lane computes 8 rows x 2 keys (keys lane and lane + 32) with float4
//    loads along D (Q rows broadcast to the warp); for P V it owns columns
//    lane + 32 j, so its accumulator is 8 x D/32 floats (64 at D = 256).
//    The row max and sum are warp shuffles; m and l live in registers.
//  * Ragged S and T: rows past S*G are zero and never stored; keys past T
//    are zero and masked, so any length works.
//
// A row whose first visited tile is all masked gets p = exp(0) = 1 there,
// which the next tile's alpha = exp(-1e30 - m) = 0 wipes out, as on the
// TPU; every row has a live key because the wrapper refuses causal S > T.

#include <cuda_runtime.h>

namespace fedk {

constexpr int kRows = 64;        // query rows of a block
constexpr int kBK = 64;          // keys of a kv tile
constexpr int kAttnThreads = 256;
constexpr int kRowsPerWarp = 8;
constexpr int kKPad = 4;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t attn_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kRows) * D        // Q
                          + static_cast<size_t>(kBK) * (D + kKPad)  // K
                          + static_cast<size_t>(kBK) * D        // V
                          + static_cast<size_t>(kRows) * kBK);  // P
}

struct AttnArgs {
  const float* q; const float* k; const float* v; float* out;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_ss;
  int H, KH, S, T, causal, window;
  float scale, cap;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kAttnThreads, 1)
flash_attention_kernel(const AttnArgs p) {
  constexpr int D4 = D / 4;
  constexpr int KS = D + kKPad;        // padded K row stride
  constexpr int NC = D / 32;           // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kRows * D;
  float* sV = sK + kBK * KS;
  float* sP = sV + kBK * D;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kh = blockIdx.y;
  const long long b = blockIdx.z;
  const int G = p.H / p.KH;
  const int SG = p.S * G;
  const int f0 = blockIdx.x * kRows;
  const int f_last = min(f0 + kRows, SG) - 1;
  const int off = p.T - p.S;

  // ---- the Q tile ----------------------------------------------------------
  for (int i = tid; i < kRows * D4; i += kAttnThreads) {
    const int r = i / D4, c = (i - r * D4) * 4;
    const int f = f0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (f < SG) {
      const int pos = f / G, h = kh * G + (f - pos * G);
      val = __ldg(reinterpret_cast<const float4*>(
          p.q + b * p.q_sb + h * p.q_sh + pos * p.q_ss + c));
    }
    *reinterpret_cast<float4*>(sQ + r * D + c) = val;
  }

  // ---- the live key range of this block ------------------------------------
  const int s_lo = f0 / G, s_hi = f_last / G;
  int k_lo = 0, k_hi = p.T - 1;
  if (p.causal) k_hi = min(k_hi, s_hi + off);
  if (p.window > 0) k_lo = max(0, s_lo + off - p.window + 1);

  // this warp's rows: their positions, running max and sum
  int row_pos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp];
  float acc[kRowsPerWarp][NC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    row_pos[i] = (f0 + warp * kRowsPerWarp + i) / G;
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;
  }
  const float* kbase = p.k + b * p.k_sb + kh * p.k_sh;
  const float* vbase = p.v + b * p.v_sb + kh * p.v_sh;
  float* prow = sP + warp * kRowsPerWarp * kBK;

  for (int kt = k_lo; kt <= k_hi; kt += kBK) {
    __syncthreads();                       // the previous tile is consumed
    for (int i = tid; i < kBK * D4; i += kAttnThreads) {
      const int j = i / D4, c = (i - j * D4) * 4;
      const int key = kt + j;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key < p.T) {
        kv = __ldg(reinterpret_cast<const float4*>(kbase + key * p.k_st + c));
        vv = __ldg(reinterpret_cast<const float4*>(vbase + key * p.v_st + c));
      }
      *reinterpret_cast<float4*>(sK + j * KS + c) = kv;
      *reinterpret_cast<float4*>(sV + j * D + c) = vv;
    }
    __syncthreads();

    // ---- scores: 8 rows x keys (lane, lane + 32) ---------------------------
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.0f;
    const float* q_rows = sQ + warp * kRowsPerWarp * D;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 k0 = *reinterpret_cast<const float4*>(sK + lane * KS + d);
      const float4 k1 = *reinterpret_cast<const float4*>(sK + (lane + 32) * KS + d);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(q_rows + i * D + d);
        s[i][0] = fmaf(qv.x, k0.x, s[i][0]);
        s[i][0] = fmaf(qv.y, k0.y, s[i][0]);
        s[i][0] = fmaf(qv.z, k0.z, s[i][0]);
        s[i][0] = fmaf(qv.w, k0.w, s[i][0]);
        s[i][1] = fmaf(qv.x, k1.x, s[i][1]);
        s[i][1] = fmaf(qv.y, k1.y, s[i][1]);
        s[i][1] = fmaf(qv.z, k1.z, s[i][1]);
        s[i][1] = fmaf(qv.w, k1.w, s[i][1]);
      }
    }

    // ---- scale, cap, mask; online softmax ------------------------------------
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int qk = row_pos[i] + off;    // this row's key position
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = kt + lane + 32 * c;
        float x = s[i][c] * p.scale;
        if (p.cap > 0.0f) x = p.cap * tanhf(x / p.cap);
        bool live = key < p.T;
        if (p.causal) live = live && key <= qk;
        if (p.window > 0) live = live && key > qk - p.window;
        s[i][c] = live ? x : kNegInf;
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s[i][0], s[i][1])));
      const float alpha = expf(m[i] - m_new);
      const float p0 = expf(s[i][0] - m_new);
      const float p1 = expf(s[i][1] - m_new);
      l[i] = l[i] * alpha + warp_sum(p0 + p1);
      m[i] = m_new;
      prow[i * kBK + lane] = p0;
      prow[i * kBK + lane + 32] = p1;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();

    // ---- acc += P V: 8 rows x columns lane + 32 j ------------------------------
#pragma unroll 1
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        pv[i] = *reinterpret_cast<const float4*>(prow + i * kBK + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) vv[j] = sV[(kk + u) * D + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float pi = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pi, vv[j], acc[i][j]);
        }
      }
    }
  }

  // ---- normalise and store ---------------------------------------------------
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int f = f0 + warp * kRowsPerWarp + i;
    if (f >= SG) continue;
    const int h = kh * G + (f - row_pos[i] * G);
    float* dst = p.out + b * p.o_sb + h * p.o_sh + row_pos[i] * p.o_ss;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) dst[lane + 32 * j] = acc[i][j] / den;
  }
}

template <int D>
int launch_flash(const AttnArgs& a, int B, cudaStream_t stream) {
  const size_t smem = attn_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = a.H / a.KH;
  const long long rows = static_cast<long long>(a.S) * G;
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows),
                  static_cast<unsigned>(a.KH), static_cast<unsigned>(B));
  flash_attention_kernel<D><<<grid, kAttnThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fedk

// q: (B, H, S, D), k, v: (B, Kh, T, D), out: (B, H, S, D), all f32 on the
// device, addressed through the given element strides (batch, head,
// position); the head dim is contiguous and every row 16-byte aligned.
// causal: 0 or 1; window <= 0 means none; cap <= 0 means none.  D is one of
// 32, 64, 128, 256.  Launches on `stream` and returns cudaGetLastError().
// Allocates nothing.
extern "C" int flash_attention_f32(
    const void* q, const void* k, const void* v, void* out,
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
             q_sb, q_sh, q_ss, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
             o_sb, o_sh, o_ss, H, KH, S, T, causal, window, scale, cap};
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_flash<32>(a, B, s);
    case 64: return launch_flash<64>(a, B, s);
    case 128: return launch_flash<128>(a, B, s);
    case 256: return launch_flash<256>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
