// One-token paged decode attention (GQA) for the NVIDIA H100 (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/paged_attention.py::paged_attention.
//
//   o[b,h,g] = sum_j softmax_j(s_j) v[page(b,j), j % ps, h],
//   s_j = hd^-0.5 q[b,h,g] . k[page(b,j), j % ps, h],  page(b,j) = block_table[b, j / ps]
//
// over the positions j < min(lengths[b], nb * ps) of row b, with scores and
// sums in f32, the normaliser floored at 1e-30 and the output in q's type, as
// the TPU kernel does (a row of length 0 gets zeros, as there). q is
// (B, KV, G, hd); the page pools are (num_pages, ps, KV, hd), contiguous (a
// per-layer view pool[l] of the (L, num_pages, ps, KV, hd) cache is); q and
// the pools each take f32 or bf16, independently.
//
// What bounds it: bytes. Each kept position costs K and V rows of hd values
// for every KV head, 4*hd*G flops per head: at G = 8 that is 8 flops per byte
// of f32 pages, far below the ridge of even the CUDA cores (67 TFLOP/s against
// 3.35 TB/s is 20 per byte). At the decode cell (B = 8, KV = 4, G = 8, hd = 128,
// f32 pages, <= 129 positions a row) a call moves at most ~4.2 MB, ~1.3 us, so
// the launch costs more than the work; at 4096 positions a row it is ~67 MB
// (bf16 pages) or ~134 MB (f32).
//
// What the design does about it. The TPU grid (B, KV, nb) carried the online
// softmax state across its sequential page axis and skipped pages past the
// length with pl.when. Here one block of 8 warps owns one (b, kv head): it
// reads its own lengths[b] and block_table[b, :] (the TPU's scalar prefetch),
// and the page loop lives inside the block, running only to the row's last
// page, so it never reads past nb or past the length. The G query rows of the
// head share every K and V row the block reads: each page row is read once.
// Loads are 16 bytes a lane along hd (4 f32 or 8 bf16 values); a group of
// lanes covers one hd row, and a warp covers 32 / (lanes per row) positions at
// once. Every lane group keeps its own online softmax state (m, l, acc) in
// registers for all G rows and walks its own positions, so the loop has no
// block-wide barrier; the groups' states are merged once at the end (shuffles
// within a warp, then shared memory across warps). The math runs on the CUDA
// cores in f32: at one query token there is no tile for the tensor cores.
// Known limit, left to a later design: (B, KV) blocks (32 at the decode cell)
// fill a quarter of the card's 132 SMs; splitting a row's pages across blocks
// needs a second reduction pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 8;             // query heads per KV head held in registers
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The 16 / sizeof(T) values of one 16-byte load, as f32.
template <typename T, int V>
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[V]) {
  const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = to_f32(vals[i]);
}

template <typename TQ, typename TP, int HD>
__global__ void __launch_bounds__(kThreads, 1)
paged_attention_kernel(const TQ* __restrict__ q, const TP* __restrict__ k_pages,
                       const TP* __restrict__ v_pages, const int* __restrict__ block_table,
                       const int* __restrict__ lengths, TQ* __restrict__ out,
                       int KV, int G, int ps, int nb, float scale) {
  constexpr int V = 16 / sizeof(TP);         // page values per 16-byte load
  constexpr int NV = HD / V;                 // loads per hd row
  constexpr int LPR = pow2_at_least(NV);     // lanes per hd row (a lane group)
  constexpr int ROWS = 32 / LPR;             // positions a warp reads at once
  constexpr int CHUNK = 16 / V;              // positions a lane group takes per step
  static_assert(HD % V == 0 && NV <= 32, "hd rows must be whole 16-byte loads, <= 32 of them");

  __shared__ float acc_s[kWarps][kMaxG][HD];
  __shared__ float m_s[kWarps][kMaxG];
  __shared__ float l_s[kWarps][kMaxG];

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPR, sub = lane % LPR;
  const bool owns = sub < NV;                // lanes past the row's loads idle
  const int d0 = sub * V;

  const int length = lengths[b];
  const int cap = nb * ps;                   // never past the block table
  const int n = length < 0 ? 0 : (length < cap ? length : cap);

  const long long qrow = ((long long)b * KV + h) * G;
  float qf[kMaxG][V];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int t = 0; t < V; ++t)
      qf[g][t] = (g < G && owns) ? to_f32(q[(qrow + g) * HD + d0 + t]) * scale : 0.f;

  float m[kMaxG], l[kMaxG], acc[kMaxG][V];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int t = 0; t < V; ++t) acc[g][t] = 0.f;
  }

  const int* table = block_table + (long long)b * nb;
  const long long pos_stride = (long long)KV * HD;   // elements between page rows
  const long long head_off = (long long)h * HD + d0;
  const int step = kWarps * ROWS * CHUNK;
  // The loop bound is the warp's, so every lane of a warp runs the same trips
  // (the shuffles below need the whole warp); a group whose chunk lies past n
  // reads nothing and keeps its state.
  for (int wstart = warp * ROWS * CHUNK; wstart < n; wstart += step) {
    const int start = wstart + grp * CHUNK;
    uint4 kr[CHUNK], vr[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int pos = start + j;
      if (pos < n && owns) {
        const int page = __ldg(table + pos / ps);
        const long long e = ((long long)page * ps + pos % ps) * pos_stride + head_off;
        kr[j] = __ldg(reinterpret_cast<const uint4*>(k_pages + e));
        vr[j] = __ldg(reinterpret_cast<const uint4*>(v_pages + e));
      } else {
        kr[j] = make_uint4(0u, 0u, 0u, 0u);
        vr[j] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float s[CHUNK][kMaxG];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      float kf[V];
      unpack<TP, V>(kr[j], kf);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        float a = 0.f;
#pragma unroll
        for (int t = 0; t < V; ++t) a = fmaf(qf[g][t], kf[t], a);
        s[j][g] = a;
      }
    }
    // sum each score over the lanes of the group (offsets < LPR stay inside it)
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < CHUNK; ++j)
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) s[j][g] += __shfl_xor_sync(0xffffffffu, s[j][g], o);
    if (start < n) {
      float vf[CHUNK][V];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) unpack<TP, V>(vr[j], vf[j]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) continue;
        float mc = s[0][g];                  // position `start` is kept
#pragma unroll
        for (int j = 1; j < CHUNK; ++j)
          if (start + j < n) mc = fmaxf(mc, s[j][g]);
        const float mn = fmaxf(m[g], mc);
        const float alpha = __expf(m[g] - mn);
        float p[CHUNK], psum = 0.f;
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
          p[j] = start + j < n ? __expf(s[j][g] - mn) : 0.f;
          psum += p[j];
        }
        l[g] = fmaf(l[g], alpha, psum);
#pragma unroll
        for (int t = 0; t < V; ++t) {
          float a = acc[g][t] * alpha;
#pragma unroll
          for (int j = 0; j < CHUNK; ++j) a = fmaf(p[j], vf[j][t], a);
          acc[g][t] = a;
        }
        m[g] = mn;
      }
    }
  }

  // merge the warp's lane groups: lanes `o` apart hold the same hd slice
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) continue;
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float a = __expf(m[g] - mn), c = __expf(mo - mn);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int t = 0; t < V; ++t)
        acc[g][t] = acc[g][t] * a + __shfl_xor_sync(0xffffffffu, acc[g][t], o) * c;
      m[g] = mn;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) continue;
      if (owns) {
#pragma unroll
        for (int t = 0; t < V; ++t) acc_s[warp][g][d0 + t] = acc[g][t];
      }
      if (lane == 0) {
        m_s[warp][g] = m[g];
        l_s[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps and write
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = __expf(m_s[w][g] - mx);
      lsum = fmaf(l_s[w][g], c, lsum);
      o = fmaf(acc_s[w][g][d], c, o);
    }
    out[(qrow + g) * HD + d] = from_f32<TQ>(o / fmaxf(lsum, 1e-30f));
  }
}

template <typename TQ, typename TP, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages, const int* block_table,
           const int* lengths, void* out, int B, int KV, int G, int ps, int nb, float scale,
           cudaStream_t stream) {
  const dim3 grid((unsigned)KV, (unsigned)B);
  paged_attention_kernel<TQ, TP, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(k_pages),
      static_cast<const TP*>(v_pages), block_table, lengths, static_cast<TQ*>(out), KV, G,
      ps, nb, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TP>
int by_head_dim(int hd, const void* q, const void* k, const void* v, const int* bt,
                const int* len, void* out, int B, int KV, int G, int ps, int nb, float scale,
                cudaStream_t s) {
  switch (hd) {
    case 32: return launch<TQ, TP, 32>(q, k, v, bt, len, out, B, KV, G, ps, nb, scale, s);
    case 64: return launch<TQ, TP, 64>(q, k, v, bt, len, out, B, KV, G, ps, nb, scale, s);
    case 80: return launch<TQ, TP, 80>(q, k, v, bt, len, out, B, KV, G, ps, nb, scale, s);
    case 128: return launch<TQ, TP, 128>(q, k, v, bt, len, out, B, KV, G, ps, nb, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype, page_dtype: 0 = float32, 1 = bfloat16. All tensors contiguous;
// block_table (B, nb) and lengths (B,) int32 on the device. Returns
// cudaGetLastError() after the launch.
extern "C" int paged_attention_fwd(int q_dtype, int page_dtype, int hd, const void* q,
                                   const void* k_pages, const void* v_pages,
                                   const int* block_table, const int* lengths, void* out,
                                   int B, int KV, int G, int ps, int nb, float scale,
                                   void* stream) {
  if (B < 1 || B > 65535 || KV < 1 || G < 1 || G > kMaxG || ps < 1 || nb < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && page_dtype == 0)
    return by_head_dim<float, float>(hd, q, k_pages, v_pages, block_table, lengths, out, B,
                                     KV, G, ps, nb, scale, s);
  if (q_dtype == 0 && page_dtype == 1)
    return by_head_dim<float, __nv_bfloat16>(hd, q, k_pages, v_pages, block_table, lengths,
                                             out, B, KV, G, ps, nb, scale, s);
  if (q_dtype == 1 && page_dtype == 0)
    return by_head_dim<__nv_bfloat16, float>(hd, q, k_pages, v_pages, block_table, lengths,
                                             out, B, KV, G, ps, nb, scale, s);
  if (q_dtype == 1 && page_dtype == 1)
    return by_head_dim<__nv_bfloat16, __nv_bfloat16>(hd, q, k_pages, v_pages, block_table,
                                                     lengths, out, B, KV, G, ps, nb, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
