// Chunked gated linear recurrence (RWKV6's wkv, Mamba2's SSD) for the NVIDIA
// H100 (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gla_scan/gla_scan.py::gla_scan.
// Per batch row b and head h, over positions t < L:
//
//   S_t = diag(exp(ld_t)) S_{t-1} + k_t v_t^T                 S in (dk, dv), f32
//   o_t = q_t^T S_t (inclusive)   or   q_t^T S_{t-1} (exclusive)
//
// and the final state S_{L-1}, starting from s0 (or zeros). Per chunk of c
// positions, with cum the within-chunk prefix sum of ld over t and cum_q =
// cum (inclusive) or cum - ld (exclusive), it computes what the reference's
// chunked form computes:
//
//   o      = (q * e^{cum_q}) S + scores v,
//   scores[t, s] = sum_d q[t,d] k[s,d] e^{min(cum_q[t,d] - cum[s,d], 0)}   (s <= t, or s < t)
//   S     <- e^{cum_end} * S + (k * e^{cum_end - cum})^T v
//
// Every exponent it evaluates is <= 0 when ld <= 0, so strong decay cannot
// overflow: e^{cum_q[t]} and e^{-cum[s]} are never formed apart. A ragged
// last chunk reads positions >= L as q = k = v = 0 and ld = 0 (the state is
// unchanged by them) and writes nothing past L. o takes v's type; the state
// is f32. Inputs are read through their (b, l, h, d) strides, so the model's
// (B, L, H, d) views of (B, L, d) products go in without a copy, and a stride
// of 0 on d broadcasts one decay per head. One block owns one (b, h) and
// walks its chunks in order (Hopper blocks run in no order, so the state
// cannot cross blocks as it crossed the TPU kernel's sequential grid axis).
//
// Two kernels, selected by type and shape, never after a failure
// (gla_scan_uses_mma):
//
// * gla_scan_mma_kernel: bf16 q, k, v with dk and dv multiples of 16 up to
//   128 and a chunk of 16, 32 or 64 (every ported model's path).
// * gla_scan_kernel: everything else (f32 q, k, v; other sizes), on the CUDA
//   cores.
//
// What bounds it. The work of a chunk of 64 at dk = dv = 64 is ~0.8 M
// multiply-adds of matrix products and, in the score cube, ~65 K
// per-channel exponentials, against ~40 KB of input: as products on the
// tensor cores the function is bound by bytes (205.5 MB at the rwkv6-7b
// shape, 0.061 ms at 3.35 TB/s). The CUDA-core kernel instead reads every
// operand of every multiply-add from shared memory, so shared-memory
// bandwidth bounds it (~56 K wavefronts a chunk; 1.52 ms at that shape).
// The tensor-core kernel sits at ~4x the byte bound: each (b, h) is a chain
// of short phases, chunk after chunk, on two blocks an SM (PERF.md).
//
// What the design does about it (gla_scan_mma_kernel, 8 warps; dk is a
// template argument, so its loops unroll):
//
// * Sub-chunks of 16. Query sub-chunk i's score blocks against earlier key
//   sub-chunks j < i are one matrix product about the reference point
//   r_i = cum at the last row of sub-chunk i - 1:
//     scores_ij = (q_i * e^{cum_q - r_i}) (k_j * e^{r_i - cum_j})^T,
//   both exponents <= 0 (ld <= 0, as the reference assumes). The 16 x 16
//   diagonal blocks are cut once more into 8-row halves: the lower-left
//   8 x 8 block is the same product about cum at the 8th row (f32, CUDA
//   cores), and only the two 8 x 8 triangles keep the per-channel clamped
//   exponential, masked by mode: ~2.2x fewer exponentials than whole 16 x 16
//   blocks, ~9x fewer than the whole cube.
// * Every other matrix product is mma.sync.m16n8k16 bf16 with f32
//   accumulation: the off-diagonal score blocks (one 8-key tile a unit,
//   spread over all warps), P v and (q * e^{cum_q}) S (warps 2i and 2i+1 for
//   sub-chunk i, alternating 16-column blocks of dv), and the state update
//   (k * e^{cum_end - cum})^T v (16 x 16 blocks of S spread over the warps).
//   An operand that is not an input as given (the scaled q and k, P, S) goes
//   in as a bf16 high part plus a bf16 low part (x - hi), two or three
//   products, so each carries ~16 bits: one bf16 rounding (~2^-9) of
//   q e^{cum_q} and S alone errs by ~0.2 on outputs of ~100, against the
//   f64-oracle limit 0.4 + 0.02 |o|, and the state's rounding would compound
//   across chunks. The state stays f32 in shared memory and is accumulated
//   in f32.
// * Scores meet in shared memory (f32) and are read back as P's A fragments
//   in mma.sync's accumulator layout; v, k scaled (the state update's A) and
//   the scaled q come through ldmatrix (.trans where the reduction dim runs
//   across rows).
// * Exponentials are ex2.approx of log2-scaled cumulative decays; the
//   prefix sum runs over segments of rows in parallel.
// * Staging: q, k, v (bf16) and ld as given, by 16-byte cp.async where the
//   innermost stride is 1 and the rows are 16-byte aligned, element by
//   element through the strides otherwise. ~97 KB of shared memory at
//   c = 64, dk = dv = 64 and at most 128 registers: two blocks an SM.
//
// gla_scan_kernel (the CUDA-core path): each chunk's q, k, v and ld are
// staged as f32, q, k and the cumulative decays in rows padded to dk + 1
// floats; the score cube, the intra- and cross-chunk products and the state
// update run as f32 FMAs with every operand read from shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element strides (b, l, h, d) of q, k, v and ld, in that order.
struct Strides {
  long long s[16];
};

template <typename T, typename TL>
__global__ void __launch_bounds__(kThreads)
gla_scan_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const TL* __restrict__ ld, const float* __restrict__ s0, T* __restrict__ out,
                float* __restrict__ state, Strides st, int L, int H, int dk, int dv, int c,
                int inclusive) {
  extern __shared__ float smem[];
  const int ldk = dk + 1;                      // padded row of q, k, cum
  float* q_s = smem;                           // (c, ldk): q, then q * e^{cum_q}
  float* k_s = q_s + c * ldk;                  // (c, ldk): k, then k * e^{cum_end - cum}
  float* cz = k_s + c * ldk;                   // (c + 1, ldk): row 0 zeros, row t+1 = cum[t]
  float* v_s = cz + (c + 1) * ldk;             // (c, dv)
  float* sc = v_s + c * dv;                    // (c, c) scores
  float* S = sc + c * c;                       // (dk, dv) carried state

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const long long* s = st.s;
  const T* qb = q + b * s[0] + h * s[2];
  const T* kb = k + b * s[4] + h * s[6];
  const T* vb = v + b * s[8] + h * s[10];
  const TL* lb = ld + b * s[12] + h * s[14];
  const long long sh = (long long)(b * H + h) * dk * dv;

  for (int i = tid; i < dk * dv; i += kThreads) S[i] = s0 ? s0[sh + i] : 0.f;
  for (int d = tid; d < dk; d += kThreads) cz[d] = 0.f;

  const int n_chunks = (L + c - 1) / c;
  for (int ic = 0; ic < n_chunks; ++ic) {
    const int l0 = ic * c;
    const int n = L - l0 < c ? L - l0 : c;     // valid rows of this chunk

    // 1. stage the chunk as f32; rows past L read as zeros
    for (int i = tid; i < c * dk; i += kThreads) {
      const int t = i / dk, d = i % dk;
      const bool in = t < n;
      const long long l = l0 + t;
      q_s[t * ldk + d] = in ? to_f32(qb[l * s[1] + d * s[3]]) : 0.f;
      k_s[t * ldk + d] = in ? to_f32(kb[l * s[5] + d * s[7]]) : 0.f;
      cz[(t + 1) * ldk + d] = in ? to_f32(lb[l * s[13] + d * s[15]]) : 0.f;
    }
    for (int i = tid; i < c * dv; i += kThreads) {
      const int t = i / dv, j = i % dv;
      v_s[i] = t < n ? to_f32(vb[(l0 + t) * s[9] + j * s[11]]) : 0.f;
    }
    __syncthreads();

    // 2. cum: prefix sum of ld over t, one column per thread
    for (int d = tid; d < dk; d += kThreads) {
      float run = 0.f;
      for (int t = 1; t <= c; ++t) {
        run += cz[t * ldk + d];
        cz[t * ldk + d] = run;
      }
    }
    __syncthreads();

    // 3. scores[t, s] = sum_d q[t,d] k[s,d] e^{min(cum_q[t,d] - cum[s,d], 0)} under the mask
    const int qrow = inclusive ? 1 : 0;        // cum_q[t] = cz[t + 1] or cz[t]
    for (int p = tid; p < c * c; p += kThreads) {
      const int t = p / c, j = p % c;
      float acc = 0.f;
      if (t < n && (inclusive ? j <= t : j < t)) {
        const float* qr = q_s + t * ldk;
        const float* cq = cz + (t + qrow) * ldk;
        const float* kr = k_s + j * ldk;
        const float* cs = cz + (j + 1) * ldk;
        for (int d = 0; d < dk; ++d)
          acc = fmaf(qr[d] * kr[d], __expf(fminf(cq[d] - cs[d], 0.f)), acc);
      }
      sc[p] = acc;
    }
    __syncthreads();

    // 4. q * e^{cum_q} and k * e^{cum_end - cum}, in place
    const float* cend = cz + c * ldk;
    for (int i = tid; i < c * dk; i += kThreads) {
      const int t = i / dk, d = i % dk;
      q_s[t * ldk + d] *= __expf(cz[(t + qrow) * ldk + d]);
      k_s[t * ldk + d] *= __expf(cend[d] - cz[(t + 1) * ldk + d]);
    }
    __syncthreads();

    // 5. o[t] = (q * e^{cum_q})[t] S + sum_s scores[t, s] v[s], in v's type
    for (int p = tid; p < n * dv; p += kThreads) {
      const int t = p / dv, j = p % dv;
      const float* qr = q_s + t * ldk;
      float acc = 0.f;
      for (int d = 0; d < dk; ++d) acc = fmaf(qr[d], S[d * dv + j], acc);
      const float* sr = sc + t * c;
      const int s_end = inclusive ? t + 1 : t;
      for (int j2 = 0; j2 < s_end; ++j2) acc = fmaf(sr[j2], v_s[j2 * dv + j], acc);
      out[(((long long)b * L + l0 + t) * H + h) * dv + j] = from_f32<T>(acc);
    }
    __syncthreads();

    // 6. S <- e^{cum_end} * S + (k * e^{cum_end - cum})^T v
    for (int p = tid; p < dk * dv; p += kThreads) {
      const int d = p / dv, j = p % dv;
      float acc = __expf(cend[d]) * S[p];
      for (int t = 0; t < n; ++t) acc = fmaf(k_s[t * ldk + d], v_s[t * dv + j], acc);
      S[p] = acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < dk * dv; i += kThreads) state[sh + i] = S[i];
}

size_t smem_bytes(int dk, int dv, int c) {
  const size_t ldk = dk + 1;
  return sizeof(float) * ((3 * (size_t)c + 1) * ldk + (size_t)c * dv + (size_t)c * c +
                          (size_t)dk * dv);
}

// ---------------------------------------------------------------------------
// bf16: sub-chunked, products on the tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr float kLog2e = 1.4426950408889634f;

// D = A B + D for a 16x16 A (row-major fragments), a 16x8 B (column-major) and
// a 16x8 f32 accumulator, in mma.sync's register layouts: with g = lane / 4 and
// t = lane % 4, a thread holds A rows g, g+8 at columns 2t, 2t+1 (+8), B column g
// at rows 2t, 2t+1 (+8), and D rows g, g+8 at columns 2t, 2t+1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A B with A = ah + al and B = bh + bl, each a bf16 high and low part:
// the three products that carry ~16 bits (al bl is below them).
__device__ __forceinline__ void mma_bf16x3(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_bf16(d, al, bh0, bh1);
  mma_bf16(d, ah, bl0, bl1);
  mma_bf16(d, ah, bh0, bh1);
}

// (x0, x1) as a bf16x2 high part and the bf16x2 of what it leaves, x - hi.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float2 ld_bf16x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lanes 8m..8m+7 give the row addresses of matrix m.
// Plain: register m holds row g, columns 2t, 2t+1 of matrix m; .trans: rows
// 2t, 2t+1 of column g.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// Rows [0, c) of one (b, h) slice of a (b, l, h, d) tensor into a tile with
// rows of `ld` elements; rows >= n are zeros. vec: 16-byte copies (d stride 1,
// rows 16-byte aligned); otherwise element by element through the strides.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, long long s_l,
                                           long long s_d, int n, int c, int width, bool vec) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    const int per_row = width / kPer;
    for (int i = threadIdx.x; i < c * per_row; i += kMmaThreads) {
      const int t = i / per_row, e = (i - t * per_row) * kPer;
      T* d = dst + t * ld + e;
      if (t < n) cp_async16(d, src + t * s_l + e);
      else *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < c * width; i += kMmaThreads) {
      const int t = i / width, e = i - t * width;
      dst[t * ld + e] = t < n ? src[t * s_l + e * s_d] : from_f32<T>(0.f);
    }
  }
}

// Shared-memory plan of gla_scan_mma_kernel (element counts; every buffer
// and row a multiple of 16 bytes, so ldmatrix, cp.async and 16-byte loads
// stay aligned).
struct MmaPlan {
  int ldq, ldv, ldc, lds, ldp;
  __host__ __device__ MmaPlan(int dk, int dv, int c)
      : ldq(dk + 8), ldv(dv + 8), ldc(dk + 4), lds(dv + 4), ldp(c + 4) {}
};

size_t mma_smem_bytes(int dk, int dv, int c, size_t ld_bytes) {
  const MmaPlan P(dk, dv, c);
  return 2 * ((size_t)4 * c * P.ldq + (size_t)c * P.ldv) +  // q, k, scaled hi, lo; v
         4 * ((size_t)(c + 1) * P.ldc + (size_t)dk * P.lds + (size_t)c * P.ldp +
              kMmaThreads) +                                // cum, S, scores, scan totals
         (ld_bytes == 4 ? 0 : ld_bytes * c * dk);           // bf16 ld (f32 lands in cum)
}

__device__ __forceinline__ void pair_sync(int i) {  // the two warps of sub-chunk i
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + i) : "memory");
}

// One chunk of gla_scan_mma_kernel, per 16-row sub-chunk i of queries:
//   scores_ij = (q_i e^{cum_q - r_i}) (k_j e^{r_i - cum_j})^T   (j < i, products)
//   scores_ii = sum_d q k e^{min(cum_q - cum, 0)}, masked        (CUDA cores; its
//               lower-left 8 x 8 block as the same product about cum at row 8)
//   o_i       = (q_i e^{cum_q}) S + P_i v                         (products)
// then S <- e^{cum_end} S + (k e^{cum_end - cum})^T v (products). cum is
// kept as log2(e) cum, so every exponential is one ex2.approx.
template <typename TL, int DK>
__global__ void __launch_bounds__(kMmaThreads, 2)
gla_scan_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const TL* __restrict__ ld,
                    const float* __restrict__ s0, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ state, Strides st, int L, int H, int dv, int c,
                    int inclusive, int vec) {
  constexpr int KS = DK / 16;                     // 16-deep steps over dk
  constexpr int kDiagUnroll = DK <= 64 ? 4 : 2;   // keeps dk 96 and 112 out of spills
  constexpr int kSeg = kMmaThreads / DK;          // scan segments a column
  constexpr bool kLdF32 = sizeof(TL) == 4;
  extern __shared__ uint4 smem16[];
  const MmaPlan P(DK, dv, c);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem16);  // (c, ldq) q
  __nv_bfloat16* Ks = Qs + c * P.ldq;                            // (c, ldq) k
  // (c, ldq) twice: the diagonal blocks' f32 factors (step 3), then bf16 high
  // and low parts of q scaled for the off-diagonal blocks (4), of q e^{cum_q}
  // (5) and of k e^{cum_end - cum} (6)
  __nv_bfloat16* Xh = Ks + c * P.ldq;
  __nv_bfloat16* Xl = Xh + c * P.ldq;
  __nv_bfloat16* Vs = Xl + c * P.ldq;                            // (c, ldv) v
  float* cz = reinterpret_cast<float*>(Vs + c * P.ldv);  // (c + 1, ldc): 0, log2e cum[t]
  float* S = cz + (c + 1) * P.ldc;                       // (dk, lds) the f32 state
  float* Ps = S + DK * P.lds;                            // (c, ldp) scores
  float* tot = Ps + c * P.ldp;                           // (kSeg, dk) scan segment sums
  // ld as given: f32 straight into cz's rows 1..c, bf16 into a tile of its own
  TL* lraw = kLdF32 ? reinterpret_cast<TL*>(cz + P.ldc)
                    : reinterpret_cast<TL*>(tot + kMmaThreads);
  const int lld = kLdF32 ? P.ldc : DK;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const long long* s = st.s;
  const __nv_bfloat16* qb = q + b * s[0] + h * s[2];
  const __nv_bfloat16* kb = k + b * s[4] + h * s[6];
  const __nv_bfloat16* vb = v + b * s[8] + h * s[10];
  const TL* lb = ld + b * s[12] + h * s[14];
  const long long sh = (long long)(b * H + h) * DK * dv;

  for (int i = tid; i < DK * dv; i += kMmaThreads)
    S[(i / dv) * P.lds + i % dv] = s0 ? s0[sh + i] : 0.f;
  for (int d = tid; d < DK; d += kMmaThreads) cz[d] = 0.f;

  const int qrow = inclusive ? 1 : 0;  // cum_q[t] = cz[t + 1] or cz[t]
  const int nsub = c >> 4;             // 16-row sub-chunks
  const int seg_rows = (c + kSeg - 1) / kSeg;
  const int n_chunks = (L + c - 1) / c;
  for (int ic = 0; ic < n_chunks; ++ic) {
    const int l0 = ic * c;
    const int n = L - l0 < c ? L - l0 : c;  // valid rows of this chunk

    // 1. stage q, k, v and ld; rows past L read as zeros
    stage_rows(Qs, P.ldq, qb + l0 * s[1], s[1], s[3], n, c, DK, vec & 1);
    stage_rows(Ks, P.ldq, kb + l0 * s[5], s[5], s[7], n, c, DK, vec & 2);
    stage_rows(Vs, P.ldv, vb + l0 * s[9], s[9], s[11], n, c, dv, vec & 4);
    stage_rows(lraw, lld, lb + l0 * s[13], s[13], s[15], n, c, DK, vec & 8);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // 2. cz[t + 1] = log2(e) cum[t]: each column cut into kSeg segments of rows,
    // summed apart, then each offset by the sums of the segments before it
    {
      const int d = tid % DK, sg = tid / DK;
      const int t0 = sg * seg_rows, t1 = min(c, t0 + seg_rows);
      if (sg < kSeg) {
        float run = 0.f;
        for (int t = t0; t < t1; ++t) {
          run = fmaf(kLog2e, to_f32(lraw[t * lld + d]), run);
          cz[(t + 1) * P.ldc + d] = run;
        }
        tot[sg * DK + d] = run;
      }
      __syncthreads();
      if (sg < kSeg && sg > 0) {
        float off = 0.f;
        for (int s2 = 0; s2 < sg; ++s2) off += tot[s2 * DK + d];
        for (int t = t0; t < t1; ++t) cz[(t + 1) * P.ldc + d] += off;
      }
      __syncthreads();
    }

    // 3. the diagonal 16 x 16 block of each sub-chunk i, cut into 8-row halves.
    // 3a. its lower-left 8 x 8 block is a product about r = cum at the 8th row
    // (cz row 16i + 8); its factors, f32, in Xh / Xl's space (free until step 4):
    // row t of F holds k e^{r - cum} (first 8 rows of a sub-chunk) or
    // q e^{cum_q - r} (last 8 rows)
    float* F = reinterpret_cast<float*>(Xh);
    const int fld = DK + 4;
    for (int p = tid; p < c * (DK / 2); p += kMmaThreads) {
      const int t = p / (DK / 2), d = 2 * (p % (DK / 2));
      const float* rh = cz + ((t & ~15) + 8) * P.ldc + d;
      float2 x, e;
      if (t & 8) {
        const float* cq = cz + (t + qrow) * P.ldc + d;
        x = ld_bf16x2(Qs + t * P.ldq + d);
        e = make_float2(cq[0] - rh[0], cq[1] - rh[1]);
      } else {
        const float* cs = cz + (t + 1) * P.ldc + d;
        x = ld_bf16x2(Ks + t * P.ldq + d);
        e = make_float2(rh[0] - cs[0], rh[1] - cs[1]);
      }
      *reinterpret_cast<float2*>(F + t * fld + d) = make_float2(x.x * ex2(e.x), x.y * ex2(e.y));
    }
    __syncthreads();

    // 3b. warps 2i and 2i+1, lanes L < 64: the lower-left block's pair L; the
    // two 8 x 8 diagonal triangles' pairs L and L + 64, with per-channel clamped
    // exponentials; zeros where the mode masks (key > row, or key >= row)
    if ((warp >> 1) < nsub) {
      const int L = 32 * (warp & 1) + lane, r0 = 16 * (warp >> 1);
      {
        const float* fq = F + (r0 + 8 + (L >> 3)) * fld;
        const float* fk = F + (r0 + (L & 7)) * fld;
        float acc = 0.f;
#pragma unroll 4
        for (int d = 0; d < DK; d += 4) {
          const float4 x = *reinterpret_cast<const float4*>(fq + d);
          const float4 y = *reinterpret_cast<const float4*>(fk + d);
          acc = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, acc))));
        }
        Ps[(r0 + 8 + (L >> 3)) * P.ldp + r0 + (L & 7)] = acc;
      }
      const int tri = inclusive ? 36 : 28;  // kept pairs of one 8 x 8 triangle
      for (int p = L; p < 2 * tri; p += 64) {
        int idx = p < tri ? p : p - tri, r = inclusive ? 0 : 1;
        while (idx >= r + inclusive) idx -= r++ + inclusive;  // row r keeps r (+1) keys
        const int row = r0 + (p < tri ? 0 : 8) + r, key = row - r + idx;
        const __nv_bfloat16* qr = Qs + row * P.ldq;
        const __nv_bfloat16* kr = Ks + key * P.ldq;
        const float* cq = cz + (row + qrow) * P.ldc;
        const float* cs = cz + (key + 1) * P.ldc;
        float acc = 0.f;
#pragma unroll kDiagUnroll
        for (int d = 0; d < DK; d += 4) {
          const uint2 q4 = *reinterpret_cast<const uint2*>(qr + d);
          const uint2 k4 = *reinterpret_cast<const uint2*>(kr + d);
          const float4 a = *reinterpret_cast<const float4*>(cq + d);
          const float4 z = *reinterpret_cast<const float4*>(cs + d);
          const float2 q01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q4.x));
          const float2 q23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q4.y));
          const float2 k01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&k4.x));
          const float2 k23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&k4.y));
          acc = fmaf(q01.x * k01.x, ex2(fminf(a.x - z.x, 0.f)), acc);
          acc = fmaf(q01.y * k01.y, ex2(fminf(a.y - z.y, 0.f)), acc);
          acc = fmaf(q23.x * k23.x, ex2(fminf(a.z - z.z, 0.f)), acc);
          acc = fmaf(q23.y * k23.y, ex2(fminf(a.w - z.w, 0.f)), acc);
        }
        Ps[row * P.ldp + key] = acc;
      }
      for (int e = L; e < 256; e += 64) {
        const int r = e >> 4, k2 = e & 15;
        if (inclusive ? k2 > r : k2 >= r) Ps[(r0 + r) * P.ldp + r0 + k2] = 0.f;
      }
    }
    __syncthreads();

    // 4. q e^{cum_q - r_i} for sub-chunks i >= 1, r_i = cum at row 16i - 1 (cz row 16i)
    for (int p = tid; p < (c - 16) * (DK / 2); p += kMmaThreads) {
      const int t = 16 + p / (DK / 2), d = 2 * (p % (DK / 2));
      const float2 x = ld_bf16x2(Qs + t * P.ldq + d);
      const float* cq = cz + (t + qrow) * P.ldc + d;
      const float* rz = cz + (t & ~15) * P.ldc + d;
      uint32_t hi, lo;
      split_bf16(x.x * ex2(cq[0] - rz[0]), x.y * ex2(cq[1] - rz[1]), hi, lo);
      *reinterpret_cast<uint32_t*>(Xh + t * P.ldq + d) = hi;
      *reinterpret_cast<uint32_t*>(Xl + t * P.ldq + d) = lo;
    }
    __syncthreads();

    // 4b. the off-diagonal blocks (i, j < i) into Ps, one key n-tile (8 keys) a
    // unit, spread over the warps
    for (int u = warp; u < nsub * (nsub - 1); u += kMmaWarps) {
      int i = 1, j = u >> 1;
      while (j >= i) j -= i++;
      const int r0 = 16 * i, key = 16 * j + 8 * (u & 1) + g;  // B column g: a key row
      const float* rz = cz + r0 * P.ldc;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        const int ar = r0 + (lane & 15), ac = 16 * ks + ((lane >> 4) << 3);
        ldsm_x4(ah, Xh + ar * P.ldq + ac);
        ldsm_x4(al, Xl + ar * P.ldq + ac);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int d = 16 * ks + 2 * tq + 8 * half;
          const float2 kk = ld_bf16x2(Ks + key * P.ldq + d);
          const float2 cs = *reinterpret_cast<const float2*>(cz + (key + 1) * P.ldc + d);
          const float2 r = *reinterpret_cast<const float2*>(rz + d);
          split_bf16(kk.x * ex2(r.x - cs.x), kk.y * ex2(r.y - cs.y), bh[half], bl[half]);
        }
        mma_bf16x3(acc, ah, al, bh[0], bh[1], bl[0], bl[1]);
      }
      float* pr = Ps + (r0 + g) * P.ldp + 16 * j + 8 * (u & 1) + 2 * tq;
      *reinterpret_cast<float2*>(pr) = make_float2(acc[0], acc[1]);
      *reinterpret_cast<float2*>(pr + 8 * P.ldp) = make_float2(acc[2], acc[3]);
    }
    __syncthreads();

    // 5. warps 2i and 2i+1 (part pt): o for query rows 16i..16i+15 of the chunk
    if ((warp >> 1) < nsub) {
      const int i = warp >> 1, pt = warp & 1, r0 = 16 * i;
      const float* prow = Ps + (r0 + g) * P.ldp + 2 * tq;
      // q e^{cum_q} into this sub-chunk's rows of Xh / Xl (step 4b is past)
      for (int p = 32 * pt + lane; p < 8 * DK; p += 64) {
        const int t = r0 + p / (DK / 2), d = 2 * (p % (DK / 2));
        const float2 x = ld_bf16x2(Qs + t * P.ldq + d);
        const float* cq = cz + (t + qrow) * P.ldc + d;
        uint32_t hi, lo;
        split_bf16(x.x * ex2(cq[0]), x.y * ex2(cq[1]), hi, lo);
        *reinterpret_cast<uint32_t*>(Xh + t * P.ldq + d) = hi;
        *reinterpret_cast<uint32_t*>(Xl + t * P.ldq + d) = lo;
      }
      pair_sync(i);

      // o = (q e^{cum_q}) S + P v, 16 columns of dv at a time, alternating parts
      __nv_bfloat16* ob = out + (((long long)b * L + l0) * H + h) * dv;
      for (int n0 = 16 * pt; n0 < dv; n0 += 32) {
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t ah[4], al[4];
          const int ar = r0 + (lane & 15), ac = 16 * ks + ((lane >> 4) << 3);
          ldsm_x4(ah, Xh + ar * P.ldq + ac);
          ldsm_x4(al, Xl + ar * P.ldq + ac);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float* sr = S + (16 * ks + 2 * tq) * P.lds + n0 + 8 * h2 + g;  // B column g
            uint32_t bh0, bl0, bh1, bl1;
            split_bf16(sr[0], sr[P.lds], bh0, bl0);
            split_bf16(sr[8 * P.lds], sr[9 * P.lds], bh1, bl1);
            mma_bf16x3(acc[h2], ah, al, bh0, bh1, bl0, bl1);
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk <= i) {
            // P's key step kk as A fragments (high and low parts): element e is
            // (row g or g+8) x (key n-tile 2kk or 2kk+1), as the accumulators lay it
            uint32_t ph[4], pl[4], bv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 x = *reinterpret_cast<const float2*>(
                  prow + (e & 1) * 8 * P.ldp + 16 * kk + (e >> 1) * 8);
              split_bf16(x.x, x.y, ph[e], pl[e]);
            }
            ldsm_x4_t(bv, Vs + (16 * kk + (lane & 15)) * P.ldv + n0 + ((lane >> 4) << 3));
            mma_bf16(acc[0], pl, bv[0], bv[1]);
            mma_bf16(acc[0], ph, bv[0], bv[1]);
            mma_bf16(acc[1], pl, bv[2], bv[3]);
            mma_bf16(acc[1], ph, bv[2], bv[3]);
          }
        }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int col = n0 + 8 * h2 + 2 * tq;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int t = r0 + g + 8 * half;
            if (t < n)
              *reinterpret_cast<__nv_bfloat162*>(ob + (long long)t * H * dv + col) =
                  __floats2bfloat162_rn(acc[h2][2 * half], acc[h2][2 * half + 1]);
          }
        }
      }
    }
    __syncthreads();

    // 6. k e^{cum_end - cum} into Xh / Xl, every row of the chunk
    const float* cend = cz + c * P.ldc;
    for (int p = tid; p < c * (DK / 2); p += kMmaThreads) {
      const int t = p / (DK / 2), d = 2 * (p % (DK / 2));
      const float2 x = ld_bf16x2(Ks + t * P.ldq + d);
      const float* cs = cz + (t + 1) * P.ldc + d;
      uint32_t hi, lo;
      split_bf16(x.x * ex2(cend[d] - cs[0]), x.y * ex2(cend[d + 1] - cs[1]), hi, lo);
      *reinterpret_cast<uint32_t*>(Xh + t * P.ldq + d) = hi;
      *reinterpret_cast<uint32_t*>(Xl + t * P.ldq + d) = lo;
    }
    __syncthreads();

    // 7. S <- e^{cum_end} S + (k e^{cum_end - cum})^T v: 16 x 16 blocks of S a warp
    const int nb = dv >> 4;
    for (int u = warp; u < KS * nb; u += kMmaWarps) {
      const int m0 = 16 * (u / nb), n0 = 16 * (u % nb);
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
      for (int ks = 0; ks < c; ks += 16) {
        uint32_t ah[4], al[4], bv[4];
        const int ar = ks + (lane & 7) + ((lane >> 4) << 3), ac = m0 + (((lane >> 3) & 1) << 3);
        ldsm_x4_t(ah, Xh + ar * P.ldq + ac);
        ldsm_x4_t(al, Xl + ar * P.ldq + ac);
        ldsm_x4_t(bv, Vs + (ks + (lane & 15)) * P.ldv + n0 + ((lane >> 4) << 3));
        mma_bf16(acc[0], al, bv[0], bv[1]);
        mma_bf16(acc[0], ah, bv[0], bv[1]);
        mma_bf16(acc[1], al, bv[2], bv[3]);
        mma_bf16(acc[1], ah, bv[2], bv[3]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = m0 + g + 8 * half;
        const float decay = ex2(cend[d]);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float2* sp = reinterpret_cast<float2*>(S + d * P.lds + n0 + 8 * h2 + 2 * tq);
          const float2 old = *sp;
          *sp = make_float2(fmaf(decay, old.x, acc[h2][2 * half]),
                            fmaf(decay, old.y, acc[h2][2 * half + 1]));
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < DK * dv; i += kMmaThreads) state[sh + i] = S[(i / dv) * P.lds + i % dv];
}

// The selection rule: bf16 q, k, v with dk, dv multiples of 16 up to 128 and a
// chunk of 16, 32 or 64 take the tensor-core kernel.
bool uses_mma(int qkv_dtype, int dk, int dv, int c) {
  return qkv_dtype == 1 && dk % 16 == 0 && dv % 16 == 0 && dk <= 128 && dv <= 128 &&
         (c == 16 || c == 32 || c == 64);
}

// 1, 2, 4, 8: q, k, v, ld may be copied 16 bytes at a time (d stride 1, base
// and row strides 16-byte aligned).
int vec_flags(const void* const* ptrs, const size_t* elem, const long long* st, const int* width) {
  int flags = 0;
  for (int i = 0; i < 4; ++i) {
    const long long* s = st + 4 * i;
    const long long per = 16 / (long long)elem[i];
    const bool ok = s[3] == 1 && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0 &&
                    s[0] % per == 0 && s[1] % per == 0 && s[2] % per == 0 &&
                    width[i] % per == 0;
    flags |= ok ? 1 << i : 0;
  }
  return flags;
}

template <typename TL, int DK>
int launch_mma_dk(const void* q, const void* k, const void* v, const void* ld, const float* s0,
                  void* out, float* state, const Strides& st, int B, int L, int H, int dv,
                  int c, int inclusive, cudaStream_t stream) {
  const size_t bytes = mma_smem_bytes(DK, dv, c, sizeof(TL));
  auto kernel = gla_scan_mma_kernel<TL, DK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const void* ptrs[4] = {q, k, v, ld};
  const size_t elem[4] = {2, 2, 2, sizeof(TL)};
  const int width[4] = {DK, DK, dv, DK};
  const int vec = vec_flags(ptrs, elem, st.s, width);
  const dim3 grid((unsigned)H, (unsigned)B);
  kernel<<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const TL*>(ld), s0,
      static_cast<__nv_bfloat16*>(out), state, st, L, H, dv, c, inclusive, vec);
  return (int)cudaGetLastError();
}

// dk is a template argument of the tensor-core kernel (its loops over dk unroll)
template <typename TL>
int launch_mma(const void* q, const void* k, const void* v, const void* ld, const float* s0,
               void* out, float* state, const Strides& st, int B, int L, int H, int dk,
               int dv, int c, int inclusive, cudaStream_t stream) {
  switch (dk) {
#define GLA_DK(D) \
  case D:         \
    return launch_mma_dk<TL, D>(q, k, v, ld, s0, out, state, st, B, L, H, dv, c, inclusive, stream);
    GLA_DK(16) GLA_DK(32) GLA_DK(48) GLA_DK(64) GLA_DK(80) GLA_DK(96) GLA_DK(112) GLA_DK(128)
#undef GLA_DK
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename TL>
int launch(const void* q, const void* k, const void* v, const void* ld, const float* s0,
           void* out, float* state, const Strides& st, int B, int L, int H, int dk, int dv,
           int c, int inclusive, cudaStream_t stream) {
  const size_t bytes = smem_bytes(dk, dv, c);
  auto kernel = gla_scan_kernel<T, TL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)H, (unsigned)B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TL*>(ld), s0, static_cast<T*>(out), state, st, L, H, dk, dv, c,
      inclusive);
  return (int)cudaGetLastError();
}

}  // namespace

// 1 when gla_scan_fwd launches the tensor-core kernel for these types and
// sizes, 0 when it launches the CUDA-core one (chunk already cut to L).
extern "C" int gla_scan_uses_mma(int qkv_dtype, int dk, int dv, int chunk) {
  return uses_mma(qkv_dtype, dk, dv, chunk) ? 1 : 0;
}

// Dynamic shared memory one block of the kernel that gla_scan_fwd selects
// needs (the wrapper refuses sizes past the card's per-block limit before
// launching).
extern "C" long long gla_scan_smem_bytes(int qkv_dtype, int ld_dtype, int dk, int dv,
                                         int chunk) {
  if (uses_mma(qkv_dtype, dk, dv, chunk))
    return (long long)mma_smem_bytes(dk, dv, chunk, ld_dtype == 0 ? 4 : 2);
  return (long long)smem_bytes(dk, dv, chunk);
}

// qkv_dtype, ld_dtype: 0 = float32, 1 = bfloat16. Launches the kernel that
// gla_scan_uses_mma names. strides: 16 element
// strides, (b, l, h, d) of q, k, v, ld. s0 (may be null) and state are
// contiguous (B, H, dk, dv) f32; out is contiguous (B, L, H, dv) of v's type.
// Returns cudaGetLastError() after the launch.
extern "C" int gla_scan_fwd(int qkv_dtype, int ld_dtype, int inclusive, const void* q,
                            const void* k, const void* v, const void* ld, const float* s0,
                            void* out, float* state, int B, int L, int H, int dk, int dv,
                            int chunk, const long long* strides, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || L < 1 || dk < 1 || dv < 1 || chunk < 1 || chunk > L)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 16; ++i) st.s[i] = strides[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (uses_mma(qkv_dtype, dk, dv, chunk)) {
    if (ld_dtype == 0)
      return launch_mma<float>(q, k, v, ld, s0, out, state, st, B, L, H, dk, dv, chunk,
                               inclusive, s);
    if (ld_dtype == 1)
      return launch_mma<__nv_bfloat16>(q, k, v, ld, s0, out, state, st, B, L, H, dk, dv,
                                       chunk, inclusive, s);
    return (int)cudaErrorInvalidValue;
  }
  if (qkv_dtype == 0 && ld_dtype == 0)
    return launch<float, float>(q, k, v, ld, s0, out, state, st, B, L, H, dk, dv, chunk,
                                inclusive, s);
  if (qkv_dtype == 0 && ld_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k, v, ld, s0, out, state, st, B, L, H, dk, dv,
                                        chunk, inclusive, s);
  if (qkv_dtype == 1 && ld_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k, v, ld, s0, out, state, st, B, L, H, dk, dv,
                                        chunk, inclusive, s);
  if (qkv_dtype == 1 && ld_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, ld, s0, out, state, st, B, L, H,
                                                dk, dv, chunk, inclusive, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
