// Flash attention forward (causal or bidirectional, GQA) for the NVIDIA H100
// (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention.
//
//   o[b,h,i] = sum_j softmax_j(s_ij) v[b,h/G,j],  s_ij = hd^-0.5 q[b,h,i] . k[b,h/G,j]
//
// with s_ij = -1e30 where j > i under `causal`, the softmax in f32 and the
// normaliser floored at 1e-30, as the TPU kernel does.
//
// What bounds it: operations. A causal call does 4*hd flops for each of the
// B*H*L*(L+1)/2 (query, key) pairs it keeps and moves each input and the output
// once: at the main path's B=4, H=32, KV=4, L=1024, hd=128 in bf16 that is
// ~34 GFLOP against ~76 MB, ~450 flop per byte, above the card's bf16 ridge (~295).
// The bound is ~35 us at the tensor cores' 989 TFLOP/s.
//
// What the design does about it. Two kernels, one per input type, share the
// plan below; neither uses wgmma or TMA yet (the next design).
//  * bf16 (the main path): tensor cores through mma.sync m16n8k16 (bf16 in, f32
//    sums). A block of 4 warps owns 64 query rows, 16 per warp, whose Q fragments
//    stay in registers; 64-key K/V tiles are staged in shared memory with 16-byte
//    loads (rows padded by 8 values, so fragment reads are free of bank
//    conflicts). S = QK^T lands in registers in the accumulator layout, the
//    online softmax runs on it in f32 with quad shuffles, and P is repacked in
//    registers as the A operand of P.V: it never touches shared memory.
//  * f32: CUDA cores (67 TFLOP/s peak, exact f32 products). A block of 4 warps
//    owns 32 query rows, 8 per warp; lane j dots key j of a 32-key tile with the
//    warp's rows (float4 reads of rows padded to hd+4), the softmax reduces with
//    warp shuffles, and P goes through shared memory into P.V, where each lane
//    owns output columns lane, lane+32, ... (hd=80 idles half the lanes on the
//    third column: its tile plan).
// Both: grid (query tile, query head, batch); the KV head is h / G, so K and V
// are never repeated; causal tiles are issued heaviest first. The loop over K
// tiles stops at the tile's causal limit (the TPU kernel's pl.when block skip,
// as a loop bound inside the block), and the diagonal tile and the ragged tail
// are masked, so any L works. Strides are arguments (unit stride on hd), so the
// model's (B, L, H, hd) layout is read and written in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;               // query rows per warp
constexpr int kBQ = kWarps * kRows;    // query rows per block
constexpr int kBK = 32;                // keys per tile: one per lane
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, l;  // element strides of batch, head and position; hd is unit-stride
};

__device__ __forceinline__ float lane_of(const float4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

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

// Shared-memory plan for one head dim.
template <int HD>
struct Plan {
  static_assert(HD % 4 == 0, "rows are read as float4");
  static constexpr int kPad = HD + 4;            // Q/K row stride in floats
  static constexpr int kCols = (HD + 31) / 32;   // output columns per lane
  static constexpr int kFloats = kBQ * kPad + kBK * kPad + kBK * HD + kWarps * kRows * kBK;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, Strides sq,
                     Strides sk, Strides sv, Strides so, int G, int Lq, int Lk,
                     float scale) {
  using P = Plan<HD>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * P::kPad;
  float* Vs = Ks + kBK * P::kPad;
  float* Ps = Vs + kBK * HD;

  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int q0 = tile * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  float* ob = o + b * so.b + h * so.h;

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx - r * HD;
    const int i = q0 + r;
    Qs[r * P::kPad + d] = i < Lq ? qb[i * sq.l + d] * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][P::kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < P::kCols; ++c) acc[r][c] = 0.f;
  }

  const int q_last = min(q0 + kBQ, Lq) - 1;
  const int k_end = CAUSAL ? min(Lk, q_last + 1) : Lk;
  const float* Qw = Qs + warp * kRows * P::kPad;
  float* Pw = Ps + warp * kRows * kBK;

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous K/V tile is consumed (and Q is staged)
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int r = idx / HD, d = idx - r * HD;
      const int j = k0 + r;
      const bool in = j < Lk;
      Ks[r * P::kPad + d] = in ? kb[j * sk.l + d] : 0.f;
      Vs[r * HD + d] = in ? vb[j * sv.l + d] : 0.f;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * P::kPad;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(Qw + r * P::kPad + d);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    const int j = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = q0 + warp * kRows + r;
      const bool keep = j < Lk && (!CAUSAL || j <= i);
      const float sr = keep ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = expf(sr - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p);
#pragma unroll
      for (int c = 0; c < P::kCols; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
      Pw[r * kBK + lane] = p;
    }
    __syncwarp();

#pragma unroll 2
    for (int jj = 0; jj < kBK; jj += 4) {
      float4 pr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pr[r] = *reinterpret_cast<const float4*>(Pw + r * kBK + jj);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vr = Vs + (jj + t) * HD;
#pragma unroll
        for (int c = 0; c < P::kCols; ++c) {
          const int d = lane + 32 * c;
          if (d < HD) {
            const float vv = vr[d];
#pragma unroll
            for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(lane_of(pr[r], t), vv, acc[r][c]);
          }
        }
      }
    }
    __syncwarp();  // P of this tile is read before the next tile rewrites it
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + warp * kRows + r;
    if (i < Lq) {
      const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < P::kCols; ++c) {
        const int d = lane + 32 * c;
        if (d < HD) ob[i * so.l + d] = acc[r][c] / den;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kMmaBQ = 16 * kWarps;  // query rows per block: 16 per warp
constexpr int kMmaBK = 64;           // keys per tile

template <int HD>
struct MmaPlan {
  static_assert(HD % 16 == 0, "hd is a multiple of the mma depth");
  static constexpr int kLd = HD + 8;          // smem row stride in bf16 values
  static constexpr int kKSteps = HD / 16;     // depth steps of S = Q K^T
  static constexpr int kOutBlocks = HD / 8;   // 8-column blocks of O
  static constexpr int kChunks = HD / 8;      // 16-byte chunks per row
  static constexpr size_t kBytes = (size_t)(kMmaBQ + 2 * kMmaBK) * kLd * 2;
};

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + rows) of a (position, hd) slice into smem; rows past `limit` are 0
template <int HD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long stride, int r0, int rows, int limit) {
  using P = MmaPlan<HD>;
  for (int idx = threadIdx.x; idx < rows * P::kChunks; idx += kThreads) {
    const int r = idx / P::kChunks, c = idx - r * P::kChunks;
    const int j = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (j < limit) val = __ldg(reinterpret_cast<const uint4*>(src + j * stride + c * 8));
    *reinterpret_cast<uint4*>(dst + r * P::kLd + c * 8) = val;
  }
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     Strides sq, Strides sk, Strides sv, Strides so, int G, int Lq, int Lk,
                     float scale) {
  using P = MmaPlan<HD>;
  extern __shared__ uint4 smem16[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem16);
  __nv_bfloat16* Ks = Qs + kMmaBQ * P::kLd;
  __nv_bfloat16* Vs = Ks + kMmaBK * P::kLd;

  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int q0 = tile * kMmaBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* kb = k + b * sk.b + kvh * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + kvh * sv.h;

  stage_rows<HD>(Qs, q + b * sq.b + h * sq.h, sq.l, q0, kMmaBQ, Lq);
  __syncthreads();
  uint32_t qf[P::kKSteps][4];
  {
    const __nv_bfloat16* qw = Qs + (warp * 16) * P::kLd;
#pragma unroll
    for (int ks = 0; ks < P::kKSteps; ++ks) {
      const __nv_bfloat16* base = qw + ks * 16 + 2 * t;
      qf[ks][0] = ld32(base + g * P::kLd);
      qf[ks][1] = ld32(base + (g + 8) * P::kLd);
      qf[ks][2] = ld32(base + g * P::kLd + 8);
      qf[ks][3] = ld32(base + (g + 8) * P::kLd + 8);
    }
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[P::kOutBlocks][4];
#pragma unroll
  for (int nb = 0; nb < P::kOutBlocks; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  const int row_base = q0 + warp * 16 + g;  // this thread's rows: row_base, row_base + 8
  const int q_last = min(q0 + kMmaBQ, Lq) - 1;
  const int k_end = CAUSAL ? min(Lk, q_last + 1) : Lk;

  for (int k0 = 0; k0 < k_end; k0 += kMmaBK) {
    __syncthreads();  // the previous K/V tile is consumed
    stage_rows<HD>(Ks, kb, sk.l, k0, kMmaBK, Lk);
    stage_rows<HD>(Vs, vb, sv.l, k0, kMmaBK, Lk);
    __syncthreads();

    float s[kMmaBK / 8][4];
#pragma unroll
    for (int nb = 0; nb < kMmaBK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
      const __nv_bfloat16* krow = Ks + (nb * 8 + g) * P::kLd + 2 * t;
#pragma unroll
      for (int ks = 0; ks < P::kKSteps; ++ks)
        mma_bf16(s[nb], qf[ks], ld32(krow + ks * 16), ld32(krow + ks * 16 + 8));
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < kMmaBK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_base + (e >> 1) * 8;
        const int col = k0 + nb * 8 + 2 * t + (e & 1);
        const bool keep = col < Lk && (!CAUSAL || col <= row);
        s[nb][e] = keep ? s[nb][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    }
    float sum[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nb = 0; nb < kMmaBK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = expf(s[nb][e] - m[e >> 1]);
        sum[e >> 1] += s[nb][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = alpha[r] * l[r] + sum[r];
    }
#pragma unroll
    for (int nb = 0; nb < P::kOutBlocks; ++nb) {
      acc[nb][0] *= alpha[0];
      acc[nb][1] *= alpha[0];
      acc[nb][2] *= alpha[1];
      acc[nb][3] *= alpha[1];
    }

    // O += P V: the accumulators of key blocks 2kk and 2kk+1 are the A fragment
    // of depth step kk; B (keys x hd columns) is gathered from the V rows.
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* v0 = Vs + (kk * 16 + 2 * t) * P::kLd + g;
#pragma unroll
      for (int nb = 0; nb < P::kOutBlocks; ++nb) {
        const __nv_bfloat16* vc = v0 + nb * 8;
        mma_bf16(acc[nb], a, pack_bf16(vc[0], vc[P::kLd]),
                 pack_bf16(vc[8 * P::kLd], vc[9 * P::kLd]));
      }
    }
  }

  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_base + r * 8;
    if (row < Lq) {
      const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int nb = 0; nb < P::kOutBlocks; ++nb)
        *reinterpret_cast<uint32_t*>(ob + row * so.l + nb * 8 + 2 * t) =
            pack_bf16(acc[nb][2 * r] / den, acc[nb][2 * r + 1] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, typename Kernel>
int launch(Kernel kern, size_t smem, int rows_per_block, const void* q, const void* k,
           const void* v, void* o, int B, int H, int G, int Lq, int Lk,
           const long long* st, float scale, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + rows_per_block - 1) / rows_per_block, H, B);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]};
  const Strides sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, sv, so, G, Lq, Lk, scale);
  return (int)cudaGetLastError();
}

template <int HD, bool CAUSAL>
int launch_hd(int dtype, const void* q, const void* k, const void* v, void* o, int B,
              int H, int G, int Lq, int Lk, const long long* st, float scale,
              cudaStream_t s) {
  if (dtype == 0)
    return launch<float>(flash_fwd_f32_kernel<HD, CAUSAL>, Plan<HD>::kBytes, kBQ, q, k, v,
                         o, B, H, G, Lq, Lk, st, scale, s);
  return launch<__nv_bfloat16>(flash_fwd_mma_kernel<HD, CAUSAL>, MmaPlan<HD>::kBytes,
                               kMmaBQ, q, k, v, o, B, H, G, Lq, Lk, st, scale, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; needs 16-byte
// aligned pointers and strides that are multiples of 8); hd in {64, 80, 128}.
// strides holds 12 element strides: (batch, head, position) for q, k, v and o in
// that order. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(int dtype, int hd, int causal, const void* q,
                                   const void* k, const void* v, void* o, int B, int H,
                                   int KV, int Lq, int Lk, const long long* strides,
                                   float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Lq < 1 || Lk < 1 || B > 65535 ||
      H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)))
      return (int)cudaErrorMisalignedAddress;
    for (int i = 0; i < 12; ++i)
      if (strides[i] % 8 != 0) return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
#define REPRO_FLASH_CASE(HDV)                                                             \
  if (hd == HDV)                                                                         \
    return causal ? launch_hd<HDV, true>(dtype, q, k, v, o, B, H, G, Lq, Lk, strides,     \
                                         scale, s)                                       \
                  : launch_hd<HDV, false>(dtype, q, k, v, o, B, H, G, Lq, Lk, strides,    \
                                          scale, s);
  REPRO_FLASH_CASE(64)
  REPRO_FLASH_CASE(80)
  REPRO_FLASH_CASE(128)
#undef REPRO_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
