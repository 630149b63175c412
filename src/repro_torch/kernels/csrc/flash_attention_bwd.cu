// Flash attention backward (causal or bidirectional, GQA) for the NVIDIA H100
// (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention
// under grad. That kernel has no backward (the reference trains through XLA's
// attention); in the port the forward kernel is the attention on the card, so
// its gradient is a kernel too. The FlashAttention-2 backward, from the
// forward's output o and its per-row log-sum-exp lse (flash_attention.cu):
//
//   D_i  = sum_d dO_id O_id
//   P_ij = exp(scale q_i . k_j - lse_i)            (0 where j > i under `causal`)
//   dV_j = sum_{heads of j's group} sum_i P_ij dO_i
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dK_j = scale sum_{heads of j's group} sum_i dS_ij q_i
//   dQ_i = scale sum_j dS_ij k_j
//
// What bounds it: operations. The algorithm needs 10 hd flops for each kept
// (query, key) pair (S, dP, dV, dK, dQ; 2.5x the forward's 4 hd); at the flow
// cell's B=4, H=32, KV=4, L=1024, hd=128, causal, that is 85.9 GFLOP against
// ~151 MB moved (q, o, dO, dq; k, v, dk, dv), 0.087 ms at the bf16 tensor cores'
// 989 TFLOP/s. Both kernels below recompute S and dP, and the bf16 path splits
// P and dS into two bf16 parts for their products, so the work done is 20 hd
// flops a pair in bf16 (14 in f32): this is the simple first version; ROADMAP
// Queue B lists its Hopper redesign (TMA, wgmma).
//
// What the design does about it. Two kernels in one call, dq first (it also
// writes D to a workspace), then dk/dv; no atomics, so two runs give the same
// bits. Rows past Lq and keys past Lk are masked, so any L works; under
// `causal` dq stops at its tile's last row and dk/dv start at the diagonal.
// Strides are arguments (unit stride on hd), as in the forward.
//  * bf16 (the training path): the tensor cores through mma.sync m16n8k16 with
//    f32 accumulators. dq: one block of 4 warps a (64-query tile, head, batch),
//    heaviest causal tiles first, 16 query rows a warp, 64-key tiles staged by
//    16-byte copies into rows padded to hd + 8; S = Q K^T and dP = dO V^T share
//    the pass over the head dim (Q and dO fragments from shared memory), P and
//    dS stay in the accumulators' registers, and dQ += dS K takes dS as the A
//    operand in a bf16 high and a bf16 low part (P and dS are not inputs as
//    given: one bf16 part would lose their low bits; two keep ~16). dk/dv: one
//    block a (64-key tile, KV head, batch), 16 keys a warp, first key tiles
//    first; it loops over the G query heads of its group and the 32-query
//    tiles from the diagonal on, computing S^T = K Q^T and dP^T = V dO^T, then
//    dV += P^T dO and dK += dS^T Q with the same two-part A operand, summed in
//    f32 registers over the whole group and written once.
//  * f32: the CUDA cores, exact f32 products. dq: one block of 4 warps a
//    (32-query tile, head, batch); lane j takes key j of a 32-key tile, each
//    warp 8 query rows; S and dP from one pass over the head dim (float4 reads
//    of rows padded to hd + 4 floats, so the lanes' rows fall in different
//    banks), dS through shared memory into dQ, where lane j owns columns j,
//    j + 32, ... dk/dv: one block a (32-key tile, KV head, batch), with the
//    roles turned: lane j takes query j, each warp 8 keys, P and dS go through
//    shared memory into dV and dK.
// Every sum is f32, and only dq, dk, dv are rounded to the input type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;               // rows a warp owns: queries (dq) or keys (dk/dv)
constexpr int kTile = kWarps * kRows;  // rows a block owns; the other side's tile, one a lane
static_assert(kTile == 32, "one lane per position of the other side's tile");

struct Strides {
  long long b, h, l;  // element strides of batch, head and position; hd is unit-stride
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float lane_of(const float4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

// Shared-memory plan for one head dim: four (kTile x kPad) f32 tiles, two
// (kTile x kTile) tiles of P / dS (kRows rows a warp), and kTile lse and D values.
template <int HD>
struct Plan {
  static_assert(HD % 32 == 0, "lane j owns output columns j, j + 32, ...");
  static constexpr int kPad = HD + 4;       // row stride in floats
  static constexpr int kCols = HD / 32;     // output columns per lane
  static constexpr int kTileFloats = kTile * kPad;
  static constexpr int kFloats = 4 * kTileFloats + 2 * kTile * kTile + 2 * kTile;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// Rows [r0, r0 + kTile) of one (batch, head) slice into shared memory as f32;
// rows at or past `limit` are zeros.
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, long long stride,
                                      int r0, int limit) {
  for (int idx = threadIdx.x; idx < kTile * HD; idx += kThreads) {
    const int r = idx / HD, d = idx - r * HD;
    const int i = r0 + r;
    dst[r * Plan<HD>::kPad + d] = i < limit ? src[(long long)i * stride + d] : 0.f;
  }
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ dq, float* __restrict__ dsum,
                    Strides sq, Strides sk, Strides sv, Strides so, Strides sdo, Strides sdq,
                    int G, int Lq, int Lk, float scale) {
  using P = Plan<HD>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + P::kTileFloats;
  float* Ks = dOs + P::kTileFloats;
  float* Vs = Ks + P::kTileFloats;
  float* Ss = Vs + P::kTileFloats;  // dS: kRows x kTile a warp

  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, kvh = h / G;
  const int q0 = tile * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long bh = (long long)b * H + h;

  stage<HD>(Qs, q + b * sq.b + h * sq.h, sq.l, q0, Lq);
  stage<HD>(dOs, dout + b * sdo.b + h * sdo.h, sdo.l, q0, Lq);
  __syncthreads();

  // D_i = dO_i . O_i (written for the dk/dv kernel) and each row's lse
  const float* Qw = Qs + warp * kRows * P::kPad;
  const float* dOw = dOs + warp * kRows * P::kPad;
  const float* ob = o + b * so.b + h * so.h;
  float Dr[kRows], lr[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + warp * kRows + r;
    float part = 0.f;
    if (i < Lq) {
#pragma unroll
      for (int c = 0; c < P::kCols; ++c) {
        const int d = lane + 32 * c;
        part = fmaf(dOw[r * P::kPad + d], ob[i * so.l + d], part);
      }
    }
    Dr[r] = warp_sum(part);
    lr[r] = i < Lq ? lse[bh * Lq + i] : 0.f;
    if (i < Lq && lane == 0) dsum[bh * Lq + i] = Dr[r];
  }

  float acc[kRows][P::kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < P::kCols; ++c) acc[r][c] = 0.f;

  const int q_last = min(q0 + kTile, Lq) - 1;
  const int k_end = CAUSAL ? min(Lk, q_last + 1) : Lk;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  float* Sw = Ss + warp * kRows * kTile;

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous K/V tile is consumed
    stage<HD>(Ks, kb, sk.l, k0, Lk);
    stage<HD>(Vs, vb, sv.l, k0, Lk);
    __syncthreads();

    // S = q_i . k_j and dP = dO_i . v_j for key j = k0 + lane
    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    const float* kr = Ks + lane * P::kPad;
    const float* vr = Vs + lane * P::kPad;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + d);
      const float4 vv = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(Qw + r * P::kPad + d);
        const float4 oo = *reinterpret_cast<const float4*>(dOw + r * P::kPad + d);
        s[r] = fmaf(qq.x, kk.x, fmaf(qq.y, kk.y, fmaf(qq.z, kk.z, fmaf(qq.w, kk.w, s[r]))));
        dp[r] = fmaf(oo.x, vv.x, fmaf(oo.y, vv.y, fmaf(oo.z, vv.z, fmaf(oo.w, vv.w, dp[r]))));
      }
    }
    const int j = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = q0 + warp * kRows + r;
      const bool keep = j < Lk && (!CAUSAL || j <= i);
      const float p = keep ? expf(fmaf(s[r], scale, -lr[r])) : 0.f;
      Sw[r * kTile + lane] = p * (dp[r] - Dr[r]);
    }
    __syncwarp();

    // dQ_i += dS_ij k_j
#pragma unroll 2
    for (int jj = 0; jj < kTile; jj += 4) {
      float4 ds[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) ds[r] = *reinterpret_cast<const float4*>(Sw + r * kTile + jj);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* krow = Ks + (jj + t) * P::kPad;
#pragma unroll
        for (int c = 0; c < P::kCols; ++c) {
          const float kv = krow[lane + 32 * c];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(lane_of(ds[r], t), kv, acc[r][c]);
        }
      }
    }
    __syncwarp();  // dS of this tile is read before the next tile rewrites it
  }

  float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + warp * kRows + r;
    if (i < Lq) {
#pragma unroll
      for (int c = 0; c < P::kCols; ++c)
        dqb[i * sdq.l + lane + 32 * c] = acc[r][c] * scale;
    }
  }
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      float* __restrict__ dk, float* __restrict__ dv,
                      Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                      int H, int G, int Lq, int Lk, float scale) {
  using P = Plan<HD>;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + P::kTileFloats;
  float* Qs = Vs + P::kTileFloats;
  float* dOs = Qs + P::kTileFloats;
  float* Ps = dOs + P::kTileFloats;  // P: kRows x kTile a warp
  float* Ss = Ps + kTile * kTile;    // dS: the same
  float* lse_s = Ss + kTile * kTile;
  float* D_s = lse_s + kTile;

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kTile;  // under `causal` the first key tiles see the most queries
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  stage<HD>(Ks, k + b * sk.b + kvh * sk.h, sk.l, k0, Lk);
  stage<HD>(Vs, v + b * sv.b + kvh * sv.h, sv.l, k0, Lk);

  float acc_dk[kRows][P::kCols], acc_dv[kRows][P::kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < P::kCols; ++c) acc_dk[r][c] = acc_dv[r][c] = 0.f;

  const float* Kw = Ks + warp * kRows * P::kPad;
  const float* Vw = Vs + warp * kRows * P::kPad;
  float* Pw = Ps + warp * kRows * kTile;
  float* Sw = Ss + warp * kRows * kTile;
  // k0 is a multiple of the query tile, so the causal query tiles start at k0
  const int q_begin = CAUSAL ? k0 : 0;

  for (int hg = 0; hg < G; ++hg) {
    const int h = kvh * G + hg;
    const long long bh = (long long)b * H + h;
    for (int q0 = q_begin; q0 < Lq; q0 += kTile) {
      __syncthreads();  // the previous query tile is consumed (and K, V are staged)
      stage<HD>(Qs, q + b * sq.b + h * sq.h, sq.l, q0, Lq);
      stage<HD>(dOs, dout + b * sdo.b + h * sdo.h, sdo.l, q0, Lq);
      if (tid < kTile) {
        const int i = q0 + tid;
        lse_s[tid] = i < Lq ? lse[bh * Lq + i] : 0.f;
        D_s[tid] = i < Lq ? dsum[bh * Lq + i] : 0.f;
      }
      __syncthreads();

      // S = k_j . q_i and dP = v_j . dO_i for query i = q0 + lane
      float s[kRows], dp[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
      const float* qr = Qs + lane * P::kPad;
      const float* orow = dOs + lane * P::kPad;
#pragma unroll 2
      for (int d = 0; d < HD; d += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(qr + d);
        const float4 oo = *reinterpret_cast<const float4*>(orow + d);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 kk = *reinterpret_cast<const float4*>(Kw + r * P::kPad + d);
          const float4 vv = *reinterpret_cast<const float4*>(Vw + r * P::kPad + d);
          s[r] = fmaf(qq.x, kk.x, fmaf(qq.y, kk.y, fmaf(qq.z, kk.z, fmaf(qq.w, kk.w, s[r]))));
          dp[r] = fmaf(oo.x, vv.x, fmaf(oo.y, vv.y, fmaf(oo.z, vv.z, fmaf(oo.w, vv.w, dp[r]))));
        }
      }
      const int i = q0 + lane;
      const float lse_i = lse_s[lane], D_i = D_s[lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = k0 + warp * kRows + r;
        const bool keep = i < Lq && j < Lk && (!CAUSAL || j <= i);
        const float p = keep ? expf(fmaf(s[r], scale, -lse_i)) : 0.f;
        Pw[r * kTile + lane] = p;
        Sw[r * kTile + lane] = p * (dp[r] - D_i);
      }
      __syncwarp();

      // dV_j += P_ij dO_i and dK_j += dS_ij q_i
#pragma unroll 1
      for (int jj = 0; jj < kTile; jj += 4) {
        float4 p4[kRows], s4[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          p4[r] = *reinterpret_cast<const float4*>(Pw + r * kTile + jj);
          s4[r] = *reinterpret_cast<const float4*>(Sw + r * kTile + jj);
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float* drow = dOs + (jj + t) * P::kPad;
          const float* qrow = Qs + (jj + t) * P::kPad;
#pragma unroll
          for (int c = 0; c < P::kCols; ++c) {
            const float dov = drow[lane + 32 * c], qv = qrow[lane + 32 * c];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              acc_dv[r][c] = fmaf(lane_of(p4[r], t), dov, acc_dv[r][c]);
              acc_dk[r][c] = fmaf(lane_of(s4[r], t), qv, acc_dk[r][c]);
            }
          }
        }
      }
      __syncwarp();  // P and dS of this tile are read before the next tile rewrites them
    }
  }

  float* dkb = dk + b * sdk.b + kvh * sdk.h;
  float* dvb = dv + b * sdv.b + kvh * sdv.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = k0 + warp * kRows + r;
    if (j < Lk) {
#pragma unroll
      for (int c = 0; c < P::kCols; ++c) {
        dkb[j * sdk.l + lane + 32 * c] = acc_dk[r][c] * scale;
        dvb[j * sdv.l + lane + 32 * c] = acc_dv[r][c];
      }
    }
  }
}


// ---------------------------------------------------------------------------
// bf16: the same two passes on the tensor cores (mma.sync m16n8k16, f32 sums)
// ---------------------------------------------------------------------------

constexpr int kQRows = 64;   // dq: query rows a block, 16 a warp
constexpr int kKTile = 64;   // dq: keys a tile
constexpr int kKRows = 64;   // dk/dv: keys a block, 16 a warp
constexpr int kQTile = 32;   // dk/dv: queries a tile

template <int HD>
struct MmaPlan {
  static_assert(HD % 16 == 0, "hd is a multiple of the mma depth");
  static constexpr int kLd = HD + 8;        // smem row stride in bf16 values (rows 16-byte aligned)
  static constexpr int kKSteps = HD / 16;   // depth steps over the head dim
  static constexpr int kNBlocks = HD / 8;   // 8-column blocks of dq, dk, dv
  static constexpr int kVecs = HD / 8;      // 16-byte chunks a row
  static constexpr size_t kDqBytes = (size_t)(2 * kQRows + 2 * kKTile) * kLd * 2 + 2 * kQRows * 4;
  static constexpr size_t kKvBytes = (size_t)(2 * kKRows + 2 * kQTile) * kLd * 2 + 2 * kQTile * 4;
};

// D = A B + D for a 16x16 A (row-major fragments), a 16x8 B (column-major) and
// a 16x8 f32 accumulator: with g = lane / 4 and t = lane % 4, a thread holds A
// rows g, g+8 at columns 2t, 2t+1 (+8), B column g at rows 2t, 2t+1 (+8), and
// D rows g, g+8 at columns 2t, 2t+1.
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

// The A fragment of rows r, r+8 and depth columns c, c+1 (+8) of a row-major
// bf16 tile in shared memory.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int r, int c) {
  const __nv_bfloat16* base = tile + r * LD + c;
  a[0] = ld32(base);
  a[1] = ld32(base + 8 * LD);
  a[2] = ld32(base + 8);
  a[3] = ld32(base + 8 * LD + 8);
}

// An f32 value split into a bf16 high part and the bf16 of what is left: the
// product of an input with both parts, summed in f32, keeps ~16 bits of it.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

// acc (16 x HD) += A (16 x 16 f32, as two accumulator blocks c0, c1 in their
// register layout, split into bf16 hi and lo parts) times rows [k0, k0 + 16) of
// a row-major bf16 tile (depth x HD) in shared memory.
template <int HD>
__device__ __forceinline__ void acc_split_product(float (&acc)[HD / 8][4], const float (&c0)[4],
                                                  const float (&c1)[4],
                                                  const __nv_bfloat16* tile, int k0, int g,
                                                  int t) {
  using P = MmaPlan<HD>;
  uint32_t hi[4], lo[4];
  split_pair(c0[0], c0[1], hi[0], lo[0]);
  split_pair(c0[2], c0[3], hi[1], lo[1]);
  split_pair(c1[0], c1[1], hi[2], lo[2]);
  split_pair(c1[2], c1[3], hi[3], lo[3]);
  const __nv_bfloat16* r0 = tile + (k0 + 2 * t) * P::kLd + g;
#pragma unroll
  for (int nb = 0; nb < P::kNBlocks; ++nb) {
    const __nv_bfloat16* c = r0 + nb * 8;
    const uint32_t b0 = pack_bf16(c[0], c[P::kLd]);
    const uint32_t b1 = pack_bf16(c[8 * P::kLd], c[9 * P::kLd]);
    mma_bf16(acc[nb], hi, b0, b1);
    mma_bf16(acc[nb], lo, b0, b1);
  }
}

// Rows [r0, r0 + rows) of one (batch, head) slice into shared memory, 16 bytes a
// copy; rows at or past `limit` are zeros.
template <int HD>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                           long long stride, int r0, int rows, int limit) {
  using P = MmaPlan<HD>;
  for (int idx = threadIdx.x; idx < rows * P::kVecs; idx += kThreads) {
    const int r = idx / P::kVecs, c = idx - r * P::kVecs;
    const int i = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (i < limit) val = __ldg(reinterpret_cast<const uint4*>(src + (long long)i * stride + c * 8));
    *reinterpret_cast<uint4*>(dst + r * P::kLd + c * 8) = val;
  }
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        __nv_bfloat16* __restrict__ dq, float* __restrict__ dsum, Strides sq,
                        Strides sk, Strides sv, Strides so, Strides sdo, Strides sdq, int G,
                        int Lq, int Lk, float scale) {
  using P = MmaPlan<HD>;
  extern __shared__ uint4 smem16[];
  __nv_bfloat16* Qt = reinterpret_cast<__nv_bfloat16*>(smem16);
  __nv_bfloat16* dOt = Qt + kQRows * P::kLd;
  __nv_bfloat16* Kt = dOt + kQRows * P::kLd;
  __nv_bfloat16* Vt = Kt + kKTile * P::kLd;
  float* row_lse = reinterpret_cast<float*>(Vt + kKTile * P::kLd);
  float* row_D = row_lse + kQRows;

  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, kvh = h / G;
  const int q0 = tile * kQRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * H + h;

  stage_bf16<HD>(Qt, q + b * sq.b + h * sq.h, sq.l, q0, kQRows, Lq);
  stage_bf16<HD>(dOt, dout + b * sdo.b + h * sdo.h, sdo.l, q0, kQRows, Lq);
  __syncthreads();
  // D_i = dO_i . O_i for the warp's 16 rows (written for the dk/dv kernel) and
  // each row's lse, kept in shared memory for the fragments' rows
  const __nv_bfloat16* ob = o + b * so.b + h * so.h;
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int i = q0 + r;
    float part = 0.f;
    if (i < Lq) {
#pragma unroll
      for (int c = 0; c < HD / 32; ++c) {
        const int d = lane + 32 * c;
        part = fmaf(__bfloat162float(dOt[r * P::kLd + d]), __bfloat162float(ob[i * so.l + d]), part);
      }
    }
    part = warp_sum(part);
    if (lane == 0) {
      row_D[r] = part;
      row_lse[r] = i < Lq ? lse[bh * Lq + i] : 0.f;
      if (i < Lq) dsum[bh * Lq + i] = part;
    }
  }
  __syncthreads();
  const int lr = warp * 16 + g;  // this thread's rows: lr, lr + 8 (block-local)
  const float lse_r[2] = {row_lse[lr], row_lse[lr + 8]};
  const float D_r[2] = {row_D[lr], row_D[lr + 8]};

  float acc[P::kNBlocks][4];
#pragma unroll
  for (int nb = 0; nb < P::kNBlocks; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  const int q_last = min(q0 + kQRows, Lq) - 1;
  const int key_end = CAUSAL ? min(Lk, q_last + 1) : Lk;
  const __nv_bfloat16* kb = k + b * sk.b + kvh * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + kvh * sv.h;

  for (int kt0 = 0; kt0 < key_end; kt0 += kKTile) {
    __syncthreads();  // the previous K/V tile is consumed
    stage_bf16<HD>(Kt, kb, sk.l, kt0, kKTile, Lk);
    stage_bf16<HD>(Vt, vb, sv.l, kt0, kKTile, Lk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the warp's 16 rows and the tile's 64 keys
    float sc[kKTile / 8][4], dpv[kKTile / 8][4];
#pragma unroll
    for (int nb = 0; nb < kKTile / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = dpv[nb][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < P::kKSteps; ++ks) {
      uint32_t aq[4], ado[4];
      load_a<P::kLd>(aq, Qt, warp * 16 + g, ks * 16 + 2 * t);
      load_a<P::kLd>(ado, dOt, warp * 16 + g, ks * 16 + 2 * t);
#pragma unroll
      for (int nb = 0; nb < kKTile / 8; ++nb) {
        const __nv_bfloat16* krow = Kt + (nb * 8 + g) * P::kLd + ks * 16 + 2 * t;
        const __nv_bfloat16* vrow = Vt + (nb * 8 + g) * P::kLd + ks * 16 + 2 * t;
        mma_bf16(sc[nb], aq, ld32(krow), ld32(krow + 8));
        mma_bf16(dpv[nb], ado, ld32(vrow), ld32(vrow + 8));
      }
    }
    // P = exp(S scale - lse), dS = P (dP - D), kept in sc
#pragma unroll
    for (int nb = 0; nb < kKTile / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + lr + (e >> 1) * 8;
        const int col = kt0 + nb * 8 + 2 * t + (e & 1);
        const bool kept = col < Lk && (!CAUSAL || col <= row);
        const float pr = kept ? expf(fmaf(sc[nb][e], scale, -lse_r[e >> 1])) : 0.f;
        sc[nb][e] = pr * (dpv[nb][e] - D_r[e >> 1]);
      }
    // dQ += dS K, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < kKTile / 16; ++kk)
      acc_split_product<HD>(acc, sc[2 * kk], sc[2 * kk + 1], Kt, kk * 16, g, t);
  }

  __nv_bfloat16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + lr + r * 8;
    if (row < Lq) {
#pragma unroll
      for (int nb = 0; nb < P::kNBlocks; ++nb)
        *reinterpret_cast<uint32_t*>(dqb + row * sdq.l + nb * 8 + 2 * t) =
            pack_bf16(acc[nb][2 * r] * scale, acc[nb][2 * r + 1] * scale);
    }
  }
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                          Strides sdo, Strides sdk, Strides sdv, int H, int G, int Lq, int Lk,
                          float scale) {
  using P = MmaPlan<HD>;
  extern __shared__ uint4 smem16[];
  __nv_bfloat16* Kt = reinterpret_cast<__nv_bfloat16*>(smem16);
  __nv_bfloat16* Vt = Kt + kKRows * P::kLd;
  __nv_bfloat16* Qt = Vt + kKRows * P::kLd;
  __nv_bfloat16* dOt = Qt + kQTile * P::kLd;
  float* col_lse = reinterpret_cast<float*>(dOt + kQTile * P::kLd);
  float* col_D = col_lse + kQTile;

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int kb0 = blockIdx.x * kKRows;  // under `causal` the first key tiles see the most queries
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  stage_bf16<HD>(Kt, k + b * sk.b + kvh * sk.h, sk.l, kb0, kKRows, Lk);
  stage_bf16<HD>(Vt, v + b * sv.b + kvh * sv.h, sv.l, kb0, kKRows, Lk);

  float dk_acc[P::kNBlocks][4], dv_acc[P::kNBlocks][4];
#pragma unroll
  for (int nb = 0; nb < P::kNBlocks; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nb][e] = dv_acc[nb][e] = 0.f;

  const int kr = warp * 16 + g;  // this thread's keys: kr, kr + 8 (block-local)
  // kb0 is a multiple of the query tile, so the causal query tiles start at kb0
  const int first_q = CAUSAL ? kb0 : 0;

  for (int head = 0; head < G; ++head) {
    const int h = kvh * G + head;
    const long long bh = (long long)b * H + h;
    for (int qt0 = first_q; qt0 < Lq; qt0 += kQTile) {
      __syncthreads();  // the previous query tile is consumed (and K, V are staged)
      stage_bf16<HD>(Qt, q + b * sq.b + h * sq.h, sq.l, qt0, kQTile, Lq);
      stage_bf16<HD>(dOt, dout + b * sdo.b + h * sdo.h, sdo.l, qt0, kQTile, Lq);
      if (tid < kQTile) {
        const int i = qt0 + tid;
        col_lse[tid] = i < Lq ? lse[bh * Lq + i] : 0.f;
        col_D[tid] = i < Lq ? dsum[bh * Lq + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys and the tile's 32 queries
      float st[kQTile / 8][4], dpt[kQTile / 8][4];
#pragma unroll
      for (int nb = 0; nb < kQTile / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nb][e] = dpt[nb][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < P::kKSteps; ++ks) {
        uint32_t ak[4], av[4];
        load_a<P::kLd>(ak, Kt, kr, ks * 16 + 2 * t);
        load_a<P::kLd>(av, Vt, kr, ks * 16 + 2 * t);
#pragma unroll
        for (int nb = 0; nb < kQTile / 8; ++nb) {
          const __nv_bfloat16* qrow = Qt + (nb * 8 + g) * P::kLd + ks * 16 + 2 * t;
          const __nv_bfloat16* orow = dOt + (nb * 8 + g) * P::kLd + ks * 16 + 2 * t;
          mma_bf16(st[nb], ak, ld32(qrow), ld32(qrow + 8));
          mma_bf16(dpt[nb], av, ld32(orow), ld32(orow + 8));
        }
      }
      // P^T in st, dS^T = P^T (dP^T - D) in dpt
#pragma unroll
      for (int nb = 0; nb < kQTile / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kb0 + kr + (e >> 1) * 8;
          const int qc = nb * 8 + 2 * t + (e & 1);
          const bool kept = qt0 + qc < Lq && key < Lk && (!CAUSAL || key <= qt0 + qc);
          const float pt = kept ? expf(fmaf(st[nb][e], scale, -col_lse[qc])) : 0.f;
          st[nb][e] = pt;
          dpt[nb][e] = pt * (dpt[nb][e] - col_D[qc]);
        }
      // dV += P^T dO and dK += dS^T Q, 16 queries a step
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk) {
        acc_split_product<HD>(dv_acc, st[2 * kk], st[2 * kk + 1], dOt, kk * 16, g, t);
        acc_split_product<HD>(dk_acc, dpt[2 * kk], dpt[2 * kk + 1], Qt, kk * 16, g, t);
      }
    }
  }

  __nv_bfloat16* dkb = dk + b * sdk.b + kvh * sdk.h;
  __nv_bfloat16* dvb = dv + b * sdv.b + kvh * sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kb0 + kr + r * 8;
    if (key < Lk) {
#pragma unroll
      for (int nb = 0; nb < P::kNBlocks; ++nb) {
        *reinterpret_cast<uint32_t*>(dkb + key * sdk.l + nb * 8 + 2 * t) =
            pack_bf16(dk_acc[nb][2 * r] * scale, dk_acc[nb][2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvb + key * sdv.l + nb * 8 + 2 * t) =
            pack_bf16(dv_acc[nb][2 * r], dv_acc[nb][2 * r + 1]);
      }
    }
  }
}

// st: (batch, head, position) strides of q, k, v, o, dO, dq, dk, dv in that order.
template <int HD, bool CAUSAL>
int launch_mma(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dq, void* dk, void* dv, float* dsum, int B, int H, int KV,
               int Lq, int Lk, const long long* st, float scale, cudaStream_t stream) {
  using P = MmaPlan<HD>;
  using T = __nv_bfloat16;
  const auto dq_mma = flash_bwd_dq_mma_kernel<HD, CAUSAL>;
  const auto dkdv_mma = flash_bwd_dkdv_mma_kernel<HD, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(dq_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)P::kDqBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)P::kKvBytes);
  if (err != cudaSuccess) return (int)err;
  Strides s[8];
  for (int i = 0; i < 8; ++i) s[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  const int G = H / KV;
  dq_mma<<<dim3((Lq + kQRows - 1) / kQRows, H, B), kThreads, P::kDqBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dq), dsum,
      s[0], s[1], s[2], s[3], s[4], s[5], G, Lq, Lk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_mma<<<dim3((Lk + kKRows - 1) / kKRows, KV, B), kThreads, P::kKvBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv), s[0],
      s[1], s[2], s[4], s[6], s[7], H, G, Lq, Lk, scale);
  return (int)cudaGetLastError();
}

template <int HD, bool CAUSAL>
int launch_f32(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dq, void* dk, void* dv, float* dsum, int B, int H, int KV,
               int Lq, int Lk, const long long* st, float scale, cudaStream_t stream) {
  using P = Plan<HD>;
  const auto dq_kern = flash_bwd_dq_kernel<HD, CAUSAL>;
  const auto dkdv_kern = flash_bwd_dkdv_kernel<HD, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)P::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)P::kBytes);
  if (err != cudaSuccess) return (int)err;
  Strides s[8];
  for (int i = 0; i < 8; ++i) s[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  const int G = H / KV;
  using F = const float*;
  dq_kern<<<dim3((Lq + kTile - 1) / kTile, H, B), kThreads, P::kBytes, stream>>>(
      static_cast<F>(q), static_cast<F>(k), static_cast<F>(v), static_cast<F>(o),
      static_cast<F>(dout), lse, static_cast<float*>(dq), dsum, s[0], s[1], s[2], s[3], s[4],
      s[5], G, Lq, Lk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kern<<<dim3((Lk + kTile - 1) / kTile, KV, B), kThreads, P::kBytes, stream>>>(
      static_cast<F>(q), static_cast<F>(k), static_cast<F>(v), static_cast<F>(dout), lse, dsum,
      static_cast<float*>(dk), static_cast<float*>(dv), s[0], s[1], s[2], s[4], s[6], s[7], H, G,
      Lq, Lk, scale);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, o, dout, dq, dk, dv alike; hd
// must be 128. lse: (B, H, Lq) f32 from flash_attention_fwd; dsum: a (B, H, Lq)
// f32 workspace (D, written by the first kernel and read by the second).
// strides holds 24 element strides: (batch, head, position) of q, k, v, o,
// dout, dq, dk and dv in that order. Launches two kernels on `stream`; returns
// cudaGetLastError() after them.
extern "C" int flash_attention_bwd(int dtype, int hd, int causal, const void* q, const void* k,
                                   const void* v, const void* o, const void* dout,
                                   const float* lse, void* dq, void* dk, void* dv, float* dsum,
                                   int B, int H, int KV, int Lq, int Lk,
                                   const long long* strides, float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Lq < 1 || Lk < 1 || B > 65535 ||
      H > 65535 || hd != 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return causal ? launch_f32<128, true>(q, k, v, o, dout, lse, dq, dk, dv, dsum, B, H, KV,
                                          Lq, Lk, strides, scale, s)
                  : launch_f32<128, false>(q, k, v, o, dout, lse, dq, dk, dv, dsum, B, H, KV,
                                           Lq, Lk, strides, scale, s);
  // the tensor-core path reads rows in 16-byte copies and writes pairs
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) && aligned16(dout) &&
        aligned16(dq) && aligned16(dk) && aligned16(dv)))
    return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i < 24; ++i)
    if (strides[i] % 8 != 0) return (int)cudaErrorMisalignedAddress;
  return causal ? launch_mma<128, true>(q, k, v, o, dout, lse, dq, dk, dv, dsum, B, H, KV, Lq,
                                        Lk, strides, scale, s)
                : launch_mma<128, false>(q, k, v, o, dout, lse, dq, dk, dv, dsum, B, H, KV, Lq,
                                         Lk, strides, scale, s);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
