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
// 989 TFLOP/s. Both paths recompute S and dP in each of their two passes, and
// the bf16 path splits P and dS into two bf16 parts for their products, so the
// work done is 20 hd flops a pair in bf16 (171.8 GFLOP at the flow cell, 0.174
// ms at the peak; 14 in f32).
//
// What the design does about it. Two passes in one call, dq first (it also
// writes each row's D, and in bf16 its lse, to a workspace), then dk/dv; each
// block owns its outputs and nothing is added across blocks by atomics, so two
// runs give the same bits. Under `causal` dq stops at its tile's last row and
// dk/dv start at the diagonal; ragged L is masked or zero-filled, so any L
// works. Strides are arguments (unit stride on hd), as in the forward.
//  * bf16 (hd 128: the dense families' training path; hd 80: zamba2-2.7b's
//    shared attention; hd 64: whisper-medium's attention): Hopper's TMA and
//    wgmma in both passes, built as the forward's kernel is
//    (flash_attention.cu): blocks of 384 threads, one producer warpgroup in
//    which a single thread issues TMA tensor loads into a ring of stages with
//    "full" and "empty" mbarriers, and two consumer warpgroups (setmaxnreg
//    24 / 240). The head dim is cut into column chunks, one TMA box and one
//    swizzled tile each (Chunks<HD>): 64 columns under the 128-byte swizzle
//    at hd 64 and 128, 16 under the 32-byte swizzle at hd 80, whose 160-byte
//    rows fit no wider one. Each pass's ring holds 128 KB: 4 stages at hd
//    128, 6 at 80, 8 at 64. P and dS enter every product as a bf16 high part
//    and the bf16 of the rest (one bf16 part would lose their low bits; two
//    keep ~16), each part its own wgmma over the same B tile.
//    dq: one block a (128-query tile, head, batch), heaviest causal tiles
//    first, 64 rows a consumer warpgroup; Q and dO load once, 64-key K/V
//    tiles stream through the ring. A consumer computes S = Q K^T and dP = dO
//    V^T with wgmma m64n64k16 over HD / 16 depth steps (both operands in
//    shared memory, K-major), P = 2^(S scale log2 e - lse log2 e) and dS = P
//    (dP - D) on the accumulator registers, and dQ += dS K with wgmma
//    m64n{HD}k16, dS the register A operand and K read MN-major.
//    Software-pipelined: one turn issues dQ of tile t and S, dP of tile t +
//    1, and the two warpgroups take turns (named barriers), so each one's
//    elementwise work overlaps the other's products. D_i = dO_i . O_i comes
//    from dO in shared memory and O rows loaded at the block's start (4
//    columns a lane, HD / 4 lanes), while the first products run; dQ leaves
//    through the warpgroup's own Q rows in shared memory, in 16-byte stores.
//    dk/dv: one block a (64-key tile, KV head, batch), first key tiles
//    first; K and V load once, and the 64-query Q/dO tiles of the group's
//    heads stream through the ring with each tile's lse and D (1-d bulk
//    copies from the row workspace, padded to 128 rows with lse = +inf, so P
//    = 0 past Lq without a mask). The consumer warpgroups share the 64 keys
//    and split the work: warpgroup 0 computes S^T = K Q^T, P^T, and dV += P^T
//    dO; warpgroup 1 dP^T = V dO^T, dS^T = P^T (dP^T - D) from the P^T that
//    warpgroup 0 hands over in shared memory (double-buffered, named
//    barriers), and dK += dS^T Q. Each keeps its K or V as register A operands
//    (ldmatrix through the swizzle, once), so S^T and dP^T are m64n64k16 with
//    only Q or dO read from shared memory; dV and dK are m64n{HD}k16 with dO
//    or Q read MN-major, summed in f32 registers over the group's heads,
//    software-pipelined as in dq. Waiting for P^T keeps warpgroup 1 behind
//    warpgroup 0, so their elementwise work falls between each other's
//    products. (The flow cell gives 256 such blocks, their work 16:1 under
//    the causal mask, heaviest first: within 3% of an even spread over 132
//    SMs.) Without a dk/dv gradient (whisper's cross-attention under
//    distillation, where only q depends on the solver) the call runs the dq
//    pass alone.
//  * f32 at hd 64, 80 and 128: the CUDA cores, exact f32 products. dq: one
//    block of 4 warps a (32-query tile, head, batch); lane j takes key j of a
//    32-key tile, each warp 8 query rows; S and dP from one pass over the head
//    dim (float4 reads of rows padded to hd + 4 floats, so the lanes' rows
//    fall in different banks), dS through shared memory into dQ. dk/dv: one
//    block a (32-key tile, KV head, batch), with the roles turned: lane j
//    takes query j, each warp 8 keys, P and dS go through shared memory into
//    dV and dK. Into dQ, dK and dV each lane accumulates columns j, j + 32,
//    ... of the warp's 8 rows at hd 64 and 128; at hd 80 each half-warp takes
//    4 of the rows and lane j % 16 columns j % 16 + 16 c (c < 5), so no lane
//    idles.
// Every sum is f32, and only dq, dk, dv are rounded to the input type.
#include <cuda.h>
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

// Shared-memory plan and lane map for one head dim: four (kTile x kPad) f32
// tiles, two (kTile x kTile) tiles of P / dS (kRows rows a warp), and kTile lse
// and D values. The products into dQ, dK and dV give each lane kRowsLane of its
// warp's kRows rows and kCols columns, col0 + kLanesRow c: at hd 64 and 128
// every lane takes all 8 rows and columns lane, lane + 32, ...; at hd 80
// (not a multiple of 32) the two half-warps take 4 rows each and lane % 16
// takes columns lane % 16 + 16 c, c < 5, so no lane idles.
template <int HD>
struct Plan {
  static_assert(HD % 16 == 0, "a half-warp spans a whole number of column groups");
  static constexpr int kPad = HD + 4;       // row stride in floats
  static constexpr int kSplit = HD % 32 == 0 ? 1 : 2;  // row groups a warp
  static constexpr int kLanesRow = 32 / kSplit;        // lanes that share a row group
  static constexpr int kRowsLane = kRows / kSplit;     // rows a lane accumulates
  static constexpr int kCols = HD / kLanesRow;         // columns a lane accumulates
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
  const int row0 = (lane / P::kLanesRow) * P::kRowsLane;  // the lane's rows in its warp
  const int col0 = lane % P::kLanesRow;
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
    if (i < Lq)
      for (int d = lane; d < HD; d += 32)
        part = fmaf(dOw[r * P::kPad + d], ob[i * so.l + d], part);
    Dr[r] = warp_sum(part);
    lr[r] = i < Lq ? lse[bh * Lq + i] : 0.f;
    if (i < Lq && lane == 0) dsum[bh * Lq + i] = Dr[r];
  }

  float acc[P::kRowsLane][P::kCols];
#pragma unroll
  for (int r = 0; r < P::kRowsLane; ++r)
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

    // dQ_i += dS_ij k_j over the lane's rows and columns
#pragma unroll 2
    for (int jj = 0; jj < kTile; jj += 4) {
      float4 ds[P::kRowsLane];
#pragma unroll
      for (int r = 0; r < P::kRowsLane; ++r)
        ds[r] = *reinterpret_cast<const float4*>(Sw + (row0 + r) * kTile + jj);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* krow = Ks + (jj + t) * P::kPad + col0;
#pragma unroll
        for (int c = 0; c < P::kCols; ++c) {
          const float kv = krow[P::kLanesRow * c];
#pragma unroll
          for (int r = 0; r < P::kRowsLane; ++r)
            acc[r][c] = fmaf(lane_of(ds[r], t), kv, acc[r][c]);
        }
      }
    }
    __syncwarp();  // dS of this tile is read before the next tile rewrites it
  }

  float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < P::kRowsLane; ++r) {
    const int i = q0 + warp * kRows + row0 + r;
    if (i < Lq) {
#pragma unroll
      for (int c = 0; c < P::kCols; ++c)
        dqb[i * sdq.l + col0 + P::kLanesRow * c] = acc[r][c] * scale;
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
  const int row0 = (lane / P::kLanesRow) * P::kRowsLane;
  const int col0 = lane % P::kLanesRow;

  stage<HD>(Ks, k + b * sk.b + kvh * sk.h, sk.l, k0, Lk);
  stage<HD>(Vs, v + b * sv.b + kvh * sv.h, sv.l, k0, Lk);

  float acc_dk[P::kRowsLane][P::kCols], acc_dv[P::kRowsLane][P::kCols];
#pragma unroll
  for (int r = 0; r < P::kRowsLane; ++r)
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

      // dV_j += P_ij dO_i and dK_j += dS_ij q_i over the lane's rows and columns
#pragma unroll 1
      for (int jj = 0; jj < kTile; jj += 4) {
        float4 p4[P::kRowsLane], s4[P::kRowsLane];
#pragma unroll
        for (int r = 0; r < P::kRowsLane; ++r) {
          p4[r] = *reinterpret_cast<const float4*>(Pw + (row0 + r) * kTile + jj);
          s4[r] = *reinterpret_cast<const float4*>(Sw + (row0 + r) * kTile + jj);
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float* drow = dOs + (jj + t) * P::kPad + col0;
          const float* qrow = Qs + (jj + t) * P::kPad + col0;
#pragma unroll
          for (int c = 0; c < P::kCols; ++c) {
            const float dov = drow[P::kLanesRow * c], qv = qrow[P::kLanesRow * c];
#pragma unroll
            for (int r = 0; r < P::kRowsLane; ++r) {
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
  for (int r = 0; r < P::kRowsLane; ++r) {
    const int j = k0 + warp * kRows + row0 + r;
    if (j < Lk) {
#pragma unroll
      for (int c = 0; c < P::kCols; ++c) {
        dkb[j * sdk.l + col0 + P::kLanesRow * c] = acc_dk[r][c] * scale;
        dvb[j * sdv.l + col0 + P::kLanesRow * c] = acc_dv[r][c];
      }
    }
  }
}


// ---------------------------------------------------------------------------
// bf16: the same two passes on Hopper's TMA and wgmma
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;      // the producer warpgroup, then two consumers
constexpr int kConsumerWarps = 8;    // each releases a stage once it is done with it
constexpr int kTurnBarrier = 1;      // dq: named barriers 1, 2 give the consumers their turns
constexpr int kSmemLimit = 232448;   // a block's shared memory on the H100
constexpr int kRingBytes = 131072;   // a pass's ring of stages: 4 at hd 128, 6 at 80, 8 at 64
constexpr int kDqRows = 128;         // dq: query rows a block, 64 a consumer warpgroup
constexpr int kDqKeys = 64;          // dq: keys a K/V tile
constexpr int kKvRows = 64;          // dk/dv: keys a block, shared by the consumer warpgroups
constexpr int kKvQueries = 64;       // dk/dv: queries a Q/dO tile
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kDqKeys == 64 && kKvQueries == 64, "the SS products are m64n64k16");

// The head dim in column chunks, one TMA box and one swizzled tile each: 64
// columns under the 128-byte swizzle at hd 64 and 128, 16 under the 32-byte
// swizzle at hd 80 (160-byte rows fit no wider swizzle), as in the forward.
// A chunk of a tile of `rows` rows is (rows x kCW) bf16 as the box lays it
// down; its 8-row groups of kGroupBytes repeat the swizzle pattern.
template <int HD>
struct Chunks {
  static constexpr int kCW = HD % 64 == 0 ? 64 : 16;
  static constexpr int kChunks = HD / kCW;
  static constexpr int kRowBytes = kCW * 2;                 // 128 or 32: the swizzle span
  static constexpr int kGroupBytes = 8 * kRowBytes;
  static constexpr uint64_t kLayout = kCW == 64 ? 1 : 3;    // descriptor code: 128B or 32B swizzle
  static_assert(HD == 64 || HD == 80 || HD == 128, "the head dims the products are built for");
  static constexpr __host__ __device__ int tile_bytes(int rows) { return rows * HD * 2; }
  static constexpr __host__ __device__ int chunk_bytes(int rows) { return rows * kRowBytes; }
  // Byte offset of (row, col) in a tile of `rows` rows: the swizzle XORs the
  // 16-byte unit of a chunk row with the address bits above the span's 128
  // bytes (row % 8 at 128 bytes a row, (row / 4) % 2 at 32).
  static __device__ __forceinline__ uint32_t offset(int rows, int row, int col) {
    const uint32_t in = row * kRowBytes + (col % kCW) * 2;
    return (col / kCW) * chunk_bytes(rows) + (in ^ ((in >> 3) & (kRowBytes - 16)));
  }
};

// dq pass: Q and dO (128 rows each, loaded once), then kStages of (K tile, V tile).
template <int HD>
struct DqPlan : Chunks<HD> {
  static constexpr int kQBytes = Chunks<HD>::tile_bytes(kDqRows);
  static constexpr int kTileBytes = Chunks<HD>::tile_bytes(kDqKeys);   // one K or one V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;
  static constexpr int kBarOffset = 2 * kQBytes + kStages * kStageBytes;
  // + 1024: the dynamic window is aligned up to the swizzle's 1024 bytes
  static constexpr size_t kBytes = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
  static_assert(kBytes <= kSmemLimit, "the plan fits one block's shared memory");
};

// dk/dv pass: K and V (64 rows each, loaded once), then kStages of (Q tile,
// dO tile), then each stage's 64 lse and D values, then two buffers in which
// one consumer warpgroup hands P^T (64 x 64 f32) to the other, then the
// mbarriers.
template <int HD>
struct KvPlan : Chunks<HD> {
  static constexpr int kKBytes = Chunks<HD>::tile_bytes(kKvRows);
  static constexpr int kTileBytes = Chunks<HD>::tile_bytes(kKvQueries);  // one Q or one dO tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;
  static constexpr int kRowsOffset = 2 * kKBytes + kStages * kStageBytes;
  static constexpr int kRowsBytes = 2 * kKvQueries * 4;       // lse, then D
  static constexpr int kPOffset = kRowsOffset + kStages * kRowsBytes;
  static constexpr int kPBytes = kKvRows * kKvQueries * 4;    // one buffer
  static constexpr int kBarOffset = kPOffset + 2 * kPBytes;
  static constexpr size_t kBytes = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
  static_assert(kBytes <= kSmemLimit, "the plan fits one block's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of the given parity has completed. A phase
// that never completes traps after ~2^34 clocks (~9 s) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = -1;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start < 0) start = clock64();
    else if (clock64() - start > (1LL << 34)) __trap();
  }
}

// One TMA box of a 4-d map (hd, position, head, batch) into shared memory;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// A contiguous run of `bytes` (a multiple of 16, both ends 16-byte aligned)
// into shared memory, counted on `bar` like a TMA box.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of an HD-wide operand: start address,
// leading and stride byte offsets (16-byte units), the plan's swizzle code in
// the top two bits. K-major swizzled operands ignore the leading offset;
// MN-major ones step by it from one kCW-column chunk to the next. The stride
// offset steps from one 8-row group to the next.
template <int HD>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  using C = Chunks<HD>;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(C::kGroupBytes >> 4) << 32) | (C::kLayout << 62);
}

// The K-major operand of an SS product: 64 rows from `row0` of a tile of
// `rows` rows, head-dim columns [16 ks, 16 ks + 16) (at hd 80 one whole chunk).
template <int HD>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int row0, int ks) {
  using C = Chunks<HD>;
  return smem_desc<HD>(tile + (ks * 16 / C::kCW) * C::chunk_bytes(rows) + row0 * C::kRowBytes +
                           (ks * 16 % C::kCW) * 2,
                       16);
}

// The MN-major B operand of an RS product: rows [16 kk, 16 kk + 16) of a tile
// of `rows` rows (the depth), all hd columns (N).
template <int HD>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows, int kk) {
  using C = Chunks<HD>;
  return smem_desc<HD>(tile + kk * 16 * C::kRowBytes, C::chunk_bytes(rows));
}

// Named barrier over the two consumer warpgroups (256 threads): one waits,
// the other arrives (a turn handed over, a P^T buffer written or read).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// The two consumer warpgroups take turns issuing their products (as the
// forward's do), so one's elementwise work overlaps the other's products on
// the tensor cores. Both take the same number of turns; warpgroup 0 has the
// first, and after its loop takes one more (issuing nothing), which matches
// warpgroup 1's last hand-over.
struct Turns {
  int cw;
  __device__ __forceinline__ explicit Turns(int cw_) : cw(cw_) {
    if (cw == 1) named_arrive(kTurnBarrier);
  }
  __device__ __forceinline__ void take() { named_sync(kTurnBarrier + cw); }
  __device__ __forceinline__ void hand_over() { named_arrive(kTurnBarrier + 1 - cw); }
  __device__ __forceinline__ void finish() {
    if (cw == 0) named_sync(kTurnBarrier);
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The wgmma asm statements name their accumulators as outputs, so the compiler
// takes them for ready when the asm retires; this pins every read after the
// wait_group that really completes them. The register A operands are read
// asynchronously too: the same fence keeps them live and untouched until then.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Accumulator layout of m64nNk16 (f32): warp w of the warpgroup holds rows
// 16w + lane/4 (registers 4j, 4j+1) and 16w + lane/4 + 8 (4j+2, 4j+3) at columns
// 8j + 2 (lane % 4) and the next one. The register A operand of a product over
// those columns as its depth takes the same rows: for depth step kk, register
// r of the four is the pair (8 kk + 2r, 8 kk + 2r + 1) of the accumulator.
// D (64 x 64, f32) {=, +=} A (64 x 16, smem) B (16 x 64, smem), both K-major.
// The first depth step (ACC false) writes D without reading it: its registers
// are outputs only, so no other instruction defines them while earlier
// products are in flight (ptxas would serialise every wgmma, C7515).
#define REPRO_WGMMA_SS_N64(CONSTRAINT, SCALE_D)                                               \
  asm volatile(                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                                \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"     \
      " %32, %33, p, 1, 1, 0, 0;\n}\n"                                                       \
      : CONSTRAINT(d[0]), CONSTRAINT(d[1]), CONSTRAINT(d[2]), CONSTRAINT(d[3]),             \
        CONSTRAINT(d[4]), CONSTRAINT(d[5]), CONSTRAINT(d[6]), CONSTRAINT(d[7]),             \
        CONSTRAINT(d[8]), CONSTRAINT(d[9]), CONSTRAINT(d[10]), CONSTRAINT(d[11]),           \
        CONSTRAINT(d[12]), CONSTRAINT(d[13]), CONSTRAINT(d[14]), CONSTRAINT(d[15]),         \
        CONSTRAINT(d[16]), CONSTRAINT(d[17]), CONSTRAINT(d[18]), CONSTRAINT(d[19]),         \
        CONSTRAINT(d[20]), CONSTRAINT(d[21]), CONSTRAINT(d[22]), CONSTRAINT(d[23]),         \
        CONSTRAINT(d[24]), CONSTRAINT(d[25]), CONSTRAINT(d[26]), CONSTRAINT(d[27]),         \
        CONSTRAINT(d[28]), CONSTRAINT(d[29]), CONSTRAINT(d[30]), CONSTRAINT(d[31])          \
      : "l"(da), "l"(db), "r"(SCALE_D))
#define REPRO_OUT(x) "=f"(x)
#define REPRO_INOUT(x) "+f"(x)
template <bool ACC>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  if (ACC) REPRO_WGMMA_SS_N64(REPRO_INOUT, 1);
  else REPRO_WGMMA_SS_N64(REPRO_OUT, 0);
}
#undef REPRO_WGMMA_SS_N64
#undef REPRO_OUT
#undef REPRO_INOUT

// D (64 x 64, f32) {=, +=} A (64 x 16, registers) B (16 x 64, smem, K-major);
// the first depth step (ACC false) writes D without reading it, as above.
#define REPRO_WGMMA_RS_N64(CONSTRAINT, SCALE_D)                                               \
  asm volatile(                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                                \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"     \
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"                                         \
      : CONSTRAINT(d[0]), CONSTRAINT(d[1]), CONSTRAINT(d[2]), CONSTRAINT(d[3]),             \
        CONSTRAINT(d[4]), CONSTRAINT(d[5]), CONSTRAINT(d[6]), CONSTRAINT(d[7]),             \
        CONSTRAINT(d[8]), CONSTRAINT(d[9]), CONSTRAINT(d[10]), CONSTRAINT(d[11]),           \
        CONSTRAINT(d[12]), CONSTRAINT(d[13]), CONSTRAINT(d[14]), CONSTRAINT(d[15]),         \
        CONSTRAINT(d[16]), CONSTRAINT(d[17]), CONSTRAINT(d[18]), CONSTRAINT(d[19]),         \
        CONSTRAINT(d[20]), CONSTRAINT(d[21]), CONSTRAINT(d[22]), CONSTRAINT(d[23]),         \
        CONSTRAINT(d[24]), CONSTRAINT(d[25]), CONSTRAINT(d[26]), CONSTRAINT(d[27]),         \
        CONSTRAINT(d[28]), CONSTRAINT(d[29]), CONSTRAINT(d[30]), CONSTRAINT(d[31])          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(SCALE_D))
#define REPRO_OUT(x) "=f"(x)
#define REPRO_INOUT(x) "+f"(x)
template <bool ACC>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  if (ACC) REPRO_WGMMA_RS_N64(REPRO_INOUT, 1);
  else REPRO_WGMMA_RS_N64(REPRO_OUT, 0);
}
#undef REPRO_WGMMA_RS_N64
#undef REPRO_OUT
#undef REPRO_INOUT

// D (64 x N, f32) += A (64 x 16, registers) B (16 x N, smem, MN-major): the
// dQ, dV and dK products, N the head dim.
template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

// D (64 x 64, f32) += A (64 x 16, registers) B (16 x 64, smem, MN-major).
template <>
__device__ __forceinline__ void wgmma_rs_mn<64>(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 80, f32) += A (64 x 16, registers) B (16 x 80, smem, MN-major).
template <>
__device__ __forceinline__ void wgmma_rs_mn<80>(float (&d)[40], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, registers) B (16 x 128, smem, MN-major).
template <>
__device__ __forceinline__ void wgmma_rs_mn<128>(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = A B^T over the head dim for this warpgroup's 64 rows of `a` (a tile of
// a_rows rows, from row a_row0) and the 64 rows of `b`: HD / 16 depth steps,
// raw dot products. The addresses are made opaque here, so the compiler builds
// the descriptors at each use instead of keeping all of them in registers
// across the loop.
template <int HD>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t a, int a_rows, int a_row0,
                                             uint32_t b) {
  asm volatile("" : "+r"(a), "+r"(b));
  wgmma_ss_n64<false>(s, kmajor_desc<HD>(a, a_rows, a_row0, 0), kmajor_desc<HD>(b, 64, 0, 0));
#pragma unroll
  for (int ks = 1; ks < HD / 16; ++ks)
    wgmma_ss_n64<true>(s, kmajor_desc<HD>(a, a_rows, a_row0, ks), kmajor_desc<HD>(b, 64, 0, ks));
}

// The register A operands of this warpgroup's 64 rows (from row0) of a tile of
// `rows` rows (K-major, swizzled as TMA laid it down), for all HD / 16 depth
// steps of the head dim: ldmatrix.x4 gives each thread the A layout (matrices:
// rows 0-7 and 8-15 at depth 0-7, then the same at depth 8-15).
template <int HD>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[HD / 16][4], uint32_t tile, int rows,
                                             int row0, int lane, int warp) {
  const int row = row0 + 16 * warp + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint32_t addr = tile + Chunks<HD>::offset(rows, row, 16 * ks + (lane >> 4) * 8);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(f[ks][0]), "=r"(f[ks][1]), "=r"(f[ks][2]), "=r"(f[ks][3])
                 : "r"(addr));
  }
}

// S = A B^T over the head dim, A in registers (load_a_frags), B the 64 rows
// of the tile `b`.
template <int HD>
__device__ __forceinline__ void issue_scores_rs(float (&s)[32], const uint32_t (&a)[HD / 16][4],
                                                uint32_t b) {
  asm volatile("" : "+r"(b));
  wgmma_rs_n64<false>(s, a[0], kmajor_desc<HD>(b, 64, 0, 0));
#pragma unroll
  for (int ks = 1; ks < HD / 16; ++ks)
    wgmma_rs_n64<true>(s, a[ks], kmajor_desc<HD>(b, 64, 0, ks));
}

// The 64 x 64 f32 accumulator tile c as register A operands (4 depth steps of
// 16) in two parts: hi its bf16 rounding, lo the bf16 of what is left (~16 bits
// of c between them).
__device__ __forceinline__ void split_a(const float (&c)[32], uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = c[8 * kk + 2 * r], x1 = c[8 * kk + 2 * r + 1];
      const uint32_t h = pack_bf16(x0, x1);  // x0 in the low half
      hi[kk][r] = h;
      lo[kk][r] = pack_bf16(x0 - __uint_as_float(h << 16), x1 - __uint_as_float(h & 0xffff0000u));
    }
}

// acc (64 x hd) += (hi + lo) B, B the 64 x hd bf16 tile `b` read MN-major:
// 8 products; the caller commits and waits.
template <int HD>
__device__ __forceinline__ void issue_split_product(float (&acc)[HD / 2], uint32_t (&hi)[4][4],
                                                    uint32_t (&lo)[4][4], uint32_t b) {
  asm volatile("" : "+r"(b));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn<HD>(acc, hi[kk], mnmajor_desc<HD>(b, 64, kk));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn<HD>(acc, lo[kk], mnmajor_desc<HD>(b, 64, kk));
}

__device__ __forceinline__ void init_barriers(uint32_t first, int stages) {
  mbar_init(first, 1);  // the tiles loaded once
  for (int s = 0; s < stages; ++s) {
    mbar_init(first + 8u * (1 + s), 1);                          // full
    mbar_init(first + 8u * (1 + stages + s), kConsumerWarps);    // empty
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// dq pass. Block i: query tile n_qtiles - 1 - i / (H B) (heaviest causal tiles
// first) of head i % H, batch (i / H) % B. Writes dq, and for every row of the
// tile (rows past Lq too) lse log2 e (+inf past Lq, so P = 0 there) and D to the
// row workspace: rows[((b H + h) 2 + {0, 1}) Lpad + i].
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          __nv_bfloat16* __restrict__ dq, float* __restrict__ rows, Strides so,
                          Strides sdo, Strides sdq, int H, int B, int G, int Lq, int Lk,
                          int Lpad, float scale) {
  using P = DqPlan<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + P::kQBytes;
  uint8_t* gbase = smem_raw + (sQ - smem_u32(smem_raw));  // sQ as a generic pointer
  const uint32_t loaded = sQ + P::kBarOffset;  // Q and dO have arrived
  const auto full = [&](int s) { return loaded + 8u * (1 + s); };
  const auto empty = [&](int s) { return loaded + 8u * (1 + P::kStages + s); };
  const auto k_tile = [&](int s) { return sQ + 2 * P::kQBytes + s * P::kStageBytes; };

  const int n_qtiles = (Lq + kDqRows - 1) / kDqRows;
  const int i = blockIdx.x;
  const int q0 = (n_qtiles - 1 - i / (H * B)) * kDqRows;
  const int h = i % H, b = (i / H) % B;
  const int q_last = min(q0 + kDqRows, Lq) - 1;
  const int key_end = CAUSAL ? min(Lk, q_last + 1) : Lk;
  const int n_tiles = (key_end + kDqKeys - 1) / kDqKeys;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) init_barriers(loaded, P::kStages);
  __syncthreads();

  if (wg == 0) {
    // producer: one thread loads Q and dO once, and keeps the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      const int kvh = h / G;
      mbar_expect_tx(loaded, 2 * P::kQBytes);
      for (int c = 0; c < P::kChunks; ++c) {
        tma_load(sQ + c * P::chunk_bytes(kDqRows), &tq, loaded, c * P::kCW, q0, h, b);
        tma_load(sdO + c * P::chunk_bytes(kDqRows), &tdo, loaded, c * P::kCW, q0, h, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % P::kStages;
        // a fresh barrier counts its phase before the first as complete
        mbar_wait(empty(s), ((t / P::kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), P::kStageBytes);
        const uint32_t sK = k_tile(s), sV = sK + P::kTileBytes;
        const int key0 = t * kDqKeys;
        for (int c = 0; c < P::kChunks; ++c) {
          tma_load(sK + c * P::chunk_bytes(kDqKeys), &tk, full(s), c * P::kCW, key0, kvh, b);
          tma_load(sV + c * P::chunk_bytes(kDqKeys), &tv, full(s), c * P::kCW, key0, kvh, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;  // this warpgroup's rows: q0 + 64 cw .. q0 + 64 cw + 63
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int warp_row = q0 + 64 * cw + 16 * warp;
    const int row_base = warp_row + g;  // this thread's rows: row_base, row_base + 8
    const long long bh = (long long)b * H + h;
    const float scale_log2 = scale * kLog2e;

    // The O values of the warp's 16 rows that D_i = dO_i . O_i needs (4
    // columns a lane, HD / 4 lanes; rows past Lq read row Lq - 1 and count
    // 0), and each row's lse: all loads issued now, while the producer's
    // first loads are in flight, so the warp waits for memory once
    const bool d_lane = lane < HD / 4;
    const int d_col = 4 * (d_lane ? lane : 0);
    uint2 x[16];
    {
      const __nv_bfloat16* ob = o + b * so.b + h * so.h + d_col;
#pragma unroll
      for (int r = 0; r < 16; ++r)
        x[r] = __ldg(reinterpret_cast<const uint2*>(ob + min(warp_row + r, Lq - 1) * so.l));
    }
    float D_r[2] = {0.f, 0.f}, l2_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_base + 8 * r;
      l2_r[r] = row < Lq ? lse[bh * Lq + row] * kLog2e : __int_as_float(0x7f800000);
    }
    // D from dO in shared memory (read through the swizzle), while the first
    // tile's S and dP run; written to the row workspace with lse
    const auto row_sums = [&]() {
      const uint8_t* tile_dO = gbase + P::kQBytes;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const uint2 y = *reinterpret_cast<const uint2*>(
            tile_dO + P::offset(kDqRows, 64 * cw + 16 * warp + r, d_col));
        const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[r].x));
        const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[r].y));
        const float2 y0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y.x));
        const float2 y1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y.y));
        float part = fmaf(x0.x, y0.x, fmaf(x0.y, y0.y, fmaf(x1.x, y1.x, x1.y * y1.y)));
        part = warp_row + r < Lq ? warp_sum(d_lane ? part : 0.f) : 0.f;
        if ((r & 7) == g) D_r[r >> 3] = part;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_base + 8 * r;
        if (t4 == 0) {
          rows[(bh * 2) * Lpad + row] = l2_r[r];
          rows[(bh * 2 + 1) * Lpad + row] = D_r[r];
        }
      }
    };

    // Software-pipelined: a turn issues dQ += dS K of tile t and then S =
    // Q K^T, dP = dO V^T of tile t + 1 (64 rows by the tile's 64 keys), and the
    // wait that ends it completes both, so this warpgroup's elementwise work
    // on tile t + 1 overlaps the other's turn. Every turn ends in a wait, so
    // no product is in flight across the loop's back edge (ptxas would
    // serialise every wgmma of the kernel, C7515, for the moves there).
    float acc[HD / 2], sc[32], dp[32];
    uint32_t hi[4][4], lo[4][4];  // dS in two bf16 parts: the register A operands
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;
    const auto issue_s_dp = [&](int t) {
      const uint32_t sK = k_tile(t % P::kStages);
      issue_scores<HD>(sc, sQ, kDqRows, 64 * cw, sK);
      issue_scores<HD>(dp, sdO, kDqRows, 64 * cw, sK + P::kTileBytes);
    };
    // P = 2^(S scale log2 e - lse log2 e), dS = P (dP - D), split into hi and
    // lo; masks only where a key can lie past Lk or past a row of this warpgroup
    const auto ds_of = [&](int t) {
      const int k0 = t * kDqKeys;
      const bool edge = k0 + kDqKeys > Lk || (CAUSAL && k0 + kDqKeys - 1 > q0 + 64 * cw);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1;
        float p = fast_exp2(fmaf(sc[e], scale_log2, -l2_r[r]));
        if (edge) {
          const int row = row_base + 8 * r, col = k0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
          if (!(col < Lk && (!CAUSAL || col <= row))) p = 0.f;
        }
        sc[e] = p * (dp[e] - D_r[r]);
      }
      split_a(sc, hi, lo);
    };
    const auto done = [&]() {  // the turn's products are complete
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(sc);
      reg_fence(dp);
      reg_fence(hi);
      reg_fence(lo);
    };

    Turns turns(cw);
    mbar_wait(loaded, 0);
    mbar_wait(full(0), 0);
    turns.take();
    wgmma_fence();
    issue_s_dp(0);
    wgmma_commit();
    turns.hand_over();
    row_sums();
    done();
    ds_of(0);
    for (int t = 0; t + 1 < n_tiles; ++t) {
      mbar_wait(full((t + 1) % P::kStages), ((t + 1) / P::kStages) & 1);
      turns.take();
      wgmma_fence();
      issue_split_product<HD>(acc, hi, lo, k_tile(t % P::kStages));
      issue_s_dp(t + 1);
      wgmma_commit();
      turns.hand_over();
      done();
      if (lane == 0) mbar_arrive(empty(t % P::kStages));
      ds_of(t + 1);
    }
    turns.take();
    wgmma_fence();
    issue_split_product<HD>(acc, hi, lo, k_tile((n_tiles - 1) % P::kStages));
    wgmma_commit();
    turns.hand_over();
    done();
    turns.finish();

    // dQ through this warpgroup's own Q rows, which its products no longer
    // read (in the swizzled layout, so the writes spread over the banks),
    // then out in 16-byte stores, HD / 8 threads a row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = 64 * cw + 16 * warp + g + 8 * r;  // block-local row
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(gbase + P::offset(kDqRows, lr, 8 * j) + 4 * t4) =
            pack_bf16(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(3 + cw) : "memory");  // this warpgroup's writes
    __nv_bfloat16* dqb = dq + b * sdq.b + h * sdq.h;
    constexpr int kUnits = HD / 8;  // 16-byte units a row
#pragma unroll
    for (int i = 0; i < 64 * kUnits / 128; ++i) {
      const int idx = i * 128 + tid, r = idx / kUnits, unit = idx % kUnits;
      const int lr = 64 * cw + r, row = q0 + lr;
      const uint4 v = *reinterpret_cast<const uint4*>(gbase + P::offset(kDqRows, lr, 8 * unit));
      if (row < Lq) *reinterpret_cast<uint4*>(dqb + row * sdq.l + unit * 8) = v;
    }
  }
}

// dk/dv pass. Block i: key tile i / (KV B) (the first key tiles, which see
// the most queries under `causal`, first), KV head i % KV, batch (i / KV) %
// B: the group's G heads, their query tiles from the diagonal on. The two consumer warpgroups share the
// block's 64 keys and split the work: warpgroup 0 computes S^T = K Q^T and P^T,
// hands P^T to warpgroup 1 through shared memory, and sums dV += P^T dO;
// warpgroup 1 computes dP^T = V dO^T, dS^T = P^T (dP^T - D) and sums dK +=
// dS^T Q. Waiting for P^T keeps warpgroup 1 behind warpgroup 0, so each one's
// elementwise work overlaps the other's products.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const float* __restrict__ rows, __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, Strides sdk, Strides sdv, int H,
                            int KV, int B, int G, int Lq, int Lk, int Lpad, float scale) {
  using P = KvPlan<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + P::kKBytes;
  const uint8_t* gbase = smem_raw + (sK - smem_u32(smem_raw));  // sK as a generic pointer
  const uint32_t loaded = sK + P::kBarOffset;  // K and V have arrived
  const auto full = [&](int s) { return loaded + 8u * (1 + s); };
  const auto empty = [&](int s) { return loaded + 8u * (1 + P::kStages + s); };
  const auto q_tile = [&](int s) { return sK + 2 * P::kKBytes + s * P::kStageBytes; };

  const int i = blockIdx.x;
  const int k0 = (i / (KV * B)) * kKvRows;
  const int kvh = i % KV, b = (i / KV) % B;
  const int h0 = kvh * G;
  // k0 is a multiple of the query tile, so the causal query tiles start at k0
  const int first_q = CAUSAL ? k0 : 0;
  const int n_q = first_q < Lq ? (Lq - first_q + kKvQueries - 1) / kKvQueries : 0;
  const int n_items = G * n_q;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) init_barriers(loaded, P::kStages);
  __syncthreads();

  if (wg == 0) {
    // producer: one thread loads K and V once, and keeps the Q/dO ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(loaded, 2 * P::kKBytes);
      for (int c = 0; c < P::kChunks; ++c) {
        tma_load(sK + c * P::chunk_bytes(kKvRows), &tk, loaded, c * P::kCW, k0, kvh, b);
        tma_load(sV + c * P::chunk_bytes(kKvRows), &tv, loaded, c * P::kCW, k0, kvh, b);
      }
      for (int t = 0; t < n_items; ++t) {
        const int s = t % P::kStages;
        const int h = h0 + t / n_q, q0 = first_q + (t % n_q) * kKvQueries;
        mbar_wait(empty(s), ((t / P::kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), P::kStageBytes + P::kRowsBytes);
        const uint32_t sQ = q_tile(s), sdO = sQ + P::kTileBytes;
        for (int c = 0; c < P::kChunks; ++c) {
          tma_load(sQ + c * P::chunk_bytes(kKvQueries), &tq, full(s), c * P::kCW, q0, h, b);
          tma_load(sdO + c * P::chunk_bytes(kKvQueries), &tdo, full(s), c * P::kCW, q0, h, b);
        }
        const float* rb = rows + ((long long)b * H + h) * 2 * Lpad + q0;
        const uint32_t sRows = sK + P::kRowsOffset + s * P::kRowsBytes;
        bulk_load(sRows, rb, P::kRowsBytes / 2, full(s));
        bulk_load(sRows + P::kRowsBytes / 2, rb + Lpad, P::kRowsBytes / 2, full(s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;  // 0: P^T and dV; 1: dS^T and dK
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int key_base = k0 + 16 * warp + g;  // this thread's keys: key_base, key_base + 8
    const float scale_log2 = scale * kLog2e;
    // P^T of item t goes through buffer t % 2, as each thread's 32 values
    // (8 float4s, thread-minor): warpgroup 1's thread holds dP^T at the same
    // places of the accumulator layout. Named barriers 1 + t % 2 say a buffer
    // is written, 3 + t % 2 that it is read.
    float4* p_buf = reinterpret_cast<float4*>(const_cast<uint8_t*>(gbase) + P::kPOffset);

    // Software-pipelined as the dq pass is: a turn issues the sum of item t
    // (dV += P^T dO, or dK += dS^T Q) and then the scores of item t + 1 (S^T
    // or dP^T), and the wait that ends it completes both.
    float acc[HD / 2], sc[32];
    uint32_t hi[4][4], lo[4][4];  // P^T or dS^T in two bf16 parts: the register A operands
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;
    uint32_t fixed[HD / 16][4];  // K (warpgroup 0) or V (1): the scores' A operand, loaded once
    const auto issue_sc = [&](int t) {  // S^T = K Q^T or dP^T = V dO^T
      const uint32_t sQ = q_tile(t % P::kStages);
      issue_scores_rs<HD>(sc, fixed, cw == 0 ? sQ : sQ + P::kTileBytes);
    };
    const auto issue_sum = [&](int t) {  // dV += P^T dO or dK += dS^T Q
      const uint32_t sQ = q_tile(t % P::kStages);
      issue_split_product<HD>(acc, hi, lo, cw == 0 ? sQ + P::kTileBytes : sQ);
    };
    const auto elementwise = [&](int t) {
      const int s = t % P::kStages, buf = t & 1;
      const int q0 = first_q + (t % n_q) * kKvQueries;
      const float* col = reinterpret_cast<const float*>(gbase + P::kRowsOffset +
                                                        s * P::kRowsBytes);
      float4* pb = p_buf + buf * (P::kPBytes / 16) + tid;
      if (cw == 0) {
        // P^T = 2^(S^T scale log2 e - lse log2 e); queries past Lq have lse
        // +inf (P = 0), keys past Lk are never stored; the causal mask only
        // where a key of the block lies past a query of the tile
        const bool edge = CAUSAL && k0 + kKvRows - 1 > q0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * t4;
          const float2 l2 = *reinterpret_cast<const float2*>(col + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * j + e;
            float p = fast_exp2(fmaf(sc[x], scale_log2, -((e & 1) ? l2.y : l2.x)));
            if (edge && key_base + 8 * (e >> 1) > q0 + c + (e & 1)) p = 0.f;
            sc[x] = p;
          }
        }
        if (t >= 2) named_sync(3 + buf);  // warpgroup 1 has read item t - 2
#pragma unroll
        for (int j = 0; j < 8; ++j)
          pb[j * 128] = make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]);
        named_arrive(1 + buf);
      } else {
        // dS^T = P^T (dP^T - D)
        named_sync(1 + buf);
        float4 pv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) pv[j] = pb[j * 128];
        if (t + 2 < n_items) named_arrive(3 + buf);  // warpgroup 0 waits for it at item t + 2
        const float* col_D = col + kKvQueries;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 dd = *reinterpret_cast<const float2*>(col_D + 8 * j + 2 * t4);
          sc[4 * j] = pv[j].x * (sc[4 * j] - dd.x);
          sc[4 * j + 1] = pv[j].y * (sc[4 * j + 1] - dd.y);
          sc[4 * j + 2] = pv[j].z * (sc[4 * j + 2] - dd.x);
          sc[4 * j + 3] = pv[j].w * (sc[4 * j + 3] - dd.y);
        }
      }
      split_a(sc, hi, lo);
    };
    const auto done = [&]() {  // the turn's products are complete
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(sc);
      reg_fence(hi);
      reg_fence(lo);
    };

    mbar_wait(loaded, 0);
    load_a_frags<HD>(fixed, cw == 0 ? sK : sV, kKvRows, 0, lane, warp);
    if (n_items > 0) {
      mbar_wait(full(0), 0);
      wgmma_fence();
      issue_sc(0);
      wgmma_commit();
      done();
      elementwise(0);
      for (int t = 0; t + 1 < n_items; ++t) {
        mbar_wait(full((t + 1) % P::kStages), ((t + 1) / P::kStages) & 1);
        wgmma_fence();
        issue_sum(t);
        issue_sc(t + 1);
        wgmma_commit();
        done();
        if (lane == 0) mbar_arrive(empty(t % P::kStages));
        elementwise(t + 1);
      }
      wgmma_fence();
      issue_sum(n_items - 1);
      wgmma_commit();
      done();
    }

    // warpgroup 0 holds dV, warpgroup 1 dK (scaled)
    const float m = cw == 0 ? 1.f : scale;
    __nv_bfloat16* out = cw == 0 ? dv + b * sdv.b + kvh * sdv.h : dk + b * sdk.b + kvh * sdk.h;
    const long long sl = cw == 0 ? sdv.l : sdk.l;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key_base + 8 * r;
      if (key < Lk) {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<uint32_t*>(out + key * sl + j * 8 + 2 * t4) =
              pack_bf16(acc[4 * j + 2 * r] * m, acc[4 * j + 2 * r + 1] * m);
      }
    }
  }
}

// Error codes past the runtime's: libcuda has no tensor-map encoder, or it
// refused a map (kTensorMapError + its CUresult).
constexpr int kNoEncoder = 9000;
constexpr int kTensorMapError = 10000;

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (hd, position, head, batch) map of one bf16 operand with the caller's
// element strides st = (batch, head, position); boxes of (kCW columns, `rows`
// rows) under the plan's swizzle, zeros past each extent.
template <int HD>
int encode_map(CUtensorMap* map, const void* ptr, int L, int heads, int B, const long long* st,
               int rows) {
  using C = Chunks<HD>;
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {HD, (cuuint64_t)L, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {C::kCW, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
         unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         C::kCW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

// st: (batch, head, position) strides of q, k, v, o, dO, dq, dk, dv in that order.
template <int HD, bool CAUSAL>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const float* lse, void* dq, void* dk, void* dv, float* rows, int B, int H,
                 int KV, int Lq, int Lk, const long long* st, float scale, bool dkdv,
                 cudaStream_t stream) {
  using T = __nv_bfloat16;
  using DP = DqPlan<HD>;
  using KP = KvPlan<HD>;
  const int G = H / KV;
  // the dq pass writes whole tiles of the row workspace
  const int Lpad = (Lq + kDqRows - 1) / kDqRows * kDqRows;
  const long long dq_blocks = (long long)((Lq + kDqRows - 1) / kDqRows) * H * B;
  const long long kv_blocks = (long long)((Lk + kKvRows - 1) / kKvRows) * KV * B;
  if (dq_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto dq_kern = flash_bwd_dq_wgmma_kernel<HD, CAUSAL>;
  const auto kv_kern = flash_bwd_dkdv_wgmma_kernel<HD, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)DP::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)KP::kBytes);
  if (err != cudaSuccess) return (int)err;
  Strides s[8];
  for (int i = 0; i < 8; ++i) s[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};

  CUtensorMap tq, tdo, tk, tv;
  int code = encode_map<HD>(&tq, q, Lq, H, B, st, kDqRows);
  if (code == 0) code = encode_map<HD>(&tdo, dout, Lq, H, B, st + 12, kDqRows);
  if (code == 0) code = encode_map<HD>(&tk, k, Lk, KV, B, st + 3, kDqKeys);
  if (code == 0) code = encode_map<HD>(&tv, v, Lk, KV, B, st + 6, kDqKeys);
  if (code != 0) return code;
  dq_kern<<<(unsigned)dq_blocks, kWgThreads, DP::kBytes, stream>>>(
      tq, tdo, tk, tv, static_cast<const T*>(o), static_cast<const T*>(dout), lse,
      static_cast<T*>(dq), rows, s[3], s[4], s[5], H, B, G, Lq, Lk, Lpad, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !dkdv) return (int)err;

  // the K and V maps (64-row boxes) serve the dk/dv pass as they are
  static_assert(kKvRows == kDqKeys, "one K/V box shape for both passes");
  code = encode_map<HD>(&tq, q, Lq, H, B, st, kKvQueries);
  if (code == 0) code = encode_map<HD>(&tdo, dout, Lq, H, B, st + 12, kKvQueries);
  if (code != 0) return code;
  kv_kern<<<(unsigned)kv_blocks, kWgThreads, KP::kBytes, stream>>>(
      tq, tdo, tk, tv, rows, static_cast<T*>(dk), static_cast<T*>(dv), s[6], s[7], H, KV, B, G,
      Lq, Lk, Lpad, scale);
  return (int)cudaGetLastError();
}

template <int HD, bool CAUSAL>
int launch_cores(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const float* lse, void* dq, void* dk, void* dv, float* dsum, int B, int H,
                 int KV, int Lq, int Lk, const long long* st, float scale, bool dkdv,
                 cudaStream_t stream) {
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
  using C = const float*;
  dq_kern<<<dim3((Lq + kTile - 1) / kTile, H, B), kThreads, P::kBytes, stream>>>(
      static_cast<C>(q), static_cast<C>(k), static_cast<C>(v), static_cast<C>(o),
      static_cast<C>(dout), lse, static_cast<float*>(dq), dsum, s[0], s[1], s[2], s[3], s[4],
      s[5], G, Lq, Lk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !dkdv) return (int)err;
  dkdv_kern<<<dim3((Lk + kTile - 1) / kTile, KV, B), kThreads, P::kBytes, stream>>>(
      static_cast<C>(q), static_cast<C>(k), static_cast<C>(v), static_cast<C>(dout), lse, dsum,
      static_cast<float*>(dk), static_cast<float*>(dv), s[0], s[1], s[2], s[4], s[6], s[7], H, G,
      Lq, Lk, scale);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dtype: 0 = float32 (the CUDA cores), 1 = bfloat16 (TMA + wgmma; needs
// 16-byte aligned pointers and strides that are multiples of 8), for q, k, v,
// o, dout, dq, dk, dv alike; hd in {64, 80, 128}. lse: (B, H, Lq) f32 from
// flash_attention_fwd. rows: an f32 workspace of B H 2 Lpad values, Lpad = Lq
// rounded up to 128 (the bf16 dq pass writes each row's lse log2 e and D there
// for its dk/dv pass; the f32 path uses its first B H Lq values for D).
// strides holds 24 element strides: (batch, head, position) of q, k, v, o,
// dout, dq, dk and dv in that order. dkdv = 0 runs the dq pass only (dk, dv
// may then be null). Launches the passes on `stream`; returns
// cudaGetLastError() after them, or an error_string code.
extern "C" int flash_attention_bwd(int dtype, int hd, int causal, int dkdv, const void* q,
                                   const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, void* dq, void* dk,
                                   void* dv, float* rows, int B, int H, int KV, int Lq, int Lk,
                                   const long long* strides, float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Lq < 1 || Lk < 1 || B > 65535 ||
      H > 65535 || (hd != 64 && hd != 80 && hd != 128) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // TMA reads 16-byte aligned rows; the row workspace takes 16-byte bulk copies
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) && aligned16(dout) &&
          aligned16(dq) && aligned16(rows) && (!dkdv || (aligned16(dk) && aligned16(dv)))))
      return (int)cudaErrorMisalignedAddress;
    for (int i = 0; i < 24; ++i)
      if ((dkdv || i < 18) && strides[i] % 8 != 0) return (int)cudaErrorMisalignedAddress;
  }
#define REPRO_BWD_CASE(HDV, LAUNCH)                                                         \
  if (hd == HDV)                                                                           \
    return causal ? LAUNCH<HDV, true>(q, k, v, o, dout, lse, dq, dk, dv, rows, B, H, KV,   \
                                      Lq, Lk, strides, scale, dkdv != 0, s)                \
                  : LAUNCH<HDV, false>(q, k, v, o, dout, lse, dq, dk, dv, rows, B, H, KV,  \
                                       Lq, Lk, strides, scale, dkdv != 0, s);
  if (dtype == 0) {
    REPRO_BWD_CASE(64, launch_cores)
    REPRO_BWD_CASE(80, launch_cores)
    REPRO_BWD_CASE(128, launch_cores)
  } else {
    REPRO_BWD_CASE(64, launch_wgmma)
    REPRO_BWD_CASE(80, launch_wgmma)
    REPRO_BWD_CASE(128, launch_wgmma)
  }
#undef REPRO_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  if (err == kNoEncoder) return "libcuda offers no cuTensorMapEncodeTiled";
  if (err >= kTensorMapError)
    return "cuTensorMapEncodeTiled refused a tensor map (extents, strides or alignment)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
