// Flash attention forward (causal or bidirectional, GQA) for the NVIDIA H100
// (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention.
//
//   o[b,h,i] = sum_j softmax_j(s_ij) v[b,h/G,j],  s_ij = hd^-0.5 q[b,h,i] . k[b,h/G,j]
//
// with s_ij = -1e30 where j > i under `causal`, the softmax in f32 and the
// normaliser floored at 1e-30, as the TPU kernel does. Given an lse pointer (the
// training path; null when serving), both kernels also write each query row's
// natural log-sum-exp, lse[b,h,i] = log sum_j exp(s_ij) (f32, (B, H, Lq)), which
// the backward (flash_attention_bwd.cu) recomputes the softmax from.
//
// What bounds it: operations. A causal call does 4*hd flops for each of the
// B*H*L*(L+1)/2 (query, key) pairs it keeps and moves each input and the output
// once: at the main path's B=4, H=32, KV=4, L=1024, hd=128 in bf16 that is
// ~34 GFLOP against ~76 MB, ~450 flop per byte, above the card's bf16 ridge (~295).
// The bound is ~35 us at the tensor cores' 989 TFLOP/s.
//
// What the design does about it. Two kernels, one per input type:
//  * bf16 (the main path): Hopper's asynchronous units, warp-specialised and
//    persistent. One block of 384 threads an SM walks work items of 128 query
//    rows of one (batch, head), heaviest causal tiles first, neighbouring blocks
//    on the heads of one GQA group (they read the same K/V tiles while these sit
//    in L2). One producer warpgroup, in which a single thread issues TMA tensor
//    loads (an item's Q tile, then its 128-key K and V tiles into a ring of 3-4
//    stages in shared memory, each stage with a "full" and an "empty" mbarrier),
//    and two consumer warpgroups of 64 query rows each; setmaxnreg moves
//    registers from the producer to the consumers. A consumer computes
//    S = Q K^T with wgmma m64n128k16 (both operands in shared memory, K-major),
//    runs the online softmax in f32 on the accumulator registers (row max and
//    sum over the quad of threads that share a row, exp2 with hd^-0.5 log2(e)
//    folded into one multiply-add, masks only on diagonal and ragged tiles),
//    repacks P to bf16 in registers as the A operand of O += P V (wgmma
//    register-A form, V read from shared memory MN-major), and releases a stage
//    once P V has read it. Each turn at the tensor cores issues S of tile t and
//    P V of tile t-1, so a warpgroup's softmax overlaps its own previous P V,
//    and the two warpgroups take turns (named barriers), so one's softmax also
//    overlaps the other's products. The head dim is cut into column chunks,
//    one TMA box and one swizzled tile each: 64 columns under the 128-byte
//    swizzle for hd 64 and 128, 16 columns under the 32-byte swizzle for hd 80
//    (160-byte rows fit no wider swizzle). The tensor maps cover (hd, position,
//    head, batch) with the caller's strides, so the model's (B, L, H, hd) layout
//    is read in place; rows past L load as zeros.
//    Measured on an H100 at 700 W (PERF.md): ~415 TFLOP/s at the main shape,
//    level with SDPA; the output stores at the end of each item cost ~14%
//    (without them 0.070 ms), through no cause found yet: not L2 traffic,
//    not the store count, not a wgmma.fence waiting on them
//    (scripts/flash_variants.py times each part).
//  * f32: CUDA cores (67 TFLOP/s peak, exact f32 products). A block of 4 warps
//    owns 32 query rows, 8 per warp; lane j dots key j of a 32-key tile with the
//    warp's rows (float4 reads of rows padded to hd+4), the softmax reduces with
//    warp shuffles, and P goes through shared memory into P.V, where each lane
//    owns output columns lane, lane+32, ... (hd=80 idles half the lanes on the
//    third column: its tile plan). Grid (query tile, query head, batch).
// Both: the KV head is h / G, so K and V are never repeated. The loop over K
// tiles stops at the tile's causal limit (the TPU kernel's pl.when block skip,
// as a loop bound inside the block), and the diagonal tile and the ragged tail
// are masked, so any L works. Strides are arguments (unit stride on hd).
//
// The tensor-map encoder is looked up at run time (cudaGetDriverEntryPoint),
// so the library needs no -lcuda.
#include <cuda.h>
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

// LSE: write each row's log-sum-exp (a template argument, as for the bf16
// kernel below: ptxas gives these kernels 128 registers, and the store in
// every variant made the hd-128 non-causal one spill 24 bytes).
template <int HD, bool CAUSAL, bool LSE>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Strides sq,
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
      // scores were taken from q * scale, so m is already on the softmax's scale
      if (LSE && lane == 0) lse[((long long)b * gridDim.y + h) * Lq + i] = m[r] + logf(den);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, one producer and two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kWsBQ = 128;          // query rows per block: 64 per consumer warpgroup
constexpr int kWsBK = 128;          // keys per K/V tile
constexpr int kWsThreads = 384;     // the producer warpgroup, then two consumers
constexpr int kConsumerWarps = 8;   // each releases a stage once it is done with it
constexpr int kTurnBarrier = 1;     // named barriers 1, 2: the consumers' turns at the tensor cores
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory for one head dim: Q (128 rows), then kStages of (K tile, V tile),
// as many as fit up to 4 (3 at hd 128), then the mbarriers. Every tile is kChunks column chunks of CW values; a chunk is
// (rows x CW) bf16 as one TMA box lays it down under its swizzle, so 8-row groups
// of kGroupBytes repeat the swizzle pattern.
template <int HD>
struct WsPlan {
  static constexpr int kCW = HD % 64 == 0 ? 64 : 16;
  static constexpr int kChunks = HD / kCW;
  static constexpr int kRowBytes = kCW * 2;                 // 128 or 32: the swizzle span
  static constexpr uint64_t kLayout = kCW == 64 ? 1 : 3;    // descriptor code: 128B or 32B swizzle
  static constexpr int kGroupBytes = 8 * kRowBytes;
  static constexpr int kQChunk = kWsBQ * kRowBytes;
  static constexpr int kKVChunk = kWsBK * kRowBytes;
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kTileBytes = kChunks * kKVChunk;     // one K or one V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kFit = (kSmemLimit - 1024 - 8 * 10 - kQBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 3, "a tile's V is read while the next two tiles load");
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  // + 1024: the dynamic window is aligned up to the 128-byte swizzle's 1024 bytes
  static constexpr size_t kBytes = 1024 + kBarOffset + 8 * (2 + 2 * kStages);
  static_assert(kBytes <= kSmemLimit, "the plan fits one block's shared memory");
  static_assert(HD % 16 == 0 && HD <= 256, "wgmma takes N <= 256 in steps of 16 here");
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

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle code in the top two bits. K-major swizzled
// operands ignore the leading offset; MN-major ones step by it from one CW-column
// chunk to the next. The stride offset steps from one 8-row group to the next.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (layout << 62);
}

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

// Named barrier over the two consumer warpgroups (256 threads): one waits for
// its turn, the other arrives to hand it over.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// The wgmma asm statements name their accumulators as outputs, so the compiler
// takes them for ready when the asm retires; this pins every read after the
// wait_group that really completes them.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The register A operand is read asynchronously too: keep it live (and
// untouched) until the wait_group that completes its reads.
__device__ __forceinline__ void reg_fence(uint32_t (&r)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator layout of m64nNk16 (f32): warp w of the warpgroup holds rows
// 16w + lane/4 (registers 4j, 4j+1) and 16w + lane/4 + 8 (4j+2, 4j+3) at columns
// 8j + 2 (lane % 4) and the next one. The register A operand of P V takes the same
// rows: register 0 = row g, keys 2t, 2t+1 of the 16; 1 = row g+8; 2 = row g, keys
// 2t+8, 2t+9; 3 = row g+8, keys 2t+8, 2t+9.
// D (64 x 128, f32) {=, +=} A (64 x 16, smem) B (16 x 128, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

// D (64 x 64, f32) += A (64 x 16, registers) B (16 x 64, smem, MN-major).
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
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
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t (&a)[4],
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
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
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


// One unit of work: 128 query rows of one (batch, head), and how many 128-key
// tiles they read. Items run heaviest causal tile first, and consecutive items
// are the heads of one batch row, so the blocks working side by side read the
// K/V tiles of one GQA group while they sit in L2.
struct Item {
  int q0, h, b, n_tiles;
};

template <bool CAUSAL>
__device__ __forceinline__ Item item_at(int i, int n_qtiles, int H, int B, int Lq, int Lk) {
  const int tile = n_qtiles - 1 - i / (H * B);
  const int q0 = tile * kWsBQ;
  const int q_last = min(q0 + kWsBQ, Lq) - 1;
  const int k_end = CAUSAL ? min(Lk, q_last + 1) : Lk;
  const int n_tiles = (k_end + kWsBK - 1) / kWsBK;
  return {q0, i % H, (i / H) % B, n_tiles};
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x; results below 2^-126 flush to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Persistent: one block an SM walks the items blockIdx.x, blockIdx.x + gridDim.x,
// ... The K/V ring and the consumers' turns run on across items, so one item's
// last products and output overlap the loads of the next.
// LSE: write each row's log-sum-exp to lse. A template argument, so the
// serving path's kernel (no lse) is the one it was; built with lse at every
// head dim, as the backward takes them all.
template <int HD, bool CAUSAL, bool LSE>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, Strides so, int H, int B, int G, int Lq, int Lk,
                       float scale_log2) {
  using P = WsPlan<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = sQ + P::kBarOffset, q_empty = q_full + 8u;
  const auto full = [&](int s) { return q_full + 8u * (2 + s); };
  const auto empty = [&](int s) { return q_full + 8u * (2 + P::kStages + s); };
  const auto k_tile = [&](int s) { return sQ + P::kQBytes + s * P::kStageBytes; };

  const int n_qtiles = (Lq + kWsBQ - 1) / kWsBQ;
  const int n_items = n_qtiles * H * B;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps Q and the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int tiles = 0, round = 0;  // K/V tiles and items loaded so far
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++round) {
        const Item it = item_at<CAUSAL>(i, n_qtiles, H, B, Lq, Lk);
        const int kvh = it.h / G;
        // a fresh barrier counts its phase before the first as complete, so
        // the first pass over Q and over the ring does not wait
        mbar_wait(q_empty, (round & 1) ^ 1);
        mbar_expect_tx(q_full, P::kQBytes);
        for (int c = 0; c < P::kChunks; ++c)
          tma_load(sQ + c * P::kQChunk, &tq, q_full, c * P::kCW, it.q0, it.h, it.b);
        for (int t = 0; t < it.n_tiles; ++t, ++tiles) {
          const int s = tiles % P::kStages;
          mbar_wait(empty(s), ((tiles / P::kStages) & 1) ^ 1);
          mbar_expect_tx(full(s), P::kStageBytes);
          const uint32_t sK = k_tile(s), sV = sK + P::kTileBytes;
          for (int c = 0; c < P::kChunks; ++c) {
            tma_load(sK + c * P::kKVChunk, &tk, full(s), c * P::kCW, t * kWsBK, kvh, it.b);
            tma_load(sV + c * P::kKVChunk, &tv, full(s), c * P::kCW, t * kWsBK, kvh, it.b);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;  // this warpgroup's rows: q0 + 64 cw .. q0 + 64 cw + 63
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const uint32_t sQw = sQ + cw * 64 * P::kRowBytes;

    // Turn t issues S_t = Q K_t^T and then O += P_{t-1} V_{t-1}, so the softmax
    // of tile t runs while P V of tile t-1 is on the tensor cores; the two
    // warpgroups take turns issuing (named barriers), so one's softmax also
    // overlaps the other's products. A stage is released once P V has read it,
    // Q once the item's last S is done. The first turn of an item (S only) and
    // the last (P V only) are peeled, so no wgmma sits on a conditional path,
    // which would make ptxas serialise them all.
    float acc[HD / 2];
    uint32_t pa[8][4];  // P of the previous tile: the register A operand
    float m[2], l[2], alpha[2];
    int q0 = 0, row_base = 0;  // the current item's first row and this thread's rows

    const auto issue_s = [&](float(&sc)[64], int tile) {  // S = Q K^T, raw dot products
      const uint32_t sK = k_tile(tile % P::kStages);
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const int c = ks * 16 / P::kCW, off = (ks * 16 % P::kCW) * 2;
        wgmma_ss_n128(sc, smem_desc(sQw + c * P::kQChunk + off, 16, P::kGroupBytes, P::kLayout),
                      smem_desc(sK + c * P::kKVChunk + off, 16, P::kGroupBytes, P::kLayout),
                      ks > 0);
      }
      wgmma_commit();
    };
    const auto issue_pv = [&](int tile) {  // O += P V, 16 keys a step
      const uint32_t sV = k_tile(tile % P::kStages) + P::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs<HD>(acc, pa[kk],
                     smem_desc(sV + kk * 16 * P::kRowBytes, P::kKVChunk, P::kGroupBytes,
                               P::kLayout));
      wgmma_commit();
    };
    const auto softmax = [&](float(&sc)[64], int t) {
      const int k0 = t * kWsBK;
      // masks only where a key can lie past Lk or past a row of this warpgroup
      if (k0 + kWsBK > Lk || (CAUSAL && k0 + kWsBK - 1 > q0 + 64 * cw)) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row_base + (e >> 1) * 8;
            const int col = k0 + j * 8 + 2 * t4 + (e & 1);
            const bool keep = col < Lk && (!CAUSAL || col <= row);
            if (!keep) sc[4 * j + e] = kNegInf;
          }
      }
      // online softmax in the log2 domain: p = 2^(s c - m c), c = hd^-0.5 log2 e
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // a row that has seen only masked keys keeps weight 0 (no stored row
        // can: every row keeps key 0)
        mc[r] = mx[r] == kNegInf ? 0.f : mx[r] * scale_log2;
        alpha[r] = fast_exp2(fmaf(m[r], scale_log2, -mc[r]));
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -mc[(i >> 1) & 1]));
        sum[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = alpha[r] * l[r] + sum[r];
      }
    };
    const auto advance = [&](const float(&sc)[64]) {  // O scaled by alpha, P to bf16
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    };
    const auto finish_pv = [&](int tile) {  // P V of the tile is done: release its stage
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(pa);
      if (lane == 0) mbar_arrive(empty(tile % P::kStages));
    };
    const auto s_done = [&](float(&sc)[64], bool last) {  // after S's wait_group
      reg_fence(sc);
      if (last && lane == 0) mbar_arrive(q_empty);  // Q is no longer read
    };

    if (cw == 1) named_arrive(kTurnBarrier);  // the first turn is warpgroup 0's
    int tiles = 0, round = 0;  // K/V tiles and items consumed so far
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++round) {
      const Item it = item_at<CAUSAL>(i, n_qtiles, H, B, Lq, Lk);
      const int n = it.n_tiles;
      q0 = it.q0;
      row_base = q0 + 64 * cw + 16 * warp + g;  // rows row_base, row_base + 8
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;

      mbar_wait(q_full, round & 1);
      {
        float sc[64];
        mbar_wait(full(tiles % P::kStages), (tiles / P::kStages) & 1);
        named_sync(kTurnBarrier + cw);
        wgmma_fence();
        issue_s(sc, tiles);
        named_arrive(kTurnBarrier + 1 - cw);
        wgmma_wait<0>();
        s_done(sc, n == 1);
        softmax(sc, 0);
        advance(sc);
      }
      for (int t = 1; t < n; ++t) {
        float sc[64];
        const int tile = tiles + t;
        mbar_wait(full(tile % P::kStages), (tile / P::kStages) & 1);
        named_sync(kTurnBarrier + cw);
        wgmma_fence();
        issue_s(sc, tile);
        issue_pv(tile - 1);
        named_arrive(kTurnBarrier + 1 - cw);
        wgmma_wait<1>();  // S is the older group
        s_done(sc, t == n - 1);
        softmax(sc, t);
        finish_pv(tile - 1);
        advance(sc);
      }
      named_sync(kTurnBarrier + cw);
      wgmma_fence();
      issue_pv(tiles + n - 1);
      // the other warpgroup's turn, unless this is warpgroup 1's very last
      if (cw == 0 || i + gridDim.x < n_items) named_arrive(kTurnBarrier + 1 - cw);
      finish_pv(tiles + n - 1);
      tiles += n;

      __nv_bfloat16* ob = o + it.b * so.b + it.h * so.h;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_base + r * 8;
        if (row < Lq) {
          const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
          for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<uint32_t*>(ob + row * so.l + j * 8 + 2 * t4) =
                pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
        }
        // m is the raw row max and l sums 2^(s c - m c), c = hd^-0.5 log2 e,
        // so the natural log-sum-exp is (m c + log2 l) ln 2
        if (LSE && row < Lq && t4 == 0)
          lse[((long long)it.b * H + it.h) * Lq + row] =
              (m[r] * scale_log2 + log2f(fmaxf(l[r], 1e-30f))) * kLn2;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

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
// element strides; boxes of (CW columns, 128 rows), zeros past each extent.
template <int HD>
int encode_map(CUtensorMap* map, const void* ptr, int L, int heads, int B, const long long* st) {
  using P = WsPlan<HD>;
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {HD, (cuuint64_t)L, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {P::kCW, kWsBK, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
         unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         P::kCW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

template <int HD, bool CAUSAL>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                 int H, int KV,
                 int Lq, int Lk, const long long* st, float scale, cudaStream_t stream) {
  using P = WsPlan<HD>;
  static_assert(kWsBQ == kWsBK, "one box shape serves q, k and v");
  CUtensorMap tq, tk, tv;
  int err = encode_map<HD>(&tq, q, Lq, H, B, st);
  if (err == 0) err = encode_map<HD>(&tk, k, Lk, KV, B, st + 3);
  if (err == 0) err = encode_map<HD>(&tv, v, Lk, KV, B, st + 6);
  if (err != 0) return err;
  const auto kern = lse != nullptr ? flash_fwd_wgmma_kernel<HD, CAUSAL, true>
                                   : flash_fwd_wgmma_kernel<HD, CAUSAL, false>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kBytes);
  if (attr != cudaSuccess) return (int)attr;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long items = (long long)((Lq + kWsBQ - 1) / kWsBQ) * H * B;
  const int grid = (int)(items < sms ? items : sms);
  const Strides so{st[9], st[10], st[11]};
  kern<<<grid, kWsThreads, P::kBytes, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse,
                                                so, H, B, H / KV, Lq, Lk, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int HD, bool CAUSAL>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int G,
               int Lq, int Lk, const long long* st, float scale, cudaStream_t stream) {
  const auto kern = lse != nullptr ? flash_fwd_f32_kernel<HD, CAUSAL, true>
                                   : flash_fwd_f32_kernel<HD, CAUSAL, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Plan<HD>::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]};
  const Strides sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  kern<<<grid, kThreads, Plan<HD>::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, sq, sk, sv, so, G, Lq, Lk, scale);
  return (int)cudaGetLastError();
}

template <int HD, bool CAUSAL>
int launch_hd(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
              int B, int H, int KV, int Lq, int Lk, const long long* st, float scale,
              cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<HD, CAUSAL>(q, k, v, o, lse, B, H, H / KV, Lq, Lk, st, scale, s);
  return launch_wgmma<HD, CAUSAL>(q, k, v, o, lse, B, H, KV, Lq, Lk, st, scale, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (TMA + wgmma; needs 16-byte
// aligned pointers and strides that are multiples of 8); hd in {64, 80, 128}.
// strides holds 12 element strides: (batch, head, position) for q, k, v and o in
// that order. lse is null or receives (B, H, Lq) f32 log-sum-exps. Returns
// cudaGetLastError() after the launch, or an error_string code.
extern "C" int flash_attention_fwd(int dtype, int hd, int causal, const void* q,
                                   const void* k, const void* v, void* o, float* lse, int B, int H,
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
    if ((long long)((Lq + kWsBQ - 1) / kWsBQ) * H * B > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_CASE(HDV)                                                               \
  if (hd == HDV)                                                                           \
    return causal ? launch_hd<HDV, true>(dtype, q, k, v, o, lse, B, H, KV, Lq, Lk,         \
                                         strides, scale, s)                                \
                  : launch_hd<HDV, false>(dtype, q, k, v, o, lse, B, H, KV, Lq, Lk,        \
                                          strides, scale, s);
  REPRO_FLASH_CASE(64)
  REPRO_FLASH_CASE(80)
  REPRO_FLASH_CASE(128)
#undef REPRO_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  if (err == kNoEncoder) return "libcuda offers no cuTensorMapEncodeTiled";
  if (err >= kTensorMapError)
    return "cuTensorMapEncodeTiled refused a tensor map (extents, strides or alignment)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
