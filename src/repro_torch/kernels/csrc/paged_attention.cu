// One-token paged decode attention (GQA) for the NVIDIA H100 (sm_90a),
// split across blocks (flash-decoding) and merged in the same launch.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/paged_attention.py::paged_attention.
//
//   o[b,h,g] = sum_j softmax_j(s_j) v[page(b,j), j % ps, h],
//   s_j = hd^-0.5 q[b,h,g] . k[page(b,j), j % ps, h],  page(b,j) = block_table[b, j / ps]
//
// over the positions j < min(lengths[b], nb * ps) of row b, with scores and
// sums in f32, the normaliser floored at 1e-30 and the output rounded once,
// at the end, to q's type, as the TPU kernel does (a row of length 0 gets
// zeros, as there). q is (B, KV, G, hd); the page pools are (num_pages, ps,
// KV, hd), contiguous (a per-layer view pool[l] of the (L, num_pages, ps, KV,
// hd) cache is); q and the pools each take f32 or bf16, independently.
//
// What bounds it: bytes. Each kept position costs K and V rows of hd values
// for every KV head, and 4*hd*G flops per head (a product and a sum for the
// score and for P.V, over G query rows): against 8*hd bytes of f32 pages
// that is G/2 = 4 flops per byte at G = 8, against 4*hd bytes of bf16 pages
// G = 8, both far below the f32 CUDA-core ridge of 67 TFLOP/s / 3.35 TB/s =
// 20 per byte. At the two shapes chip_smoke.py times (B = 8, KV = 4, G = 8,
// hd = 128, ps = 16): the decode cell (nb = 16, bf16 q over f32 pages, 488
// kept positions) moves ~2.13 MB, a bound of ~0.0006 ms, so the launch and
// the host cost more than the work; the long rows (nb = 256, lengths up to
// 4096, 18,851 kept positions) move 38.6 MB with bf16 pages (bound 0.0115
// ms) or 77.2 MB with f32 pages (0.0230 ms).
//
// What the design does about it. The TPU grid (B, KV, nb) carried the online
// softmax state along its sequential page axis. Here the page axis is cut
// into splits of `pps` pages (kernels/flash_attention/paged_attention.py::
// split_plan picks pps from the shapes alone, aiming at four blocks an SM),
// and the grid is (splits * KV, B): one 128-thread block a (split, head,
// row), so even short rows spread over the card. A block reads lengths[b]
// and exits at once if its split starts past the row's length.
// * Staged loads: the split's positions stream through a ring of kStages
//   (3 for f32 pages, 4 for bf16) tiles of 16 positions in shared memory,
//   K and V rows of the block's head, by 16-byte cp.async copies; a
//   position past the split's end is zero-filled and never read. The tiles
//   for the next stages are in flight while this tile's scores and P.V run.
//   cp.async rather than TMA: every position finds its page through the
//   block table, a (page, head) box is only 16 rows, and the pool's address
//   changes with the layer (64 tensor maps a decode step, K and V, to encode
//   or to cache), while a cp.async needs none.
// * Math. bf16 q over bf16 pages (G = 8 flops a byte): both products on
//   the tensor cores, mma.sync m16n8k16 bf16 with f32 sums: S^T = Q K^T with
//   the query rows as M (padded to 16; rows 8-15 fill the A fragment's
//   second and fourth registers when G > 8), 16 positions as N and hd as K, exact
//   (bf16 products, f32 sums; the scale is applied to the f32 scores), and
//   P.V with the softmax weights split into three bf16 parts, so they keep
//   f32 accuracy; each product starts from zero and is added in f32 outside
//   the tensor cores, so the long sums round as f32 sums do. Every warp computes the tile's scores and online
//   softmax itself (the score fragment is already P's A fragment) and P.V
//   for its quarter of hd: one barrier a tile. The other type pairs (f32
//   pages, G/2 = 4 flops a byte: the decode cell's bf16 q over the f32 slot
//   state) stay on the CUDA cores in f32: scores over 16 positions x 8 query
//   rows, each thread a 4 x 2 tile over one eighth of hd, summed over the
//   eight by a reduce-scatter of shuffles; a per-tile online softmax (16
//   lanes a query row); P.V with each thread 4 query rows x 4 head-dim values
//   over half the tile's positions; three barriers a tile.
// * Up to 16 query rows a KV head (qwen3-moe-235b-a22b: 64 over 4), as the
//   TPU kernel takes any G: G <= 8 runs the kernels built for 8 rows (MG =
//   8), unchanged; G <= 16 those built for 16. There a tensor-core lane
//   holds rows g and g + 8; a CUDA-core score lane an 8 x 2 tile (8
//   positions, the same 2 rows' q in registers), a softmax lane two rows, a
//   P.V lane 4 rows over all 16 positions (4 warps x 4 rows). They allow 2
//   (tensor cores) and 3 blocks an SM, for the registers the extra rows take.
// * The merge, in the same launch: a (row, head) with one live split writes
//   its output directly. Otherwise each live split writes (m, l, acc) for its
//   G query rows to an f32 workspace, and one thread adds one to the (row,
//   head)'s arrival counter with acquire-release order; the split that
//   arrives last merges the live splits in one online pass,
//   o = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30), 8
//   splits' loads in flight at a time, and sets the counter back to 0 for
//   the next call. The wrapper allocates the workspace and the counters once
//   per device and keeps them.
// * Occupancy: 128 threads, registers capped at 128 by __launch_bounds__
//   (4 blocks an SM; 168 and 3 blocks for the tensor-core path, which spilled
//   under 128); at hd 128 the ring takes 50,688 bytes (f32 pages) or
//   34,816 (bf16) of dynamic shared memory, plus ~1.2 KB of static (~2.2 KB
//   at MG = 16), so four blocks fit an SM's 227 KB either way.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;           // blocks an SM the registers must allow
constexpr int kMinBlocksMma = 3;        // the same for the tensor-core path
constexpr int kMaxG = 16;               // query rows per KV head
constexpr int kTile = 16;               // positions a stage holds
constexpr int kMaxDevices = 64;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <typename TP> struct Plan {
  static constexpr int kStages = sizeof(TP) == 4 ? 3 : 4;
  static constexpr int kPad = 16 / (int)sizeof(TP);        // one 16-byte chunk a row
};

template <typename TP, int HD> __host__ __device__ constexpr int row_elems() {
  return HD + Plan<TP>::kPad;
}

template <typename TP, int HD> __host__ __device__ constexpr int stage_elems() {
  return 2 * kTile * row_elems<TP, HD>();                   // K tile, then V tile
}

template <typename TP, int HD> __host__ __device__ constexpr int smem_bytes() {
  return Plan<TP>::kStages * stage_elems<TP, HD>() * (int)sizeof(TP);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive values from shared memory, as f32.
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// A 16-byte copy to shared memory; with `valid` false it writes zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b on the tensor cores: a 16x16 bf16 A (row), a 16x8 bf16 B (col), a
// 16x8 f32 accumulator, in mma.sync's register layouts: with g = lane / 4 and
// c = lane % 4, a[0] holds A[g][2c, 2c+1], a[1] A[g+8][2c..], a[2]
// A[g][2c+8..], a[3] A[g+8][2c+8..]; b0 B[2c, 2c+1][g], b1 B[2c+8..][g];
// d[0..1] D[g][2c, 2c+1], d[2..3] D[g+8][2c..].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// (x0, x1) as three bf16x2 parts, hi + mid + lo, each the bf16 of what the
// parts before it leave: the sum is within 2^-27 of x.
__device__ __forceinline__ void split3_bf16(float x0, float x1, uint32_t (&part)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    x0 -= hf.x;
    x1 -= hf.y;
    part[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 x0, __nv_bfloat16 x1) {
  const __nv_bfloat162 v(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Adds one to an arrival counter, in the GPU's order: what this thread and
// (through a preceding barrier) its block wrote before is visible to
// whoever counts after, and what they wrote before counting is visible
// here. Returns the count before.
__device__ __forceinline__ int arrive(int* counter) {
  int before;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(before) : "l"(counter) : "memory");
  return before;
}

// Copies the K and V rows of positions p0 .. p0 + 15 of one head into a
// stage, by 16-byte cp.async copies; positions at or past `end` are
// zero-filled and read nothing.
template <typename TP, int HD>
__device__ __forceinline__ void load_tile(TP* ks, int p0, int end, const int* table, int ps,
                                          const TP* k_pages, const TP* v_pages,
                                          long long pos_stride, long long head_off) {
  constexpr int ROW = row_elems<TP, HD>();
  constexpr int CE = 16 / (int)sizeof(TP);     // page values a 16-byte copy moves
  constexpr int CPR = HD / CE;                 // copies a row
  TP* vs = ks + kTile * ROW;
  for (int i = threadIdx.x; i < kTile * CPR; i += kThreads) {
    const int jj = i / CPR, c = i - jj * CPR;
    const int pos = p0 + jj;
    const bool valid = pos < end;
    long long e = 0;
    if (valid) {
      const int blk = pos / ps;
      const int page = __ldg(table + blk);
      e = ((long long)page * ps + (pos - blk * ps)) * pos_stride + head_off + c * CE;
    }
    cp_async16(ks + jj * ROW + c * CE, k_pages + e, valid);
    cp_async16(vs + jj * ROW + c * CE, v_pages + e, valid);
  }
}

// Blocks an SM the registers must allow: 16 query rows hold twice the
// tensor-core path's q fragments and sums, and the CUDA-core path's scores
// come 8 positions a thread instead of 4.
template <typename TQ, typename TP, int MG> __host__ __device__ constexpr int min_blocks() {
  return sizeof(TQ) == 2 && sizeof(TP) == 2 ? (MG > 8 ? 2 : kMinBlocksMma)
                                            : (MG > 8 ? 3 : kMinBlocks);
}

template <typename TQ, typename TP, int HD, int MG>
__global__ void __launch_bounds__(kThreads, min_blocks<TQ, TP, MG>())
paged_attention_split_kernel(const TQ* __restrict__ q, const TP* __restrict__ k_pages,
                             const TP* __restrict__ v_pages,
                             const int* __restrict__ block_table,
                             const int* __restrict__ lengths, TQ* __restrict__ out,
                             float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                             int* __restrict__ counters, int KV, int G, int ps, int nb,
                             int pps, int nsplit, float scale) {
  // bf16 q over bf16 pages: both products on the tensor cores
  constexpr bool MMA = sizeof(TQ) == 2 && sizeof(TP) == 2;
  constexpr int S = Plan<TP>::kStages;
  constexpr int ROW = row_elems<TP, HD>();
  constexpr int NQ = HD / 4;                   // groups of 4 head-dim values
  constexpr int QPL = (NQ + 7) / 8;            // such groups a score lane holds
  constexpr int KS = HD / 16;                  // 16-wide steps of hd (tensor cores)
  constexpr int PW = (KS + 3) / 4;             // pairs of 8-wide hd tiles a warp owns
  constexpr int RH = MG / 8;                   // query rows a lane holds: g, g + 8
  constexpr int PG = 4 * RH;                   // positions a score lane holds (CUDA cores)
  constexpr int NJ = kTile / PG;               // position groups of a tile
  constexpr int NP = 2 * PG;                   // a score lane's partial sums
  constexpr int NVG = MG / 4;                  // P.V lanes' groups of 4 query rows
  constexpr int NVH = 4 / NVG;                 // and their shares of a tile's positions
  static_assert(MG == 8 || MG == 16, "8 or 16 query rows per KV head");
  static_assert(HD % 16 == 0 && HD <= 128, "hd must be a multiple of 16, <= 128");
  static_assert(MG * HD * 4 <= smem_bytes<TP, HD>(), "the split's sums fit the ring");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  TP* stages = reinterpret_cast<TP*>(smem_raw);
  __shared__ float s_sm[MG][kTile];            // scores of the tile (CUDA cores)
  __shared__ __align__(16) float p_sm[kTile][MG];      // softmax weights of the tile
  __shared__ __align__(16) float alpha_sm[MG];         // rescale of the running sums
  __shared__ float ml_sm[2 * MG];              // the split's m and l per query row
  __shared__ int last_sm;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int split = blockIdx.x % nsplit, h = blockIdx.x / nsplit, b = blockIdx.y;
  const int bh = b * KV + h;
  const long long qrow = (long long)bh * G;

  // ---- q, in the registers of the path's layout ---------------------------
  // (read before the exit below, so its loads overlap the one of lengths[b])
  // CUDA cores: r = t % 8 takes head-dim groups r, r + 8, ... of query rows
  // 2 gp, 2 gp + 1, scaled; its score tile is positions PG jq .. PG jq + PG - 1.
  // Tensor cores: q is the A operand of S^T = Q K^T, rows gq and gq + 8 (< G)
  // of 16: qa[k][2 i] and qa[k][2 i + 1] hold row gq + 8 i.
  const int r = t & 7, jq = (t >> 3) % NJ, gp = (t >> 3) / NJ;
  const int gq = lane >> 2, cq = lane & 3;
  float qreg[MMA ? 1 : 2][MMA ? 1 : QPL][4];
  uint32_t qa[MMA ? KS : 1][2 * RH];
  if constexpr (MMA) {
#pragma unroll
    for (int k = 0; k < KS; ++k)
#pragma unroll
      for (int i = 0; i < RH; ++i) {
        const int g = gq + 8 * i;
        const TQ* qr = q + (qrow + g) * HD + 16 * k + 2 * cq;
        qa[k][2 * i] = g < G ? pack_bf16(qr[0], qr[1]) : 0u;
        qa[k][2 * i + 1] = g < G ? pack_bf16(qr[8], qr[9]) : 0u;
      }
  } else {
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) {
      const int g = 2 * gp + gi;
#pragma unroll
      for (int i = 0; i < QPL; ++i) {
        const int qd = r + 8 * i;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          qreg[gi][i][e] =
              (g < G && qd < NQ) ? to_f32(q[(qrow + g) * HD + 4 * qd + e]) * scale : 0.f;
      }
    }
  }

  const int length = lengths[b];
  const int cap = nb * ps;                     // never past the block table
  const int n = length < 0 ? 0 : min(length, cap);
  const int span = pps * ps;                   // positions a split covers
  const int live = n == 0 ? 1 : (n + span - 1) / span;
  if (split >= live) return;                   // past the row's length: nothing to do
  const int start = split * span;
  const int end = min(start + span, n);
  const int ntiles = (end - start + kTile - 1) / kTile;

  const int* table = block_table + (long long)b * nb;
  const long long pos_stride = (long long)KV * HD;   // elements between page rows
  const long long head_off = (long long)h * HD;
  auto stage_tile = [&](int tile) {            // one commit group a tile, empty or not
    if (tile < ntiles)
      load_tile<TP, HD>(stages + (tile % S) * stage_elems<TP, HD>(), start + tile * kTile,
                        end, table, ps, k_pages, v_pages, pos_stride, head_off);
    asm volatile("cp.async.commit_group;\n" ::);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) stage_tile(s);

  float* red = reinterpret_cast<float*>(smem_raw);   // [MG][HD] over the ring, after
  float m_run[RH], l_run[RH];                  // of this lane's query rows
#pragma unroll
  for (int i = 0; i < RH; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
  }

  if constexpr (MMA) {
    // ---- tensor cores: every warp computes the tile's scores and softmax
    // (16 positions x MG query rows, 2 x KS products), then P.V for its hd
    // pairs, P split into three bf16 parts so it keeps f32 accuracy. Each
    // product starts from a zero accumulator and is added in f32 outside
    // the tensor cores, so the long sums round as f32 sums do.
    const int mi = lane >> 3, ri = lane & 7;   // the 8x8 matrix and row a lane addresses
    float o[PW][2][2 * RH];                    // O[gq + 8 i][16 pair + 8 nt + 2 cq + e]
#pragma unroll
    for (int pw = 0; pw < PW; ++pw)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2 * RH; ++e) o[pw][nt][e] = 0.f;

    for (int tile = 0; tile < ntiles; ++tile) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 2) : "memory");
      __syncthreads();                         // tile landed; tile - 1's slot is free
      stage_tile(tile + S - 1);
      const TP* ks = stages + (tile % S) * stage_elems<TP, HD>();
      const TP* vs = ks + kTile * ROW;
      const int p0 = start + tile * kTile;

      // S^T = Q K^T: lane holds query row gq + 8 i at positions 2cq, 2cq+1
      // (sc[0][2 i ..]) and 8 + 2cq, 9 + 2cq (sc[1][2 i ..])
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + ((mi >> 1) * 8 + ri) * ROW + 16 * k + (mi & 1) * 8);
        const uint32_t a[4] = {qa[k][0], RH > 1 ? qa[k][RH] : 0u, qa[k][1],
                               RH > 1 ? qa[k][2 * RH - 1] : 0u};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(d, a, kb[2 * nt], kb[2 * nt + 1]);
#pragma unroll
          for (int e = 0; e < 2 * RH; ++e) sc[nt][e] += d[e];
        }
      }
      float alpha[RH];
      uint32_t lo_pos[RH][3], hi_pos[RH][3];   // positions 2cq.. and 8 + 2cq..
#pragma unroll
      for (int i = 0; i < RH; ++i) {
        float s4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = (e >> 1) * 8 + 2 * cq + (e & 1);
          s4[e] = p0 + j < end ? sc[e >> 1][2 * i + (e & 1)] * scale : kNegInf;
        }
        float mx = fmaxf(fmaxf(s4[0], s4[1]), fmaxf(s4[2], s4[3]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m_run[i], mx);
        float p[4], psum = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = __expf(s4[e] - m_new);
          psum += p[e];
        }
        psum += __shfl_xor_sync(kFull, psum, 1);
        psum += __shfl_xor_sync(kFull, psum, 2);
        alpha[i] = __expf(m_run[i] - m_new);
        l_run[i] = fmaf(l_run[i], alpha[i], psum);
        m_run[i] = m_new;
        split3_bf16(p[0], p[1], lo_pos[i]);
        split3_bf16(p[2], p[3], hi_pos[i]);
      }

      // O += P V over this warp's hd pairs
#pragma unroll
      for (int pw = 0; pw < PW; ++pw) {
        const int pair = warp + 4 * pw;
        if (pair < KS) {
          uint32_t vb[4];
          ldsm_x4_t(vb, vs + ((mi & 1) * 8 + ri) * ROW + 16 * pair + (mi >> 1) * 8);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int pi = 2; pi >= 0; --pi) {   // smallest part first
              const uint32_t a[4] = {lo_pos[0][pi], RH > 1 ? lo_pos[RH - 1][pi] : 0u,
                                     hi_pos[0][pi], RH > 1 ? hi_pos[RH - 1][pi] : 0u};
              mma_bf16(d, a, vb[2 * nt], vb[2 * nt + 1]);
            }
#pragma unroll
            for (int e = 0; e < 2 * RH; ++e)
              o[pw][nt][e] = fmaf(o[pw][nt][e], alpha[e >> 1], d[e]);
          }
        }
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();                           // the ring is free from here on
#pragma unroll
    for (int pw = 0; pw < PW; ++pw) {
      const int pair = warp + 4 * pw;
      if (pair < KS) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < RH; ++i) {
            const int d = 16 * pair + 8 * nt + 2 * cq;
            red[(gq + 8 * i) * HD + d] = o[pw][nt][2 * i];
            red[(gq + 8 * i) * HD + d + 1] = o[pw][nt][2 * i + 1];
          }
      }
    }
    if (warp == 0 && cq == 0) {
#pragma unroll
      for (int i = 0; i < RH; ++i) {
        ml_sm[gq + 8 * i] = m_run[i];
        ml_sm[MG + gq + 8 * i] = l_run[i];
      }
    }
  } else {
    // ---- CUDA cores: scores by the 2 x PG tiles above, the online softmax
    // with 16 lanes a query row (RH rows a lane), P.V with 4 query rows x 4
    // head-dim values over kTile / NVH positions a thread
    const int sg = t >> 4, sj = t & 15;        // softmax lane: query row, position
    const int vq = t & 31, vg = (t >> 5) % NVG, vh = (t >> 5) / NVG;   // P.V lane
    float acc[4][4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;

    for (int tile = 0; tile < ntiles; ++tile) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 2) : "memory");
      __syncthreads();                         // tile landed; tile - 1's slot is free
      stage_tile(tile + S - 1);
      const TP* ks = stages + (tile % S) * stage_elems<TP, HD>();
      const TP* vs = ks + kTile * ROW;
      const int p0 = start + tile * kTile;

      float part[NP];
#pragma unroll
      for (int o = 0; o < NP; ++o) part[o] = 0.f;
#pragma unroll
      for (int jj = 0; jj < PG; ++jj) {
#pragma unroll
        for (int i = 0; i < QPL; ++i) {
          const int qd = r + 8 * i;
          if (qd < NQ) {
            float kf[4];
            load4(ks + (PG * jq + jj) * ROW + 4 * qd, kf);
#pragma unroll
            for (int gi = 0; gi < 2; ++gi)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                part[2 * jj + gi] = fmaf(qreg[gi][i][e], kf[e], part[2 * jj + gi]);
          }
        }
      }
      // reduce-scatter over the 8 lanes of the hd shares: lane r ends with
      // the full scores of entries (NP / 8) r + c, c < NP / 8, entry 2 jj + gi
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) {
        const bool up = r & 4;
        const float send = up ? part[i] : part[i + NP / 2];
        part[i] = (up ? part[i + NP / 2] : part[i]) + __shfl_xor_sync(kFull, send, 4);
      }
#pragma unroll
      for (int i = 0; i < NP / 4; ++i) {
        const bool up = r & 2;
        const float send = up ? part[i] : part[i + NP / 4];
        part[i] = (up ? part[i + NP / 4] : part[i]) + __shfl_xor_sync(kFull, send, 2);
      }
#pragma unroll
      for (int i = 0; i < NP / 8; ++i) {
        const bool up = r & 1;
        const float send = up ? part[i] : part[i + NP / 8];
        part[i] = (up ? part[i + NP / 8] : part[i]) + __shfl_xor_sync(kFull, send, 1);
      }
#pragma unroll
      for (int c = 0; c < NP / 8; ++c) {
        const int e = (NP / 8) * r + c;
        const int j = PG * jq + (e >> 1);
        s_sm[2 * gp + (e & 1)][j] = p0 + j < end ? part[c] : kNegInf;
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < RH; ++i) {
        const int g = sg + 8 * i;
        const float s = s_sm[g][sj];
        float mx = s;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_new = fmaxf(m_run[i], mx);
        const float p = __expf(s - m_new);
        float psum = p;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) psum += __shfl_xor_sync(kFull, psum, o);
        const float alpha = __expf(m_run[i] - m_new);
        l_run[i] = fmaf(l_run[i], alpha, psum);
        m_run[i] = m_new;
        p_sm[sj][g] = p;
        if (sj == 0) alpha_sm[g] = alpha;
      }
      __syncthreads();

      if (vq < NQ) {
        const float4 a4 = *reinterpret_cast<const float4*>(&alpha_sm[4 * vg]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][e] *= a[g];
#pragma unroll
        for (int jj = 0; jj < kTile / NVH; ++jj) {
          const int j = (kTile / NVH) * vh + jj;
          float vf[4];
          load4(vs + j * ROW + 4 * vq, vf);
          const float4 p4 = *reinterpret_cast<const float4*>(&p_sm[j][4 * vg]);
          const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(pj[g], vf[e], acc[g][e]);
        }
      }
    }
    // the split's acc into red (with two position halves, summed there)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();                           // the ring is free from here on
    float* own = &red[(4 * vg) * HD + 4 * vq];
    if (vh == NVH - 1 && vq < NQ) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        *reinterpret_cast<float4*>(own + g * HD) =
            make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    }
    if constexpr (NVH == 2) {
      __syncthreads();
      if (vh == 0 && vq < NQ) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float4 o4 = *reinterpret_cast<const float4*>(own + g * HD);
          o4.x += acc[g][0]; o4.y += acc[g][1]; o4.z += acc[g][2]; o4.w += acc[g][3];
          *reinterpret_cast<float4*>(own + g * HD) = o4;
        }
      }
    }
    if (sj == 0) {
#pragma unroll
      for (int i = 0; i < RH; ++i) {
        ml_sm[sg + 8 * i] = m_run[i];
        ml_sm[MG + sg + 8 * i] = l_run[i];
      }
    }
  }
  __syncthreads();                             // red and ml_sm hold the split's result

  if (live == 1) {                             // the only split: write the output
    for (int idx = t; idx < G * HD; idx += kThreads) {
      const int g = idx / HD;
      out[qrow * HD + idx] = from_f32<TQ>(red[idx] / fmaxf(ml_sm[MG + g], 1e-30f));
    }
    return;
  }

  // ---- several live splits: publish, and the last to arrive merges --------
  const long long part_id = (long long)bh * nsplit + split;
  for (int idx = t; idx < G * NQ; idx += kThreads)
    reinterpret_cast<float4*>(ws_acc + part_id * G * HD)[idx] =
        reinterpret_cast<const float4*>(red)[idx];
  if (t < G) {
    ws_ml[part_id * 2 * G + t] = ml_sm[t];
    ws_ml[part_id * 2 * G + G + t] = ml_sm[MG + t];
  }
  // the block's writes, then one acquire-release count by thread 0: the
  // split that counts last sees every other split's partial
  __syncthreads();
  if (t == 0) last_sm = arrive(&counters[bh]) == live - 1;
  __syncthreads();
  if (!last_sm) return;

  const float* acc_bh = ws_acc + (long long)bh * nsplit * G * HD;
  const float* ml_bh = ws_ml + (long long)bh * nsplit * 2 * G;
  for (int idx = t; idx < G * NQ; idx += kThreads) {
    const int g = idx / NQ, qd = idx - g * NQ;
    // one online pass over the live splits, 8 at a time: their loads are in
    // flight together, then each is folded into the running (M, L, o)
    float M = kNegInf, L = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < live; s0 += 8) {
      float m[8], l[8];
      float4 a[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int sp = s0 + j;
        const bool in = sp < live;
        m[j] = in ? __ldcg(ml_bh + sp * 2 * G + g) : kNegInf;
        l[j] = in ? __ldcg(ml_bh + sp * 2 * G + G + g) : 0.f;
        a[j] = in ? __ldcg(reinterpret_cast<const float4*>(
                        acc_bh + ((long long)sp * G + g) * HD + 4 * qd))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float mn = fmaxf(M, m[j]);
        const float keep = __expf(M - mn);     // what is merged so far, rescaled
        const float c = __expf(m[j] - mn);     // this split's share
        L = L * keep + l[j] * c;
        o[0] = o[0] * keep + a[j].x * c;
        o[1] = o[1] * keep + a[j].y * c;
        o[2] = o[2] * keep + a[j].z * c;
        o[3] = o[3] * keep + a[j].w * c;
        M = mn;
      }
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[(qrow + g) * HD + 4 * qd + e] = from_f32<TQ>(o[e] * inv);
  }
  if (t == 0) counters[bh] = 0;                // ready for the next call
}

// What one call passes to the kernel.
struct Args {
  const void *q, *k_pages, *v_pages;
  const int *block_table, *lengths;
  void* out;
  float *ws_acc, *ws_ml;
  int* counters;
  int B, KV, G, ps, nb, pps, nsplit;
  float scale;
};

template <typename TQ, typename TP, int HD, int MG>
int launch(const Args& a, int device, cudaStream_t stream) {
  const auto kernel = paged_attention_split_kernel<TQ, TP, HD, MG>;
  constexpr int bytes = smem_bytes<TP, HD>();
  static bool configured[kMaxDevices] = {};    // the shared-memory opt-in, per device
  if (!configured[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured[device] = true;
  }
  const dim3 grid((unsigned)(a.nsplit * a.KV), (unsigned)a.B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TP*>(a.k_pages),
      static_cast<const TP*>(a.v_pages), a.block_table, a.lengths, static_cast<TQ*>(a.out),
      a.ws_acc, a.ws_ml, a.counters, a.KV, a.G, a.ps, a.nb, a.pps, a.nsplit, a.scale);
  return (int)cudaGetLastError();
}

// G <= 8 query rows a KV head take the 8-row kernels, up to 16 the 16-row ones
template <typename TQ, typename TP, int HD>
int by_group(const Args& a, int device, cudaStream_t s) {
  return a.G <= 8 ? launch<TQ, TP, HD, 8>(a, device, s) : launch<TQ, TP, HD, 16>(a, device, s);
}

template <typename TQ, typename TP>
int by_head_dim(int hd, const Args& a, int device, cudaStream_t s) {
  switch (hd) {
    case 32: return by_group<TQ, TP, 32>(a, device, s);
    case 64: return by_group<TQ, TP, 64>(a, device, s);
    case 80: return by_group<TQ, TP, 80>(a, device, s);
    case 128: return by_group<TQ, TP, 128>(a, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int by_type(int q_dtype, int page_dtype, int hd, const Args& a, int device, cudaStream_t s) {
  if (q_dtype == 0 && page_dtype == 0) return by_head_dim<float, float>(hd, a, device, s);
  if (q_dtype == 0 && page_dtype == 1)
    return by_head_dim<float, __nv_bfloat16>(hd, a, device, s);
  if (q_dtype == 1 && page_dtype == 0)
    return by_head_dim<__nv_bfloat16, float>(hd, a, device, s);
  if (q_dtype == 1 && page_dtype == 1)
    return by_head_dim<__nv_bfloat16, __nv_bfloat16>(hd, a, device, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_dtype, page_dtype: 0 = float32, 1 = bfloat16. All tensors contiguous, on
// `device`; block_table (B, nb) and lengths (B,) int32. The page axis is cut
// into ceil(nb / pages_per_split) splits. With more than one split,
// `workspace` holds B * KV * splits * G * (hd + 2) floats and `counters`
// B * KV ints, all 0 before the first call (each call leaves them 0). Calls
// sharing a workspace must be ordered (one stream of `device`). Launches on
// `device` and restores the caller's current device; returns
// cudaGetLastError() after the launch.
extern "C" int paged_attention_fwd(int q_dtype, int page_dtype, int hd, const void* q,
                                   const void* k_pages, const void* v_pages,
                                   const int* block_table, const int* lengths, void* out,
                                   float* workspace, int* counters, int B, int KV, int G,
                                   int ps, int nb, int pages_per_split, float scale,
                                   int device, void* stream) {
  if (B < 1 || B > 65535 || KV < 1 || G < 1 || G > kMaxG || ps < 1 || nb < 1 ||
      pages_per_split < 1 || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (nb + pages_per_split - 1) / pages_per_split;
  if ((long long)nsplit * KV > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (nsplit > 1 && (workspace == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, block_table, lengths, out, workspace,
               nsplit > 1 ? workspace + (long long)B * KV * nsplit * G * hd : nullptr,
               counters, B, KV, G, ps, nb, pages_per_split, nsplit, scale};
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int launched = by_type(q_dtype, page_dtype, hd, a, device,
                               static_cast<cudaStream_t>(stream));
  if (current != device) cudaSetDevice(current);
  return launched;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
