// Backward of the chunked gated linear recurrence (gla_scan.cu) for the NVIDIA
// H100 (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gla_scan/gla_scan.py::gla_scan
// under grad. That kernel has no backward: the reference differentiates its
// plain chunked form (src/repro/models/linear_scan.py::gla_chunked) through
// XLA. In the port the forward kernel is the recurrence on the card, so its
// gradient is a kernel too. Per batch row b and head h, with S_t the state
// after step t and G the gradient of the state carried backwards from
// dS_final:
//
//   dq_t = S_t do_t (inclusive) or S_{t-1} do_t (exclusive)
//   dk_t = G_t v_t,   dv_t = G_t^T k_t,   ds0 = G before the first step
//   dL/db_t = q_t * dq_t - k_t * dk_t (exclusive: q_{t+1} * dq_{t+1}), plus
//             sum_v dS_final * S_final at t = L - 1;  dld_t = sum_{t' >= t} dL/db_t'
//
// (b the prefix sum of ld; the plain version, kernels/gla_scan/ref.py::
// gla_chunked_bwd, writes the same chunk by chunk). Per chunk of c positions,
// with cum the within-chunk prefix sum of ld, cum_q = cum (inclusive) or cum -
// ld (exclusive), E[t,s,d] = e^{min(cum_q[t,d] - cum[s,d], 0)} under the mask
// and S0 the chunk's starting state:
//
//   dP[t,s] = do_t . v_s,   P[t,s] = sum_d q[t,d] k[s,d] E[t,s,d]
//   dq[t,d] = e^{cum_q[t,d]} (S0 do_t)[d] + sum_s dP[t,s] k[s,d] E[t,s,d]
//   dk[s,d] = sum_t dP[t,s] q[t,d] E[t,s,d] + e^{cum_end[d] - cum[s,d]} (G v_s)[d]
//   dv[s]   = sum_t P[t,s] do_t + G^T (k_s * e^{cum_end - cum_s})
//   G      <- e^{cum_end} * G + (q * e^{cum_q})^T do
//
// Every exponent is <= 0 for ld <= 0, as in the forward.
//
// Chunk starting states: the backward recomputes them. One block owns one
// (b, h); it first walks its chunks forwards from s0, then walks them in
// reverse with G in shared memory. On the way forward the CUDA-core kernel
// writes each chunk's starting state (dk x dv f32) to a scratch buffer the
// wrapper allocates (B, H, N_chunks, dk, dv: 67 MB at rwkv6-7b's flow shape);
// the tensor-core kernel writes instead the one term the state gives the
// reverse sweep, dq's e^{cum_q} (S0 do) (B, H, N_chunks c, dk f32: the same
// 67 MB there). Saving the states in the forward instead would hold them
// from each forward to its backward (32 layers of them at rwkv6-7b without
// recomputation) and change both forward kernels; the extra sweep reads k,
// v and ld (and do) once more and does one or two products a chunk.
//
// One group broadcast over the heads (zamba2's q and k, read with a stride of
// 0 on h): each block writes its head's dq and dk to an f32 workspace (B, L,
// H, dk), and a second kernel sums it over the heads in a fixed order, so the
// kernel returns (B, L, 1, dk) and two runs give the same bits. Blocks that
// own several heads of a group, reading q and k once and summing dq, dk in
// the block, are later work (ROADMAP Queue B item 14). One decay a head (ld's
// last dim 1, a stride of 0 on d): dld is summed over dk in the block.
//
// Two kernels, selected by type and shape alone, never after a failure, with
// the forward's rule (gla_scan.cu's uses_mma; gla_scan_bwd_uses_mma):
//
// * gla_scan_bwd_mma_kernel: bf16 q, k, v with dk and dv multiples of 16 up
//   to 128 and a chunk of 16, 32 or 64 (rwkv6-7b's and zamba2-2.7b's path).
// * gla_scan_bwd_kernel: everything else (f32 q, k, v; other sizes), on the
//   CUDA cores.
//
// What bounds it: at rwkv6-7b's flow shape (B 4, L 1024, H 64, dk = dv = 64,
// chunk 64, bf16 q/k/v/do, f32 ld) the function reads q, k, v, do, ld and
// writes dq, dk, dv, dld, ~370 MB (0.11 ms at 3.35 TB/s); its ~19 GFLOP of
// products take 0.02 ms at the bf16 peak, 0.29 ms at the f32 CUDA-core one.
// So on the tensor cores it is bound by bytes. The CUDA-core kernel instead
// reads every operand of every f32 FMA from shared memory and evaluates the
// per-channel exponential of E over the whole masked c x c x dk cube three
// times (P, dq, dk), on one block of ~180 KB an SM: shared-memory bandwidth
// and those exponentials bound it (6.8 ms at that shape, PERF.md). What
// bounds the tensor-core kernel in practice is its chain of short phases
// chunk after chunk, each (b, h) alone on its block (PERF.md).
//
// What the design does about it (gla_scan_bwd_mma_kernel, 8 warps; dk a
// template argument, so its loops unroll):
//
// * The starting state S0 of a chunk enters the backward only through dq's
//   term e^{cum_q} (S0 do); the forward sweep computes that term on the
//   tensor cores while it holds S0 and writes it (f32) to the scratch, and
//   the reverse sweep starts dq's accumulators from it. Neither S0 nor a
//   second state-sized buffer lives in the reverse sweep.
// * 16-row sub-chunks. With r_i = cum at the row before query sub-chunk i
//   and rho_j = cum at key sub-chunk j's last row, every factor below has an
//   exponent <= 0 (ld <= 0, as the reference assumes):
//     P_ij  = (q_i e^{cum_q - r_i}) (k_j e^{r_i - cum_j})^T                (i > j)
//     dq_i += e^{cum_q - rho_j} * (dP_ij (k_j e^{rho_j - cum_j}))          (i > j)
//     dk_j += e^{r_i - cum_j} * (dP_ij^T (q_i e^{cum_q - r_i}))            (i > j)
//   P's blocks are the forward's (about r_i). dq's sum over earlier keys is
//   taken about each key sub-chunk's last row and dk's over later queries
//   about the row before each query sub-chunk, so both products read one
//   bf16 copy each of k and q scaled once a chunk (K-bar, Q-bar), and the
//   factor that makes the reference points meet scales the accumulator.
//   dP = do v^T is recomputed on the tensor cores where a product needs it
//   as an operand (rows t for dq, rows s for dk), so no c x c dP tile lives
//   in shared memory.
// * The 16 x 16 diagonal blocks are cut into 8-row halves, as the forward's:
//   the lower-left 8 x 8 block is a product about cum at the 8th row, through
//   the same f32 factors F the forward uses (k e^{r - cum}, q e^{cum_q - r}),
//   and only the two 8 x 8 triangles take the clamped per-channel
//   exponential, masked by mode (key <= row, or key < row), for P, dq and dk.
// * Every other product is mma.sync.m16n8k16 bf16 with f32 sums: dP (both
//   orientations), dq's state term do S0^T, dk's v G^T, dv's
//   P^T do + (k e^{cum_end - cum}) G, the update of G by (q e^{cum_q})^T do
//   and the forward sweep's state update. An operand that is not an input as
//   given (scaled q and k, P, dP, S0, G) goes in as a bf16 high part plus a
//   bf16 low part (x - hi), two or three products, so each carries ~16 bits.
//   S0 and G stay f32 in shared memory and are summed in f32.
// * The diagonal blocks' terms of dq and dk run one (sub-chunk, column) a
//   thread, each triangle's exponential shared by the two sums; dq's are
//   added to its state term in the scratch, dk's staged f32 in shared
//   memory.
// * Units of dq, dk and dv are 16 rows of a sub-chunk by 16 columns; a warp
//   takes them in pairs of early and late sub-chunks (balanced_unit), so the
//   triangular work of dq (i earlier key blocks), dk (nsub - 1 - i later
//   query blocks) and dv evens out across warps. dk's accumulators stay in
//   registers from its diagonal terms to the write; dq's start from the
//   scratch in their own phase, one unit at a time.
// * Fragments come through ldmatrix (.trans where the reduction runs down
//   the rows); exponentials are ex2.approx of log2(e)-scaled cumulative
//   decays; q, k, v, do and ld are staged by 16-byte cp.async where their
//   rows allow it. ~112 KB of shared memory at c = dk = dv = 64 and at most
//   128 registers at dk <= 64: two blocks an SM. Wider dk (more units a warp,
//   larger tiles) takes one block an SM; dk = dv = 128 at a chunk of 64
//   needs ~238 KB and is refused, as the CUDA-core kernel refuses it.
// * dld: q dq (shifted a row in the exclusive mode) minus k dk is staged
//   f32 and summed in reverse by row segments in parallel. Every sum has a
//   fixed order and there are no atomics: two runs give the same bits.
//
// gla_scan_bwd_kernel (the CUDA-core path) keeps the first, plain form: f32
// FMAs with every operand read from shared memory, the per-channel
// exponentials of E evaluated for P, dq and dk, one block of 256 threads an
// SM (~180 KB of shared memory at c = dk = dv = 64); each chunk's starting
// state written to the scratch by the forward sweep. Rows of q, k, cum, dq,
// dk are padded to dk + 1 floats and of v, do, S0, G to dv + 1, so the loops
// that walk a column read distinct banks.
//
// Both read their inputs through their (b, l, h, d) strides, as the
// forward's; a ragged last chunk reads zeros past L (its rows add nothing to
// any gradient).
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

// Element strides (b, l, h, d) of q, k, v, ld and do, in that order.
struct Strides {
  long long s[20];
};

// Shared-memory plan, in floats.
struct Plan {
  int ldk, ldv, c, dk, dv;
  __host__ __device__ Plan(int dk_, int dv_, int c_)
      : ldk(dk_ + 1), ldv(dv_ + 1), c(c_), dk(dk_), dv(dv_) {}
  __host__ __device__ size_t floats() const {
    return 4 * (size_t)c * ldk + (size_t)(c + 1) * ldk + 2 * (size_t)c * ldv +
           2 * (size_t)c * c + 2 * (size_t)dk * ldv + 2 * (size_t)dk;
  }
};

template <typename T, typename TL>
__global__ void __launch_bounds__(kThreads)
gla_scan_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const TL* __restrict__ ld, const T* __restrict__ dout,
                    const float* __restrict__ s0, const float* __restrict__ dS_final,
                    float* states, T* __restrict__ dq, T* __restrict__ dk,
                    float* __restrict__ dq_ws, float* __restrict__ dk_ws, T* __restrict__ dv,
                    TL* __restrict__ dld, float* __restrict__ ds0, Strides st, int L, int H,
                    int DK, int DV, int c, int inclusive, int scalar_decay, int group) {
  extern __shared__ float smem[];
  const Plan pl(DK, DV, c);
  const int ldk = pl.ldk, ldv = pl.ldv;
  float* q_s = smem;                     // (c, ldk): q, then q * e^{cum_q}
  float* k_s = q_s + c * ldk;            // (c, ldk): k, then k * e^{cum_end - cum}
  float* cz = k_s + c * ldk;             // (c + 1, ldk): row 0 zeros, row t+1 = cum[t]
  float* dq_s = cz + (c + 1) * ldk;      // (c, ldk): dq, then q * dq
  float* dk_s = dq_s + c * ldk;          // (c, ldk): dk, then k * dk, then dld
  float* v_s = dk_s + c * ldk;           // (c, ldv)
  float* do_s = v_s + c * ldv;           // (c, ldv)
  float* P = do_s + c * ldv;             // (c, c)
  float* dP = P + c * c;                 // (c, c)
  float* S0 = dP + c * c;                // (dk, ldv): the chunk's starting state
  float* G = S0 + DK * ldv;              // (dk, ldv): the running state, then its gradient
  float* run = G + DK * ldv;             // (dk): sum of dL/db over the later positions
  float* q_next = run + DK;              // (dk): q * dq at the later chunk's first row

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const long long* s = st.s;
  const T* qb = q + b * s[0] + h * s[2];
  const T* kb = k + b * s[4] + h * s[6];
  const T* vb = v + b * s[8] + h * s[10];
  const TL* lb = ld + b * s[12] + h * s[14];
  const T* ob = dout + b * s[16] + h * s[18];
  const long long bh = (long long)b * H + h;
  const int n_chunks = (L + c - 1) / c;
  float* states_bh = states + bh * n_chunks * DK * DV;
  const int qrow = inclusive ? 1 : 0;    // cum_q[t] = cz[t + 1] or cz[t]
  const float* cend = cz + c * ldk;

  for (int i = tid; i < DK * DV; i += kThreads) {
    const int d = i / DV, j = i % DV;
    G[d * ldv + j] = s0 ? s0[bh * DK * DV + i] : 0.f;
  }
  for (int d = tid; d < DK; d += kThreads) cz[d] = 0.f;

  // 1. forwards: each chunk's starting state to the scratch buffer
  for (int ic = 0; ic < n_chunks; ++ic) {
    const int l0 = ic * c;
    const int n = L - l0 < c ? L - l0 : c;
    __syncthreads();                     // G is complete, the last chunk's k_s consumed
    for (int i = tid; i < DK * DV; i += kThreads)
      states_bh[(long long)ic * DK * DV + i] = G[(i / DV) * ldv + i % DV];
    for (int i = tid; i < c * DK; i += kThreads) {
      const int t = i / DK, d = i % DK;
      const bool in = t < n;
      const long long l = l0 + t;
      k_s[t * ldk + d] = in ? to_f32(kb[l * s[5] + d * s[7]]) : 0.f;
      cz[(t + 1) * ldk + d] = in ? to_f32(lb[l * s[13] + d * s[15]]) : 0.f;
    }
    for (int i = tid; i < c * DV; i += kThreads) {
      const int t = i / DV, j = i % DV;
      v_s[t * ldv + j] = t < n ? to_f32(vb[(l0 + t) * s[9] + j * s[11]]) : 0.f;
    }
    __syncthreads();
    for (int d = tid; d < DK; d += kThreads) {
      float acc = 0.f;
      for (int t = 1; t <= c; ++t) {
        acc += cz[t * ldk + d];
        cz[t * ldk + d] = acc;
      }
    }
    __syncthreads();
    for (int i = tid; i < c * DK; i += kThreads) {
      const int t = i / DK, d = i % DK;
      k_s[t * ldk + d] *= __expf(cend[d] - cz[(t + 1) * ldk + d]);
    }
    __syncthreads();
    for (int p = tid; p < DK * DV; p += kThreads) {
      const int d = p / DV, j = p % DV;
      float acc = __expf(cend[d]) * G[d * ldv + j];
      for (int t = 0; t < n; ++t) acc = fmaf(k_s[t * ldk + d], v_s[t * ldv + j], acc);
      G[d * ldv + j] = acc;
    }
  }
  __syncthreads();

  // G holds the final state: the dS_final term of dL/db at t = L - 1; then G
  // becomes the gradient of the final state
  for (int d = tid; d < DK; d += kThreads) {
    float acc = 0.f;
    if (dS_final)
      for (int j = 0; j < DV; ++j)
        acc = fmaf(dS_final[bh * DK * DV + d * DV + j], G[d * ldv + j], acc);
    run[d] = acc;
    q_next[d] = 0.f;
  }
  __syncthreads();
  for (int i = tid; i < DK * DV; i += kThreads)
    G[(i / DV) * ldv + i % DV] = dS_final ? dS_final[bh * DK * DV + i] : 0.f;

  // 2. backwards
  for (int ic = n_chunks - 1; ic >= 0; --ic) {
    const int l0 = ic * c;
    const int n = L - l0 < c ? L - l0 : c;
    __syncthreads();                     // the later chunk is done with every buffer

    // 2a. stage the chunk as f32 (zeros past L) and its starting state
    for (int i = tid; i < c * DK; i += kThreads) {
      const int t = i / DK, d = i % DK;
      const bool in = t < n;
      const long long l = l0 + t;
      q_s[t * ldk + d] = in ? to_f32(qb[l * s[1] + d * s[3]]) : 0.f;
      k_s[t * ldk + d] = in ? to_f32(kb[l * s[5] + d * s[7]]) : 0.f;
      cz[(t + 1) * ldk + d] = in ? to_f32(lb[l * s[13] + d * s[15]]) : 0.f;
    }
    for (int i = tid; i < c * DV; i += kThreads) {
      const int t = i / DV, j = i % DV;
      const bool in = t < n;
      const long long l = l0 + t;
      v_s[t * ldv + j] = in ? to_f32(vb[l * s[9] + j * s[11]]) : 0.f;
      do_s[t * ldv + j] = in ? to_f32(ob[l * s[17] + j * s[19]]) : 0.f;
    }
    for (int i = tid; i < DK * DV; i += kThreads)
      S0[(i / DV) * ldv + i % DV] = states_bh[(long long)ic * DK * DV + i];
    __syncthreads();

    // 2b. cum: prefix sum of ld over t, one column per thread
    for (int d = tid; d < DK; d += kThreads) {
      float acc = 0.f;
      for (int t = 1; t <= c; ++t) {
        acc += cz[t * ldk + d];
        cz[t * ldk + d] = acc;
      }
    }
    __syncthreads();

    // 2c. P and dP under the mask
    for (int p = tid; p < c * c; p += kThreads) {
      const int t = p / c, j = p % c;
      float sc = 0.f, dpv = 0.f;
      if (t < n && (inclusive ? j <= t : j < t)) {
        const float* qr = q_s + t * ldk;
        const float* kr = k_s + j * ldk;
        const float* cq = cz + (t + qrow) * ldk;
        const float* cs = cz + (j + 1) * ldk;
        for (int d = 0; d < DK; ++d)
          sc = fmaf(qr[d] * kr[d], __expf(fminf(cq[d] - cs[d], 0.f)), sc);
        const float* orow = do_s + t * ldv;
        const float* vr = v_s + j * ldv;
        for (int e = 0; e < DV; ++e) dpv = fmaf(orow[e], vr[e], dpv);
      }
      P[p] = sc;
      dP[p] = dpv;
    }
    __syncthreads();

    // 2d. dq (items < c dk) and dk (the next c dk items)
    for (int p = tid; p < 2 * c * DK; p += kThreads) {
      if (p < c * DK) {
        const int t = p / DK, d = p % DK;
        float acc = 0.f;
        if (t < n) {
          const float cq = cz[(t + qrow) * ldk + d];
          const float* orow = do_s + t * ldv;
          const float* srow = S0 + d * ldv;
          for (int e = 0; e < DV; ++e) acc = fmaf(orow[e], srow[e], acc);
          acc *= __expf(cq);
          const int s_end = inclusive ? t + 1 : t;
          const float* dpr = dP + t * c;
          for (int j = 0; j < s_end; ++j)
            acc = fmaf(dpr[j] * k_s[j * ldk + d],
                       __expf(fminf(cq - cz[(j + 1) * ldk + d], 0.f)), acc);
        }
        dq_s[t * ldk + d] = acc;
      } else {
        const int r = p - c * DK;
        const int j = r / DK, d = r % DK;
        float acc = 0.f;
        if (j < n) {
          const float cs = cz[(j + 1) * ldk + d];
          for (int t = inclusive ? j : j + 1; t < n; ++t)
            acc = fmaf(dP[t * c + j] * q_s[t * ldk + d],
                       __expf(fminf(cz[(t + qrow) * ldk + d] - cs, 0.f)), acc);
          const float* gr = G + d * ldv;
          const float* vr = v_s + j * ldv;
          float gv = 0.f;
          for (int e = 0; e < DV; ++e) gv = fmaf(gr[e], vr[e], gv);
          acc = fmaf(__expf(cend[d] - cs), gv, acc);
        }
        dk_s[j * ldk + d] = acc;
      }
    }
    __syncthreads();

    // 2e. dq and dk out (per head, or to the workspace that sums the group);
    // then q * dq and k * dk in place
    for (int i = tid; i < c * DK; i += kThreads) {
      const int t = i / DK, d = i % DK;
      const float gq = dq_s[t * ldk + d], gk = dk_s[t * ldk + d];
      if (t < n) {
        const long long o = ((long long)(b * L + l0 + t) * H + h) * DK + d;
        if (group) {
          dq_ws[o] = gq;
          dk_ws[o] = gk;
        } else {
          dq[o] = from_f32<T>(gq);
          dk[o] = from_f32<T>(gk);
        }
      }
      dq_s[t * ldk + d] = q_s[t * ldk + d] * gq;
      dk_s[t * ldk + d] = k_s[t * ldk + d] * gk;
    }
    __syncthreads();

    // 2f. dL/db and its reverse prefix sum, one column per thread: dk_s <- dld
    for (int d = tid; d < DK; d += kThreads) {
      float acc = run[d];
      for (int t = c - 1; t >= 0; --t) {
        const float qterm = inclusive ? dq_s[t * ldk + d]
                                      : (t + 1 < c ? dq_s[(t + 1) * ldk + d] : q_next[d]);
        acc += qterm - dk_s[t * ldk + d];
        dk_s[t * ldk + d] = acc;
      }
      run[d] = acc;
      if (!inclusive) q_next[d] = dq_s[d];
    }
    __syncthreads();

    // 2g. dld out; q * e^{cum_q} and k * e^{cum_end - cum} in place
    if (scalar_decay) {
      for (int t = tid; t < n; t += kThreads) {
        float acc = 0.f;
        for (int d = 0; d < DK; ++d) acc += dk_s[t * ldk + d];
        dld[(long long)(b * L + l0 + t) * H + h] = from_f32<TL>(acc);
      }
    } else {
      for (int i = tid; i < n * DK; i += kThreads) {
        const int t = i / DK, d = i % DK;
        dld[((long long)(b * L + l0 + t) * H + h) * DK + d] = from_f32<TL>(dk_s[t * ldk + d]);
      }
    }
    for (int i = tid; i < c * DK; i += kThreads) {
      const int t = i / DK, d = i % DK;
      q_s[t * ldk + d] *= __expf(cz[(t + qrow) * ldk + d]);
      k_s[t * ldk + d] *= __expf(cend[d] - cz[(t + 1) * ldk + d]);
    }
    __syncthreads();

    // 2h. dv[s] = sum_t P[t,s] do_t + G^T (k_s * e^{cum_end - cum_s})
    for (int p = tid; p < n * DV; p += kThreads) {
      const int j = p / DV, e = p % DV;
      float acc = 0.f;
      for (int t = inclusive ? j : j + 1; t < n; ++t)
        acc = fmaf(P[t * c + j], do_s[t * ldv + e], acc);
      const float* kr = k_s + j * ldk;
      for (int d = 0; d < DK; ++d) acc = fmaf(kr[d], G[d * ldv + e], acc);
      dv[((long long)(b * L + l0 + j) * H + h) * DV + e] = from_f32<T>(acc);
    }
    __syncthreads();

    // 2i. G <- e^{cum_end} * G + (q * e^{cum_q})^T do
    for (int p = tid; p < DK * DV; p += kThreads) {
      const int d = p / DV, e = p % DV;
      float acc = __expf(cend[d]) * G[d * ldv + e];
      for (int t = 0; t < n; ++t) acc = fmaf(q_s[t * ldk + d], do_s[t * ldv + e], acc);
      G[d * ldv + e] = acc;
    }
  }
  __syncthreads();
  if (ds0)
    for (int i = tid; i < DK * DV; i += kThreads) ds0[bh * DK * DV + i] = G[(i / DV) * ldv + i % DV];
}

// out[b, l, 0, d] = sum over h of ws[b, l, h, d], h in order
template <typename T>
__global__ void __launch_bounds__(kThreads)
sum_heads_kernel(const float* __restrict__ ws, T* __restrict__ out, long long rows, int H,
                 int DK) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * DK) return;
  const long long r = i / DK;
  const int d = (int)(i % DK);
  const float* w = ws + r * H * DK + d;
  float acc = 0.f;
  for (int h = 0; h < H; ++h) acc += w[(long long)h * DK];
  out[i] = from_f32<T>(acc);
}

// dq and dk of one group: the f32 workspaces summed over the heads
template <typename T>
int sum_heads(const float* dq_ws, const float* dk_ws, void* dq, void* dk, int B, int L, int H,
              int DK, cudaStream_t stream) {
  const long long rows = (long long)B * L;
  const unsigned blocks = (unsigned)((rows * DK + kThreads - 1) / kThreads);
  sum_heads_kernel<T><<<blocks, kThreads, 0, stream>>>(dq_ws, static_cast<T*>(dq), rows, H, DK);
  sum_heads_kernel<T><<<blocks, kThreads, 0, stream>>>(dk_ws, static_cast<T*>(dk), rows, H, DK);
  return (int)cudaGetLastError();
}

template <typename T, typename TL>
int launch(const void* q, const void* k, const void* v, const void* ld, const void* dout,
           const float* s0, const float* dS_final, float* states, void* dq, void* dk,
           float* dq_ws, float* dk_ws, void* dv, void* dld, float* ds0, const Strides& st, int B,
           int L, int H, int DK, int DV, int c, int inclusive, int scalar_decay, int group,
           cudaStream_t stream) {
  const size_t bytes = Plan(DK, DV, c).floats() * sizeof(float);
  auto kernel = gla_scan_bwd_kernel<T, TL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)H, (unsigned)B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TL*>(ld), static_cast<const T*>(dout), s0, dS_final, states,
      static_cast<T*>(dq), static_cast<T*>(dk), dq_ws, dk_ws, static_cast<T*>(dv),
      static_cast<TL*>(dld), ds0, st, L, H, DK, DV, c, inclusive, scalar_decay, group);
  err = cudaGetLastError();
  if (err != cudaSuccess || !group) return (int)err;
  return sum_heads<T>(dq_ws, dk_ws, dq, dk, B, L, H, DK, stream);
}


// ---------------------------------------------------------------------------
// bf16: sub-chunked, products on the tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDd = 20;  // row of the diagonal dP tiles: 16 keys, padded

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

// A fragments (high and low parts) of a 16 x 16 block held as two 16 x 8
// accumulators: element e is (row g or g+8) x (n-tile 0 or 1), as mma lays
// them out.
__device__ __forceinline__ void acc_to_a(const float (&acc)[2][4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split_bf16(acc[e >> 1][2 * (e & 1)], acc[e >> 1][2 * (e & 1) + 1], hi[e], lo[e]);
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

// Two 8x8 matrices (lanes 0-15 give the row addresses).
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// A fragments of rows r0..r0+15, columns k0..k0+15 of a row-major bf16 tile.
__device__ __forceinline__ void ldsm_a(uint32_t (&r)[4], const __nv_bfloat16* tile, int ld,
                                       int r0, int k0, int lane) {
  ldsm_x4(r, tile + (r0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3));
}

// B fragments of two n-tiles, B[k][n] = tile[n0 + n][k0 + k] (rows of the
// tile are B's columns): registers 0, 1 for n0..n0+7, 2, 3 for n0+8..n0+15.
__device__ __forceinline__ void ldsm_b_rows(uint32_t (&r)[4], const __nv_bfloat16* tile,
                                            int ld, int n0, int k0, int lane) {
  ldsm_x4(r, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                 (((lane >> 3) & 1) << 3));
}

// B fragments of two n-tiles, B[k][n] = tile[k0 + k][n0 + n] (the tile's rows
// run down the reduction): registers 0, 1 for n0..n0+7, 2, 3 for n0+8..n0+15.
__device__ __forceinline__ void ldsm_b_cols(uint32_t (&r)[4], const __nv_bfloat16* tile,
                                            int ld, int k0, int n0, int lane) {
  ldsm_x4_t(r, tile + (k0 + (lane & 15)) * ld + n0 + ((lane >> 4) << 3));
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

// stage_rows for ld of either dtype (ld_bf16: bf16, else f32), element offset
// `off` into it.
__device__ __forceinline__ void stage_ld(void* dst, int ld, const void* src, long long off,
                                         long long s_l, long long s_d, int n, int c, int width,
                                         int ld_bf16, bool vec) {
  if (ld_bf16)
    stage_rows(static_cast<__nv_bfloat16*>(dst), ld,
               static_cast<const __nv_bfloat16*>(src) + off, s_l, s_d, n, c, width, vec);
  else
    stage_rows(static_cast<float*>(dst), ld, static_cast<const float*>(src) + off, s_l, s_d, n,
               c, width, vec);
}

__device__ __forceinline__ void store_ld(void* dst, long long i, float x, int ld_bf16) {
  if (ld_bf16) static_cast<__nv_bfloat16*>(dst)[i] = __float2bfloat16(x);
  else static_cast<float*>(dst)[i] = x;
}

// The unit that a warp's u-th slot (u = warp + 8m) takes: the second half of
// the units in reverse, so a warp pairs early sub-chunks with late ones and
// the triangular work of dq (earlier key blocks), dk (later query blocks)
// and dv evens out across warps.
__device__ __forceinline__ int balanced_unit(int u, int n_units) {
  const int half = n_units / 2;
  return u < half ? u : n_units - 1 + half - u;
}

// Shared-memory plan of gla_scan_bwd_mma_kernel (element counts; every buffer
// and row a multiple of 16 bytes, so ldmatrix, cp.async and 16-byte loads
// stay aligned). `region` holds P (c, ldp) and the diagonal dP tiles (c, kDd)
// until dv is written, then the dld terms (c, ldc).
struct MmaPlan {
  int ldq, ldv, ldc, lds, ldp, region;
  __host__ __device__ MmaPlan(int dk, int dv, int c)
      : ldq(dk + 8), ldv(dv + 8), ldc(dk + 4), lds(dv + 4), ldp(c + 4),
        region(c * (c + 4) + c * kDd > c * (dk + 4) ? c * (c + 4) + c * kDd : c * (dk + 4)) {}
};

size_t mma_smem_bytes(int dk, int dv, int c) {
  const MmaPlan P(dk, dv, c);
  return 2 * (4 * (size_t)c * P.ldq + 2 * (size_t)c * P.ldv) +  // q, k, X hi, lo; v, do
         4 * ((size_t)(c + 1) * P.ldc + (size_t)dk * P.lds + P.region +
              kMmaThreads + 4 * (size_t)dk);  // cum, G, region, scan totals, run, q_next
}

// S <- e^{cum_end} S + A^T B for A (c, dk) in bf16 high and low parts (Xh, Xl,
// rows t) and B (c, dv) bf16 (rows t): 16 x 16 blocks of S a warp.
template <int DK>
__device__ __forceinline__ void state_update(float* S, int lds, const __nv_bfloat16* Xh,
                                             const __nv_bfloat16* Xl, int ldq,
                                             const __nv_bfloat16* Bs, int ldb,
                                             const float* cend, int dv, int c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int nb = dv >> 4;
  for (int u = warp; u < (DK / 16) * nb; u += kMmaWarps) {
    const int m0 = 16 * (u / nb), n0 = 16 * (u % nb);
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
    for (int ks = 0; ks < c; ks += 16) {
      uint32_t ah[4], al[4], bv[4];
      const int ar = ks + (lane & 7) + ((lane >> 4) << 3), ac = m0 + (((lane >> 3) & 1) << 3);
      ldsm_x4_t(ah, Xh + ar * ldq + ac);
      ldsm_x4_t(al, Xl + ar * ldq + ac);
      ldsm_b_cols(bv, Bs, ldb, ks, n0, lane);
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
        float2* sp = reinterpret_cast<float2*>(S + d * lds + n0 + 8 * h2 + 2 * tq);
        const float2 old = *sp;
        *sp = make_float2(fmaf(decay, old.x, acc[h2][2 * half]),
                          fmaf(decay, old.y, acc[h2][2 * half + 1]));
      }
    }
  }
}

// acc[h2] += A S^T for A 16 rows of a bf16 tile (as given) and S (dk, ds)
// f32, in high and low parts: columns n0..n0+15 of the product (rows of S).
__device__ __forceinline__ void times_state_t(float (&acc)[2][4], const __nv_bfloat16* As,
                                              int lda, int r0, const float* S, int lds,
                                              int n0, int width, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  for (int ks = 0; ks < width; ks += 16) {
    uint32_t a[4];
    ldsm_a(a, As, lda, r0, ks, lane);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float* sr = S + (n0 + 8 * h2 + g) * lds + ks + 2 * tq;  // B column g: a row of S
      const float2 x0 = *reinterpret_cast<const float2*>(sr);
      const float2 x1 = *reinterpret_cast<const float2*>(sr + 8);
      uint32_t bh0, bl0, bh1, bl1;
      split_bf16(x0.x, x0.y, bh0, bl0);
      split_bf16(x1.x, x1.y, bh1, bl1);
      mma_bf16(acc[h2], a, bl0, bl1);
      mma_bf16(acc[h2], a, bh0, bh1);
    }
  }
}

// cz[t + 1] = log2(e) cum[t] over t < c from ld staged at lraw (rows of lld):
// each column cut into kSeg segments of rows, summed apart, then each offset
// by the sums of the segments before it.
template <int DK>
__device__ __forceinline__ void cum_scan(float* cz, int ldc, const void* lraw, int lld,
                                         int ld_bf16, float* tot, int c) {
  constexpr int kSeg = kMmaThreads / DK;
  const int tid = threadIdx.x, d = tid % DK, sg = tid / DK;
  const int seg_rows = (c + kSeg - 1) / kSeg;
  const int t0 = sg * seg_rows, t1 = min(c, t0 + seg_rows);
  if (sg < kSeg) {
    float run = 0.f;
    for (int t = t0; t < t1; ++t) {
      const float x = ld_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(lraw)[t * lld + d])
                              : static_cast<const float*>(lraw)[t * lld + d];
      run = fmaf(kLog2e, x, run);
      cz[(t + 1) * ldc + d] = run;
    }
    tot[sg * DK + d] = run;
  }
  __syncthreads();
  if (sg < kSeg && sg > 0) {
    float off = 0.f;
    for (int s2 = 0; s2 < sg; ++s2) off += tot[s2 * DK + d];
    for (int t = t0; t < t1; ++t) cz[(t + 1) * ldc + d] += off;
  }
  __syncthreads();
}

// The diagonal 16 x 16 block's terms of dq and dk in column d of sub-chunk
// i0 / 16, in f32, one thread: the two 8 x 8 triangles with the clamped
// per-channel exponential, masked by mode (key <= row, or key < row), each
// exponential shared by dq's and dk's sums; the lower-left 8 x 8 block about
// rh = cum at the 8th row, through k e^{rh - cum} (first half) and
// q e^{cum_q - rh} (last half). dq's terms are added to dq_rows (the state
// term is there), dk's written to dk_rows.
template <bool INCL>
__device__ __forceinline__ void diag_column(const float* cz, int ldc, const __nv_bfloat16* Qs,
                                            const __nv_bfloat16* Ks, int ldq, const float* Dd,
                                            int i0, int d, int qrow, float* dq_rows, int dq_ld,
                                            float* dk_rows, int dk_ld) {
  const float rh = cz[(i0 + 8) * ldc + d];
  float fk[8], elo[8], dkl[8];  // the first half's k e^{rh - cum}, e^{rh - cum}, dk
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int b0 = i0 + 8 * half;
    float q[8], k[8], cq[8], cs[8], dq[8], dk[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      q[r] = __bfloat162float(Qs[(b0 + r) * ldq + d]);
      k[r] = __bfloat162float(Ks[(b0 + r) * ldq + d]);
      cq[r] = cz[(b0 + r + qrow) * ldc + d];
      cs[r] = cz[(b0 + r + 1) * ldc + d];
      dq[r] = dk[r] = 0.f;
    }
    const float* dd = Dd + b0 * kDd + 8 * half;  // dP[b0 + row][b0 + key]
#pragma unroll
    for (int tt = 0; tt < 8; ++tt)
#pragma unroll
      for (int ss = 0; ss < 8; ++ss)
        if (INCL ? ss <= tt : ss < tt) {
          const float pd = dd[tt * kDd + ss];
          const float e = ex2(fminf(cq[tt] - cs[ss], 0.f));
          dq[tt] = fmaf(pd * k[ss], e, dq[tt]);
          dk[ss] = fmaf(pd * q[tt], e, dk[ss]);
        }
    if (half == 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        elo[r] = ex2(rh - cs[r]);
        fk[r] = k[r] * elo[r];
        dkl[r] = dk[r];
        dq_rows[r * dq_ld + d] += dq[r];
      }
    } else {
      const float* ll = Dd + b0 * kDd;          // dP[last-half row][first-half key]
      float llk[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int tt = 0; tt < 8; ++tt) {
        const float fq = q[tt] * ex2(cq[tt] - rh);
        float acc = 0.f;
#pragma unroll
        for (int ss = 0; ss < 8; ++ss) {
          const float pd = ll[tt * kDd + ss];
          acc = fmaf(pd, fk[ss], acc);
          llk[ss] = fmaf(pd, fq, llk[ss]);
        }
        dq_rows[(8 + tt) * dq_ld + d] += fmaf(ex2(cq[tt] - rh), acc, dq[tt]);
        dk_rows[(8 + tt) * dk_ld + d] = dk[tt];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) dk_rows[r * dk_ld + d] = fmaf(elo[r], llk[r], dkl[r]);
    }
  }
}

// Per batch row b and head h: a forward sweep over the chunks from s0 that
// writes dq's state term e^{cum_q} (S0 do) to dqs, then a reverse sweep with
// G, the gradient of the chunk's final state, in shared memory. cum is kept
// as log2(e) cum, so every exponential is one ex2.approx.
template <int DK>
__global__ void __launch_bounds__(kMmaThreads, DK <= 64 ? 2 : 1)
gla_scan_bwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const void* __restrict__ ld,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ s0,
                        const float* __restrict__ dS_final, float* dqs,
                        __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                        float* __restrict__ dq_ws, float* __restrict__ dk_ws,
                        __nv_bfloat16* __restrict__ dv, void* __restrict__ dld,
                        float* __restrict__ ds0, Strides st, int L, int H, int DV, int c,
                        int inclusive, int scalar_decay, int group, int ld_bf16, int vec) {
  constexpr int KS = DK / 16;                                  // 16-column blocks of dk
  constexpr int kUnits = (4 * KS + kMmaWarps - 1) / kMmaWarps;  // dq / dk units a warp
  constexpr int kSeg = kMmaThreads / DK;                       // scan segments a column
  extern __shared__ uint4 smem16[];
  const MmaPlan P(DK, DV, c);
  const int ldq = P.ldq, ldv = P.ldv, ldc = P.ldc, lds = P.lds, ldp = P.ldp;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem16);  // (c, ldq) q
  __nv_bfloat16* Ks = Qs + c * ldq;                              // (c, ldq) k
  // (c, ldq) twice: bf16 ld as given (staging), the diagonal blocks' f32
  // factors F, then the high and low parts of q-bar, k-bar, q e^{cum_q} and
  // (forward sweep) k e^{cum_end - cum}
  __nv_bfloat16* Xh = Ks + c * ldq;
  __nv_bfloat16* Xl = Xh + c * ldq;
  __nv_bfloat16* Vs = Xl + c * ldq;                              // (c, ldv) v
  __nv_bfloat16* Os = Vs + c * ldv;                              // (c, ldv) do
  float* cz = reinterpret_cast<float*>(Os + c * ldv);  // (c + 1, ldc): 0, log2e cum[t]
  float* G = cz + (c + 1) * ldc;                       // (dk, lds): S, then its gradient
  float* Ps = G + DK * lds;                            // (c, ldp) P under the mask
  float* Dd = Ps + c * ldp;                            // (c, kDd) dP's diagonal blocks
  float* DB = Ps;                                      // (c, ldc) then the dld terms
  float* tot = Ps + P.region;                          // (kSeg, dk) scan segment sums
  float* run = tot + kMmaThreads;                      // (2, dk) dld carried from later chunks
  float* qn = run + 2 * DK;                            // (2, dk) q dq at the later chunk's row 0
  float* F = reinterpret_cast<float*>(Xh);
  const int fld = DK + 4;
  // ld as given: f32 straight into cz's rows 1..c, bf16 into Xh (free until 2b)
  void* lraw = ld_bf16 ? static_cast<void*>(Xh) : static_cast<void*>(cz + ldc);
  const int lld = ld_bf16 ? DK : ldc;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const long long* s = st.s;
  const __nv_bfloat16* qb = q + b * s[0] + h * s[2];
  const __nv_bfloat16* kb = k + b * s[4] + h * s[6];
  const __nv_bfloat16* vb = v + b * s[8] + h * s[10];
  const long long lo_b = b * s[12] + h * s[14];
  const __nv_bfloat16* ob = dout + b * s[16] + h * s[18];
  const long long bh = (long long)b * H + h;
  const int n_chunks = (L + c - 1) / c;
  const int nsub = c >> 4;                // 16-row sub-chunks
  const int n_units = nsub * KS;          // (sub-chunk, 16 columns of dk)
  float* dqs_bh = dqs + bh * n_chunks * c * DK;
  const int qrow = inclusive ? 1 : 0;     // cum_q[t] = cz[t + 1] or cz[t]
  const float* cend = cz + c * ldc;

  for (int i = tid; i < DK * DV; i += kMmaThreads)
    G[(i / DV) * lds + i % DV] = s0 ? s0[bh * DK * DV + i] : 0.f;
  for (int d = tid; d < DK; d += kMmaThreads) cz[d] = 0.f;

  // 1. forwards: dq's state term, then S <- e^{cum_end} S + (k e^{cum_end - cum})^T v
  for (int ic = 0; ic < n_chunks; ++ic) {
    const int l0 = ic * c;
    const int n = L - l0 < c ? L - l0 : c;
    stage_rows(Ks, ldq, kb + l0 * s[5], s[5], s[7], n, c, DK, vec & 2);
    stage_rows(Vs, ldv, vb + l0 * s[9], s[9], s[11], n, c, DV, vec & 4);
    stage_ld(lraw, lld, ld, lo_b + l0 * s[13], s[13], s[15], n, c, DK, ld_bf16, vec & 8);
    stage_rows(Os, ldv, ob + l0 * s[17], s[17], s[19], n, c, DV, vec & 16);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    cum_scan<DK>(cz, ldc, lraw, lld, ld_bf16, tot, c);

    // 1a. e^{cum_q} (do S^T), one (sub-chunk, 16 columns of dk) unit a warp
    for (int u = warp; u < n_units; u += kMmaWarps) {
      const int r0 = 16 * (u / KS), n0 = 16 * (u % KS);
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      times_state_t(acc, Os, ldv, r0, G, lds, n0, DV, lane);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int d = n0 + 8 * h2 + 2 * tq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = r0 + g + 8 * half;
          const float* cq = cz + (t + qrow) * ldc + d;
          *reinterpret_cast<float2*>(dqs_bh + (long long)(l0 + t) * DK + d) =
              make_float2(acc[h2][2 * half] * ex2(cq[0]), acc[h2][2 * half + 1] * ex2(cq[1]));
        }
      }
    }
    // 1b. k e^{cum_end - cum} into Xh / Xl
    for (int p = tid; p < c * (DK / 2); p += kMmaThreads) {
      const int t = p / (DK / 2), d = 2 * (p % (DK / 2));
      const float2 x = ld_bf16x2(Ks + t * ldq + d);
      const float* cs = cz + (t + 1) * ldc + d;
      uint32_t hi, lo;
      split_bf16(x.x * ex2(cend[d] - cs[0]), x.y * ex2(cend[d + 1] - cs[1]), hi, lo);
      *reinterpret_cast<uint32_t*>(Xh + t * ldq + d) = hi;
      *reinterpret_cast<uint32_t*>(Xl + t * ldq + d) = lo;
    }
    __syncthreads();
    state_update<DK>(G, lds, Xh, Xl, ldq, Vs, ldv, cend, DV, c);
    __syncthreads();
  }

  // G holds the final state: the dS_final term of dL/db at t = L - 1; then G
  // becomes the gradient of the final state
  for (int d = tid; d < DK; d += kMmaThreads) {
    float acc = 0.f;
    if (dS_final)
      for (int j = 0; j < DV; ++j)
        acc = fmaf(dS_final[bh * DK * DV + d * DV + j], G[d * lds + j], acc);
    run[d] = acc;
    qn[d] = 0.f;
  }
  __syncthreads();
  for (int i = tid; i < DK * DV; i += kMmaThreads)
    G[(i / DV) * lds + i % DV] = dS_final ? dS_final[bh * DK * DV + i] : 0.f;

  // 2. backwards; run and qn alternate halves by chunk (par: this chunk reads)
  int par = 0;
  for (int ic = n_chunks - 1; ic >= 0; --ic, par ^= 1) {
    const int l0 = ic * c;
    const int n = L - l0 < c ? L - l0 : c;

    // 2a. stage q, k, v, do and ld (rows past L read as zeros); cum
    stage_rows(Qs, ldq, qb + l0 * s[1], s[1], s[3], n, c, DK, vec & 1);
    stage_rows(Ks, ldq, kb + l0 * s[5], s[5], s[7], n, c, DK, vec & 2);
    stage_rows(Vs, ldv, vb + l0 * s[9], s[9], s[11], n, c, DV, vec & 4);
    stage_ld(lraw, lld, ld, lo_b + l0 * s[13], s[13], s[15], n, c, DK, ld_bf16, vec & 8);
    stage_rows(Os, ldv, ob + l0 * s[17], s[17], s[19], n, c, DV, vec & 16);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    cum_scan<DK>(cz, ldc, lraw, lld, ld_bf16, tot, c);

    // 2b. the diagonal blocks' lower-left 8 x 8 factors about rh = cum at the
    // 8th row of the sub-chunk (cz row 16i + 8), f32 in Xh / Xl's space: row t
    // of F holds k e^{rh - cum} (first 8 rows of a sub-chunk) or q e^{cum_q - rh}
    // (last 8 rows)
    for (int p = tid; p < c * (DK / 2); p += kMmaThreads) {
      const int t = p / (DK / 2), d = 2 * (p % (DK / 2));
      const float* rh = cz + ((t & ~15) + 8) * ldc + d;
      float2 x, e;
      if (t & 8) {
        const float* cq = cz + (t + qrow) * ldc + d;
        x = ld_bf16x2(Qs + t * ldq + d);
        e = make_float2(cq[0] - rh[0], cq[1] - rh[1]);
      } else {
        const float* cs = cz + (t + 1) * ldc + d;
        x = ld_bf16x2(Ks + t * ldq + d);
        e = make_float2(rh[0] - cs[0], rh[1] - cs[1]);
      }
      *reinterpret_cast<float2*>(F + t * fld + d) = make_float2(x.x * ex2(e.x), x.y * ex2(e.y));
    }
    __syncthreads();

    // 2c. warps 2i and 2i+1: P's diagonal block i (its lower-left block from
    // F, its two 8 x 8 triangles with per-channel clamped exponentials, zeros
    // where the mode masks) and dP's (do_i v_i^T, key n-tile warp & 1) into Dd
    if ((warp >> 1) < nsub) {
      const int Lp = 32 * (warp & 1) + lane, r0 = 16 * (warp >> 1);
      {
        const float* fq = F + (r0 + 8 + (Lp >> 3)) * fld;
        const float* fk = F + (r0 + (Lp & 7)) * fld;
        float acc = 0.f;
#pragma unroll 4
        for (int d = 0; d < DK; d += 4) {
          const float4 x = *reinterpret_cast<const float4*>(fq + d);
          const float4 y = *reinterpret_cast<const float4*>(fk + d);
          acc = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, acc))));
        }
        Ps[(r0 + 8 + (Lp >> 3)) * ldp + r0 + (Lp & 7)] = acc;
      }
      const int tri = inclusive ? 36 : 28;  // kept pairs of one 8 x 8 triangle
      for (int p = Lp; p < 2 * tri; p += 64) {
        int idx = p < tri ? p : p - tri, r = inclusive ? 0 : 1;
        while (idx >= r + inclusive) idx -= r++ + inclusive;  // row r keeps r (+1) keys
        const int row = r0 + (p < tri ? 0 : 8) + r, key = row - r + idx;
        const __nv_bfloat16* qr = Qs + row * ldq;
        const __nv_bfloat16* kr = Ks + key * ldq;
        const float* cq = cz + (row + qrow) * ldc;
        const float* cs = cz + (key + 1) * ldc;
        float acc = 0.f;
#pragma unroll 4
        for (int d = 0; d < DK; d += 2) {
          const float2 qq = ld_bf16x2(qr + d), kk = ld_bf16x2(kr + d);
          const float2 a = *reinterpret_cast<const float2*>(cq + d);
          const float2 z = *reinterpret_cast<const float2*>(cs + d);
          acc = fmaf(qq.x * kk.x, ex2(fminf(a.x - z.x, 0.f)), acc);
          acc = fmaf(qq.y * kk.y, ex2(fminf(a.y - z.y, 0.f)), acc);
        }
        Ps[row * ldp + key] = acc;
      }
      for (int e = Lp; e < 256; e += 64) {
        const int r = e >> 4, k2 = e & 15;
        if (inclusive ? k2 > r : k2 >= r) Ps[(r0 + r) * ldp + r0 + k2] = 0.f;
      }
      const int kt = 8 * (warp & 1);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ks = 0; ks < DV; ks += 16) {
        uint32_t a[4], bq[2];
        ldsm_a(a, Os, ldv, r0, ks, lane);
        ldsm_x2(bq, Vs + (r0 + kt + (lane & 7)) * ldv + ks + (((lane >> 3) & 1) << 3));
        mma_bf16(acc, a, bq[0], bq[1]);
      }
      *reinterpret_cast<float2*>(Dd + (r0 + g) * kDd + kt + 2 * tq) = make_float2(acc[0], acc[1]);
      *reinterpret_cast<float2*>(Dd + (r0 + g + 8) * kDd + kt + 2 * tq) =
          make_float2(acc[2], acc[3]);
    }
    __syncthreads();

    // 2d. the diagonal blocks' terms of dq (into the scratch, beside its state
    // term) and of dk (f32 into Xh / Xl's space, free until 2e), one (sub-chunk,
    // column) a thread
    float* dkd = reinterpret_cast<float*>(Xh);
    for (int u = tid; u < nsub * DK; u += kMmaThreads) {
      const int i0 = 16 * (u / DK), d = u % DK;
      float* dq_rows = dqs_bh + (long long)(l0 + i0) * DK;
      if (inclusive) diag_column<true>(cz, ldc, Qs, Ks, ldq, Dd, i0, d, qrow, dq_rows, DK,
                                       dkd + i0 * fld, fld);
      else diag_column<false>(cz, ldc, Qs, Ks, ldq, Dd, i0, d, qrow, dq_rows, DK,
                              dkd + i0 * fld, fld);
    }
    __syncthreads();

    // 2d'. each warp's dk units (slot warp + 8m takes unit u = balanced_unit:
    // sub-chunk u / KS, columns 16 (u % KS)) start from their diagonal terms
    // (dq's units start in 2i)
    float ak[kUnits][2][4];
#pragma unroll
    for (int m = 0; m < kUnits; ++m) {
      const int slot = warp + kMmaWarps * m, u = balanced_unit(slot, n_units);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = 16 * (u / KS) + g + 8 * half, d = 16 * (u % KS) + 8 * h2 + 2 * tq;
          const float2 y = slot < n_units ? *reinterpret_cast<const float2*>(dkd + t * fld + d)
                                          : make_float2(0.f, 0.f);
          ak[m][h2][2 * half] = y.x;
          ak[m][h2][2 * half + 1] = y.y;
        }
    }
    __syncthreads();

    // 2e. q-bar = q e^{cum_q - r_i} for sub-chunks i >= 1, r_i = cum at row
    // 16i - 1 (cz row 16i), into Xh / Xl
    for (int p = tid; p < (c - 16) * (DK / 2); p += kMmaThreads) {
      const int t = 16 + p / (DK / 2), d = 2 * (p % (DK / 2));
      const float2 x = ld_bf16x2(Qs + t * ldq + d);
      const float* cq = cz + (t + qrow) * ldc + d;
      const float* rz = cz + (t & ~15) * ldc + d;
      uint32_t hi, lo;
      split_bf16(x.x * ex2(cq[0] - rz[0]), x.y * ex2(cq[1] - rz[1]), hi, lo);
      *reinterpret_cast<uint32_t*>(Xh + t * ldq + d) = hi;
      *reinterpret_cast<uint32_t*>(Xl + t * ldq + d) = lo;
    }
    __syncthreads();

    // 2f. P's off-diagonal blocks (i, j < i) into Ps, one key n-tile (8 keys) a
    // unit, spread over the warps
    for (int u = warp; u < nsub * (nsub - 1); u += kMmaWarps) {
      int i = 1, j = u >> 1;
      while (j >= i) j -= i++;
      const int r0 = 16 * i, key = 16 * j + 8 * (u & 1) + g;  // B column g: a key row
      const float* rz = cz + r0 * ldc;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        ldsm_a(ah, Xh, ldq, r0, 16 * ks, lane);
        ldsm_a(al, Xl, ldq, r0, 16 * ks, lane);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int d = 16 * ks + 2 * tq + 8 * half;
          const float2 kk = ld_bf16x2(Ks + key * ldq + d);
          const float2 cs = *reinterpret_cast<const float2*>(cz + (key + 1) * ldc + d);
          const float2 r = *reinterpret_cast<const float2*>(rz + d);
          split_bf16(kk.x * ex2(r.x - cs.x), kk.y * ex2(r.y - cs.y), bh[half], bl[half]);
        }
        mma_bf16x3(acc, ah, al, bh[0], bh[1], bl[0], bl[1]);
      }
      float* pr = Ps + (r0 + g) * ldp + 16 * j + 8 * (u & 1) + 2 * tq;
      *reinterpret_cast<float2*>(pr) = make_float2(acc[0], acc[1]);
      *reinterpret_cast<float2*>(pr + 8 * ldp) = make_float2(acc[2], acc[3]);
    }

    // 2g. dk's units: the later query sub-chunks i, e^{r_i - cum} (dP_ij^T
    // q-bar_i) with dP_ij^T = v_j do_i^T recomputed here, and the state term
    // e^{cum_end - cum} (v G^T)
#pragma unroll
    for (int m = 0; m < kUnits; ++m) {
      const int slot = warp + kMmaWarps * m, u = balanced_unit(slot, n_units);
      if (slot >= n_units) continue;
      const int j0 = 16 * (u / KS), n0 = 16 * (u % KS);
      for (int i0 = j0 + 16; i0 < c; i0 += 16) {
        float dpt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int ks = 0; ks < DV; ks += 16) {
          uint32_t a[4], bo[4];
          ldsm_a(a, Vs, ldv, j0, ks, lane);
          ldsm_b_rows(bo, Os, ldv, i0, ks, lane);
          mma_bf16(dpt[0], a, bo[0], bo[1]);
          mma_bf16(dpt[1], a, bo[2], bo[3]);
        }
        uint32_t ah[4], al[4], bh[4], bl[4];
        acc_to_a(dpt, ah, al);
        ldsm_b_cols(bh, Xh, ldq, i0, n0, lane);
        ldsm_b_cols(bl, Xl, ldq, i0, n0, lane);
        float tmp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        mma_bf16x3(tmp[0], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma_bf16x3(tmp[1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        const float* ri = cz + i0 * ldc;                 // r_i: cum at row i0 - 1
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int sr = j0 + g + 8 * (e >> 1), d = n0 + 8 * h2 + 2 * tq + (e & 1);
            ak[m][h2][e] = fmaf(ex2(ri[d] - cz[(sr + 1) * ldc + d]), tmp[h2][e], ak[m][h2][e]);
          }
      }
      float vg[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      times_state_t(vg, Vs, ldv, j0, G, lds, n0, DV, lane);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int sr = j0 + g + 8 * (e >> 1), d = n0 + 8 * h2 + 2 * tq + (e & 1);
          ak[m][h2][e] = fmaf(ex2(cend[d] - cz[(sr + 1) * ldc + d]), vg[h2][e], ak[m][h2][e]);
        }
    }
    __syncthreads();

    // 2h. dv[s] = sum_t P[t,s] do_t + G^T (k_s e^{cum_end - cum_s}), 16 rows by
    // 16 columns a unit; and k-bar = k e^{rho_j - cum} (rho_j = cum at the last
    // row of the key's sub-chunk, cz row 16j + 16) into Xh / Xl
    {
      const int nbv = DV >> 4;
      for (int slot = warp; slot < nsub * nbv; slot += kMmaWarps) {
        const int u = balanced_unit(slot, nsub * nbv);
        const int j0 = 16 * (u / nbv), e0 = 16 * (u % nbv);
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int i0 = j0; i0 < c; i0 += 16) {
          // P^T's A fragments: element e is (key j0 + g (+8)) x (query i0 + 2tq (+8))
          uint32_t ph[4], pl[4], bv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float* pc = Ps + (i0 + 2 * tq + 8 * (e >> 1)) * ldp + j0 + g + 8 * (e & 1);
            split_bf16(pc[0], pc[ldp], ph[e], pl[e]);
          }
          ldsm_b_cols(bv, Os, ldv, i0, e0, lane);
          mma_bf16(acc[0], pl, bv[0], bv[1]);
          mma_bf16(acc[0], ph, bv[0], bv[1]);
          mma_bf16(acc[1], pl, bv[2], bv[3]);
          mma_bf16(acc[1], ph, bv[2], bv[3]);
        }
        for (int ks = 0; ks < DK; ks += 16) {
          uint32_t kh[4], kl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int sr = j0 + g + 8 * (e & 1), d = ks + 2 * tq + 8 * (e >> 1);
            const float2 x = ld_bf16x2(Ks + sr * ldq + d);
            const float* cs = cz + (sr + 1) * ldc + d;
            split_bf16(x.x * ex2(cend[d] - cs[0]), x.y * ex2(cend[d + 1] - cs[1]), kh[e], kl[e]);
          }
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float* sr = G + (ks + 2 * tq) * lds + e0 + 8 * h2 + g;  // B column g
            uint32_t bh0, bl0, bh1, bl1;
            split_bf16(sr[0], sr[lds], bh0, bl0);
            split_bf16(sr[8 * lds], sr[9 * lds], bh1, bl1);
            mma_bf16x3(acc[h2], kh, kl, bh0, bh1, bl0, bl1);
          }
        }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int sr = j0 + g + 8 * half;
            if (sr < n)
              *reinterpret_cast<__nv_bfloat162*>(
                  dv + ((long long)(b * L + l0 + sr) * H + h) * DV + e0 + 8 * h2 + 2 * tq) =
                  __floats2bfloat162_rn(acc[h2][2 * half], acc[h2][2 * half + 1]);
          }
      }
    }
    for (int p = tid; p < c * (DK / 2); p += kMmaThreads) {
      const int t = p / (DK / 2), d = 2 * (p % (DK / 2));
      const float2 x = ld_bf16x2(Ks + t * ldq + d);
      const float* cs = cz + (t + 1) * ldc + d;
      const float* rho = cz + ((t | 15) + 1) * ldc + d;
      uint32_t hi, lo;
      split_bf16(x.x * ex2(rho[0] - cs[0]), x.y * ex2(rho[1] - cs[1]), hi, lo);
      *reinterpret_cast<uint32_t*>(Xh + t * ldq + d) = hi;
      *reinterpret_cast<uint32_t*>(Xl + t * ldq + d) = lo;
    }
    __syncthreads();

    // 2i. dq's units, one at a time: from the scratch (the state and diagonal
    // terms), the earlier key sub-chunks j, e^{cum_q - rho_j} (dP_ij k-bar_j)
    // with dP_ij = do_i v_j^T recomputed here; then dq out, and q dq into DB's
    // row t (inclusive) or t - 1 (exclusive; row 0 to qn, the later chunk's
    // row 0 to DB's last row)
    for (int slot = warp; slot < n_units; slot += kMmaWarps) {
      const int u = balanced_unit(slot, n_units);
      const int i0 = 16 * (u / KS), n0 = 16 * (u % KS);
      float aq[2][4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 x = *reinterpret_cast<const float2*>(
              dqs_bh + (long long)(l0 + i0 + g + 8 * half) * DK + n0 + 8 * h2 + 2 * tq);
          aq[h2][2 * half] = x.x;
          aq[h2][2 * half + 1] = x.y;
        }
      for (int j0 = 0; j0 < i0; j0 += 16) {
        float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int ks = 0; ks < DV; ks += 16) {
          uint32_t a[4], bv[4];
          ldsm_a(a, Os, ldv, i0, ks, lane);
          ldsm_b_rows(bv, Vs, ldv, j0, ks, lane);
          mma_bf16(dp[0], a, bv[0], bv[1]);
          mma_bf16(dp[1], a, bv[2], bv[3]);
        }
        uint32_t ah[4], al[4], bh[4], bl[4];
        acc_to_a(dp, ah, al);
        ldsm_b_cols(bh, Xh, ldq, j0, n0, lane);
        ldsm_b_cols(bl, Xl, ldq, j0, n0, lane);
        float tmp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        mma_bf16x3(tmp[0], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma_bf16x3(tmp[1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        const float* rj = cz + (j0 + 16) * ldc;          // rho_j: cum at row j0 + 15
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = i0 + g + 8 * (e >> 1), d = n0 + 8 * h2 + 2 * tq + (e & 1);
            aq[h2][e] = fmaf(ex2(cz[(t + qrow) * ldc + d] - rj[d]), tmp[h2][e], aq[h2][e]);
          }
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = i0 + g + 8 * half, d = n0 + 8 * h2 + 2 * tq;
          const float x0 = aq[h2][2 * half], x1 = aq[h2][2 * half + 1];
          const long long o = ((long long)(b * L + l0 + t) * H + h) * DK + d;
          if (t < n) {
            if (group) *reinterpret_cast<float2*>(dq_ws + o) = make_float2(x0, x1);
            else *reinterpret_cast<__nv_bfloat162*>(dq + o) = __floats2bfloat162_rn(x0, x1);
          }
          const float2 qq = ld_bf16x2(Qs + t * ldq + d);
          const float2 qd = make_float2(qq.x * x0, qq.y * x1);
          if (inclusive) *reinterpret_cast<float2*>(DB + t * ldc + d) = qd;
          else if (t > 0) *reinterpret_cast<float2*>(DB + (t - 1) * ldc + d) = qd;
          else *reinterpret_cast<float2*>(qn + (par ^ 1) * DK + d) = qd;
          if (!inclusive && t == c - 1)
            *reinterpret_cast<float2*>(DB + t * ldc + d) =
                *reinterpret_cast<const float2*>(qn + par * DK + d);
        }
    }
    __syncthreads();

    // 2j. dk out, and DB -= k dk; q e^{cum_q} into Xh / Xl
#pragma unroll
    for (int m = 0; m < kUnits; ++m) {
      const int slot = warp + kMmaWarps * m, u = balanced_unit(slot, n_units);
      if (slot >= n_units) continue;
      const int j0 = 16 * (u / KS), n0 = 16 * (u % KS);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = j0 + g + 8 * half, d = n0 + 8 * h2 + 2 * tq;
          const float x0 = ak[m][h2][2 * half], x1 = ak[m][h2][2 * half + 1];
          const long long o = ((long long)(b * L + l0 + t) * H + h) * DK + d;
          if (t < n) {
            if (group) *reinterpret_cast<float2*>(dk_ws + o) = make_float2(x0, x1);
            else *reinterpret_cast<__nv_bfloat162*>(dk + o) = __floats2bfloat162_rn(x0, x1);
          }
          const float2 kk = ld_bf16x2(Ks + t * ldq + d);
          float2* db = reinterpret_cast<float2*>(DB + t * ldc + d);
          const float2 old = *db;
          *db = make_float2(old.x - kk.x * x0, old.y - kk.y * x1);
        }
    }
    for (int p = tid; p < c * (DK / 2); p += kMmaThreads) {
      const int t = p / (DK / 2), d = 2 * (p % (DK / 2));
      const float2 x = ld_bf16x2(Qs + t * ldq + d);
      const float* cq = cz + (t + qrow) * ldc + d;
      uint32_t hi, lo;
      split_bf16(x.x * ex2(cq[0]), x.y * ex2(cq[1]), hi, lo);
      *reinterpret_cast<uint32_t*>(Xh + t * ldq + d) = hi;
      *reinterpret_cast<uint32_t*>(Xl + t * ldq + d) = lo;
    }
    __syncthreads();

    // 2k. dld: reverse sums of DB down each column by segments of rows, each
    // then offset by the later segments' sums and run (the later chunks');
    // between the two halves G <- e^{cum_end} G + (q e^{cum_q})^T do
    {
      const int d = tid % DK, sg = tid / DK;
      const int seg_rows = (c + kSeg - 1) / kSeg;
      const int t0 = sg * seg_rows, t1 = min(c, t0 + seg_rows);
      if (sg < kSeg) {
        float acc = 0.f;
        for (int t = t1 - 1; t >= t0; --t) {
          acc += DB[t * ldc + d];
          DB[t * ldc + d] = acc;
        }
        tot[sg * DK + d] = acc;
      }
      state_update<DK>(G, lds, Xh, Xl, ldq, Os, ldv, cend, DV, c);
      __syncthreads();
      if (sg < kSeg) {
        float off = run[par * DK + d];
        for (int s2 = sg + 1; s2 < kSeg; ++s2) off += tot[s2 * DK + d];
        for (int t = t0; t < t1; ++t) {
          const float x = DB[t * ldc + d] + off;
          DB[t * ldc + d] = x;
          if (!scalar_decay && t < n)
            store_ld(dld, ((long long)(b * L + l0 + t) * H + h) * DK + d, x, ld_bf16);
        }
        if (sg == 0) run[(par ^ 1) * DK + d] = t1 > t0 ? DB[d] : off;
      }
      if (scalar_decay) {
        __syncthreads();
        for (int t = tid; t < n; t += kMmaThreads) {
          float acc = 0.f;
          for (int d2 = 0; d2 < DK; ++d2) acc += DB[t * ldc + d2];
          store_ld(dld, (long long)(b * L + l0 + t) * H + h, acc, ld_bf16);
        }
      }
    }
    __syncthreads();
  }
  if (ds0)
    for (int i = tid; i < DK * DV; i += kMmaThreads) ds0[bh * DK * DV + i] = G[(i / DV) * lds + i % DV];
}

// The selection rule (the forward's): bf16 q, k, v with dk, dv multiples of
// 16 up to 128 and a chunk of 16, 32 or 64 take the tensor-core kernel.
bool uses_mma(int qkv_dtype, int dk, int dv, int c) {
  return qkv_dtype == 1 && dk % 16 == 0 && dv % 16 == 0 && dk <= 128 && dv <= 128 &&
         (c == 16 || c == 32 || c == 64);
}

// 1, 2, 4, 8, 16: q, k, v, ld, do may be copied 16 bytes at a time (d stride
// 1, base and row strides 16-byte aligned).
int vec_flags(const void* const* ptrs, const size_t* elem, const long long* st, const int* width) {
  int flags = 0;
  for (int i = 0; i < 5; ++i) {
    const long long* s = st + 4 * i;
    const long long per = 16 / (long long)elem[i];
    const bool ok = s[3] == 1 && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0 &&
                    s[0] % per == 0 && s[1] % per == 0 && s[2] % per == 0 &&
                    width[i] % per == 0;
    flags |= ok ? 1 << i : 0;
  }
  return flags;
}

template <int DK>
int launch_mma_dk(const void* q, const void* k, const void* v, const void* ld, const void* dout,
                  const float* s0, const float* dS_final, float* scratch, void* dq, void* dk,
                  float* dq_ws, float* dk_ws, void* dv, void* dld, float* ds0, const Strides& st,
                  int B, int L, int H, int DV, int c, int inclusive, int scalar_decay, int group,
                  int ld_bf16, cudaStream_t stream) {
  const size_t bytes = mma_smem_bytes(DK, DV, c);
  auto kernel = gla_scan_bwd_mma_kernel<DK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const void* ptrs[5] = {q, k, v, ld, dout};
  const size_t elem[5] = {2, 2, 2, ld_bf16 ? 2u : 4u, 2};
  const int width[5] = {DK, DK, DV, DK, DV};
  const int vec = vec_flags(ptrs, elem, st.s, width);
  const dim3 grid((unsigned)H, (unsigned)B);
  kernel<<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), ld, static_cast<const __nv_bfloat16*>(dout), s0,
      dS_final, scratch, static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      dq_ws, dk_ws, static_cast<__nv_bfloat16*>(dv), dld, ds0, st, L, H, DV, c, inclusive,
      scalar_decay, group, ld_bf16, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || !group) return (int)err;
  return sum_heads<__nv_bfloat16>(dq_ws, dk_ws, dq, dk, B, L, H, DK, stream);
}

// dk is a template argument of the tensor-core kernel (its loops over dk
// unroll); ld's dtype is read at run time (one instantiation a dk)
int launch_mma(const void* q, const void* k, const void* v, const void* ld, const void* dout,
               const float* s0, const float* dS_final, float* scratch, void* dq, void* dk,
               float* dq_ws, float* dk_ws, void* dv, void* dld, float* ds0, const Strides& st,
               int B, int L, int H, int DK, int DV, int c, int inclusive, int scalar_decay,
               int group, int ld_bf16, cudaStream_t stream) {
  switch (DK) {
#define GLA_BWD_DK(D)                                                                        \
  case D:                                                                                    \
    return launch_mma_dk<D>(q, k, v, ld, dout, s0, dS_final, scratch, dq, dk, dq_ws, dk_ws, \
                            dv, dld, ds0, st, B, L, H, DV, c, inclusive, scalar_decay,      \
                            group, ld_bf16, stream);
    GLA_BWD_DK(16) GLA_BWD_DK(32) GLA_BWD_DK(48) GLA_BWD_DK(64) GLA_BWD_DK(80)
    GLA_BWD_DK(96) GLA_BWD_DK(112) GLA_BWD_DK(128)
#undef GLA_BWD_DK
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// 1 when gla_scan_bwd launches the tensor-core kernel for these types and
// sizes, 0 when it launches the CUDA-core one (chunk already cut to L).
extern "C" int gla_scan_bwd_uses_mma(int qkv_dtype, int dk, int dv, int chunk) {
  return uses_mma(qkv_dtype, dk, dv, chunk) ? 1 : 0;
}

// Dynamic shared memory one block of the kernel that gla_scan_bwd selects
// needs (the wrapper refuses sizes past the card's per-block limit before
// launching).
extern "C" long long gla_scan_bwd_smem_bytes(int qkv_dtype, int dk, int dv, int chunk) {
  if (uses_mma(qkv_dtype, dk, dv, chunk)) return (long long)mma_smem_bytes(dk, dv, chunk);
  return (long long)(Plan(dk, dv, chunk).floats() * sizeof(float));
}

// qkv_dtype (q, k, v, do, dq, dk, dv), ld_dtype (ld, dld): 0 = float32, 1 =
// bfloat16. Launches the kernel that gla_scan_bwd_uses_mma names. strides: 20
// element strides, (b, l, h, d) of q, k, v, ld and do (a stride of 0 on h for
// one group's q and k, on d for one decay a head). s0, dS_final (may be null)
// and ds0 (null when s0 is) are contiguous (B, H, dk, dv) f32. scratch is
// f32: B H ceil(L / chunk) dk dv floats for the CUDA-core kernel (the chunks'
// starting states), B H ceil(L / chunk) chunk dk for the tensor-core one (dq's
// state term). dv is contiguous (B, L, H, dv); dld contiguous (B, L, H, dk),
// or (B, L, H) when scalar_decay; dq and dk contiguous (B, L, H, dk), or with
// `group` (B, L, dk), summed from the f32 workspaces dq_ws and dk_ws of (B, L,
// H, dk) (null otherwise). Returns cudaGetLastError() after the launches.
extern "C" int gla_scan_bwd(int qkv_dtype, int ld_dtype, int inclusive, int scalar_decay,
                            int group, const void* q, const void* k, const void* v,
                            const void* ld, const void* dout, const float* s0,
                            const float* dS_final, float* scratch, void* dq, void* dk,
                            float* dq_ws, float* dk_ws, void* dv, void* dld, float* ds0, int B,
                            int L, int H, int dk_, int dv_, int chunk, const long long* strides,
                            void* stream) {
  if (B < 1 || B > 65535 || H < 1 || L < 1 || dk_ < 1 || dv_ < 1 || chunk < 1 || chunk > L ||
      (group && (dq_ws == nullptr || dk_ws == nullptr)))
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 20; ++i) st.s[i] = strides[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (uses_mma(qkv_dtype, dk_, dv_, chunk)) {
    if (ld_dtype != 0 && ld_dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_mma(q, k, v, ld, dout, s0, dS_final, scratch, dq, dk, dq_ws, dk_ws, dv, dld,
                      ds0, st, B, L, H, dk_, dv_, chunk, inclusive, scalar_decay, group,
                      ld_dtype, s);
  }
#define GLA_BWD(T, TL)                                                                      \
  return launch<T, TL>(q, k, v, ld, dout, s0, dS_final, scratch, dq, dk, dq_ws, dk_ws, dv, \
                       dld, ds0, st, B, L, H, dk_, dv_, chunk, inclusive, scalar_decay,   \
                       group, s);
  if (qkv_dtype == 0 && ld_dtype == 0) GLA_BWD(float, float)
  if (qkv_dtype == 0 && ld_dtype == 1) GLA_BWD(float, __nv_bfloat16)
  if (qkv_dtype == 1 && ld_dtype == 0) GLA_BWD(__nv_bfloat16, float)
  if (qkv_dtype == 1 && ld_dtype == 1) GLA_BWD(__nv_bfloat16, __nv_bfloat16)
#undef GLA_BWD
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
