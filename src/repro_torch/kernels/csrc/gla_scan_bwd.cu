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
// (b, h); it first walks its chunks forwards from s0, writing each chunk's
// starting state (dk x dv f32) to a scratch buffer the wrapper allocates
// (B, H, N_chunks, dk, dv: 67 MB at rwkv6-7b's flow shape), then walks them in
// reverse with G in shared memory. Saving the states in the forward instead
// would hold them from each forward to its backward (32 layers of them at
// rwkv6-7b without recomputation) and change both forward kernels; the extra
// sweep reads k, v and ld once more and does one product a chunk, against the
// reverse sweep's five.
//
// One group broadcast over the heads (zamba2's q and k, read with a stride of
// 0 on h): each block writes its head's dq and dk to an f32 workspace (B, L,
// H, dk), and a second kernel sums it over the heads in a fixed order, so the
// kernel returns (B, L, 1, dk) and two runs give the same bits. One decay a
// head (ld's last dim 1, a stride of 0 on d): dld is summed over dk in the
// block.
//
// What bounds it: at rwkv6-7b's flow shape (B 4, L 1024, H 64, dk = dv = 64,
// chunk 64, bf16 q/k/v/do, f32 ld) the function reads q, k, v, do, ld and
// writes dq, dk, dv, dld, ~370 MB (0.11 ms at 3.35 TB/s); its ~19 GFLOP of
// products take 0.02 ms at the bf16 peak, 0.29 ms at the f32 CUDA-core one.
// This version runs on the CUDA cores, so those operations, read from shared
// memory, and the per-channel exponentials bound it in practice.
//
// What the design does about it: this first version is the plain one, as
// gla_scan.cu's CUDA-core kernel: f32 FMAs with every operand read from
// shared memory, the per-channel exponentials of E evaluated three times (P,
// dq, dk), one block of 256 threads an SM (~180 KB of shared memory at c =
// dk = dv = 64). Rows of q, k, cum, dq, dk are padded to dk + 1 floats and of
// v, do, S0, G to dv + 1, so the loops that walk a column read distinct
// banks. Every sum is f32 and in a fixed order, with no atomics: two runs
// give the same bits. Inputs are read through their (b, l, h, d) strides, as
// the forward's; a ragged last chunk reads zeros past L (its rows add nothing
// to any gradient). Tensor cores are later work (ROADMAP Queue B item 14).
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
  const long long rows = (long long)B * L;
  const unsigned blocks = (unsigned)((rows * DK + kThreads - 1) / kThreads);
  sum_heads_kernel<T><<<blocks, kThreads, 0, stream>>>(dq_ws, static_cast<T*>(dq), rows, H, DK);
  sum_heads_kernel<T><<<blocks, kThreads, 0, stream>>>(dk_ws, static_cast<T*>(dk), rows, H, DK);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one block needs (the wrapper refuses sizes past the
// card's per-block limit before launching).
extern "C" long long gla_scan_bwd_smem_bytes(int dk, int dv, int chunk) {
  return (long long)(Plan(dk, dv, chunk).floats() * sizeof(float));
}

// qkv_dtype (q, k, v, do, dq, dk, dv), ld_dtype (ld, dld): 0 = float32, 1 =
// bfloat16. strides: 20 element strides, (b, l, h, d) of q, k, v, ld and do
// (a stride of 0 on h for one group's q and k, on d for one decay a head).
// s0, dS_final (may be null) and ds0 (null when s0 is) are contiguous (B, H,
// dk, dv) f32; states is an f32 scratch of B H ceil(L / chunk) dk dv. dv is
// contiguous (B, L, H, dv); dld contiguous (B, L, H, dk), or (B, L, H) when
// scalar_decay; dq and dk contiguous (B, L, H, dk), or with `group` (B, L,
// dk), summed from the f32 workspaces dq_ws and dk_ws of (B, L, H, dk) (null
// otherwise). Returns cudaGetLastError() after the launches.
extern "C" int gla_scan_bwd(int qkv_dtype, int ld_dtype, int inclusive, int scalar_decay,
                            int group, const void* q, const void* k, const void* v,
                            const void* ld, const void* dout, const float* s0,
                            const float* dS_final, float* states, void* dq, void* dk,
                            float* dq_ws, float* dk_ws, void* dv, void* dld, float* ds0, int B,
                            int L, int H, int dk_, int dv_, int chunk, const long long* strides,
                            void* stream) {
  if (B < 1 || B > 65535 || H < 1 || L < 1 || dk_ < 1 || dv_ < 1 || chunk < 1 || chunk > L ||
      (group && (dq_ws == nullptr || dk_ws == nullptr)))
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 20; ++i) st.s[i] = strides[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GLA_BWD(T, TL)                                                                     \
  return launch<T, TL>(q, k, v, ld, dout, s0, dS_final, states, dq, dk, dq_ws, dk_ws, dv, \
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
