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
// Every exponent it evaluates is <= 0 when ld <= 0 (a difference of cumulative
// log-decays, or a clamp), so strong decay cannot overflow: e^{cum_q[t]} and
// e^{-cum[s]} are never formed apart. A ragged last chunk reads positions
// >= L as q = k = v = 0 and ld = 0 (the state is unchanged by them) and
// writes nothing past L. q, k, v take f32 or bf16 (one type), ld f32 or bf16,
// each independently; every tile is widened to f32 as the TPU kernel does. o
// takes v's type; the state is f32. Inputs are read through their (b, l, h, d)
// strides, so the model's (B, L, H, d) views of (B, L, d) products go in
// without a copy, and a stride of 0 on d broadcasts one decay per head.
//
// What bounds it: operations. Per chunk of 64 at dk = dv = 64: ~2.4 MFLOP
// (the (c, c, dk) exponential-weighted score cube, the cross-chunk product,
// the intra-chunk product and the state update) and ~130 K exponentials,
// against ~40 KB of bf16 input: ~60 flops a byte, above the CUDA cores' ridge
// (67 TFLOP/s f32 over 3.35 TB/s is 20 a byte).
//
// What the design does about it. The TPU kernel carried S in VMEM scratch
// across a sequential chunk axis of its grid; Hopper blocks run in no order,
// so one block of 256 threads owns one (b, h) and walks its chunks in order,
// holding S in shared memory as f32. Each chunk's q, k, v and ld are staged in
// shared memory as f32; q, k and the cumulative decays sit in rows padded to
// dk + 1 floats so that the threads of a warp (one query row t, 32 key rows s)
// read 32 different banks. The exclusive cum_q is the previous row of cum (a
// zero row leads the buffer), which also saves a tile: at c = 64, dk = dv = 64
// the block holds ~99 KB, so two blocks share an SM. The math runs as f32 FMAs
// on the CUDA cores; tensor cores, TMA staging and a split of the state over
// several blocks are left to a later design.
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

// Dynamic shared memory one block needs (the wrapper refuses sizes past the
// card's per-block limit before launching).
extern "C" long long gla_scan_smem_bytes(int dk, int dv, int chunk) {
  return (long long)smem_bytes(dk, dv, chunk);
}

// qkv_dtype, ld_dtype: 0 = float32, 1 = bfloat16. strides: 16 element
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
