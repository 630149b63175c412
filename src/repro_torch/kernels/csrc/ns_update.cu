// NS solver update rule (paper eq. 11) for the NVIDIA H100 (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ns_update/ns_update.py::ns_update
// (with ns_update_nd, which padded D to a multiple of 128 for the TPU's lanes).
//
//   out = a * x0 + sum_j w_j * U_j        coeff = [a, w_0, ..., w_{n-1}]  (f32)
//
// x0 and out hold N = B*D elements, U holds n rows of N; rows of w past the
// current solver step are already zero (the caller masks).
//
// What bounds it: memory. It reads (n+1)*N elements and writes N while doing
// 2*(n+1)*N flops, under half a flop per byte in f32, far below the card's ridge. At the
// main path's n=8, N=4*1024*64 in f32 that is 10.5 MB, about 3 us at 3.35 TB/s:
// the launch itself costs about as much as the work.
//
// What the design does about it: every input byte is read once and every output
// byte written once, in one grid-stride pass with 16-byte vector loads (4 f32 or
// 8 bf16 values) where N and the pointers allow, and a scalar pass for the rest,
// so any D works without padding. The sum is kept in f32 registers. The n+1
// coefficients come from device memory (staged in shared memory), so the solver
// loop never waits on the host.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> struct Vec { static constexpr int kLen = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&f)[Vec<T>::kLen]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::kLen; ++i) f[i] = to_f32(vals[i]);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float (&f)[Vec<T>::kLen]) {
  uint4 raw;
  T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::kLen; ++i) vals[i] = from_f32<T>(f[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ns_update_kernel(const T* __restrict__ x0, const T* __restrict__ u,
                 const float* __restrict__ coeff, T* __restrict__ out,
                 long long N, int n, long long nvec) {
  constexpr int V = Vec<T>::kLen;
  __shared__ float c[kMaxN + 1];
  for (int j = threadIdx.x; j <= n; j += blockDim.x) c[j] = coeff[j];
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = first; i < nvec; i += stride) {
    const long long e = i * V;
    float acc[V], f[V];
    load16(x0 + e, f);
#pragma unroll
    for (int t = 0; t < V; ++t) acc[t] = c[0] * f[t];
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      load16(u + j * N + e, f);
      const float w = c[j + 1];
#pragma unroll
      for (int t = 0; t < V; ++t) acc[t] = fmaf(w, f[t], acc[t]);
    }
    store16(out + e, acc);
  }
  for (long long e = nvec * V + first; e < N; e += stride) {
    float acc = c[0] * to_f32(x0[e]);
    for (int j = 0; j < n; ++j) acc = fmaf(c[j + 1], to_f32(u[j * N + e]), acc);
    out[e] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* x0, const void* u, const float* coeff, void* out,
           long long N, int n, cudaStream_t stream) {
  constexpr int V = Vec<T>::kLen;
  const bool vec = N % V == 0 && reinterpret_cast<uintptr_t>(x0) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long nvec = vec ? N / V : 0;
  const long long work = vec ? nvec : N;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 8LL * sms;  // 8 blocks of 256 threads fill an SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  ns_update_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x0), static_cast<const T*>(u), coeff,
      static_cast<T*>(out), N, n, nvec);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int ns_update_fwd(int dtype, const void* x0, const void* u,
                             const float* coeff, void* out, long long N, int n,
                             void* stream) {
  if (n < 1 || n > kMaxN || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x0, u, coeff, out, N, n, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x0, u, coeff, out, N, n, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
