// NS solver update rule (paper eq. 11) for the NVIDIA H100 (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ns_update/ns_update.py::ns_update
// (with ns_update_nd, which padded D to a multiple of 128 for the TPU's lanes).
//
//   out = a * x0 + sum_j w_j * U_j        a, w_0, ..., w_{n-1}  (f32, on the card)
//
// x0 and out hold N = B*D elements, U holds n rows of N. The solver hands step i
// the live rows only (U[:i+1], the weights b[i, :i+1]), so the kernel reads i+1
// rows at step i, not the whole buffer.
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
// coefficients come from device memory as two pointers (a, and w with its stride:
// a row of the solver's b), staged in shared memory, so the solver loop never
// waits on the host and builds no coefficient vector.
//
// Backward (ns_update_bwd; the TPU kernel has none: the reference differentiates
// its jnp form). Given the incoming gradient g (x0's shape):
//
//   dU_j = w_j * g,   dx0 = a * g (when x0 needs it),   da = <x0, g>,   dw_j = <U_j, g>
//
// One launch. Bounded by memory as the forward is: it reads g, x0 and the k rows
// of U and writes k rows of dU (and dx0), 18.9 MB at the flow cell's last step
// (k = 8, N = 4*65536 f32), ~5.6 us at 3.35 TB/s.
//
// Design (redesigned for the H100; the first version walked the rows outside its
// element loop with one 16-byte vector a thread, re-read g per row, and summed
// the blocks' partials with one thread a dot product walking 256 blocks in turn):
// - a block takes tiles of kBwdThreads * kBwdElems elements; each thread loads
//   its 8 elements of g (two 16-byte vectors of f32, one of bf16) once a tile,
//   keeps them in registers and walks the k + 1 rows (x0, then U) inside the
//   tile, kBwdRows rows' loads issued together, so a thread keeps 4 (bf16) or
//   8 (f32) independent 16-byte loads in flight;
// - the grid is the tiles the data needs, up to ns_update_bwd_max_blocks (4 a
//   SM), so the main shape's 4 * 65536 elements make 128 blocks, one an SM;
// - each row's dot product is reduced over a warp by a shuffle tree and added to
//   the warp's slot in shared memory (lane 0, tile after tile), then over the
//   warps in warp order into a per-block partial;
// - the last block to count itself on an arrival counter (one acquire-release
//   atomic after a block barrier) adds the partials up: one warp a dot product,
//   each lane summing blocks lane, lane + 32, ... in order, then a fixed shuffle
//   tree. It sets the counter back to 0, so no memset is launched, and every sum
//   runs in an order fixed by block, warp and lane index: two runs give the same
//   bits, and no float atomics touch a result.
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
                 const float* __restrict__ a, const float* __restrict__ w,
                 long long w_stride, T* __restrict__ out, long long N, int n,
                 long long nvec) {
  constexpr int V = Vec<T>::kLen;
  __shared__ float c[kMaxN + 1];
  for (int j = threadIdx.x; j <= n; j += blockDim.x) c[j] = j == 0 ? *a : w[(j - 1) * w_stride];
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
int launch(const void* x0, const void* u, const float* a, const float* w,
           long long w_stride, void* out, long long N, int n, cudaStream_t stream) {
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
      static_cast<const T*>(x0), static_cast<const T*>(u), a, w, w_stride,
      static_cast<T*>(out), N, n, nvec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Adds one to an arrival counter, in the GPU's order: what this block wrote
// before (through a preceding barrier) is visible to whoever counts after, and
// what they wrote before counting is visible here. Returns the count before.
__device__ __forceinline__ int arrive(int* counter) {
  int before;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(before) : "l"(counter) : "memory");
  return before;
}

constexpr int kBwdThreads = 256;
constexpr int kBwdElems = 8;  // elements of g a thread holds in a tile
constexpr int kBwdRows = 4;   // rows whose loads a thread has in flight together
constexpr int kBwdWarps = kBwdThreads / 32;

// 16-byte vectors a thread holds in a tile: two of f32, one of bf16, so a
// block's tile is kBwdThreads * kBwdElems elements whatever the type
template <typename T> struct BwdVecs {
  static constexpr int kN = kBwdElems / Vec<T>::kLen > 0 ? kBwdElems / Vec<T>::kLen : 1;
};

// Row j of the backward: x0 for j = 0 (coefficient a, gradient dx0), U_{j-1}
// for j >= 1 (w_{j-1}, dU_{j-1}).
template <typename T>
__device__ __forceinline__ const T* bwd_src(const T* x0, const T* u, int j, long long N) {
  return j == 0 ? x0 : u + (long long)(j - 1) * N;
}
template <typename T>
__device__ __forceinline__ T* bwd_dst(T* dx0, T* du, int j, long long N) {
  return j == 0 ? dx0 : du + (long long)(j - 1) * N;  // dx0 may be null: then only da
}

// grads receives (da, dw_0, ..., dw_{n-1}); partials holds (n + 1) * gridDim.x
// floats, dot product j's block sums at j * gridDim.x; counter is 0 on entry
// and is left at 0.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
ns_update_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x0, const T* __restrict__ u,
                     const float* __restrict__ a, const float* __restrict__ w,
                     long long w_stride, T* __restrict__ du, T* __restrict__ dx0,
                     float* __restrict__ grads, float* __restrict__ partials,
                     int* __restrict__ counter, long long N, int n, long long nvec) {
  constexpr int V = Vec<T>::kLen, P = BwdVecs<T>::kN, R = kBwdRows;
  __shared__ float c[kMaxN + 1];
  __shared__ float red[kMaxN + 1][kBwdWarps];
  __shared__ int last;
  for (int j = threadIdx.x; j <= n; j += kBwdThreads) c[j] = j == 0 ? *a : w[(j - 1) * w_stride];
  for (int i = threadIdx.x; i < (n + 1) * kBwdWarps; i += kBwdThreads) (&red[0][0])[i] = 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tile = (long long)kBwdThreads * P;
  // the loop's bounds are the block's, so every lane reaches the shuffles
  for (long long t0 = blockIdx.x * tile; t0 < nvec; t0 += (long long)gridDim.x * tile) {
    const long long base = t0 + threadIdx.x;
    float gf[P][V];
    bool live[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      live[p] = base + p * kBwdThreads < nvec;
      if (live[p]) load16(g + (base + p * kBwdThreads) * V, gf[p]);
    }
    for (int j0 = 0; j0 <= n; j0 += R) {
      float sf[R][P][V];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T* src = bwd_src(x0, u, j0 + r, N);
#pragma unroll
        for (int p = 0; p < P; ++p)
          if (j0 + r <= n && live[p]) load16(src + (base + p * kBwdThreads) * V, sf[r][p]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = j0 + r;
        if (j > n) break;  // the same for the whole block
        T* dst = bwd_dst(dx0, du, j, N);
        const float cj = c[j];
        float dot = 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (!live[p]) continue;
          float o[V];
#pragma unroll
          for (int t = 0; t < V; ++t) {
            dot = fmaf(sf[r][p][t], gf[p][t], dot);
            o[t] = cj * gf[p][t];
          }
          if (dst != nullptr) store16(dst + (base + p * kBwdThreads) * V, o);
        }
        dot = warp_sum(dot);
        if (lane == 0) red[j][warp] += dot;
      }
    }
  }
  if (nvec * V < N) {  // the elements past the last whole vector, or all when unaligned
    const long long stride = (long long)gridDim.x * kBwdThreads;
    const long long first = nvec * V + (long long)blockIdx.x * kBwdThreads + threadIdx.x;
    for (int j = 0; j <= n; ++j) {
      const T* src = bwd_src(x0, u, j, N);
      T* dst = bwd_dst(dx0, du, j, N);
      const float cj = c[j];
      float dot = 0.f;
      for (long long e = first; e < N; e += stride) {
        const float gv = to_f32(g[e]);
        dot = fmaf(to_f32(src[e]), gv, dot);
        if (dst != nullptr) dst[e] = from_f32<T>(cj * gv);
      }
      dot = warp_sum(dot);
      if (lane == 0) red[j][warp] += dot;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j <= n; j += kBwdThreads) {
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < kBwdWarps; ++wp) s += red[j][wp];
    partials[(long long)j * gridDim.x + blockIdx.x] = s;
  }
  // the block's partials, then one count by thread 0: the block that counts
  // last sees every other block's partials and adds them up
  __syncthreads();
  if (threadIdx.x == 0) last = arrive(counter) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  const int blocks = (int)gridDim.x;
  for (int j = warp; j <= n; j += kBwdWarps) {
    const float* row = partials + (long long)j * blocks;
    float s = 0.f;
    for (int blk = lane; blk < blocks; blk += 32) s += __ldcg(row + blk);
    s = warp_sum(s);
    if (lane == 0) grads[j] = s;
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next call
}

template <typename T>
int launch_bwd(const void* g, const void* x0, const void* u, const float* a, const float* w,
               long long w_stride, void* du, void* dx0, float* grads, float* partials,
               int max_blocks, int* counter, long long N, int n, cudaStream_t stream) {
  constexpr int V = Vec<T>::kLen;
  const auto al16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = N % V == 0 && al16(g) && al16(x0) && al16(u) && al16(du) &&
                   al16(dx0);  // a null dx0 passes
  const long long nvec = vec ? N / V : 0;
  const long long tile = (long long)kBwdThreads * BwdVecs<T>::kN * V;  // elements a tile covers
  long long blocks = (N + tile - 1) / tile;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  ns_update_bwd_kernel<T><<<(unsigned)blocks, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x0), static_cast<const T*>(u), a, w,
      w_stride, static_cast<T*>(du), static_cast<T*>(dx0), grads, partials, counter, N, n,
      nvec);
  return (int)cudaGetLastError();
}

}  // namespace

// The most blocks ns_update_bwd launches on a card with `sms` SMs; its
// workspace holds that many times (n + 1) floats.
extern "C" int ns_update_bwd_max_blocks(int sms) { return 4 * sms; }

// Backward of ns_update_fwd. g, x0 and u as the forward's x0 and u (one dtype);
// du receives n rows of N, dx0 N values or is null (then dx0 is not computed),
// grads n + 1 f32 values (da, then dw). workspace holds max_blocks * (n + 1)
// f32 values; counter points at one int that is 0 and is left at 0. Returns
// cudaGetLastError() after the launch.
extern "C" int ns_update_bwd(int device, int dtype, const void* g, const void* x0,
                             const void* u, const float* a, const float* w, long long w_stride,
                             void* du, void* dx0, float* grads, float* workspace,
                             int max_blocks, int* counter, long long N, int n, void* stream) {
  if (n < 1 || n > kMaxN || N < 1 || max_blocks < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  int current = device;
  cudaGetDevice(&current);
  if (current != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      dtype == 0 ? launch_bwd<float>(g, x0, u, a, w, w_stride, du, dx0, grads, workspace,
                                     max_blocks, counter, N, n, s)
                 : launch_bwd<__nv_bfloat16>(g, x0, u, a, w, w_stride, du, dx0, grads,
                                             workspace, max_blocks, counter, N, n, s);
  if (current != device) cudaSetDevice(current);
  return err;
}

// device: the card the tensors and the stream live on (made current for the
// launch if it is not). dtype: 0 = float32, 1 = bfloat16. a points at one f32,
// w at n f32 values w_stride apart. Returns cudaGetLastError() after the launch.
extern "C" int ns_update_fwd(int device, int dtype, const void* x0, const void* u,
                             const float* a, const float* w, long long w_stride, void* out,
                             long long N, int n, void* stream) {
  if (n < 1 || n > kMaxN || N < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  int current = device;
  cudaGetDevice(&current);
  if (current != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = dtype == 0 ? launch<float>(x0, u, a, w, w_stride, out, N, n, s)
                             : launch<__nv_bfloat16>(x0, u, a, w, w_stride, out, N, n, s);
  if (current != device) cudaSetDevice(current);
  return err;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
