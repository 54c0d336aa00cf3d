// Fused RMSNorm, row by row.
//
// Replaces the TPU kernel `repro/kernels/rmsnorm/rmsnorm.py`:
// `rmsnorm_kernel_call` (Pallas body `_kernel`).  For x (rows, D) in f32 or
// bf16 and an f32 scale (D,), each row i:
//
//   ms   = sum_j x[i,j]^2 / D          (f32)
//   y[i] = x[i] * (1 / sqrt(ms + eps)) * scale   (f32, stored in x's type)
//
// What bounds it on an H100: the row is read once and written once, so at
// (16384, 4096) f32 one call moves 537 MB, 0.160 ms at 3.35 TB/s (bf16:
// 268 MB, 0.080 ms), against 3 operations an element (0.2 GFLOP, 0.003 ms at
// the 67 TFLOP/s FP32 peak).  It is bound by bytes.
//
// Design (simple first):
//   * up to D = 1024 a warp owns a row (8 rows to a 256-thread block); above
//     that a block owns a row: 256 threads up to D = 8192, 1024 threads up
//     to D = 32768;
//   * the row is read once, in 16-byte words (4 f32 or 8 bf16) when D and
//     the pointers allow it, and kept in registers (at most 32 values a
//     thread) from the sum of squares to the store;
//   * the f32 sum of squares goes by warp shuffles, then, for a block-owned
//     row, through one partial a warp in shared memory;
//   * nothing is padded: the TPU kernel pads rows to its 256-row tile, and
//     the real rows of its result are these.
//
// Left for later: several rows a block for large D (fewer, fuller waves),
// and TMA loads of the next row while this one is stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RN_THREADS 256            // threads of a block up to D = 8192
#define RN_BIG_THREADS 1024       // threads of a block above that
#define RN_MAX_PER_THREAD 32      // row values a thread keeps in registers
#define RN_WARP_MAX_D 1024        // a warp owns a row up to here
#define RN_MAX_D (RN_MAX_PER_THREAD * RN_BIG_THREADS)

namespace {

template <typename T>
struct Word;  // VEC elements loaded and stored as one 16-byte word
template <>
struct Word<float> {
  static constexpr int VEC = 4;
};
template <>
struct Word<__nv_bfloat16> {
  static constexpr int VEC = 8;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

template <typename T, int VEC>
__device__ __forceinline__ void load_pack(const T* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = to_f32(p[0]);
  } else {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = to_f32(e[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const float* v) {
  if constexpr (VEC == 1) {
    from_f32(v[0], p);
  } else {
    uint4 w;
    T* e = reinterpret_cast<T*>(&w);
#pragma unroll
    for (int j = 0; j < VEC; ++j) from_f32(v[j], &e[j]);
    *reinterpret_cast<uint4*>(p) = w;
  }
}

// `tpr` threads own a row: 32 (a warp; the block holds THREADS / 32 rows) or
// THREADS (the block).  A row is npack = D / VEC packs; thread `sub` of the
// row holds packs sub, sub + tpr, ... (at most RN_MAX_PER_THREAD values).
template <typename T, int VEC, int THREADS>
__global__ void __launch_bounds__(THREADS) rmsnorm_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    T* __restrict__ y, long long rows, int D, int tpr, float eps) {
  constexpr int PACKS = RN_MAX_PER_THREAD / VEC;
  __shared__ float part[THREADS / 32];
  __shared__ float total;

  const int sub = threadIdx.x % tpr;
  const long long row =
      (long long)blockIdx.x * (THREADS / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;  // the same for every lane of a warp
  const int npack = D / VEC;
  const T* xr = x + (live ? row : 0LL) * (long long)D;

  float v[PACKS][VEC];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < PACKS; ++k) {
    const int p = sub + k * tpr;
    if (live && p < npack) {
      load_pack<T, VEC>(xr + (size_t)p * VEC, v[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) ss += v[k][j] * v[k][j];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (tpr > 32) {  // a block-owned row: one partial a warp, then warp 0
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) part[warp] = ss;
    __syncthreads();
    if (warp == 0) {
      float t = lane < THREADS / 32 ? part[lane] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
      if (lane == 0) total = t;
    }
    __syncthreads();
    ss = total;
  }
  if (!live) return;

  const float inv = 1.0f / sqrtf(ss / (float)D + eps);
  T* yr = y + row * (long long)D;
#pragma unroll
  for (int k = 0; k < PACKS; ++k) {
    const int p = sub + k * tpr;
    if (p < npack) {
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = v[k][j] * inv * scale[p * VEC + j];
      store_pack<T, VEC>(yr + (size_t)p * VEC, o);
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_typed(const void* x, const float* scale, void* y,
                         long long rows, int D, float eps,
                         cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (D <= RN_WARP_MAX_D) {
    const long long blocks = (rows + RN_THREADS / 32 - 1) / (RN_THREADS / 32);
    if (blocks > 2147483647LL) return cudaErrorInvalidValue;
    rmsnorm_kernel<T, VEC, RN_THREADS><<<(unsigned)blocks, RN_THREADS, 0, stream>>>(
        xt, scale, yt, rows, D, 32, eps);
  } else if (D <= RN_MAX_PER_THREAD * RN_THREADS) {
    if (rows > 2147483647LL) return cudaErrorInvalidValue;
    rmsnorm_kernel<T, VEC, RN_THREADS><<<(unsigned)rows, RN_THREADS, 0, stream>>>(
        xt, scale, yt, rows, D, RN_THREADS, eps);
  } else {
    if (rows > 2147483647LL) return cudaErrorInvalidValue;
    rmsnorm_kernel<T, VEC, RN_BIG_THREADS>
        <<<(unsigned)rows, RN_BIG_THREADS, 0, stream>>>(xt, scale, yt, rows, D,
                                                        RN_BIG_THREADS, eps);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vec(const void* x, const float* scale, void* y,
                       long long rows, int D, float eps, cudaStream_t stream) {
  constexpr int VEC = Word<T>::VEC;
  const bool aligned = D % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (aligned) return launch_typed<T, VEC>(x, scale, y, rows, D, eps, stream);
  return launch_typed<T, 1>(x, scale, y, rows, D, eps, stream);
}

}  // namespace

extern "C" {

int rmsnorm_max_d(void) { return RN_MAX_D; }
int rmsnorm_warp_max_d(void) { return RN_WARP_MAX_D; }

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x and y (rows, D) contiguous, of `dtype` 0 (f32) or 1 (bf16); scale (D,)
// f32.  Launches on `stream`; returns a cudaError_t (0 on success).
int rmsnorm_launch(const void* x, const void* scale, void* y, int dtype,
                   long long rows, int D, float eps, void* stream) {
  if (rows < 1 || D < 1 || D > RN_MAX_D || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_vec<float>(x, s, y, rows, D, eps, st)
                 : launch_vec<__nv_bfloat16>(x, s, y, rows, D, eps, st);
  return static_cast<int>(err);
}

}  // extern "C"
