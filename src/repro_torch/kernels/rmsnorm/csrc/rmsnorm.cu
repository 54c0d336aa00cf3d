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
//   * bf16 rows of 1024 < D <= 8192 in 16-byte words are a warp's too, 4
//     rows to a 128-thread block: each lane issues all its loads (up to 16
//     words to D = 4096, 32 to 8192) before it uses the first, so an SM has
//     many bytes in flight, and the sum needs only warp shuffles, so no
//     block barrier stands between the sum and the store; at 160-220
//     registers a thread, blocks of 4 rows let three share an SM where
//     blocks of 8 would fit one;
//   * the row is read once, in 16-byte words (4 f32 or 8 bf16) when D and
//     the pointers allow it, and kept in registers (at most 32 values a
//     thread) from the sum of squares to the store;
//   * the f32 sum of squares goes by warp shuffles, then, for a block-owned
//     row, through one partial a warp in shared memory;
//   * nothing is padded: the TPU kernel pads rows to its 256-row tile, and
//     the real rows of its result are these.
//
// Left for later: the same for f32 (its block-per-row variant reaches 88 %
// of its bound), and TMA loads of the next row while this one is stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RN_THREADS 256            // threads of a block up to D = 8192
#define RN_BIG_THREADS 1024       // threads of a block above that
#define RN_MAX_PER_THREAD 32      // row values a thread keeps in registers
#define RN_WARP_MAX_D 1024        // a warp owns a row up to here
#define RN_MAX_D (RN_MAX_PER_THREAD * RN_BIG_THREADS)
#define RN_WARP_BF16_MAX_D 8192   // bf16 rows in 16-byte words: a warp's up to here
#define RN_BF16_THREADS 128       // and 4 such rows to a block

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

// bf16 rows in 16-byte words, a warp to a row, THREADS / 32 rows a block:
// lane l holds words l, l + 32, ... (at most WORDS), raw, from the loads
// (all issued first) to the store.
template <int WORDS, int THREADS>
__global__ void __launch_bounds__(THREADS) rmsnorm_bf16_warp_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
    __nv_bfloat16* __restrict__ y, long long rows, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp
  const int nword = D / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * (long long)D);
  uint4 w[WORDS];
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const int p = lane + 32 * k;
    if (p < nword) w[k] = __ldcs(xr + p);  // read once: stream past the caches
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    if (lane + 32 * k < nword) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w[k]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = __bfloat162float(e[j]);
        ss += v * v;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);

  const float inv = 1.0f / sqrtf(ss / (float)D + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + row * (long long)D);
  const float4* sc = reinterpret_cast<const float4*>(scale);
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const int p = lane + 32 * k;
    if (p < nword) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w[k]);
      const float4 s0 = sc[2 * p], s1 = sc[2 * p + 1];
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      float o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = __bfloat162float(e[j]) * inv * sv[j];
      store_pack<__nv_bfloat16, 8>(reinterpret_cast<__nv_bfloat16*>(&yr[p]), o);
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
  if (!aligned) return launch_typed<T, 1>(x, scale, y, rows, D, eps, stream);
  if constexpr (VEC == 8) {  // bf16
    if (D > RN_WARP_MAX_D && D <= RN_WARP_BF16_MAX_D &&
        reinterpret_cast<uintptr_t>(scale) % 16 == 0) {
      constexpr int ROWS = RN_BF16_THREADS / 32;
      const long long blocks = (rows + ROWS - 1) / ROWS;
      if (blocks > 2147483647LL) return cudaErrorInvalidValue;
      const __nv_bfloat16* xt = static_cast<const __nv_bfloat16*>(x);
      __nv_bfloat16* yt = static_cast<__nv_bfloat16*>(y);
      if (D <= 4096) {
        rmsnorm_bf16_warp_kernel<16, RN_BF16_THREADS>
            <<<(unsigned)blocks, RN_BF16_THREADS, 0, stream>>>(xt, scale, yt, rows, D, eps);
      } else {
        rmsnorm_bf16_warp_kernel<32, RN_BF16_THREADS>
            <<<(unsigned)blocks, RN_BF16_THREADS, 0, stream>>>(xt, scale, yt, rows, D, eps);
      }
      return cudaGetLastError();
    }
  }
  return launch_typed<T, VEC>(x, scale, y, rows, D, eps, stream);
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
