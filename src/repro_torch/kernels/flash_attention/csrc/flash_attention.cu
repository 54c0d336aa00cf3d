// Causal online-softmax attention forward for grouped-query attention.
//
// Replaces the TPU kernel `repro/kernels/flash_attention/flash_attention.py`:
// `flash_attention_kernel_call` (Pallas body `_kernel`).  For q (B,T,H,D)
// and k, v (B,S,KV,D), each query head h reading key/value head h*KV/H:
//
//   s   = q.k^T * scale in f32                (scale = 1/sqrt(D) by default)
//   s   = -1e30 where the key lies at or past S, or (causal) after the query;
//         positions are absolute from 0, with no query offset
//   m, l, acc: running max, denominator and f32 accumulator over key tiles
//   out = acc / max(l, 1e-30), in the input dtype (f32 or bf16)
//
// The finite -1e30 sentinel keeps every row finite, as in the reference.
//
// What bounds it on an H100: per (b, h) causal attention does about
// 4*D*T(T+1)/2 operations on 2*(T*D + S*D) input and output elements, so at
// the Qwen3-8B forward shape (B,T,H,KV,D) = (1,4096,32,8,128) it is bound by
// operations: 137.5 GFLOP, 0.139 ms at the 989 TFLOP/s bf16 tensor-core peak,
// 2.05 ms at the 67 TFLOP/s FP32 peak this kernel is limited to (it runs on
// the CUDA cores), against 0.025 ms to move its 84 MB.
//
// Design (simple first):
//   * grid (ceil(T/64), H, B): one block of 256 threads per (b, h, 64-query
//     tile), heavy (late) causal tiles first; a loop inside the block over
//     64-key tiles up to the causal limit takes the place of the TPU's
//     sequential "arbitrary" grid axis; key tiles wholly in the future of
//     the tile's last query are skipped (they would add exactly nothing);
//   * q (transposed), then k (transposed) and v (row-major) in turn, in
//     shared memory as f32: 85 KB at D = 128, hence the opt-in above 48 KB;
//   * thread (ty, tx) owns query rows 4ty..4ty+3: scores of key columns
//     4tx..4tx+3 of the tile and output columns 4tx (+64); the 16 threads
//     of a row group sit in one half-warp, so the row max and sum are
//     butterfly shuffles and every thread keeps m and l of its rows in
//     registers, bit-identical across the half-warp;
//   * the probabilities go to shared memory, transposed, for the P.V step.
//
// Left for later: tensor-core products (wgmma) in bf16 with f32
// accumulation, TMA loads of the next key tile while this one computes, and
// a persistent schedule over the causal triangle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 256
#define FA_MAX_D 128
#define FA_LD 68  // row stride of the transposed tiles: FA_BQ + 4 = FA_BK + 4

namespace {

constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float half_warp_max(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS) flash_fwd_kernel(
    const T* __restrict__ q,  // (B, Tq, H, D)
    const T* __restrict__ k,  // (B, S, KV, D)
    const T* __restrict__ v,  // (B, S, KV, D)
    T* __restrict__ o,        // (B, Tq, H, D)
    int Tq, int S, int H, int KV, int D, float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* sQt = reinterpret_cast<float*>(smem4);  // D x FA_LD: q tile, [d][row]
  float* sKV = sQt + D * FA_LD;  // D x FA_LD: k tile [d][key]; then v [key][d]
  float* sPt = sKV + D * FA_LD;  // FA_BK x FA_LD: probabilities, [key][row]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int r0 = 4 * ty, c0 = 4 * tx;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_BQ;
  const int kvh = (int)((long long)h * KV / H);

  const size_t q_row = (size_t)H * D;  // stride between positions of q and o
  const size_t k_row = (size_t)KV * D;
  const T* qb = q + (size_t)b * Tq * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * S * k_row + (size_t)kvh * D;
  const T* vb = v + (size_t)b * S * k_row + (size_t)kvh * D;
  T* ob = o + (size_t)b * Tq * q_row + (size_t)h * D;

  for (int i = tid; i < FA_BQ * D; i += FA_THREADS) {
    const int r = i / D, d = i - r * D;
    const int t = q0 + r;
    sQt[d * FA_LD + r] = t < Tq ? to_f32(qb[(size_t)t * q_row + d]) : 0.f;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(S, q0 + FA_BQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += FA_BK) {
    __syncthreads();  // the q tile is in; last tile's readers of sKV, sPt done
    for (int i = tid; i < FA_BK * D; i += FA_THREADS) {
      const int r = i / D, d = i - r * D;
      const int s = k0 + r;
      sKV[d * FA_LD + r] = s < S ? to_f32(kb[(size_t)s * k_row + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(sQt + d * FA_LD + r0);
      const float4 c = *reinterpret_cast<const float4*>(sKV + d * FA_LD + c0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += av[i] * cv[j];
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r0 + i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + c0 + j;
        const bool live = kpos < S && (!causal || qpos >= kpos);
        sc[i][j] = live ? sc[i][j] * scale : kMasked;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        sum += sc[i][j];
      }
      l[i] = alpha[i] * l[i] + half_warp_sum(sum);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sPt + (c0 + j) * FA_LD + r0) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();  // every thread is done with the k tile; P is visible

    for (int i = tid; i < FA_BK * D; i += FA_THREADS) {
      const int r = i / D, d = i - r * D;
      const int s = k0 + r;
      sKV[r * D + d] = s < S ? to_f32(vb[(size_t)s * k_row + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha[i];
    for (int kk = 0; kk < FA_BK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(sPt + kk * FA_LD + r0);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int jc = 0; jc < 2; ++jc) {
        const int c = c0 + 64 * jc;
        if (c < D) {
          const float4 w = *reinterpret_cast<const float4*>(sKV + kk * D + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * jc + 0] += pv[i] * w.x;
            acc[i][4 * jc + 1] += pv[i] * w.y;
            acc[i][4 * jc + 2] += pv[i] * w.z;
            acc[i][4 * jc + 3] += pv[i] * w.w;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + r0 + i;
    if (t >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jc = 0; jc < 2; ++jc) {
      const int c = c0 + 64 * jc;
      if (c < D) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          store(ob + (size_t)t * q_row + c + e, acc[i][4 * jc + e] / denom);
      }
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * (2 * (size_t)D * FA_LD + FA_BK * FA_LD);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Tq,
           int S, int H, int KV, int D, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + FA_BQ - 1) / FA_BQ, H, B);
  flash_fwd_kernel<T><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Tq, S, H, KV, D, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int flash_attention_block_q(void) { return FA_BQ; }
int flash_attention_block_k(void) { return FA_BK; }
int flash_attention_max_d(void) { return FA_MAX_D; }
// Dynamic shared memory of one block at head dim D.
int flash_attention_smem_bytes(int D) { return (int)smem_bytes(D); }

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  Launches on `stream`; returns a
// cudaError_t (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int Tq, int S, int H,
                           int KV, int D, float scale, int causal,
                           void* stream) {
  if (B < 1 || B > 65535 || Tq < 1 || S < 1 || H < 1 || H > 65535 ||
      KV < 1 || KV > H || D < 4 || D > FA_MAX_D || D % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, B, Tq, S, H, KV, D, scale, causal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, Tq, S, H, KV, D, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
