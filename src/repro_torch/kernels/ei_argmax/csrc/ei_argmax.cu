// Fused posterior + Expected Improvement + argmax over the candidate axis.
//
// Replaces the TPU kernel `repro/kernels/ei_argmax/kernel.py`:
// `ei_argmax_kernel_call` (Pallas body `_kernel`, TPU triangular solve
// `_forward_substitution`).  For each job j and each candidate column c of
// the static (n,d) encoding it computes, without ever storing the (B,n)
// cross block:
//
//   d2_b  = |f_b|^2 + |e_c|^2 - 2 f_b.e_c, clamped at 0   (gp.pairwise_sqdist)
//   k_b   = Matern52(d2_b / ls^2) * pm_b                   (padded slots -> 0)
//   mean  = sum_b k_b alpha_b,  v = L^-1 k,  var = max(1 - |v|^2, 1e-12)
//   EI    = de-standardized Expected Improvement (erf CDF), -inf where masked
//
// and reduces (max EI, argmax) over c, the lowest index winning ties, as
// `jnp.argmax` / `torch.argmax` do over the full block.  No B or d is
// capped: the limits are the grid's (J <= 65535) and, for the blocked route,
// one candidate's right-hand side beside the staged training rows in the
// block's shared memory (`blocked_tile`): B + d + 1 <= 55296 - r(d + 3), r =
// min(64, 4096 / d) rows, so it depends on d (B <= 54713 at d = 6, B <=
// 50943 at d = 64).
//
// What bounds it on an H100: per candidate it reads d floats and one mask
// byte (about 25 bytes at d = 6) and does about B(2d + 21) + B(B - 1)
// FP32 operations (about 1.4 kflop at B = 24), so at the catalog shape
// (n = 131072, d = 6, B = 24) the FP32 rate bounds it (about 2.7 us against
// about 1 us of memory traffic).  At the paper grid's n = 69 it is one block
// and its latency: the main path calls it once per BO step.
//
// Design:
//   * registers, B <= 64 and d <= 8 (`ei_reg_kernel<BB, 8>`: BB = 16, 32 or
//     64, the smallest that holds B; the tuner's encodings have d = 4-6):
//     one thread owns one candidate; its features and v stay in registers,
//     every loop over b, i and k fully unrolled to BB (or 8) with an exit
//     at B (or d), so no array is indexed at run time and nothing goes to
//     local memory (a d <= 32 bucket too doubled the library's build, to
//     45 s).  L (padded to BB x BB), the features, |f_b|^2, alpha and pm of
//     job j are staged in shared memory; each thread runs the row sweep of
//     the forward substitution, k_b and v_b in one loop: v_b needs only
//     v_0 .. v_{b-1};
//   * blocked, any other B and d (`ei_blocked_kernel`): 64 candidates a
//     block (fewer when B is large) keep their features and their
//     right-hand sides, B x 64, in shared memory, a column a thread.  k is
//     computed 64 training rows at a time, their features staged first.
//     The solve goes panel by panel of 16 rows, 64 rows of the panel's
//     columns of L staged in shared memory at a time: each thread solves
//     the diagonal block into 16 registers, then subtracts the panel's
//     terms from every row below.  Row b takes the same subtractions in the
//     same order (i ascending) as in the register route, so the two routes
//     compute the same f32 substitution; no inverse of L is formed.  (Each
//     thread reading its own rows of L from global memory, one after
//     another, took 0.10 ms at the paper grid's n = B = 69 on an H100,
//     all latency);
//   * one launch a call: each block reduces its columns to one (max, argmax)
//     pair, and the last block of a job to finish (a __threadfence and an
//     atomic count, which that block resets to 0 for the next call) folds
//     the job's pairs.  Blocks run in no order, so the TPU kernel's
//     sequential strict-`>` fold becomes an order-free comparison: larger
//     value wins, equal values go to the lower index;
//   * the substitution runs in f32 and the two sums over b (mean, |v|^2)
//     in f64, as in the plain version (`tile.ei_from_sqdist`; the TPU
//     kernel sums in f32): 1 - |v|^2 cancels when many observations crowd
//     the space, and there two f32 evaluations summed in other orders part
//     by more than the EI tolerance;
//   * NaN counts as larger than any number, as in `torch.argmax`; EI is
//     NaN only when the head's Cholesky failed at every grid point.
//
// Left for later: the (B,d) x (d,tile) distance block and the triangular
// solve as tensor-core products.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <limits.h>

#define EI_BLOCK 256
#define EI_REG_MAX_B 64
#define EI_REG_MAX_D 8
#define EI_PANEL 16
#define EI_BLOCKED_THREADS 64  // the blocked route's block: a candidate a thread
#define EI_ROWS 64  // rows of L (or of the training features) the blocked route stages at a time
#define EI_BLOCKED_SMEM (216 * 1024)  // dynamic shared memory the blocked route may take

namespace {

constexpr float kSqrt5 = 2.2360679774997896964f;
constexpr float kSqrt2 = 1.4142135623730950488f;
constexpr float kSqrt2Pi = 2.5066282746310005024f;

// max(x, lo) that keeps a NaN, like jnp.maximum / torch.clamp_min.
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return x < lo ? lo : x;
}

// Does (v, i) beat (bv, bi)?  Larger wins, ties go to the lower index,
// NaN beats any number.
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  const bool vn = v != v, bn = bv != bv;
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

// k_b for a raw squared distance: the Matern-5/2 kernel times pm_b.
__device__ __forceinline__ float matern(float fn, float en, float dot, float ls2, float pm) {
  const float d2 = clamp_lo(fn + en - 2.f * dot, 0.f);
  const float s2 = clamp_lo(d2 / ls2, 1e-12f);
  const float s5 = kSqrt5 * sqrtf(s2);
  return (1.f + s5 + (5.f / 3.f) * s2) * expf(-s5) * pm;
}

// The de-standardized EI of a candidate from its posterior sums, which come
// in f64: 1 - |v|^2 cancels (to 3e-3 at B = 256 with 200 observations), so
// it is taken before rounding to f32.
__device__ __forceinline__ float ei_tail(double mean_n, double vv, const float* s, float xi) {
  const float std_n = sqrtf(clamp_lo(static_cast<float>(1.0 - vv), 1e-12f));
  const float mean = static_cast<float>(mean_n) * s[2] + s[1];
  const float sd = std_n * s[2];
  const float imp = s[3] - mean - xi;
  const float z = imp / clamp_lo(sd, 1e-12f);
  const float cdf = 0.5f * (1.f + erff(z / kSqrt2));
  const float pdf = expf(-0.5f * z * z) / kSqrt2Pi;
  return clamp_lo(imp * cdf + sd * pdf, 0.f);
}

// Reduces the block's (ei, col) pairs to one, writes it as the block's
// partial and, in the last block of job j to finish, folds the job's
// partials into out_val / out_idx and resets done[j].
__device__ void block_argmax_and_fold(float ei, int col, float* __restrict__ part_val,
                                      int* __restrict__ part_idx, int* __restrict__ done,
                                      float* __restrict__ out_val, int* __restrict__ out_idx) {
  __shared__ float rv[EI_BLOCK];
  __shared__ int ri[EI_BLOCK];
  __shared__ int last;
  const int tid = threadIdx.x, j = blockIdx.y, nb = gridDim.x, nt = blockDim.x;  // a power of 2
  rv[tid] = ei;
  ri[tid] = col;
  __syncthreads();
  for (int s = nt / 2; s > 0; s >>= 1) {
    if (tid < s && beats(rv[tid + s], ri[tid + s], rv[tid], ri[tid])) {
      rv[tid] = rv[tid + s];
      ri[tid] = ri[tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    part_val[static_cast<size_t>(j) * nb + blockIdx.x] = rv[0];
    part_idx[static_cast<size_t>(j) * nb + blockIdx.x] = ri[0];
    __threadfence();  // the partial is visible before the count says so
    last = atomicAdd(&done[j], 1) == nb - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float bv = -CUDART_INF_F;
  int bi = INT_MAX;  // every real pair beats this sentinel
  for (int i = tid; i < nb; i += nt) {
    const float v = __ldcg(part_val + static_cast<size_t>(j) * nb + i);
    const int id = __ldcg(part_idx + static_cast<size_t>(j) * nb + i);
    if (beats(v, id, bv, bi)) {
      bv = v;
      bi = id;
    }
  }
  __syncthreads();
  rv[tid] = bv;
  ri[tid] = bi;
  __syncthreads();
  for (int s = nt / 2; s > 0; s >>= 1) {
    if (tid < s && beats(rv[tid + s], ri[tid + s], rv[tid], ri[tid])) {
      rv[tid] = rv[tid + s];
      ri[tid] = ri[tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    out_val[j] = rv[0];
    out_idx[j] = ri[0];
    done[j] = 0;  // ready for the next call
  }
}

template <int BB, int DD>
__global__ void __launch_bounds__(EI_BLOCK) ei_reg_kernel(
    const float* __restrict__ enc,     // (J, n, d)
    const uint8_t* __restrict__ mask,  // (J, n) candidate mask (bool bytes)
    const float* __restrict__ feats,   // (J, B, d)
    const float* __restrict__ pm,      // (J, B)
    const float* __restrict__ alpha,   // (J, B)
    const float* __restrict__ chol,    // (J, B, B) lower factor
    const float* __restrict__ scal,    // (J, 4): ls, y_mean, y_std, best
    float* __restrict__ part_val, int* __restrict__ part_idx, int* __restrict__ done,
    float* __restrict__ out_val, int* __restrict__ out_idx, int n, int d, int B, float xi) {
  extern __shared__ float smem[];
  float* sL = smem;           // BB x BB, row stride BB: constant offsets in the unrolled sweep
  float* sF = sL + BB * BB;   // BB x DD
  float* sFn = sF + BB * DD;  // BB: |f_b|^2
  float* sA = sFn + BB;       // BB
  float* sP = sA + BB;        // BB
  __shared__ float sS[4];

  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  const float* Lg = chol + static_cast<size_t>(j) * B * B;
  const float* Fg = feats + static_cast<size_t>(j) * B * d;
  for (int i = tid; i < B * B; i += EI_BLOCK) sL[(i / B) * BB + i % B] = Lg[i];
  for (int i = tid; i < B * d; i += EI_BLOCK) sF[(i / d) * DD + i % d] = Fg[i];
  for (int i = tid; i < B; i += EI_BLOCK) {
    sA[i] = alpha[static_cast<size_t>(j) * B + i];
    sP[i] = pm[static_cast<size_t>(j) * B + i];
  }
  if (tid < 4) sS[tid] = scal[j * 4 + tid];
  __syncthreads();
  for (int b = tid; b < B; b += EI_BLOCK) {
    float s = 0.f;
    for (int k = 0; k < d; ++k) s += sF[b * DD + k] * sF[b * DD + k];
    sFn[b] = s;
  }
  __syncthreads();
  const float ls2 = sS[0] * sS[0];

  const int col = blockIdx.x * EI_BLOCK + tid;
  float ei = -CUDART_INF_F;
  if (col < n && mask[static_cast<size_t>(j) * n + col]) {
    const float* e = enc + (static_cast<size_t>(j) * n + col) * d;
    float ev[DD];
    float en = 0.f;
#pragma unroll
    for (int k = 0; k < DD; ++k) {
      if (k >= d) break;
      ev[k] = e[k];
      en += ev[k] * ev[k];
    }
    float v[BB];
    double mean_n = 0.0, vv = 0.0;
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      if (b >= B) break;
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < DD; ++k) {
        if (k >= d) break;
        dot += sF[b * DD + k] * ev[k];
      }
      const float kb = matern(sFn[b], en, dot, ls2, sP[b]);
      mean_n += static_cast<double>(kb) * sA[b];
      float acc = kb;
#pragma unroll
      for (int i = 0; i < b; ++i) acc -= sL[b * BB + i] * v[i];
      v[b] = acc / sL[b * BB + b];
      vv += static_cast<double>(v[b]) * v[b];
    }
    ei = ei_tail(mean_n, vv, sS, xi);
  }
  block_argmax_and_fold(ei, col, part_val, part_idx, done, out_val, out_idx);
}

__global__ void __launch_bounds__(EI_BLOCKED_THREADS) ei_blocked_kernel(
    const float* __restrict__ enc, const uint8_t* __restrict__ mask,
    const float* __restrict__ feats, const float* __restrict__ pm,
    const float* __restrict__ alpha, const float* __restrict__ chol,
    const float* __restrict__ scal, float* __restrict__ part_val, int* __restrict__ part_idx,
    int* __restrict__ done, float* __restrict__ out_val, int* __restrict__ out_idx, int n,
    int d, int B, int T, int R, float xi) {
  extern __shared__ float smem[];
  float* sK = smem;                 // B x T: k, then the rows' partial sums
  float* sE = sK + (size_t)B * T;   // T x d: the candidates' features
  float* sEn = sE + (size_t)T * d;  // T: their squared norms
  float* sF = sEn + T;              // R x d: a chunk of the training features
  float* sFn = sF + (size_t)R * d;  // R: their squared norms, pm and alpha
  float* sP = sFn + R;
  float* sA = sP + R;
  __shared__ float sL[EI_ROWS * EI_PANEL];  // 64 rows of a panel of L
  __shared__ float sS[4];

  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * T;
  const float* Lg = chol + static_cast<size_t>(j) * B * B;
  const float* Fg = feats + static_cast<size_t>(j) * B * d;
  if (tid < 4) sS[tid] = scal[j * 4 + tid];
  for (int i = tid; i < T * d; i += EI_BLOCKED_THREADS) {
    const int col = c0 + i / d;
    sE[i] = col < n ? enc[(static_cast<size_t>(j) * n + c0) * d + i] : 0.f;
  }
  __syncthreads();
  for (int c = tid; c < T; c += EI_BLOCKED_THREADS) {
    float en = 0.f;
    for (int k = 0; k < d; ++k) en += sE[c * d + k] * sE[c * d + k];
    sEn[c] = en;
  }
  const float ls2 = sS[0] * sS[0];

  // k for R training rows at a time, their features staged first; thread
  // tid < T sums its candidate's mean over them, b ascending.
  double mean_n = 0.0, vv = 0.0;
  for (int b0 = 0; b0 < B; b0 += R) {
    const int nr = min(R, B - b0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < nr * d; i += EI_BLOCKED_THREADS) sF[i] = Fg[static_cast<size_t>(b0) * d + i];
    for (int i = tid; i < nr; i += EI_BLOCKED_THREADS) {
      sP[i] = pm[static_cast<size_t>(j) * B + b0 + i];
      sA[i] = alpha[static_cast<size_t>(j) * B + b0 + i];
    }
    __syncthreads();
    for (int r = tid; r < nr; r += EI_BLOCKED_THREADS) {
      float fn = 0.f;
      for (int k = 0; k < d; ++k) fn += sF[r * d + k] * sF[r * d + k];
      sFn[r] = fn;
    }
    __syncthreads();
    for (int i = tid; i < nr * T; i += EI_BLOCKED_THREADS) {
      const int r = i / T, c = i - r * T;
      float dot = 0.f;
      for (int k = 0; k < d; ++k) dot += sF[r * d + k] * sE[c * d + k];
      sK[static_cast<size_t>(b0 + r) * T + c] = matern(sFn[r], sEn[c], dot, ls2, sP[r]);
    }
    __syncthreads();
    if (tid < T)
      for (int r = 0; r < nr; ++r)
        mean_n += static_cast<double>(sK[static_cast<size_t>(b0 + r) * T + tid]) * sA[r];
  }

  // The solve, panel by panel of 16 rows, 64 rows of the panel's columns of
  // L staged at a time: each thread solves the diagonal block into 16
  // registers (its candidate's v), then subtracts the panel's terms from its
  // candidate's column of every row below.
  float* Kc = sK + tid;
  for (int p0 = 0; p0 < B; p0 += EI_PANEL) {
    const int np = min(EI_PANEL, B - p0);
    float v[EI_PANEL];
    for (int r0 = p0; r0 < B; r0 += EI_ROWS) {
      const int nr = min(EI_ROWS, B - r0);
      __syncthreads();  // the previous chunk's readers are done
      for (int i = tid; i < nr * EI_PANEL; i += EI_BLOCKED_THREADS) {
        const int r = i / EI_PANEL, k = i % EI_PANEL;
        sL[i] = k < np ? Lg[static_cast<size_t>(r0 + r) * B + p0 + k] : 0.f;
      }
      __syncthreads();
      if (tid >= T) continue;
      int r = 0;
      if (r0 == p0) {  // the diagonal block
#pragma unroll
        for (int q = 0; q < EI_PANEL; ++q) {
          if (q >= np) break;
          float acc = Kc[static_cast<size_t>(p0 + q) * T];
#pragma unroll
          for (int i = 0; i < q; ++i) acc -= sL[q * EI_PANEL + i] * v[i];
          v[q] = acc / sL[q * EI_PANEL + q];
          vv += static_cast<double>(v[q]) * v[q];
        }
        r = np;
      }
      for (; r < nr; ++r) {  // rows below the panel: np == 16 here
        float acc = Kc[static_cast<size_t>(r0 + r) * T];
#pragma unroll
        for (int i = 0; i < EI_PANEL; ++i) acc -= sL[r * EI_PANEL + i] * v[i];
        Kc[static_cast<size_t>(r0 + r) * T] = acc;
      }
    }
  }

  const int col = c0 + tid;
  float ei = -CUDART_INF_F;
  if (tid < T && col < n && mask[static_cast<size_t>(j) * n + col]) ei = ei_tail(mean_n, vv, sS, xi);
  block_argmax_and_fold(ei, tid < T ? col : INT_MAX, part_val, part_idx, done, out_val, out_idx);
}

// Training rows a chunk of the blocked route's k stages: 64, fewer for wide
// features (at most 4096 floats of them).
int blocked_rows(int d) {
  const int r = 4096 / d;
  return r < 1 ? 1 : (r < EI_ROWS ? r : EI_ROWS);
}

// Shared memory of the blocked route beyond its candidates' share.
long long blocked_fixed(int d) {
  const long long r = blocked_rows(d);
  return 4 * (r * d + 3 * r);
}

// Candidates a block of the blocked route takes: up to its 64 threads, as
// many as their right-hand sides, features and norms fit in
// EI_BLOCKED_SMEM beside the staged rows; 0 if not even one does.
int blocked_tile(int d, int B) {
  const long long per = 4LL * (static_cast<long long>(B) + d + 1);
  const long long t = (EI_BLOCKED_SMEM - blocked_fixed(d)) / per;
  return static_cast<int>(t < 0 ? 0 : (t < EI_BLOCKED_THREADS ? t : EI_BLOCKED_THREADS));
}

template <int BB, int DD>
constexpr size_t reg_smem() {
  return sizeof(float) * (BB * BB + BB * DD + 3 * BB);
}

template <int BB, int DD>
cudaError_t launch_reg(dim3 grid, cudaStream_t s, const float* enc, const uint8_t* mask,
                       const float* feats, const float* pm, const float* alpha,
                       const float* chol, const float* scal, float* part_val, int* part_idx,
                       int* done, float* out_val, int* out_idx, int n, int d, int B, float xi) {
  const cudaError_t err = cudaFuncSetAttribute(ei_reg_kernel<BB, DD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(reg_smem<BB, DD>()));
  if (err != cudaSuccess) return err;
  ei_reg_kernel<BB, DD><<<grid, EI_BLOCK, reg_smem<BB, DD>(), s>>>(enc, mask, feats, pm, alpha, chol, scal, part_val,
                                             part_idx, done, out_val, out_idx, n, d, B, xi);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Candidates a block takes on `route` (1 registers, 2 blocked; 0 picks the
// register route where B <= 64 and d <= 8) for n candidates, or 0 if the
// route cannot take (d, B).  The partials hold J * ceil(n / this) entries
// each.
int ei_argmax_tile(int n, int d, int B, int route) {
  if (n < 1 || d < 1 || B < 1) return 0;
  const bool reg = B <= EI_REG_MAX_B && d <= EI_REG_MAX_D;
  if (route == 1) return reg ? EI_BLOCK : 0;
  if (route == 0 && reg) return EI_BLOCK;
  const int t = blocked_tile(d, B), whole = (n + 31) / 32 * 32;  // no idle warps past n
  return t < whole ? t : whole;
}

const char* ei_argmax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One launch on `stream`; returns a cudaError_t (0 on success).  part_val /
// part_idx hold J * ceil(n / ei_argmax_tile(n, d, B, route)) entries each;
// done holds J ints that are 0 before the call and are 0 again after it.
int ei_argmax_launch(const float* enc, const uint8_t* mask, const float* feats,
                     const float* pm, const float* alpha, const float* chol,
                     const float* scal, float* part_val, int* part_idx, int* done,
                     float* out_val, int* out_idx, int J, int n, int d, int B,
                     float xi, int route, void* stream) {
  const int tile = ei_argmax_tile(n, d, B, route);
  if (J < 1 || J > 65535 || n < 1 || tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + tile - 1) / tile, J);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route != 2 && B <= EI_REG_MAX_B && d <= EI_REG_MAX_D) {
#define EI_REG_ARGS grid, s, enc, mask, feats, pm, alpha, chol, scal, part_val, part_idx, done, \
                    out_val, out_idx, n, d, B, xi
    cudaError_t err;
    if (B <= 16) err = launch_reg<16, EI_REG_MAX_D>(EI_REG_ARGS);
    else if (B <= 32) err = launch_reg<32, EI_REG_MAX_D>(EI_REG_ARGS);
    else err = launch_reg<64, EI_REG_MAX_D>(EI_REG_ARGS);
#undef EI_REG_ARGS
    return static_cast<int>(err);
  }
  const size_t smem = 4 * (static_cast<size_t>(B) * tile + static_cast<size_t>(tile) * d + tile) +
                      static_cast<size_t>(blocked_fixed(d));
  cudaError_t err = cudaFuncSetAttribute(ei_blocked_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ei_blocked_kernel<<<grid, EI_BLOCKED_THREADS, smem, s>>>(enc, mask, feats, pm, alpha, chol, scal,
                                                 part_val, part_idx, done, out_val, out_idx, n,
                                                 d, B, tile, blocked_rows(d), xi);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
