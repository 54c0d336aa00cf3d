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
// `jnp.argmax` / `torch.argmax` do over the full block.
//
// What bounds it on an H100: per candidate it reads d floats and one mask
// byte (about 25 bytes at d = 6) and does about B(2d + 21) + B(B - 1)
// FP32 operations (about 1.4 kflop at B = 24), so at the catalog shape
// (n = 131072, d = 6, B = 24) the FP32 rate bounds it (about 2.7 us against
// about 1 us of memory traffic).  The rest is launch overhead: the main path
// calls it once per BO step.
//
// Design (simple first):
//   * grid (ceil(n / EI_BLOCK), J); one thread owns one candidate column;
//   * L (B x B), feats (B x d), |f_b|^2, alpha and pm of job j are staged in
//     dynamic shared memory (L alone is 64 KB at the cap B = 128, hence the
//     opt-in above 48 KB);
//   * each thread runs the row sweep of the forward substitution, computing
//     k_b and v_b in the same loop: v_b needs only v_0 .. v_{b-1};
//   * each block reduces its columns to one (max, argmax) pair; a second
//     kernel, one block per job, reduces the pairs.  Blocks run in no order,
//     so the TPU kernel's sequential strict-`>` fold becomes an order-free
//     comparison: larger value wins, equal values go to the lower index.
//   * NaN counts as larger than any number, as in `torch.argmax`; EI is
//     NaN only when the head's Cholesky failed at every grid point.
//
// Left for later: the (B,d) x (d,tile) distance block and the triangular
// solve as tensor-core (wgmma) products, and keeping k and v in registers
// (compile-time B buckets) instead of the local-memory array used here.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <limits.h>

#define EI_BLOCK 256
#define EI_MAX_B 128
#define EI_MAX_D 32

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

__device__ __forceinline__ void block_argmax(float* rv, int* ri) {
  const int tid = threadIdx.x;
  __syncthreads();
  for (int s = EI_BLOCK / 2; s > 0; s >>= 1) {
    if (tid < s && beats(rv[tid + s], ri[tid + s], rv[tid], ri[tid])) {
      rv[tid] = rv[tid + s];
      ri[tid] = ri[tid + s];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(EI_BLOCK) ei_tile_kernel(
    const float* __restrict__ enc,     // (J, n, d)
    const uint8_t* __restrict__ mask,  // (J, n) candidate mask (bool bytes)
    const float* __restrict__ feats,   // (J, B, d)
    const float* __restrict__ pm,      // (J, B)
    const float* __restrict__ alpha,   // (J, B)
    const float* __restrict__ chol,    // (J, B, B) lower factor
    const float* __restrict__ scal,    // (J, 4): ls, y_mean, y_std, best
    float* __restrict__ part_val,      // (J, nb)
    int* __restrict__ part_idx,        // (J, nb)
    int n, int d, int B, float xi) {
  extern __shared__ float smem[];
  float* sL = smem;          // B*B
  float* sF = sL + B * B;    // B*d
  float* sFn = sF + B * d;   // B: |f_b|^2
  float* sA = sFn + B;       // B
  float* sP = sA + B;        // B
  __shared__ float rv[EI_BLOCK];
  __shared__ int ri[EI_BLOCK];

  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  const float* Lg = chol + (size_t)j * B * B;
  const float* Fg = feats + (size_t)j * B * d;
  for (int i = tid; i < B * B; i += EI_BLOCK) sL[i] = Lg[i];
  for (int i = tid; i < B * d; i += EI_BLOCK) sF[i] = Fg[i];
  for (int i = tid; i < B; i += EI_BLOCK) {
    sA[i] = alpha[(size_t)j * B + i];
    sP[i] = pm[(size_t)j * B + i];
  }
  __syncthreads();
  for (int b = tid; b < B; b += EI_BLOCK) {
    float s = 0.f;
    for (int k = 0; k < d; ++k) s += sF[b * d + k] * sF[b * d + k];
    sFn[b] = s;
  }
  __syncthreads();

  const float ls = scal[j * 4 + 0];
  const float y_mean = scal[j * 4 + 1];
  const float y_std = scal[j * 4 + 2];
  const float best = scal[j * 4 + 3];
  const float ls2 = ls * ls;

  const int col = blockIdx.x * EI_BLOCK + tid;
  float ei = -CUDART_INF_F;
  if (col < n && mask[(size_t)j * n + col]) {
    const float* e = enc + ((size_t)j * n + col) * d;
    float ev[EI_MAX_D];
    float en = 0.f;
    for (int k = 0; k < d; ++k) {
      ev[k] = e[k];
      en += ev[k] * ev[k];
    }
    float v[EI_MAX_B];
    float mean_n = 0.f, vv = 0.f;
    for (int b = 0; b < B; ++b) {
      float dot = 0.f;
      for (int k = 0; k < d; ++k) dot += sF[b * d + k] * ev[k];
      const float d2 = clamp_lo(sFn[b] + en - 2.f * dot, 0.f);
      const float s2 = clamp_lo(d2 / ls2, 1e-12f);
      const float s5 = kSqrt5 * sqrtf(s2);
      const float kb = (1.f + s5 + (5.f / 3.f) * s2) * expf(-s5) * sP[b];
      mean_n += kb * sA[b];
      const float* Lrow = sL + b * B;
      float acc = kb;
      for (int i = 0; i < b; ++i) acc -= Lrow[i] * v[i];
      const float vb = acc / Lrow[b];
      v[b] = vb;
      vv += vb * vb;
    }
    const float std_n = sqrtf(clamp_lo(1.f - vv, 1e-12f));
    const float mean = mean_n * y_std + y_mean;
    const float sd = std_n * y_std;
    const float imp = best - mean - xi;
    const float z = imp / clamp_lo(sd, 1e-12f);
    const float cdf = 0.5f * (1.f + erff(z / kSqrt2));
    const float pdf = expf(-0.5f * z * z) / kSqrt2Pi;
    ei = clamp_lo(imp * cdf + sd * pdf, 0.f);
  }
  rv[tid] = ei;
  ri[tid] = col;
  block_argmax(rv, ri);
  if (tid == 0) {
    part_val[(size_t)j * gridDim.x + blockIdx.x] = rv[0];
    part_idx[(size_t)j * gridDim.x + blockIdx.x] = ri[0];
  }
}

__global__ void __launch_bounds__(EI_BLOCK) ei_reduce_kernel(
    const float* __restrict__ part_val, const int* __restrict__ part_idx,
    int nb, float* __restrict__ out_val, int* __restrict__ out_idx) {
  __shared__ float rv[EI_BLOCK];
  __shared__ int ri[EI_BLOCK];
  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  float bv = -CUDART_INF_F;
  int bi = INT_MAX;  // every real pair beats this sentinel
  for (int i = tid; i < nb; i += EI_BLOCK) {
    const float v = part_val[(size_t)j * nb + i];
    const int id = part_idx[(size_t)j * nb + i];
    if (beats(v, id, bv, bi)) {
      bv = v;
      bi = id;
    }
  }
  rv[tid] = bv;
  ri[tid] = bi;
  block_argmax(rv, ri);
  if (tid == 0) {
    out_val[j] = rv[0];
    out_idx[j] = ri[0];
  }
}

}  // namespace

extern "C" {

int ei_argmax_block(void) { return EI_BLOCK; }
int ei_argmax_max_b(void) { return EI_MAX_B; }
int ei_argmax_max_d(void) { return EI_MAX_D; }

const char* ei_argmax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches both passes on `stream`; returns a cudaError_t (0 on success).
// part_val / part_idx hold J * ceil(n / EI_BLOCK) entries each.
int ei_argmax_launch(const float* enc, const uint8_t* mask, const float* feats,
                     const float* pm, const float* alpha, const float* chol,
                     const float* scal, float* part_val, int* part_idx,
                     float* out_val, int* out_idx, int J, int n, int d, int B,
                     float xi, void* stream) {
  if (J < 1 || J > 65535 || n < 1 || d < 1 || d > EI_MAX_D || B < 1 ||
      B > EI_MAX_B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      sizeof(float) * ((size_t)B * B + (size_t)B * d + 3 * (size_t)B);
  cudaError_t err = cudaFuncSetAttribute(
      ei_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (n + EI_BLOCK - 1) / EI_BLOCK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ei_tile_kernel<<<dim3(nb, J), EI_BLOCK, smem, s>>>(
      enc, mask, feats, pm, alpha, chol, scal, part_val, part_idx, n, d, B, xi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ei_reduce_kernel<<<J, EI_BLOCK, 0, s>>>(part_val, part_idx, nb, out_val,
                                          out_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
