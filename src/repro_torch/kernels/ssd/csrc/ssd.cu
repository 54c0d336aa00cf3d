// Mamba-2 SSD intra-chunk (diagonal) term.
//
// Replaces the TPU kernel `repro/kernels/ssd/ssd.py`: `ssd_diag_kernel_call`
// (Pallas body `_kernel`).  For x (BC,Q,H,P), dt and lA (BC,Q,H), B and C
// (BC,Q,H,N), all f32, per (batch*chunk, head) cell and query row i:
//
//   cs   = cumsum(lA) over the chunk, summed in f64, rounded once to f32
//   y[i] = sum_{j <= i} (C_i . B_j) * exp(cs_i - cs_j) * dt_j * x_j
//
// The (Q,Q) decay and scores never touch device memory, which is the point
// of the TPU kernel.
//
// What bounds it on an H100: at the mamba2-370m forward's shape
// (BC,Q,H,P,N) = (128,256,32,64,128) one call moves 0.578 GB when B and C
// arrive once per group (head stride 0; 1.62 GB if they came head-expanded):
// 0.173 ms at 3.35 TB/s.  The products of the lower triangle are 51.7 GFLOP
// (103.1 GFLOP as the TPU kernel computes them, full Q x Q): 0.052 ms at the
// 989 TFLOP/s bf16 tensor-core peak, 0.77 ms at the 67 TFLOP/s FP32 peak this
// kernel is held to (it runs in f32 on the CUDA cores).  So it is bound by
// bytes, and a CUDA-core kernel by its operations.
//
// Design (simple first):
//   * one block of 256 threads per (query tile of 64 rows, head, batch*chunk),
//     heavy (late) query tiles first; a loop inside the block over 64-row key
//     tiles up to and including the diagonal tile takes the place of the
//     TPU's whole-chunk VMEM block (C, B and x of one 256-row chunk would take
//     320 KB in f32 at N = 128, P = 64, beyond the 227 KB a block can have);
//     key tiles above the diagonal are skipped, their decay is exactly 0;
//   * shared memory: C of the query rows and B of the key tile, transposed,
//     x of the key tile, the weighted scores, and dt and the prefix sum of lA
//     for the chunk up to the tile's last row: 103 KB at N = 128, so two
//     blocks per SM;
//   * the prefix sum of lA is taken by one thread, one add after another in
//     f64, each partial sum rounded once to f32, while the other threads load
//     the first key tile.  Over a 256-step chunk whose log-decays sum to -200
//     a running f32 sum strays by up to 4.5e-5 (XLA's cumsum by 1.8e-5), and
//     exp(cs_i - cs_j), summed over the chunk, turns that into up to 1e-3 of
//     an output of size 1; rounded from f64 it strays by half an f32 step;
//   * thread (ty, tx) owns query rows 4ty..4ty+3: scores of key columns
//     4tx..4tx+3 and output columns 4tx..4tx+3, in registers, f32 throughout;
//   * B and C are read through strides, so a head stride of 0 reads one
//     group's rows for every head without copying them out per head.
//
// Left for later: bf16 tensor-core products (wgmma), TMA loads of the next
// key tile while this one computes, and the inter-chunk states in the same
// pass.

#include <cuda_runtime.h>
#include <stdint.h>

#define SSD_BQ 64  // query rows of a block; key rows of a tile (the same)
#define SSD_THREADS 256
#define SSD_MAX_Q 256
#define SSD_MAX_N 128
#define SSD_MAX_P 64
#define SSD_LD 68  // row stride of the transposed tiles: SSD_BQ + 4

namespace {

__global__ void __launch_bounds__(SSD_THREADS) ssd_diag_kernel(
    const float* __restrict__ x,   // (BC, Q, H, P)
    const float* __restrict__ dt,  // (BC, Q, H)
    const float* __restrict__ lA,  // (BC, Q, H)
    const float* __restrict__ B,   // (BC, Q, H, N), strides sb_*
    const float* __restrict__ C,   // (BC, Q, H, N), strides sc_*
    float* __restrict__ y,         // (BC, Q, H, P)
    int BC, int Q, int H, int P, int N, long long sb_bc, long long sb_q,
    long long sb_h, long long sc_bc, long long sc_q, long long sc_h) {
  extern __shared__ float4 smem4[];
  float* sCt = reinterpret_cast<float*>(smem4);  // N x SSD_LD: C, [n][row]
  float* sBt = sCt + N * SSD_LD;                 // N x SSD_LD: B, [n][key]
  float* sX = sBt + N * SSD_LD;        // SSD_BQ x SSD_MAX_P: x, [key][p]
  float* sWt = sX + SSD_BQ * SSD_MAX_P;  // SSD_BQ x SSD_LD: weights, [key][row]
  float* sCS = sWt + SSD_BQ * SSD_LD;    // SSD_MAX_Q: lA, then its prefix sum
  float* sDT = sCS + SSD_MAX_Q;          // SSD_MAX_Q: dt

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int r0 = 4 * ty, c0 = 4 * tx;
  const int n_qt = (Q + SSD_BQ - 1) / SSD_BQ;
  const long long cells = (long long)H * BC;
  const int qt = n_qt - 1 - (int)(blockIdx.x / cells);  // late tiles first
  const long long cell = blockIdx.x % cells;
  const int h = (int)(cell % H);
  const long long bc = cell / H;
  const int q0 = qt * SSD_BQ;
  const int q_end = min(Q, q0 + SSD_BQ);  // the cumsum is needed up to here

  const float* dtb = dt + bc * Q * H + h;
  const float* lab = lA + bc * Q * H + h;
  const size_t x_row = (size_t)H * P;  // stride between positions of x and y
  const float* xb = x + bc * Q * x_row + (size_t)h * P;
  float* yb = y + bc * Q * x_row + (size_t)h * P;
  const float* Bb = B + bc * sb_bc + h * sb_h;
  const float* Cb = C + bc * sc_bc + h * sc_h;

  for (int t = tid; t < q_end; t += SSD_THREADS) {
    sCS[t] = lab[(size_t)t * H];
    sDT[t] = dtb[(size_t)t * H];
  }
  for (int i = tid; i < SSD_BQ * N; i += SSD_THREADS) {
    const int r = i / N, n = i - r * N;
    const int t = q0 + r;
    sCt[n * SSD_LD + r] = t < Q ? Cb[t * sc_q + n] : 0.f;
  }
  for (int i = tid; i < SSD_BQ * SSD_MAX_P; i += SSD_THREADS) sX[i] = 0.f;
  __syncthreads();
  if (tid == 0) {  // one add after another in f64, rounded once to f32
    double run = 0.0;
    for (int t = 0; t < q_end; ++t) {
      run += (double)sCS[t];
      sCS[t] = (float)run;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 <= q0; k0 += SSD_BQ) {
    for (int i = tid; i < SSD_BQ * N; i += SSD_THREADS) {
      const int r = i / N, n = i - r * N;
      const int s = k0 + r;
      sBt[n * SSD_LD + r] = s < Q ? Bb[s * sb_q + n] : 0.f;
    }
    for (int i = tid; i < SSD_BQ * P; i += SSD_THREADS) {
      const int r = i / P, p = i - r * P;
      const int s = k0 + r;
      sX[r * SSD_MAX_P + p] = s < Q ? xb[(size_t)s * x_row + p] : 0.f;
    }
    __syncthreads();  // tiles in; on the first tile, the prefix sum too

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      const float4 a = *reinterpret_cast<const float4*>(sCt + n * SSD_LD + r0);
      const float4 b = *reinterpret_cast<const float4*>(sBt + n * SSD_LD + c0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += av[i] * bv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + c0 + j;
        // kpos <= qpos < Q: at or before the query, inside the chunk
        sc[i][j] = (kpos <= qpos && qpos < Q)
                       ? sc[i][j] * expf(sCS[qpos] - sCS[kpos]) * sDT[kpos]
                       : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sWt + (c0 + j) * SSD_LD + r0) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();  // the weights are visible

    for (int kk = 0; kk < SSD_BQ; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(sWt + kk * SSD_LD + r0);
      const float4 v = *reinterpret_cast<const float4*>(sX + kk * SSD_MAX_P + c0);
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] += wv[i] * v.x;
        acc[i][1] += wv[i] * v.y;
        acc[i][2] += wv[i] * v.z;
        acc[i][3] += wv[i] * v.w;
      }
    }
    __syncthreads();  // readers of sBt, sX and sWt are done with this tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + r0 + i;
    if (t >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < P) yb[(size_t)t * x_row + c0 + j] = acc[i][j];
  }
}

size_t smem_bytes(int N) {
  return sizeof(float) * (2 * (size_t)N * SSD_LD + SSD_BQ * SSD_MAX_P +
                          SSD_BQ * SSD_LD + 2 * SSD_MAX_Q);
}

}  // namespace

extern "C" {

int ssd_diag_block(void) { return SSD_BQ; }
int ssd_diag_max_q(void) { return SSD_MAX_Q; }
int ssd_diag_max_n(void) { return SSD_MAX_N; }
int ssd_diag_max_p(void) { return SSD_MAX_P; }
// Dynamic shared memory of one block at state size N.
int ssd_diag_smem_bytes(int N) { return (int)smem_bytes(N); }

const char* ssd_diag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, dt, lA and y contiguous; B and C with element strides over (BC, Q, H)
// and unit stride over N.  Launches on `stream`; returns a cudaError_t (0 on
// success).
int ssd_diag_launch(const void* x, const void* dt, const void* lA,
                    const void* B, const void* C, void* y, int BC, int Q,
                    int H, int P, int N, long long sb_bc, long long sb_q,
                    long long sb_h, long long sc_bc, long long sc_q,
                    long long sc_h, void* stream) {
  if (BC < 1 || Q < 1 || Q > SSD_MAX_Q || H < 1 || P < 1 || P > SSD_MAX_P ||
      N < 1 || N > SSD_MAX_N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks =
      (long long)((Q + SSD_BQ - 1) / SSD_BQ) * H * (long long)BC;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_diag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_diag_kernel<<<(unsigned)blocks, SSD_THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(lA), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y), BC, Q, H, P, N,
      sb_bc, sb_q, sb_h, sc_bc, sc_q, sc_h);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
