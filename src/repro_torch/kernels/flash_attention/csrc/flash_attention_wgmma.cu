// Causal or bidirectional GQA attention forward in bf16 on Hopper's tensor cores.
//
// Replaces the TPU kernel `repro/kernels/flash_attention/flash_attention.py`:
// `flash_attention_kernel_call` (Pallas body `_kernel`), for bf16 inputs with
// D a multiple of 8 up to 128 (f32, and bf16 with D % 8 != 0, stay on the
// CUDA-core kernel of `flash_attention.cu`).  For q (B,T,H,D) and k, v
// (B,S,KV,D), each query head h reading key/value head h*KV/H:
//
//   s   = q.k^T in f32 (bf16 products, exact in f32), times the scale
//   s   = -1e30 where the key lies at or past S, or (causal) after the query
//   m, l, acc: running max, denominator and f32 accumulator over key tiles
//   p   = exp(s - m) in f32, summed into l
//   out = acc / max(l, 1e-30), in bf16
//   lse = m + log(max(l, 1e-30)) in f32, a row's log-sum-exp of the scaled
//         scores, where the caller asks for it (the backward reads it:
//         `flash_attention_bwd_wgmma.cu`)
//
// The tensor cores take P.V in bf16.  Rounding p to bf16 there (the usual
// flash design) makes the result depend on the last bits of s: where two
// implementations sum q.k in different orders, a p that rounds one step
// apart moves an output by up to 2^-8 of that key's weight.  On an H100, at
// the Qwen3-8B forward shape, that broke the one-rounding agreement with a
// plain version that rounded p too, at an output of an early (short) row.
// So p goes in as two bf16 terms, P_hi = bf16(p) and P_lo = bf16(p - P_hi),
// and O += P_hi.V + P_lo.V: P.V sees p to about 16 bits (2^-17 relative),
// the f32 p of the plain version and of the CUDA-core kernel up to
// rounding, at the cost of a second P.V product per tile.
//
// What bounds it on an H100: at the Qwen3-8B forward shape (B,T,H,KV,D) =
// (1,4096,32,8,128), causal, it does 137.5 GFLOP of products (4*D per
// query-key pair at or before the query) and moves 84 MB (q, k, v read
// once, o written once): 0.139 ms at the 989 TFLOP/s bf16 tensor-core peak
// against 0.025 ms at 3.35 TB/s, so it is bound by operations, and only the
// tensor cores can come near that bound.
//
// Design:
//   * a block of two consumer warpgroups (64 query rows each) and one
//     producer warpgroup owns 128 queries of one (b, h); grid (B*H,
//     ceil(T/128)), the heavy late causal tiles first; a loop over 128-key
//     tiles up to the causal limit replaces the TPU's sequential grid axis,
//     so key tiles wholly in the future are never loaded, and the mask runs
//     only on the tiles at the diagonal or the ragged end of S;
//   * one producer thread issues TMA loads: q once, then k and v tiles into
//     a two-stage ring in dynamic shared memory (32 KB a tile at D = 128:
//     160 KB), each completing on a "full" mbarrier; it refills a stage when
//     both consumer warpgroups have arrived on its "empty" mbarrier, so the
//     load of tile j+1 overlaps the products of tile j; `setmaxnreg` moves
//     registers from the producer (40) to the consumers (232), which hold two
//     64 x 128 f32 accumulators and P without spilling;
//   * the tensor maps are (D, heads, positions, batch) with boxes of 64 x
//     128 rows and the 128-byte swizzle, so ragged T, S and D (D < 64 or
//     64 < D < 128 read as zeros past D) need no padding;
//   * S = Q.K^T: `wgmma` m64n128k16, Q and K both K-major from shared
//     memory through 128-byte-swizzle descriptors (a D = 128 row is two
//     64-column atoms, 16 KB apart);
//   * the online softmax runs on the accumulator fragments in registers:
//     a thread holds 2 rows x 32 keys, the row max and sum go across the
//     four threads of a row by shuffles; exp2 on the special-function
//     unit, its argument one FMA; O is rescaled in registers, and P is
//     split into bf16 pairs in registers, where the accumulator layout of S
//     is the A-operand layout of the next product;
//   * O += P_hi.V + P_lo.V: `wgmma` m64nDk16 with A from registers and V
//     from shared memory, MN-major (the transpose bit), f32 accumulation;
//     O is stored from the fragments.
//
// Tried beside this design on an H100 and left out: a consumer thread
// issuing the loads, without a producer warpgroup, was slower; the two
// warpgroups taking turns at the tensor cores (ping-pong), a third stage,
// and issuing S_j together with P_{j-1}.V_{j-1} so that the softmax
// overlaps the products gained nothing measurable.  Counting the second
// P.V product (a third of its tensor-core work), the kernel keeps the
// tensor cores about as busy as scaled_dot_product_attention does.
//
// Left for later: a persistent causal schedule, 2-CTA clusters sharing the
// K/V tiles of a head group by multicast, and a cheaper exact P.V (the
// second product is the price of agreeing with the f32 p).

#include "wgmma_common.cuh"

#define TC_BQ 128      // queries a block: two warpgroups of 64 rows
#define TC_BK 128      // keys a tile
#define TC_CONSUMERS 256  // two warpgroups
#define TC_THREADS 384    // and a producer warpgroup
#define TC_PRODUCER_REGS 40
#define TC_CONSUMER_REGS 232  // 128 x 40 + 256 x 232 <= 65536
#define TC_STAGES 2       // k/v ring depth
#define TC_MAX_D 128
#define TC_ATOM 16384  // bytes of 128 rows x 64 bf16: one swizzle atom column of a tile

namespace {

// A 128-row tile of DP columns: NA boxes of 64 columns, one atom each.
template <int NA>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int head, int pos, int batch) {
  mbar_expect_tx(bar, NA * TC_ATOM);
  tma_tile<NA, TC_ATOM>(dst, map, bar, head, pos, batch);
}

// DP: the head dim the tiles hold (64 or 128); D <= DP is the real one.
// Thread layout of a warpgroup's 64 x N accumulator: thread t (warp w =
// t / 32, lane) holds rows 16w + lane/4 and that + 8, and in each 8-column
// block jj the columns 8jj + 2(lane % 4) and the next: registers 4jj, 4jj+1
// (first row) and 4jj+2, 4jj+3 (second row).
template <int DP>
__global__ void __launch_bounds__(TC_THREADS, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int T, int S, int H, int KV, int D, float scale_log2, int causal) {
  constexpr int NA = DP / 64;
  constexpr uint32_t TILE = NA * TC_ATOM;
  constexpr int NO = DP / 2;
  // mbarriers: q; k full, v full and k/v empty of each stage
  __shared__ __align__(8) uint64_t bars[1 + 3 * TC_STAGES];
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's 1 KB period
  const uint32_t sQ = base;
  const uint32_t bar_q = smem_u32(&bars[0]);

  const int tid = threadIdx.x;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BQ;
  const int kvh = static_cast<int>(static_cast<long long>(h) * KV / H);
  const int k_end = causal ? min(S, q0 + TC_BQ) : S;
  const int n_tiles = (k_end + TC_BK - 1) / TC_BK;

  auto kfull = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto vfull = [&](int s) { return smem_u32(&bars[1 + TC_STAGES + s]); };
  auto kv_empty = [&](int s) { return smem_u32(&bars[1 + 2 * TC_STAGES + s]); };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + 2 * TC_STAGES; ++i) mbar_init(smem_u32(&bars[i]), 1);
#pragma unroll
    for (int s = 0; s < TC_STAGES; ++s) mbar_init(kv_empty(s), 2);  // one arrival a warpgroup
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= TC_CONSUMERS) {  // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(TC_PRODUCER_REGS));
    if (tid == TC_CONSUMERS) {
      load_tile<NA>(sQ, &qmap, bar_q, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % TC_STAGES;
        if (j >= TC_STAGES) mbar_wait(kv_empty(s), (j / TC_STAGES - 1) & 1);
        const uint32_t sK = base + TILE * (1 + 2 * s);
        load_tile<NA>(sK, &kmap, kfull(s), kvh, j * TC_BK, b);
        load_tile<NA>(sK + TILE, &vmap, vfull(s), kvh, j * TC_BK, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(TC_CONSUMER_REGS));
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // and row0 + 8
  const int col = 2 * (lane % 4);
  const uint32_t q_wg = sQ + wg * 64 * 128;  // this warpgroup's 64 rows of each atom

  float acc[NO], sc[64];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;  // l: this thread's share

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % TC_STAGES;
    const uint32_t parity = (j / TC_STAGES) & 1;
    const uint32_t sK = base + TILE * (1 + 2 * s), sV = sK + TILE;

    // S = Q.K^T over DP / 16 slices of 16 columns.
    mbar_wait(kfull(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / 4) * TC_ATOM + (kk % 4) * 32;
      wgmma_ss_n128(sc, sw128_desc(q_wg + off, 16), sw128_desc(sK + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);

    // Online softmax in base 2 on the fragments: the max of the raw scores
    // (the scale is positive), then p = 2^(s * scale * log2(e) - m), m in
    // base-2 units.
    const int k0 = j * TC_BK;
    const bool edge = k0 + TC_BK > S || (causal && k0 + TC_BK - 1 > q0 + 64 * wg);
    float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (edge) {
          const int key = k0 + 8 * jj + col + e;
          if (key >= S || (causal && key > row0)) sc[4 * jj + e] = kMasked;
          if (key >= S || (causal && key > row0 + 8)) sc[4 * jj + 2 + e] = kMasked;
        }
        mx0 = fmaxf(mx0, sc[4 * jj + e]);
        mx1 = fmaxf(mx1, sc[4 * jj + 2 + e]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
    const float mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
    const float alpha0 = exp2_approx(m0 - mn0), alpha1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * jj + e] = exp2_approx(fmaf(sc[4 * jj + e], scale_log2, -mn0));
        sc[4 * jj + 2 + e] = exp2_approx(fmaf(sc[4 * jj + 2 + e], scale_log2, -mn1));
        sum0 += sc[4 * jj + e];
        sum1 += sc[4 * jj + 2 + e];
      }
    }
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      acc[4 * jj] *= alpha0;
      acc[4 * jj + 1] *= alpha0;
      acc[4 * jj + 2] *= alpha1;
      acc[4 * jj + 3] *= alpha1;
    }
    // P = P_hi + P_lo in bf16 pairs.  Slice kk of P (keys 16kk..16kk+15) is
    // column blocks 2kk and 2kk+1: register r of the slice holds the pair
    // sc[8kk + 2r], sc[8kk + 2r + 1].
    uint32_t ph[32], pl[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) split_bf16(sc[2 * i], sc[2 * i + 1], ph[i], pl[i]);

    // O += P_hi.V + P_lo.V over 8 slices of 16 keys; V's slice is 16 rows of
    // 128 bytes.
    mbar_wait(vfull(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t vd = sw128_desc(sV + kk * 2048, TC_ATOM);
      wgmma_rs_d<DP>(acc, &ph[4 * kk], vd);
      wgmma_rs_d<DP>(acc, &pl[4 * kk], vd);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    if (tid % 128 == 0) mbar_arrive(kv_empty(s));  // this warpgroup is done with stage s
  }

  const float d0 = fmaxf(quad_sum(l0), 1e-30f), d1 = fmaxf(quad_sum(l1), 1e-30f);
  if (lse != nullptr && lane % 4 == 0) {  // log(sum exp(s)) = (m + log2 l) ln 2, m in base 2
    float* lrow = lse + (static_cast<size_t>(b) * H + h) * T;
    if (row0 < T) lrow[row0] = (m0 + log2f(d0)) * kLn2;
    if (row0 + 8 < T) lrow[row0 + 8] = (m1 + log2f(d1)) * kLn2;
  }
  const size_t row_stride = static_cast<size_t>(H) * D;
  __nv_bfloat16* o0 = o + (static_cast<size_t>(b) * T + row0) * row_stride + static_cast<size_t>(h) * D;
  __nv_bfloat16* o1 = o0 + 8 * row_stride;
#pragma unroll
  for (int jj = 0; jj < DP / 8; ++jj) {
    const int c = 8 * jj + col;
    if (c < D) {
      if (row0 < T)
        *reinterpret_cast<__nv_bfloat162*>(o0 + c) =
            __floats2bfloat162_rn(acc[4 * jj] / d0, acc[4 * jj + 1] / d0);
      if (row0 + 8 < T)
        *reinterpret_cast<__nv_bfloat162*>(o1 + c) =
            __floats2bfloat162_rn(acc[4 * jj + 2] / d1, acc[4 * jj + 3] / d1);
    }
  }
}

size_t wgmma_smem_bytes(int D) {
  const int na = D <= 64 ? 1 : 2;
  return 1024 + static_cast<size_t>(na) * TC_ATOM * (1 + 2 * TC_STAGES);  // + 1 KB to align
}

template <int DP>
int launch_wgmma(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, void* o,
                 float* lse, int B, int T, int S, int H, int KV, int D, float scale, int causal,
                 cudaStream_t stream) {
  const size_t smem = wgmma_smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (T + TC_BQ - 1) / TC_BQ);
  flash_fwd_wgmma_kernel<DP><<<grid, TC_THREADS, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, T, S, H, KV, D, scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int flash_attention_wgmma_block_q(void) { return TC_BQ; }
int flash_attention_wgmma_block_k(void) { return TC_BK; }
int flash_attention_wgmma_max_d(void) { return TC_MAX_D; }
// Dynamic shared memory of one block at head dim D.
int flash_attention_wgmma_smem_bytes(int D) { return (int)wgmma_smem_bytes(D); }

// bf16 q (B,T,H,D), k and v (B,S,KV,D) and o (B,T,H,D), contiguous and
// 16-byte aligned, 8 <= D <= 128 with D % 8 == 0; `lse`, unless null, the
// f32 (B,H,T) row log-sum-exp of the scaled, masked scores, which the
// backward reads.  Launches on `stream`; returns a cudaError_t (0 on success).
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int B, int T, int S, int H, int KV, int D,
                                 float scale, int causal, void* stream) {
  if (B < 1 || T < 1 || S < 1 || H < 1 || KV < 1 || KV > H || D < 8 || D > TC_MAX_D ||
      D % 8 != 0 || static_cast<long long>(B) * H > 2147483647LL ||
      (T + TC_BQ - 1) / TC_BQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return static_cast<int>(bound);
  CUtensorMap qm, km, vm;
  if (!make_map(enc, &qm, q, B, T, H, D, TC_BQ) || !make_map(enc, &km, k, B, S, KV, D, TC_BK) ||
      !make_map(enc, &vm, v, B, S, KV, D, TC_BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (D <= 64) return launch_wgmma<64>(qm, km, vm, o, l, B, T, S, H, KV, D, scale, causal, st);
  return launch_wgmma<128>(qm, km, vm, o, l, B, T, S, H, KV, D, scale, causal, st);
}

}  // extern "C"
