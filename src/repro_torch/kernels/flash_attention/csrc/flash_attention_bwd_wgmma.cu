// Backward of the tensor-core flash-attention forward (`flash_attention_wgmma.cu`)
// on Hopper: bf16 q, k, v and dO, D a multiple of 8 up to 128, causal or
// bidirectional, GQA.
//
// It replaces no TPU kernel: the JAX package's flash attention differentiates
// through its oracle (`repro/kernels/flash_attention/ops.py::_bwd`, the VJP of
// `attention_ref`), and so did the port until this kernel.  Autograd through
// the oracle builds the f32 (B, KV, G, T, S) logits, probabilities and their
// gradients in device memory over the whole square; this kernel computes the
// same gradients FlashAttention-2 style, never writing a T x S block.
//
// For q (B,T,H,D), k, v (B,S,KV,D), the forward's bf16 output o, its f32
// row log-sum-exp lse (B,H,T) and the output's gradient dO:
//
//   Di  = rowsum(dO * o) in f32                       (flash_bwd_dot_do_o_kernel)
//   s   = q.k^T * scale, p = exp(s - lse), 0 where masked: the forward's
//         masks (causal: the key after the query, top-left aligned; keys at
//         or past S)
//   dp  = dO.v^T, ds = p * (dp - Di)
//   dv  = sum over queries of p^T.dO                  (flash_bwd_dkdv_wgmma_kernel)
//   dk  = scale * sum over queries of ds^T.q          (flash_bwd_dkdv_wgmma_kernel)
//   dq  = scale * sum over keys of ds.k               (flash_bwd_dq_wgmma_kernel)
//
// dk and dv sum over the G = H / KV query heads of their KV head.  q, k, v and
// dO enter the tensor cores in bf16 as given; p and ds are f32 and enter their
// products as two bf16 terms each, X_hi = bf16(x) and X_lo = bf16(x - X_hi)
// (the forward's rule for p, and its reason), so the products see them to
// about 16 bits; every accumulator is f32; dq, dk and dv are rounded to bf16
// once, at the end.
//
// What bounds it on an H100: at (B,T,H,KV,D) = (1,4096,32,8,128), causal, the
// backward's five products need 10*D operations for each of the 8.39 M
// query-key pairs at or before the query, over 32 heads: 3.44e11, 0.347 ms at
// the 989 TFLOP/s bf16 peak; it reads q, k, v, o, dO and lse and writes dq,
// dk, dv, about 0.15 GB, 0.045 ms at 3.35 TB/s.  So it is bound by operations,
// and only the tensor cores come near that bound.  This design issues 10
// products a pair (the two-term p and ds, and s and dp computed twice, once
// for dk/dv and once for dq), twice the counted work.
//
// Design:
//   * two kernels of the forward's shape instead of one with atomics: the
//     dK/dV kernel owns 128 keys of one (b, KV head), walks the G query heads
//     and the 64-query tiles that see its keys, and keeps dK and dV in
//     registers (no scratch, no atomics, the GQA sum inside the block); the
//     dQ kernel owns 128 queries of one (b, h), walks the 128-key tiles up to
//     the causal limit as the forward does, and keeps dQ in registers.  Each
//     recomputes s and dp; that costs two of the ten products a pair, and
//     saves the f32 dQ scratch, its atomics or second pass, and the barriers
//     between warpgroups that sharing ds through shared memory would need;
//   * each block: two consumer warpgroups (64 rows each) and one producer
//     warpgroup whose one thread issues TMA loads into a two-stage ring
//     (`setmaxnreg` 40 / 232, as the forward); heavy causal blocks first;
//   * dK/dV: s^T = K.Q^T and dp^T = V.dO^T by `wgmma` m64n64k16 from shared
//     memory (K, V the A operands, Q, dO the B operands, all K-major); p^T
//     and ds^T on the fragments, each query's lse and Di from shared memory
//     (bulk-copied beside the tile), each split into its bf16 pairs as soon
//     as it is computed (splitting after the whole tile spilled 44 bytes a
//     thread and cost 6 % on an H100); dV += P^T.dO and dK += dS^T.Q by
//     m64nDk16 with A from registers (the accumulator layout of s^T is the
//     A-operand layout) and Q, dO MN-major;
//   * dQ: s = Q.K^T and dp = dO.V^T by m64n128k16, then dQ += dS.K with A
//     from registers and K MN-major, as the forward's P.V;
//   * the rows past T (the last query tile) carry lse = +inf and Di = 0 in
//     padded (B, H, Tp) copies the first kernel writes, so their p is 0 and
//     they add nothing.
//
// On an H100 at (1,4096,32,8,128) causal the dK/dV kernel keeps the tensor
// cores busy about 58 % of its time and the dQ kernel about 70 %, counting
// the products each issues.  A three-stage ring for the dK/dV kernel gained
// nothing measurable.  Left for later: overlapping one tile's softmax with
// the next tile's products (two warpgroups in ping-pong), and one kernel
// that shares ds through shared memory for dq (two products fewer a pair).

#include "wgmma_common.cuh"

#define BW_CONSUMERS 256   // two warpgroups
#define BW_THREADS 384     // and a producer warpgroup
#define BW_PRODUCER_REGS 40
#define BW_CONSUMER_REGS 232  // 128 x 40 + 256 x 232 <= 65536
#define BW_STAGES 2        // ring depth
#define BW_MAX_D 128
#define BW_ROW_PAD 128     // the padded row statistics: Tp = T rounded up to this
#define KV_BN 128          // dK/dV kernel: keys a block (two warpgroups of 64)
#define KV_BM 64           // and queries a tile
#define KV_ATOM_K 16384    // bytes of 128 rows x 64 bf16
#define KV_ATOM_Q 8192     // bytes of 64 rows x 64 bf16
#define DQ_BM 128          // dQ kernel: queries a block (two warpgroups of 64)
#define DQ_BN 128          // and keys a tile
#define DQ_ATOM 16384

namespace {

// Di = rowsum(dO * o) and lse2 = lse * log2(e) for each row r = (b*H + h)*Tp + t,
// one warp a row; rows t >= T get Di = 0 and lse2 = +inf.
__global__ void __launch_bounds__(256) flash_bwd_dot_do_o_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ di, float* __restrict__ lse2, int T,
    int Tp, int H, int D, long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int t = static_cast<int>(r % Tp);
  const long long bh = r / Tp;
  float acc = 0.f;
  if (t < T) {
    const long long b = bh / H, h = bh % H;
    const size_t off = ((static_cast<size_t>(b) * T + t) * H + h) * D;
    for (int c = 2 * lane; c < D; c += 64) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + off + c));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + off + c));
      acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    di[r] = acc;
    lse2[r] = t < T ? lse[bh * T + t] * kLog2e : __int_as_float(0x7f800000);
  }
}

// The dK/dV kernel.  Thread layout of a warpgroup's 64 x N accumulator, as
// the forward's: thread t (warp w = t / 32, lane) holds rows 16w + lane/4
// and that + 8, and in each 8-column block jj the columns 8jj + 2(lane % 4)
// and the next: registers 4jj, 4jj+1 (first row) and 4jj+2, 4jj+3 (second).
// Here rows are keys and the columns of s^T, dp^T are queries.
template <int DP>
__global__ void __launch_bounds__(BW_THREADS, 1) flash_bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const float* __restrict__ lse2, const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int T, int Tp, int S, int H, int KV, int D, float scale,
    float scale_log2, int causal) {
  constexpr int NA = DP / 64;
  constexpr uint32_t TILE_K = NA * KV_ATOM_K, TILE_Q = NA * KV_ATOM_Q;
  constexpr uint32_t STAGE = 2 * TILE_Q + 1024;  // q, dO, then lse2 and Di (256 B each)
  constexpr int NO = DP / 2;
  // mbarriers: k and v; q/dO/lse2/Di full and empty of each stage
  __shared__ __align__(8) uint64_t bars[1 + 2 * BW_STAGES];
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + TILE_K;
  const uint32_t bar_kv = smem_u32(&bars[0]);
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + BW_STAGES + s]); };
  auto stage = [&](int s) { return base + 2 * TILE_K + STAGE * s; };

  const int tid = threadIdx.x;
  const int kvh = blockIdx.x % KV, b = blockIdx.x / KV;
  const int k0 = blockIdx.y * KV_BN;  // block 0 has the most causal work: launched first
  const int G = H / KV;
  const int nq = (T + KV_BM - 1) / KV_BM;
  const int qt0 = causal ? min(k0 / KV_BM, nq) : 0;  // earlier query tiles see none of its keys
  const int nqb = nq - qt0, n_iter = G * nqb;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one arrival a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= BW_CONSUMERS) {  // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(BW_PRODUCER_REGS));
    if (tid == BW_CONSUMERS && n_iter > 0) {
      mbar_expect_tx(bar_kv, 2 * TILE_K);
      tma_tile<NA, KV_ATOM_K>(sK, &kmap, bar_kv, kvh, k0, b);
      tma_tile<NA, KV_ATOM_K>(sV, &vmap, bar_kv, kvh, k0, b);
      for (int i = 0; i < n_iter; ++i) {
        const int s = i % BW_STAGES;
        if (i >= BW_STAGES) mbar_wait(empty(s), (i / BW_STAGES - 1) & 1);
        const int h = kvh * G + i / nqb, q0 = (qt0 + i % nqb) * KV_BM;
        const uint32_t st = stage(s);
        const size_t rows = (static_cast<size_t>(b) * H + h) * Tp + q0;
        mbar_expect_tx(full(s), 2 * TILE_Q + 2 * KV_BM * 4);
        tma_tile<NA, KV_ATOM_Q>(st, &qmap, full(s), h, q0, b);
        tma_tile<NA, KV_ATOM_Q>(st + TILE_Q, &domap, full(s), h, q0, b);
        bulk_load(st + 2 * TILE_Q, lse2 + rows, KV_BM * 4, full(s));
        bulk_load(st + 2 * TILE_Q + KV_BM * 4, di + rows, KV_BM * 4, full(s));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(BW_CONSUMER_REGS));
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int kw = k0 + 64 * wg;                // this warpgroup's first key
  const int key0 = kw + 16 * warp + lane / 4;  // and key0 + 8: this thread's rows
  const int col = 2 * (lane % 4);
  const uint32_t k_wg = sK + wg * 64 * 128, v_wg = sV + wg * 64 * 128;

  float dka[NO], dva[NO], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;

  if (n_iter > 0) mbar_wait(bar_kv, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int s = i % BW_STAGES;
    const uint32_t parity = (i / BW_STAGES) & 1;
    const uint32_t sQ = stage(s), sdO = sQ + TILE_Q;
    const int q0 = (qt0 + i % nqb) * KV_BM;

    // s^T = K.Q^T and dp^T = V.dO^T over DP / 16 slices of 16 columns.
    mbar_wait(full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss_n64(st, sw128_desc(k_wg + kslice<KV_ATOM_K>(kk), 16),
                   sw128_desc(sQ + kslice<KV_ATOM_Q>(kk), 16), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss_n64(dpt, sw128_desc(v_wg + kslice<KV_ATOM_K>(kk), 16),
                   sw128_desc(sdO + kslice<KV_ATOM_Q>(kk), 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(st);
    pin(dpt);

    // p^T = 2^(s * scale * log2(e) - lse2) and ds^T = p^T * (dp^T - Di), each
    // column's lse2 and Di from the stage, split at once into bf16 pairs
    // hi + lo: pair r holds registers 2r and 2r + 1, so slice kk (queries
    // 16kk..16kk+15) is pairs 4kk..4kk+3.
    const float* sl = reinterpret_cast<const float*>(smem_raw + (sQ + 2 * TILE_Q - raw));
    const float* sd = sl + KV_BM;
    const bool edge = (causal && kw + 63 > q0) || kw + 64 > S;
    uint32_t ph[16], pl[16], dh[16], dl[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      float p[4], ds[4];  // registers 4jj..4jj+3: keys key0 (e) and key0 + 8 (2 + e)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * jj + col + e;
        const float l2 = sl[c], d = sd[c];
        p[e] = exp2_approx(fmaf(st[4 * jj + e], scale_log2, -l2));
        p[2 + e] = exp2_approx(fmaf(st[4 * jj + 2 + e], scale_log2, -l2));
        if (edge) {
          const int q = q0 + c;
          if (key0 >= S || (causal && key0 > q)) p[e] = 0.f;
          if (key0 + 8 >= S || (causal && key0 + 8 > q)) p[2 + e] = 0.f;
        }
        ds[e] = p[e] * (dpt[4 * jj + e] - d);
        ds[2 + e] = p[2 + e] * (dpt[4 * jj + 2 + e] - d);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        split_bf16(p[2 * r], p[2 * r + 1], ph[2 * jj + r], pl[2 * jj + r]);
        split_bf16(ds[2 * r], ds[2 * r + 1], dh[2 * jj + r], dl[2 * jj + r]);
      }
    }

    // dV += P^T.dO and dK += dS^T.Q over 4 slices of 16 queries; a slice of
    // dO or Q is 16 rows of 128 bytes, MN-major.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KV_BM / 16; ++kk) {
      const uint64_t od = sw128_desc(sdO + kk * 2048, KV_ATOM_Q);
      wgmma_rs_d<DP>(dva, &ph[4 * kk], od);
      wgmma_rs_d<DP>(dva, &pl[4 * kk], od);
      const uint64_t qd = sw128_desc(sQ + kk * 2048, KV_ATOM_Q);
      wgmma_rs_d<DP>(dka, &dh[4 * kk], qd);
      wgmma_rs_d<DP>(dka, &dl[4 * kk], qd);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(dva);
    pin(dka);
    pin(ph);
    pin(pl);
    pin(dh);
    pin(dl);
    if (tid % 128 == 0) mbar_arrive(empty(s));  // this warpgroup is done with stage s
  }

  const size_t row_stride = static_cast<size_t>(KV) * D;
  const size_t at = (static_cast<size_t>(b) * S + key0) * row_stride + static_cast<size_t>(kvh) * D;
#pragma unroll
  for (int jj = 0; jj < DP / 8; ++jj) {
    const int c = 8 * jj + col;
    if (c < D) {
      if (key0 < S) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + c) =
            __floats2bfloat162_rn(dka[4 * jj] * scale, dka[4 * jj + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + c) =
            __floats2bfloat162_rn(dva[4 * jj], dva[4 * jj + 1]);
      }
      if (key0 + 8 < S) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * row_stride + c) =
            __floats2bfloat162_rn(dka[4 * jj + 2] * scale, dka[4 * jj + 3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * row_stride + c) =
            __floats2bfloat162_rn(dva[4 * jj + 2], dva[4 * jj + 3]);
      }
    }
  }
}

// The dQ kernel: the forward's loop over key tiles, with dp^T's place taken
// by dp = dO.V^T and P.V's by dS.K.  Rows are queries.
template <int DP>
__global__ void __launch_bounds__(BW_THREADS, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const float* __restrict__ lse2, const float* __restrict__ di, __nv_bfloat16* __restrict__ dq,
    int T, int Tp, int S, int H, int KV, int D, float scale, float scale_log2, int causal) {
  constexpr int NA = DP / 64;
  constexpr uint32_t TILE = NA * DQ_ATOM;
  constexpr int NO = DP / 2;
  // mbarriers: q and dO; k full, v full and k/v empty of each stage
  __shared__ __align__(8) uint64_t bars[1 + 3 * BW_STAGES];
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = base + TILE;
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto kfull = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto vfull = [&](int s) { return smem_u32(&bars[1 + BW_STAGES + s]); };
  auto kv_empty = [&](int s) { return smem_u32(&bars[1 + 2 * BW_STAGES + s]); };

  const int tid = threadIdx.x;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_BM;  // the heavy late tiles first
  const int kvh = h / (H / KV);
  const int k_end = causal ? min(S, q0 + DQ_BM) : S;
  const int n_tiles = (k_end + DQ_BN - 1) / DQ_BN;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + 2 * BW_STAGES; ++i) mbar_init(smem_u32(&bars[i]), 1);
#pragma unroll
    for (int s = 0; s < BW_STAGES; ++s) mbar_init(kv_empty(s), 2);  // one arrival a warpgroup
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= BW_CONSUMERS) {  // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(BW_PRODUCER_REGS));
    if (tid == BW_CONSUMERS) {
      mbar_expect_tx(bar_q, 2 * TILE);
      tma_tile<NA, DQ_ATOM>(sQ, &qmap, bar_q, h, q0, b);
      tma_tile<NA, DQ_ATOM>(sdO, &domap, bar_q, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % BW_STAGES;
        if (j >= BW_STAGES) mbar_wait(kv_empty(s), (j / BW_STAGES - 1) & 1);
        const uint32_t sK = base + TILE * (2 + 2 * s);
        mbar_expect_tx(kfull(s), TILE);
        tma_tile<NA, DQ_ATOM>(sK, &kmap, kfull(s), kvh, j * DQ_BN, b);
        mbar_expect_tx(vfull(s), TILE);
        tma_tile<NA, DQ_ATOM>(sK + TILE, &vmap, vfull(s), kvh, j * DQ_BN, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(BW_CONSUMER_REGS));
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // and row0 + 8
  const int col = 2 * (lane % 4);
  const uint32_t q_wg = sQ + wg * 64 * 128, do_wg = sdO + wg * 64 * 128;
  // The rows' statistics; rows past T (below Tp) read lse2 = +inf, Di = 0.
  const size_t rows = (static_cast<size_t>(b) * H + h) * Tp;
  const float l0 = lse2[rows + row0], l1 = lse2[rows + row0 + 8];
  const float di0 = di[rows + row0], di1 = di[rows + row0 + 8];

  float acc[NO], sc[64], dp[64];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = dp[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % BW_STAGES;
    const uint32_t parity = (j / BW_STAGES) & 1;
    const uint32_t sK = base + TILE * (2 + 2 * s), sV = sK + TILE;

    // s = Q.K^T and dp = dO.V^T over DP / 16 slices of 16 columns.
    mbar_wait(kfull(s), parity);
    mbar_wait(vfull(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = kslice<DQ_ATOM>(kk);
      wgmma_ss_n128(sc, sw128_desc(q_wg + off, 16), sw128_desc(sK + off, 16), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = kslice<DQ_ATOM>(kk);
      wgmma_ss_n128(dp, sw128_desc(do_wg + off, 16), sw128_desc(sV + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);
    pin(dp);

    // ds = p * (dp - Di), p = 2^(s * scale * log2(e) - lse2), 0 where masked,
    // split at once into bf16 pairs hi + lo: pair r holds registers 2r and
    // 2r + 1, so slice kk (keys 16kk..16kk+15) is pairs 4kk..4kk+3.
    const int k0 = j * DQ_BN;
    const bool edge = k0 + DQ_BN > S || (causal && k0 + DQ_BN - 1 > q0 + 64 * wg);
    uint32_t dh[32], dl[32];
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      float ds[4];  // registers 4jj..4jj+3: rows row0 (e) and row0 + 8 (2 + e)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = exp2_approx(fmaf(sc[4 * jj + e], scale_log2, -l0));
        float p1 = exp2_approx(fmaf(sc[4 * jj + 2 + e], scale_log2, -l1));
        if (edge) {
          const int key = k0 + 8 * jj + col + e;
          if (key >= S || (causal && key > row0)) p0 = 0.f;
          if (key >= S || (causal && key > row0 + 8)) p1 = 0.f;
        }
        ds[e] = p0 * (dp[4 * jj + e] - di0);
        ds[2 + e] = p1 * (dp[4 * jj + 2 + e] - di1);
      }
      split_bf16(ds[0], ds[1], dh[2 * jj], dl[2 * jj]);
      split_bf16(ds[2], ds[3], dh[2 * jj + 1], dl[2 * jj + 1]);
    }

    // dQ += dS_hi.K + dS_lo.K over 8 slices of 16 keys; K's slice is 16 rows
    // of 128 bytes, MN-major.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_BN / 16; ++kk) {
      const uint64_t kd = sw128_desc(sK + kk * 2048, DQ_ATOM);
      wgmma_rs_d<DP>(acc, &dh[4 * kk], kd);
      wgmma_rs_d<DP>(acc, &dl[4 * kk], kd);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    pin(dh);
    pin(dl);
    if (tid % 128 == 0) mbar_arrive(kv_empty(s));  // this warpgroup is done with stage s
  }

  const size_t row_stride = static_cast<size_t>(H) * D;
  __nv_bfloat16* d0 = dq + (static_cast<size_t>(b) * T + row0) * row_stride + static_cast<size_t>(h) * D;
  __nv_bfloat16* d1 = d0 + 8 * row_stride;
#pragma unroll
  for (int jj = 0; jj < DP / 8; ++jj) {
    const int c = 8 * jj + col;
    if (c < D) {
      if (row0 < T)
        *reinterpret_cast<__nv_bfloat162*>(d0 + c) =
            __floats2bfloat162_rn(acc[4 * jj] * scale, acc[4 * jj + 1] * scale);
      if (row0 + 8 < T)
        *reinterpret_cast<__nv_bfloat162*>(d1 + c) =
            __floats2bfloat162_rn(acc[4 * jj + 2] * scale, acc[4 * jj + 3] * scale);
    }
  }
}

size_t dkdv_smem_bytes(int D) {
  const size_t na = D <= 64 ? 1 : 2;
  return 1024 + 2 * na * KV_ATOM_K + BW_STAGES * (2 * na * KV_ATOM_Q + 1024);  // + 1 KB to align
}

size_t dq_smem_bytes(int D) {
  const size_t na = D <= 64 ? 1 : 2;
  return 1024 + na * DQ_ATOM * (2 + 2 * BW_STAGES);
}

struct Maps {
  CUtensorMap q64, do64, q128, do128, k, v;
};

template <int DP>
int launch_bwd(const Maps& m, const float* lse2, const float* di, void* dq, void* dk, void* dv,
               int B, int T, int Tp, int S, int H, int KV, int D, float scale, int causal,
               cudaStream_t stream) {
  const size_t kv_smem = dkdv_smem_bytes(DP), q_smem = dq_smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * kLog2e;
  flash_bwd_dkdv_wgmma_kernel<DP><<<dim3(B * KV, (S + KV_BN - 1) / KV_BN), BW_THREADS, kv_smem,
                                    stream>>>(
      m.q64, m.do64, m.k, m.v, lse2, di, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), T, Tp, S, H, KV, D, scale, scale_log2, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_wgmma_kernel<DP><<<dim3(B * H, (T + DQ_BM - 1) / DQ_BM), BW_THREADS, q_smem,
                                  stream>>>(
      m.q128, m.do128, m.k, m.v, lse2, di, static_cast<__nv_bfloat16*>(dq), T, Tp, S, H, KV, D,
      scale, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int flash_attention_bwd_row_pad(void) { return BW_ROW_PAD; }

// bf16 q, o, dout and dq (B,T,H,D), k, v, dk and dv (B,S,KV,D), contiguous and
// 16-byte aligned, 8 <= D <= 128 with D % 8 == 0 and H a multiple of KV; f32
// lse (B,H,T), the forward's; f32 scratch di and lse2 of B*H*Tp floats each,
// Tp = T rounded up to flash_attention_bwd_row_pad(), 16-byte aligned.
// Launches the three kernels on `stream`; returns a cudaError_t (0 on success).
int flash_attention_bwd_wgmma_launch(const void* q, const void* k, const void* v, const void* o,
                                     const void* lse, const void* dout, void* dq, void* dk,
                                     void* dv, void* di, void* lse2, int B, int T, int S, int H,
                                     int KV, int D, float scale, int causal, void* stream) {
  if (B < 1 || T < 1 || S < 1 || H < 1 || KV < 1 || KV > H || H % KV != 0 || D < 8 ||
      D > BW_MAX_D || D % 8 != 0 || static_cast<long long>(B) * H > 2147483647LL ||
      (T + DQ_BM - 1) / DQ_BM > 65535 || (S + KV_BN - 1) / KV_BN > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                        reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
                        reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
                        reinterpret_cast<uintptr_t>(di) | reinterpret_cast<uintptr_t>(lse2) |
                        reinterpret_cast<uintptr_t>(lse);
  if (any % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  cudaError_t err = bind_context();
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps m;
  if (!make_map(enc, &m.q64, q, B, T, H, D, KV_BM) ||
      !make_map(enc, &m.do64, dout, B, T, H, D, KV_BM) ||
      !make_map(enc, &m.q128, q, B, T, H, D, DQ_BM) ||
      !make_map(enc, &m.do128, dout, B, T, H, D, DQ_BM) ||
      !make_map(enc, &m.k, k, B, S, KV, D, KV_BN) || !make_map(enc, &m.v, v, B, S, KV, D, KV_BN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Tp = (T + BW_ROW_PAD - 1) / BW_ROW_PAD * BW_ROW_PAD;
  const long long rows = static_cast<long long>(B) * H * Tp;
  float* dif = static_cast<float*>(di);
  float* l2 = static_cast<float*>(lse2);
  flash_bwd_dot_do_o_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), dif, l2, T, Tp, H, D, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (D <= 64) return launch_bwd<64>(m, l2, dif, dq, dk, dv, B, T, Tp, S, H, KV, D, scale, causal, st);
  return launch_bwd<128>(m, l2, dif, dq, dk, dv, B, T, Tp, S, H, KV, D, scale, causal, st);
}

}  // extern "C"
