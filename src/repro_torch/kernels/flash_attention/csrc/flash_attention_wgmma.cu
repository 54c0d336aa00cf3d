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

#include <cuda.h>  // CUtensorMap and its enums: types only, no libcuda at link time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of `bar` with this parity to complete.  A load that
// never lands (a fault in a tensor map) traps after about 10 s rather than
// leaving the card spinning.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// One box of `map` at coordinates (d, head, pos, batch) into shared memory
// at `dst`, completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d, int head, int pos, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(head), "r"(pos), "r"(batch)
      : "memory");
}

// A 128-row tile of DP columns: NA boxes of 64 columns, one atom each.
template <int NA>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int head, int pos, int batch) {
  mbar_expect_tx(bar, NA * TC_ATOM);
#pragma unroll
  for (int a = 0; a < NA; ++a) tma_load(dst + a * TC_ATOM, map, bar, 64 * a, head, pos, batch);
}

// Shared-memory matrix descriptor for `wgmma`, 128-byte swizzle: start
// address, leading byte offset (K-major: unused; MN-major: the next 64
// columns), stride byte offset 1024 (the next 8 rows of 128 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// (a, b) as two bf16 pairs hi + lo: hi rounds them, lo rounds what hi
// leaves out (exact in f32), so hi + lo holds each to about 16 bits.  The
// low half of a pair is the first (lower-column) value.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 2^x by the special-function unit (relative error about 2^-22); results
// below 2^-126 flush to 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// D(64 x 128) (+)= A(64 x 16, shared, K-major) * B(16 x 128, shared, K-major);
// ``accumulate`` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D(64 x 64) += A(64 x 16, registers) * B(16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D(64 x 128) += A(64 x 16, registers) * B(16 x 128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&acc)[DP / 2], const uint32_t* a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&acc)[32], const uint32_t* a, uint64_t b) {
  wgmma_rs_n64(acc, a, b);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&acc)[64], const uint32_t* a, uint64_t b) {
  wgmma_rs_n128(acc, a, b);
}

// DP: the head dim the tiles hold (64 or 128); D <= DP is the real one.
// Thread layout of a warpgroup's 64 x N accumulator: thread t (warp w =
// t / 32, lane) holds rows 16w + lane/4 and that + 8, and in each 8-column
// block jj the columns 8jj + 2(lane % 4) and the next: registers 4jj, 4jj+1
// (first row) and 4jj+2, 4jj+3 (second row).
template <int DP>
__global__ void __launch_bounds__(TC_THREADS, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, int T, int S,
    int H, int KV, int D, float scale_log2, int causal) {
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
      wgmma_pv<DP>(acc, &ph[4 * kk], vd);
      wgmma_pv<DP>(acc, &pl[4 * kk], vd);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    if (tid % 128 == 0) mbar_arrive(kv_empty(s));  // this warpgroup is done with stage s
  }

  const float d0 = fmaxf(quad_sum(l0), 1e-30f), d1 = fmaxf(quad_sum(l1), 1e-30f);
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

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, len, heads, D) bf16, contiguous, as a 4-D map (D, heads, len, B) read
// in boxes of 64 columns x 1 head x 128 positions, 128-byte swizzled; reads
// past D or len give zeros.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int len, int heads,
              int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)len, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)len * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, TC_BQ, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

size_t wgmma_smem_bytes(int D) {
  const int na = D <= 64 ? 1 : 2;
  return 1024 + static_cast<size_t>(na) * TC_ATOM * (1 + 2 * TC_STAGES);  // + 1 KB to align
}

template <int DP>
int launch_wgmma(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, void* o,
                 int B, int T, int S, int H, int KV, int D, float scale, int causal,
                 cudaStream_t stream) {
  const size_t smem = wgmma_smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (T + TC_BQ - 1) / TC_BQ);
  flash_fwd_wgmma_kernel<DP><<<grid, TC_THREADS, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), T, S, H, KV, D, scale * kLog2e, causal);
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
// 16-byte aligned, 8 <= D <= 128 with D % 8 == 0.  Launches on `stream`;
// returns a cudaError_t (0 on success).
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* o, int B,
                                 int T, int S, int H, int KV, int D, float scale, int causal,
                                 void* stream) {
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
  CUtensorMap qm, km, vm;
  if (!make_map(enc, &qm, q, B, T, H, D) || !make_map(enc, &km, k, B, S, KV, D) ||
      !make_map(enc, &vm, v, B, S, KV, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch_wgmma<64>(qm, km, vm, o, B, T, S, H, KV, D, scale, causal, st);
  return launch_wgmma<128>(qm, km, vm, o, B, T, S, H, KV, D, scale, causal, st);
}

}  // extern "C"
