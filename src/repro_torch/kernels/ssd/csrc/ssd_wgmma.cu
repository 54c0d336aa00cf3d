// Mamba-2 SSD intra-chunk (diagonal) term on Hopper's tensor cores.
//
// Replaces the TPU kernel `repro/kernels/ssd/ssd.py`: `ssd_diag_kernel_call`
// (Pallas body `_kernel`).  For x (BC,Q,H,P), dt and lA (BC,Q,H), B and C
// (BC,Q,G,N) with G dividing H (head h reads group h / (H/G)), all f32, per
// (batch*chunk, head) cell and query row i:
//
//   cs   = cumsum(lA) over the chunk, summed in f64, rounded once to f32
//   y[i] = sum_{j <= i} (C_i . B_j) * exp(cs_i - cs_j) * dt_j * x_j
//
// The (Q,Q) decay and scores never touch device memory, which is the point
// of the TPU kernel.  No shape is capped: Q, N and P are walked in tiles,
// and the only limit is the grid's (2^31 - 1 blocks).
//
// What bounds it on an H100: at the mamba2-370m forward's shape
// (BC,Q,H,P,N) = (128,256,32,64,128), G = 1, one call moves 0.578 GB (x, dt,
// lA read and y written once, B and C once per group): 0.173 ms at
// 3.35 TB/s.  The lower triangle's products are 51.7 GFLOP, 0.052 ms at the
// 989 TFLOP/s bf16 peak and 0.104 ms at the 495 TFLOP/s TF32 peak, so on the
// tensor cores it is bound by bytes.
//
// Precision.  The inputs are f32 and the op must stay right for any f32
// input, at rtol = atol = 1e-4 against the f32 plain version.  Each operand
// goes to the tensor cores as two TF32 terms, a_hi = tf32(a) and a_lo =
// tf32(a - a_hi), and a product as hi.hi + hi.lo + lo.hi in f32 (the lo.lo
// term is below 2^-21 of it): "3xTF32".  The bf16 split of the flash kernel
// (2^-17 a term) was emulated on the CPU first and breaks that tolerance by
// up to 8x on random f32 inputs, and by 1.6x even when x, B and C are bf16
// values, through the split of the weights alone; 3xTF32 stays under 0.17
// of it.  TF32 `wgmma` takes both operands K-major, and x (keys x P) is
// P-major in memory: it is transposed on its way into shared memory (below).
// When a tile's low parts are all zero (x, B and C are bf16 values cast to
// f32 in the model) the products with them are skipped: they add exact
// zeros, so the result is the same.
//
// Design:
//   * a pre-pass (`ssd_cumsum_kernel`, a thread per (cell, head), one add
//     after another in f64) writes cs for any Q to a scratch buffer the
//     wrapper allocates; a running f32 sum over a 256-step chunk strays by
//     up to 4.5e-5 and, through exp(cs_i - cs_j), moves an output of size 1
//     by up to 1e-3, so cs is rounded once from f64, as the plain version
//     rounds it;
//   * one warpgroup (128 threads) per (query tile of 64 rows, batch*chunk,
//     group, run of heads of that group), heavy (late) query tiles first,
//     two blocks an SM (82 KB of shared memory each);
//   * S = C.B^T depends on the group, not the head: a block computes it once
//     per key tile (`wgmma` m64n64k8, 3xTF32, N walked 32 columns at a
//     time) for up to 2 key tiles (128 keys), keeps it in shared memory in
//     the accumulator's own per-thread order, and reuses it for each of its
//     heads; longer chunks take several such spans, the output summed over
//     them in place (only this block writes those rows);
//   * per head and 64-column slice of P: W = S * exp(cs_i - cs_j) * dt_j on
//     and below the diagonal, 0 above it, computed on the accumulator
//     fragments in registers and split into TF32 pairs there; the S
//     accumulator's layout is the A-operand layout of the next `wgmma` once
//     the keys of each 8-key slice are taken in the order 0,2,4,6,1,3,5,7,
//     so x^T is written to shared memory in that order and W never leaves
//     the registers; y += W_hi.x_hi + W_lo.x_hi + W_hi.x_lo (m64n64k8, A from
//     registers);
//   * the tensor cores' f32 sums truncate (round toward zero) where f32
//     arithmetic rounds to nearest: on an H100, with the three products of
//     a step in one accumulator, an output at Q = 512, N = 192 strayed
//     beyond the tolerance above.  So the hi.hi products and the two small
//     corrections of S go to separate accumulators, fresh for each 32
//     columns, whose partial sums are added up in f32; a CPU emulation of
//     truncating sums puts the worst output at 0.3 of the tolerance that
//     way, against 1.5 with one accumulator.  y needs none of this: its
//     terms fall off with the decay, so its products share one accumulator
//     (the emulation gives the same worst output either way);
//   * loads: the next step's f32 tile (a 64 x 32 chunk each of C and B, or
//     64 keys x 64 columns of x) is copied by `cp.async` into a staging tile
//     while this step's products run, 16 bytes a thread where the rows are
//     16-byte aligned (N, P and the strides multiples of 4), else 4 bytes,
//     zeros past the edges; each step then splits it into the
//     128-byte-swizzled operand tiles, and transposes x on the way.  TMA
//     would copy the tiles as they are, and every operand still needs that
//     pass through the registers;
//   * key tiles above the diagonal are skipped (their decay is exactly 0);
//     B and C are read through strides, so a head-broadcast view or the
//     grouped (BC,Q,G,N) tensor is read as it is, never copied per head.
//
// Left for later: the inter-chunk states in the same pass, a producer
// warpgroup feeding two consumers, and the scores of a span kept in
// registers.

#include <cuda_runtime.h>
#include <stdint.h>

#define SW_BQ 64       // query rows of a block: one warpgroup's wgmma M
#define SW_BK 64       // keys of a tile
#define SW_NK 32       // columns of C and B a step: one 128-byte row of f32
#define SW_PT 64       // columns of P a pass
#define SW_SPAN 2      // key tiles whose scores stay in shared memory
#define SW_THREADS 128
#define SW_ATOM 8192   // bytes of 64 rows x 128 bytes: one swizzle atom column

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a rounded to TF32 (10 mantissa bits, to nearest, ties away), as f32 bits:
// what cvt.rna.tf32.f32 gives, in two integer operations (infinities and
// NaNs stay what they are).
__device__ __forceinline__ uint32_t to_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

// (hi, lo) TF32 bits of a: hi + lo holds a to about 2^-21.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

// Shared-memory matrix descriptor, K-major, 128-byte swizzle: start address,
// leading byte offset unused (16), stride byte offset 1024 (the next 8 rows
// of 128 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Byte offset of 16-byte group `grp` of row `row` in a 128-byte-swizzled
// tile whose base is 1024-byte aligned.
__device__ __forceinline__ uint32_t swz(int row, int grp) {
  return static_cast<uint32_t>(row * 128 + ((grp ^ (row & 7)) << 4));
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
// 4 bytes from global to shared memory, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
// 16 bytes from global to shared memory, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
__device__ __forceinline__ void pin(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Keeps A-operand registers live (unchanged) up to this point.
__device__ __forceinline__ void keep(const uint32_t (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" ::"r"(r[i]) : "memory");
}


// D(64 x 64) += A(64 x 8, shared, K-major) * B(8 x 64, shared, K-major), TF32.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// D(64 x 64) += A(64 x 8, registers) * B(8 x 64, shared, K-major), TF32.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The chunk's prefix sums of lA for every (cell, head): one add after
// another in f64, each partial sum rounded once to f32.
__global__ void ssd_cumsum_kernel(const float* __restrict__ lA, float* __restrict__ cs,
                                  long long cells, int Q, int H) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= cells * H) return;
  const long long bc = i / H;
  const int h = static_cast<int>(i - bc * H);
  const float* src = lA + bc * Q * H + h;
  float* dst = cs + bc * Q * H + h;
  double run = 0.0;
  for (int t = 0; t < Q; ++t) {
    run += static_cast<double>(src[static_cast<size_t>(t) * H]);
    dst[static_cast<size_t>(t) * H] = static_cast<float>(run);
  }
}

// Thread layout of the 64 x 64 accumulator: thread t (warp w = t / 32,
// lane, g = lane / 4, t4 = lane % 4) holds rows 16w + g and that + 8 and, in
// each 8-column block jj, columns 8jj + 2 t4 and the next: registers 4jj,
// 4jj + 1 (first row) and 4jj + 2, 4jj + 3 (second row).
//
// A step: wait for its staged f32 tile and for the operand tiles to be free
// (one barrier), split (and for x transpose) the tile into the operand
// tiles, barrier, start the copy of the next step's tile, run the products.
__global__ void __launch_bounds__(SW_THREADS, 2) ssd_diag_wgmma_kernel(
    const float* __restrict__ x,   // (BC, Q, H, P)
    const float* __restrict__ dt,  // (BC, Q, H)
    const float* __restrict__ cs,  // (BC, Q, H): the prefix sums of lA
    const float* __restrict__ B,   // (BC, Q, G, N), strides sb_*
    const float* __restrict__ C,   // (BC, Q, G, N), strides sc_*
    float* __restrict__ y,         // (BC, Q, H, P)
    int BC, int Q, int H, int G, int P, int N, int hc, long long sb_bc, long long sb_q,
    long long sb_g, long long sc_bc, long long sc_q, long long sc_g, int vec_x, int vec_cb,
    int vec_y) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's 1 KB period
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  // Operand tiles, 32 KB: C_hi, C_lo, B_hi, B_lo (one atom each) while S is
  // computed; x_hi, x_lo (two atoms each: 64 keys) while y is.  Then the
  // staging tile (16 KB of f32), the scores of a span, cs and dt.
  const uint32_t sOp = base;
  const uint32_t sStage = base + 4 * SW_ATOM;
  const float* const stage = reinterpret_cast<const float*>(gbase + 4 * SW_ATOM);
  float4* const sS = reinterpret_cast<float4*>(gbase + 6 * SW_ATOM);  // SW_SPAN x 8 x 128
  float* const sCSq = reinterpret_cast<float*>(gbase + 6 * SW_ATOM + SW_SPAN * 16384);
  float* const sCSk = sCSq + SW_BQ;            // SW_SPAN * SW_BK
  float* const sDTk = sCSk + SW_SPAN * SW_BK;  // SW_SPAN * SW_BK

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int rep = H / G;
  const int n_hc = (rep + hc - 1) / hc;
  const int n_qt = (Q + SW_BQ - 1) / SW_BQ;
  const long long cells = static_cast<long long>(BC) * G * n_hc;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / cells);  // late tiles first
  long long cell = blockIdx.x % cells;
  const int hci = static_cast<int>(cell % n_hc);
  cell /= n_hc;
  const int grp = static_cast<int>(cell % G);
  const long long bc = cell / G;
  const int h_first = grp * rep + hci * hc;
  const int n_heads = min(hc, rep - hci * hc);
  const int q0 = qt * SW_BQ;
  const int n_nk = (N + SW_NK - 1) / SW_NK;
  const int n_pt = (P + SW_PT - 1) / SW_PT;

  const float* Bg = B + bc * sb_bc + grp * sb_g;
  const float* Cg = C + bc * sc_bc + grp * sc_g;
  const size_t row_h = static_cast<size_t>(H);      // stride between positions of dt, cs
  const size_t row_x = static_cast<size_t>(H) * P;  // ... of x and y
  const float* dtb = dt + bc * Q * row_h;
  const float* csb = cs + bc * Q * row_h;
  const float* xb = x + bc * Q * row_x;
  float* yb = y + bc * Q * row_x;

  // This thread's fragment rows (0..63 in the tile) and columns of block 0.
  const int fr0 = 16 * warp + g8;
  const int fc0 = 2 * t4;
  // Its rows of a C or B chunk (warp + 4i, column lane) and its column of x
  // (p = prow) with keys 2i + e_par (staging) or 8m + e_par + 2j (operand).
  const int e_par = warp >> 1, prow = 32 * (warp & 1) + lane;

  for (int t_lo = 0; t_lo <= qt; t_lo += SW_SPAN) {
    const int t_hi = min(qt + 1, t_lo + SW_SPAN);
    const int k_lo = t_lo * SW_BK;

    // ------------------------------------------------ S = C.B^T per key tile
    // Step s: key tile t_lo + s / n_nk, state columns 32 (s % n_nk) onward;
    // staged as C (64 x 32) then B (64 x 32).
    const int s_steps = (t_hi - t_lo) * n_nk;
    auto stage_cb = [&](int s) {
      const int k0 = (t_lo + s / n_nk) * SW_BK;
      const int n0 = (s % n_nk) * SW_NK;
      if (vec_cb) {  // 16 bytes a thread: rows f / 8, columns 4 (f % 8) onward
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int f = tid + SW_THREADS * i, r = f / 8, n = n0 + 4 * (f % 8);
          const uint32_t dst = sStage + 4 * (r * SW_NK + 4 * (f % 8));
          const bool cok = q0 + r < Q && n < N, bok = k0 + r < Q && n < N;
          cp_async16(dst, cok ? Cg + (q0 + r) * sc_q + n : Cg, cok);
          cp_async16(dst + 4 * SW_BQ * SW_NK, bok ? Bg + (k0 + r) * sb_q + n : Bg, bok);
        }
      } else {  // 4 bytes a thread: rows warp + 4i, column lane
        const int n = n0 + lane;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int r = warp + 4 * i;
          const uint32_t dst = sStage + 4 * (r * SW_NK + lane);
          const bool cok = q0 + r < Q && n < N, bok = k0 + r < Q && n < N;
          cp_async4(dst, cok ? Cg + (q0 + r) * sc_q + n : Cg, cok);
          cp_async4(dst + 4 * SW_BQ * SW_NK, bok ? Bg + (k0 + r) * sb_q + n : Bg, bok);
        }
      }
      cp_async_commit();
    };
    stage_cb(0);
    float ssum[32], acc[32], accc[32];
    for (int s = 0; s < s_steps; ++s) {
      const int nk = s % n_nk;
      cp_async_wait_all();
      __syncthreads();  // the staged chunk is in; the operand tiles are free
      int lo_c = 0, lo_b = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = warp + 4 * i;
        const uint32_t off = swz(r, lane >> 2) + 4 * (lane & 3);
        uint32_t hi, lo;
        split_tf32(stage[r * SW_NK + lane], hi, lo);
        *reinterpret_cast<uint32_t*>(gbase + off) = hi;
        *reinterpret_cast<uint32_t*>(gbase + SW_ATOM + off) = lo;
        lo_c |= lo != 0u;
        split_tf32(stage[SW_BQ * SW_NK + r * SW_NK + lane], hi, lo);
        *reinterpret_cast<uint32_t*>(gbase + 2 * SW_ATOM + off) = hi;
        *reinterpret_cast<uint32_t*>(gbase + 3 * SW_ATOM + off) = lo;
        lo_b |= lo != 0u;
      }
      fence_async_smem();
      lo_c = __syncthreads_or(lo_c);  // the operand tiles are in; the staging tile is free
      lo_b = __syncthreads_or(lo_b);
      if (s + 1 < s_steps) stage_cb(s + 1);  // the next chunk's copy overlaps the products

      // Tensor-core sums truncate, so the hi.hi products and the small
      // corrections go to separate accumulators, each chunk's added to the
      // running scores in f32 (round to nearest).
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = accc[i] = 0.f;
      pin(acc);
      pin(accc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t ch = sw128_desc(sOp + 32 * kk), cl = sw128_desc(sOp + SW_ATOM + 32 * kk);
        const uint64_t bh = sw128_desc(sOp + 2 * SW_ATOM + 32 * kk);
        const uint64_t bl = sw128_desc(sOp + 3 * SW_ATOM + 32 * kk);
        wgmma_ss(acc, ch, bh);
        if (lo_b) wgmma_ss(accc, ch, bl);
        if (lo_c) wgmma_ss(accc, cl, bh);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      pin(accc);
#pragma unroll
      for (int i = 0; i < 32; ++i) ssum[i] = (nk == 0 ? 0.f : ssum[i]) + (acc[i] + accc[i]);
      if (nk == n_nk - 1) {  // this key tile's scores, in this thread's own slots
        float4* dst = sS + (s / n_nk) * 8 * SW_THREADS + tid;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          dst[i * SW_THREADS] =
              make_float4(ssum[4 * i], ssum[4 * i + 1], ssum[4 * i + 2], ssum[4 * i + 3]);
      }
    }

    // ------------------------------------------------ y += W.x per head, P slice
    // Step s: head s / (n_pt * nt), P slice (s / nt) % n_pt, key tile s % nt.
    // The staged x tile is [key][p] (64 x 64); in the operand tile x^T the
    // keys of each 8-key slice run 0,2,4,6,1,3,5,7, so that thread (warp,
    // lane) stores keys 8m + e_par + 2j (j < 4) of its p as one 16-byte
    // group, 2(m % 4) + e_par of atom m / 4.
    const int nt = t_hi - t_lo;
    const int y_steps = n_heads * n_pt * nt;
    // The next head's cs (query rows, then the span's keys) and dt (keys),
    // a few values a thread.
    constexpr int kCS = SW_BQ + SW_SPAN * SW_BK, kDT = SW_SPAN * SW_BK;
    constexpr int nCS = (kCS + SW_THREADS - 1) / SW_THREADS;
    constexpr int nDT = (kDT + SW_THREADS - 1) / SW_THREADS;
    float pre_cs[nCS], pre_dt[nDT];
    auto stage_x = [&](int s) {
      const int h = h_first + s / (n_pt * nt);
      const int p = ((s / nt) % n_pt) * SW_PT + prow;
      const int k0 = (t_lo + s % nt) * SW_BK;
      const float* xh = xb + static_cast<size_t>(h) * P;
      if (vec_x) {  // 16 bytes a thread: keys f / 16, columns 4 (f % 16) onward
        const int p0 = p - prow;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int f = tid + SW_THREADS * i, kl = f / 16, pc = 4 * (f % 16);
          const bool ok = k0 + kl < Q && p0 + pc < P;
          cp_async16(sStage + 4 * (kl * SW_PT + pc), ok ? xh + (k0 + kl) * row_x + p0 + pc : xb, ok);
        }
      } else {  // 4 bytes a thread: keys 2i + e_par, column prow
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int kl = 2 * i + e_par;
          const bool ok = k0 + kl < Q && p < P;
          cp_async4(sStage + 4 * (kl * SW_PT + prow), ok ? xh + (k0 + kl) * row_x + p : xb, ok);
        }
      }
      cp_async_commit();
      if (s % (n_pt * nt) == 0) {  // a new head: cs at the query rows and span keys, dt at the keys
#pragma unroll
        for (int i = 0; i < nCS; ++i) {
          const int v = tid + SW_THREADS * i;  // query rows, then keys
          const int pos = v < SW_BQ ? q0 + v : k_lo + v - SW_BQ;
          pre_cs[i] = (v < kCS && pos < Q) ? csb[pos * row_h + h] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < nDT; ++i) {
          const int v = tid + SW_THREADS * i, kpos = k_lo + v;
          pre_dt[i] = (v < kDT && kpos < Q) ? dtb[kpos * row_h + h] : 0.f;
        }
      }
    };
    stage_x(0);
    float yacc[32];
    for (int s = 0; s < y_steps; ++s) {
      const int h = h_first + s / (n_pt * nt);
      const int p0 = ((s / nt) % n_pt) * SW_PT;
      const int tl = s % nt;
      const int k0 = (t_lo + tl) * SW_BK;
      cp_async_wait_all();
      __syncthreads();  // the staged tile is in; the operand tiles, cs and dt are free
      if (s % (n_pt * nt) == 0) {
#pragma unroll
        for (int i = 0; i < nCS; ++i) {
          const int v = tid + SW_THREADS * i;
          if (v < kCS) sCSq[v] = pre_cs[i];  // sCSk follows sCSq
        }
#pragma unroll
        for (int i = 0; i < nDT; ++i) {
          const int v = tid + SW_THREADS * i;
          if (v < kDT) sDTk[v] = pre_dt[i];
        }
      }
      if (tl == 0) {  // a new (head, P slice): its output so far
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int qi = q0 + fr0 + 8 * ((r >> 1) & 1);
          const int p = p0 + 8 * (r >> 2) + fc0 + (r & 1);
          yacc[r] = (t_lo > 0 && qi < Q && p < P)
                        ? yb[qi * row_x + static_cast<size_t>(h) * P + p] : 0.f;
        }
      }
      int lo_x = 0;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          split_tf32(stage[(8 * m + e_par + 2 * j) * SW_PT + prow], hi[j], lo[j]);
          lo_x |= lo[j] != 0u;
        }
        const uint32_t off = (m / 4) * SW_ATOM + swz(prow, 2 * (m % 4) + e_par);
        *reinterpret_cast<uint4*>(gbase + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(gbase + 2 * SW_ATOM + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      fence_async_smem();
      lo_x = __syncthreads_or(lo_x);  // operands, cs and dt in; the staging tile free
      if (s + 1 < y_steps) stage_x(s + 1);

      // W on this thread's fragment, split into A operands: slice kk takes
      // registers 4kk, 4kk + 2, 4kk + 1, 4kk + 3 (keys 2 t4 and 2 t4 + 1 of
      // rows g and g + 8).  The second half's (keys 32-63) is computed while
      // the first half's products run.
      uint32_t whi[32], wlo[32];
      const float4* src = sS + tl * 8 * SW_THREADS + tid;
      // Below the diagonal, with all 64 rows in the chunk, nothing is masked.
      const bool edge = k0 + SW_BK > q0 || q0 + SW_BQ > Q;
      const float csq[2] = {sCSq[fr0], sCSq[fr0 + 8]};
      const float* csk = sCSk + (k0 - k_lo) + fc0;
      const float* dtk = sDTk + (k0 - k_lo) + fc0;
      auto weights = [&](int half) {
#pragma unroll
        for (int i = 4 * half; i < 4 * half + 4; ++i) {
          const float4 sv = src[i * SW_THREADS];
          const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kl = 8 * i + (e & 1);  // key within the tile, less fc0
            float w = sr[e] * expf(csq[e >> 1] - csk[kl]) * dtk[kl];
            if (edge) {
              const int qi = q0 + fr0 + 8 * (e >> 1), kj = k0 + fc0 + kl;
              w = (kj <= qi && qi < Q) ? w : 0.f;  // above the diagonal exp may overflow
            }
            const int slot = 4 * i + ((e & 1) << 1) + (e >> 1);  // 0, 2, 1, 3
            split_tf32(w, whi[slot], wlo[slot]);
          }
        }
#pragma unroll
        for (int i = 16 * half; i < 16 * half + 16; ++i) {  // final before the fence
          asm volatile("" : "+r"(whi[i]), "+r"(wlo[i])::"memory");
        }
      };
      weights(0);
      pin(yacc);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (half == 1) weights(1);
        wgmma_fence();
#pragma unroll
        for (int kk = 4 * half; kk < 4 * half + 4; ++kk) {
          const uint32_t off = (kk / 4) * SW_ATOM + 32 * (kk % 4);
          const uint64_t xh = sw128_desc(sOp + off), xl = sw128_desc(sOp + 2 * SW_ATOM + off);
          wgmma_rs(yacc, &whi[4 * kk], xh);
          wgmma_rs(yacc, &wlo[4 * kk], xh);
          if (lo_x) wgmma_rs(yacc, &whi[4 * kk], xl);
        }
        wgmma_commit();
      }
      wgmma_wait_all();
      pin(yacc);
      keep(whi);  // the products read them until the wait
      keep(wlo);
      if (tl == nt - 1) {  // the (head, P slice) is done: its two rows, a pair of columns at a time
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int qi = q0 + fr0 + 8 * half;
          if (qi >= Q) continue;
          float* yr = yb + qi * row_x + static_cast<size_t>(h) * P + p0 + fc0;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int p = p0 + fc0 + 8 * jj;
            const float a = yacc[4 * jj + 2 * half], b = yacc[4 * jj + 2 * half + 1];
            if (vec_y && p + 1 < P) {
              *reinterpret_cast<float2*>(yr + 8 * jj) = make_float2(a, b);
            } else {
              if (p < P) yr[8 * jj] = a;
              if (p + 1 < P) yr[8 * jj + 1] = b;
            }
          }
        }
      }
    }
    __syncthreads();  // the next span's first step overwrites the scores
  }
}

constexpr size_t kSmemBytes =
    1024 + 6 * SW_ATOM + SW_SPAN * 16384 + sizeof(float) * (SW_BQ + 2 * SW_SPAN * SW_BK);

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// Heads a block takes: all of its group's while that leaves at least two
// blocks an SM, halved until it does (each halving computes S twice as often).
int heads_per_block(int BC, int Q, int H, int G) {
  const int rep = H / G;
  const long long tiles = static_cast<long long>((Q + SW_BQ - 1) / SW_BQ) * BC * G;
  int hc = rep;
  while (hc > 1 && tiles * ((rep + hc - 1) / hc) < 2LL * num_sms()) hc = (hc + 1) / 2;
  return hc;
}

}  // namespace

extern "C" {

int ssd_diag_block(void) { return SW_BQ; }
// Dynamic shared memory of one block (any shape).
int ssd_diag_smem_bytes(void) { return static_cast<int>(kSmemBytes); }

const char* ssd_diag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, dt, lA and y contiguous; B and C (BC, Q, G, N) with element strides over
// (BC, Q, G) and unit stride over N; cs a (BC, Q, H) f32 scratch buffer.
// Launches the prefix-sum pass and the kernel on `stream`; returns a
// cudaError_t (0 on success).
int ssd_diag_launch(const void* x, const void* dt, const void* lA, const void* B,
                    const void* C, void* y, void* cs, int BC, int Q, int H, int G, int P,
                    int N, long long sb_bc, long long sb_q, long long sb_g, long long sc_bc,
                    long long sc_q, long long sc_g, void* stream) {
  if (BC < 1 || Q < 1 || H < 1 || G < 1 || H % G != 0 || P < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hc = heads_per_block(BC, Q, H, G);
  const long long blocks = static_cast<long long>((Q + SW_BQ - 1) / SW_BQ) * BC * G *
                           ((H / G + hc - 1) / hc);
  const long long pre = (static_cast<long long>(BC) * H + 127) / 128;
  if (blocks > 2147483647LL || pre > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ssd_cumsum_kernel<<<static_cast<unsigned>(pre), 128, 0, st>>>(
      static_cast<const float*>(lA), static_cast<float*>(cs), BC, Q, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_diag_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies where every row of a tile starts 16-byte aligned.
  auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec_x = a16(x) && P % 4 == 0;
  const int vec_y = reinterpret_cast<uintptr_t>(y) % 8 == 0 && P % 2 == 0;  // 8-byte pairs of y
  const int vec_cb = a16(B) && a16(C) && N % 4 == 0 &&
                     (sb_bc | sb_q | sb_g | sc_bc | sc_q | sc_g) % 4 == 0;
  ssd_diag_wgmma_kernel<<<static_cast<unsigned>(blocks), SW_THREADS, kSmemBytes, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(cs),
      static_cast<const float*>(B), static_cast<const float*>(C), static_cast<float*>(y), BC, Q,
      H, G, P, N, hc, sb_bc, sb_q, sb_g, sc_bc, sc_q, sc_g, vec_x, vec_cb, vec_y);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
