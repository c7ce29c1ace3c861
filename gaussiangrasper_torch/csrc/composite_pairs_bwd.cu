// Backward of the per-tile compositing, for Hopper (sm_90a).
//
// Replaces three kernels of the JAX package's rasterize_pallas.py, with one per-tile body:
//   K2 _bwd_pairs_kernel (launched by _call_bwd_pairs from _composite_pairs_bwd): one tile per
//      kernel instance, rows from the depth-sorted pair stream;
//   K6 _bwd_pairs2_kernel (launched by _call_bwd_pairs2 under GGT_TP=2): tiles 2j and 2j + 1 per
//      kernel instance;
//   K4 _bwd_kernel (launched by _call_bwd from _composite_n_bwd, the table path): one tile per
//      kernel instance, rows from the packed (T, K, 6 + C) table, gradients into a (T, K, 6 + C)
//      table (see "The table path" below).
// Inputs of K2: the stream (pair_gidx, starts, counts),
// the attribute table (N, 6 + C) (xy | conic a, b, c | opacity | colour), bg (C,), the upstream
// g_out (T, P, C) and g_alpha (T, P), and K1's saved logt and ncomp (T, P). Output: gpairs
// (B, 6 + C), per stream row dxy(2), dconic(3), dopacity(1), dcolour(C), each summed over the
// tile's pixels; the wrapper zero-fills it, so rows no tile walks stay zero. The per-Gaussian sum
// (index_add_ by pair_gidx) and the bg gradient (sum_p exp(logt) g_out) run outside, as JAX runs
// them outside Pallas.
//
// Per pixel the walk runs back to front over rows k < min(ncomp, count): K1's cut index is the
// composite mask, and K1 rounds an uncut ncomp up to its 128-row chunk, so the count bounds it
// too. With suffix_comp the running sum of log(1 - alpha) over the composited rows behind k and
// suffix_wgc the running sum of w_j <c_j, g>:
//   t_before = exp(logt - (suffix_comp + log1p(-alpha)))        (the log form of JAX :708-710)
//   w = alpha t_before,  gc = <c_k, g_out[p]>
//   dalpha = t_before gc - (suffix_wgc + T_final (<bg, g> - g_alpha)) / max(1 - alpha, 1e-6)
// zeroed unless w > 0 and o exp(-sigma) < 0.999; then dsigma = -o exp(-sigma) dalpha,
// dopacity = exp(-sigma) dalpha and the conic / centre chain of the module docstring in
// ops/rasterize_cuda.py. A row whose sigma < 0 or alpha < 1/255 adds nothing (alpha 0 there).
//
// What bounded the first design on this card (one CTA of 1024 threads a tile, warps on 32 x 1
// pixel rows, 128-row batches): the 39-wide terms on the SM's shared-memory and shuffle pipe.
// For each row a warp with a contributing lane read the 39-wide <c_k, g> from shared memory (78
// loads), rebuilt the 6 + C row values from the staged g_out (39 more) and reduced them by three
// 16-wide shuffle reduce-scatters with three shared atomics: ~177 shared-memory or shuffle
// instructions a live warp-row. The TPU kernel computes the same two 39-wide terms as matrix
// products (gc = col . g_out^T at rasterize_pallas.py:689, dcolour = w . g_out at :734); here
// they go to the tensor cores.
//
// Design. Two CTAs a tile, each one half of its pixels (ts 32 -> 512 threads, one a pixel), two
// CTAs an SM (64 registers a thread, 109 KB of shared memory a CTA at C = 39). A warp covers an
// 8 x 4 pixel block (tile_pixel), so a splat's footprint meets fewer warps than with pixel rows.
// The CTA stages its half of g_out channel-major in thread order (C x (512 + 8) floats; the
// stride puts a fragment's 32 loads on 32 banks). The walk covers rows [0, kmax), kmax the
// CTA's largest min(ncomp, count), in batches of kBatch = 32 rows from the last down, gathered
// into shared memory through the row source, with a 32 x (6 + C) accumulator for the row sums.
// Within a batch each warp works alone on sub-chunks of kSub = 8 rows, from the last down,
// skipping those below which none of its 32 pixels walks:
//   1. the validity tests (sigma >= 0, alpha >= 1/255, in K1's explicitly rounded operations, so
//      they decide as the plain version does); a lane keeps exp(-sigma) of each live row in a
//      register, and a sub-chunk with no live lane in the warp ends here;
//   2. gc = <c_row, g_out[p]> for the warp's 32 pixels x 8 rows by mma.sync m16n8k8 (M pixels, N
//      rows, K channels padded to 8), operands from shared memory; the fragments hold other
//      lanes' pixels, so they pass through a per-warp 8 x 32 buffer (row stride 36: no bank
//      conflicts on the store, the lane's read or the next product's loads);
//   3. the reverse walk on the CUDA cores, one thread per pixel: alpha, t_before in log form,
//      dalpha, the two suffix carries and the conic chain, reading gc from the buffer and
//      writing w in its place; the 6 geometric and opacity values of a row with a live lane go
//      across the warp by one 8-wide reduce-scatter (9 shuffles) and one shared atomic
//      instruction;
//   4. dcolour = w . g_out for the 8 rows by mma.sync (M channels in 16-channel tiles, N rows, K
//      the warp's 32 pixels), added to the batch's sums with shared atomics (the warps of the
//      CTA sum into the same rows). No per-row shuffle of the C colour values remains.
// Each batch's sums are then added to the output rows with global float reductions (the two
// halves add into the same rows: a + b on a zeroed output, so their order does not change the
// result). Shared float atomics (compare-and-swap loops on this card, ATOMS.CAST.SPIN) make the
// order of the pixel sums vary from run to run, so the kernel agrees with the plain version to
// rounding, not bit for bit.
//
// Precision. A single-pass TF32 product rounds each operand to 10 mantissa bits (relative error
// ~4.9e-4 an element), too coarse for the 1e-4 criterion on the per-Gaussian sums. Both products
// run in 3xTF32: x = hi + lo with hi = tf32(x) (cvt.rna: to nearest, ties away) and lo = x - hi,
// which the tensor core reads as TF32 by dropping its 13 low bits, and lo hi + hi lo + hi hi
// accumulate in f32 (lo lo dropped): ~21 mantissa bits, f32-grade. tests/test_torch_rasterize.py
// emulates the schemes in the plain version against the JAX kernel on the CPU (C 39, two scenes):
// 3xTF32 stays within 6e-6 of each column group's max, while one pass (hi hi) misses 1e-4 by
// 2.5-12x in every group and two passes (lo hi + hi hi) by 1.3-6x, so the card's check would
// catch a kernel that took either.
//
// The table path (K4). grad_tile takes its rows from a row source (tile_rows.cuh): K2 / K6 gather
// each batch through pair_gidx and add its row sums to the batch's stream rows; K4 copies rows
// [t K + base, ...) of the packed table and adds its sums to the same rows of gattr (T, K,
// 6 + C), which the wrapper zero-fills and scatter-adds by tile_gidx. The TPU kernel runs two
// forward passes (total_blend, then the gradients with suffix = total - prefix); K4 keeps K2's
// single reverse walk from min(ncomp, count) - 1 on K3's ncomp. Rows past a pixel's cut or past
// the count add zero in both, so the two compute the same gattr to rounding.
//
// Two tiles per instance (K6). A grid of 4 ceil(T/2) CTAs in four-CTA clusters, cluster j
// holding tiles 2j and 2j + 1, two CTAs each (cluster_ctarank r: tile 2j + r / 2, half r % 2);
// the phantom CTAs of an odd T return before any barrier; all three kernels call the one body
// (grad_tile), so the gradient math exists once. The launcher sets the dynamic shared memory and
// the carveout, and the wrapper raises when cudaOccupancyMaxActiveClusters says no cluster fits.
// The JAX kernel flushes a kr-row gradient window that may overrun into the next tile's segment,
// so it must flush tile 2j before tile 2j + 1 on a sequential grid (_bwd_pairs2_kernel's
// docstring). Here each CTA adds only into rows [start, start + count) of its own tile's segment
// (the rows it walked), the segments do not overlap, and CTAs may run in any order: the
// flush-ordering argument has no counterpart.
//
// Bound on this card (H100 SXM: 67 TFLOP/s f32 outside the tensor cores, 495 TFLOP/s dense TF32
// on them, so 165 for an f32-grade 3xTF32 product; 3.35 TB/s): each walked pair-pixel visit
// costs ~16 operations for sigma and alpha; each contributing visit adds ~40 on the CUDA cores
// (log1p, two expf, dalpha, the conic chain, the 6 pixel sums) and the 2C flops of each of the two
// products on the tensor cores. chip_smoke.py computes the bound from the run's own visit
// counts, the two units' times added: 0.385 ms at its full-width k2 inputs (16.2 GFLOP + 23.7
// GFLOP of products), bound by operations. Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3
// at 700.00 W: K2 6.9-7.2 ms, ~18x the bound, where the first design took 17.3-17.5 ms (45x);
// K4 within 4% of K2; K6 10-13% above it (62 four-CTA clusters fit the card). The warps walk 20.3 M
// warp x row pairs there, 6.6 M of them live (10.1 M with the first design's 32 x 1 warps):
// ~275 SM clocks a live warp-row at the 1980 MHz maximum, ~450 for the first design. Timed
// source variants put about half of K2's time in the products' operand loads and TF32 splits,
// and ~12% in the shared atomics (PERF.md). ptxas: 64 registers, no spills at C = 39 (K2, K4,
// K6), 60-61 at C = 3.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_rows.cuh"

namespace {

constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaCutoff = (float)(1.0 / 255.0);
constexpr int kBatch = 32;      // rows staged in shared memory per batch (a multiple of kSub)
constexpr int kSub = 8;         // rows per sub-chunk: the n of the m16n8k8 products
constexpr int kBufStride = 36;  // row stride of a warp's kSub x 32 buffer: no bank conflicts
constexpr unsigned kFull = 0xffffffffu;

// Sums 8 values over the warp's 32 lanes and leaves the sum of value `lane & 7` in the lane:
// recursive halving (each level a lane keeps one half of its values and trades the other with
// its partner; 7 shuffles), then the four 8-lane groups combined (2 more).
__device__ __forceinline__ float reduce_scatter8(float (&x)[8], int lane) {
#pragma unroll
  for (int o = 4; o >= 1; o >>= 1) {
    const bool hi = lane & o;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float send = hi ? x[i] : x[i + o];
      const float keep = hi ? x[i + o] : x[i];
      x[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  const float s = x[0] + __shfl_xor_sync(kFull, x[0], 8);
  return s + __shfl_xor_sync(kFull, s, 16);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a b on the tensor cores: m16n8k8, TF32 operands, f32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: each f32 operand x = hi + lo, hi = tf32(x) and lo = x - hi (exact in f32;
// the tensor core reads it as TF32 by dropping its 13 low bits), and lo hi + hi lo + hi hi (lo lo
// dropped) carry ~21 mantissa bits, f32-grade.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const float (&a)[4],
                                           const float (&b)[2]) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = to_tf32(a[i]);
    al[i] = __float_as_uint(a[i] - __uint_as_float(ah[i]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bh[i] = to_tf32(b[i]);
    bl[i] = __float_as_uint(b[i] - __uint_as_float(bh[i]));
  }
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// The tile pixel of thread lin: warp w covers the 8 x 4 pixel block w of the tile (blocks in
// row-major order), lane l its pixel (l % 8, l / 8); ts is a multiple of 8.
__device__ __forceinline__ int tile_pixel(int lin, int ts) {
  const int w = lin >> 5, l = lin & 31, bw = ts >> 3;
  return ((w / bw) * 4 + (l >> 3)) * ts + (w % bw) * 8 + (l & 7);
}

// The thread of tile pixel p: tile_pixel's inverse.
__device__ __forceinline__ int pixel_thread(int p, int ts) {
  const int x = p % ts, y = p / ts;
  return (((y >> 2) * (ts >> 3) + (x >> 3)) << 5) + ((y & 3) << 3) + (x & 7);
}

// Dynamic shared memory of the body for a CTA of p pixels: g_out (C x (p + 8)), the batch's rows
// and their sums (2 x kBatch x (6 + C)), one kSub x kBufStride buffer a warp, the batch's indices.
template <int C>
size_t smem_bytes(int p) {
  return sizeof(float) * ((size_t)C * (p + 8) + 2 * (size_t)kBatch * (6 + C) +
                          (size_t)(p / 32) * kSub * kBufStride) +
         sizeof(int32_t) * kBatch;
}

// The per-tile backward of half `half` of tile t's pixels, run by one CTA (one thread per pixel),
// over the rows that `rows` (PairRows or TableRows) gives; the half's row sums are added to the
// same positions of grows, where the other half's CTA adds its own.
template <int C, class Rows>
__device__ __forceinline__ void grad_tile(
    int t, int half, const Rows& rows, const int32_t* __restrict__ counts,
    const float* __restrict__ bg, const float* __restrict__ g_out,
    const float* __restrict__ g_alpha, const float* __restrict__ logt,
    const float* __restrict__ ncomp, int tw, int ts, float* __restrict__ grows) {
  constexpr int A = 6 + C;
  constexpr int CK = (C + 7) / 8 * 8;  // channels padded to the k of <c, g>
  constexpr int CM = (C + 15) / 16;    // 16-channel m tiles of dcolour
  extern __shared__ float smem[];
  __shared__ int s_kmax;
  const int Pc = blockDim.x;  // this CTA's pixels, half of the tile's
  const int P = 2 * Pc;
  const int GS = Pc + 8;  // channel stride of the staged g_out: fragment loads hit 32 banks
  const int lin = threadIdx.x;
  const int lane = lin & 31;
  const int warp = lin >> 5;
  float* s_g = smem;                     // C x GS
  float* s_attr = s_g + C * GS;          // kBatch x A
  float* s_acc = s_attr + kBatch * A;    // kBatch x A
  float* s_buf = s_acc + kBatch * A + warp * kSub * kBufStride;  // this warp's kSub x 32
  int32_t* s_gid = (int32_t*)(s_acc + kBatch * A + (Pc / 32) * kSub * kBufStride);
  const int gq = lane >> 2;  // the mma fragments' groupID
  const int tq = lane & 3;   // and threadID_in_group
  const int p0 = warp * 32;  // the warp's first thread: g_out is staged in thread order

  const size_t start = rows.start(t);
  const int count = counts[t];
  const int pl = tile_pixel(half * Pc + lin, ts);
  const float px = (float)((t % tw) * ts + pl % ts);
  const float py = (float)((t / tw) * ts + pl / ts);
  const size_t pix = (size_t)t * P + pl;

  // the half's pixels are whole rows of 8 x 4 blocks, so its (Pc, C) block of g_out is
  // contiguous: read it coalesced, store it transposed, each pixel's channels in its thread's
  // column
  const float* gt = g_out + ((size_t)t * P + half * Pc) * C;
  for (int i = lin; i < Pc * C; i += Pc) {
    const int p = i / C;
    s_g[(i - p * C) * GS + pixel_thread(half * Pc + p, ts) - half * Pc] = gt[i];
  }
  if (lin == 0) s_kmax = 0;
  __syncthreads();

  float bg_dot_g = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) bg_dot_g = fmaf(s_g[c * GS + lin], bg[c], bg_dot_g);
  const float logt_total = logt[pix];
  const float tail = expf(logt_total) * (bg_dot_g - g_alpha[pix]);
  const int kstart = min((int)ncomp[pix], count);
  const int wmax = __reduce_max_sync(kFull, kstart);
  if (lane == 0) atomicMax(&s_kmax, wmax);
  __syncthreads();
  const int kmax = s_kmax;

  float suffix_comp = 0.f;  // sum of log(1 - alpha) over composited rows behind k
  float suffix_wgc = 0.f;   // sum of w_j <c_j, g> over the same rows
  for (int base = kmax > 0 ? (kmax - 1) / kBatch * kBatch : -1; base >= 0; base -= kBatch) {
    const int n = min(kBatch, kmax - base);
    __syncthreads();  // the previous batch is written out
    for (int i = lin; i < n * A; i += Pc) s_acc[i] = 0.f;
    rows.template stage<A>(start + base, n, s_attr, s_gid);
    __syncthreads();

    // each warp on its own, sub-chunks of kSub rows from the last down
    for (int r0 = (n - 1) / kSub * kSub; r0 >= 0; r0 -= kSub) {
      if (base + r0 >= wmax) continue;  // no lane of the warp walks these rows

      // 1. the validity tests; a lane keeps exp(-sigma) of each live row, 0 elsewhere
      float esig[kSub];
      unsigned live_rows = 0;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        float e = 0.f;
        if (base + r0 + j < kstart) {
          const float* row = s_attr + (r0 + j) * A;
          const float dx = __fsub_rn(px, row[0]);
          const float dy = __fsub_rn(py, row[1]);
          const float sa = __fmul_rn(__fmul_rn(row[2], dx), dx);
          const float sc = __fmul_rn(__fmul_rn(row[4], dy), dy);
          const float sb = __fmul_rn(__fmul_rn(row[3], dx), dy);
          const float sigma = __fadd_rn(__fmul_rn(0.5f, __fadd_rn(sa, sc)), sb);
          const float es = expf(-sigma);
          const float a = fminf(kAlphaClamp, __fmul_rn(row[5], es));
          if (sigma >= 0.f && a >= kAlphaCutoff) e = es;
        }
        esig[j] = e;
        if (__any_sync(kFull, e != 0.f)) live_rows |= 1u << j;
      }
      if (live_rows == 0) continue;

      // 2. gc[pixel][row] = <c_row, g_out[pixel]> on the tensor cores: M the warp's 32 pixels
      // (two m tiles), N the kSub rows, K the channels; through the buffer to the pixel's lane
      {
        float d[2][4] = {};
#pragma unroll
        for (int k0 = 0; k0 < CK; k0 += 8) {
          const int c0 = k0 + tq, c1 = k0 + tq + 4;
          const float* col = s_attr + (r0 + gq) * A + 6;
          const float b[2] = {c0 < C ? col[c0] : 0.f, c1 < C ? col[c1] : 0.f};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const float* g = s_g + p0 + mt * 16 + gq;
            const float a[4] = {c0 < C ? g[c0 * GS] : 0.f, c0 < C ? g[c0 * GS + 8] : 0.f,
                                c1 < C ? g[c1 * GS] : 0.f, c1 < C ? g[c1 * GS + 8] : 0.f};
            mma_3xtf32(d[mt], a, b);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float* o = s_buf + 2 * tq * kBufStride + mt * 16 + gq;
          o[0] = d[mt][0];
          o[kBufStride] = d[mt][1];
          o[8] = d[mt][2];
          o[kBufStride + 8] = d[mt][3];
        }
        __syncwarp();
      }

      // 3. the reverse walk, one thread per pixel; w replaces gc in the buffer
#pragma unroll
      for (int j = kSub - 1; j >= 0; --j) {
        float w = 0.f;
        if (live_rows >> j & 1u) {
          float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          if (esig[j] != 0.f) {
            const float* row = s_attr + (r0 + j) * A;
            const float dx = __fsub_rn(px, row[0]);
            const float dy = __fsub_rn(py, row[1]);
            const float raw = __fmul_rn(row[5], esig[j]);
            const float a = fminf(kAlphaClamp, raw);
            const float lt = log1pf(-a);
            const float t_before = expf(logt_total - (suffix_comp + lt));
            w = a * t_before;
            const float gc = s_buf[j * kBufStride + lane];
            const float wgc = w * gc;
            float dalpha = t_before * gc - (suffix_wgc + tail) / fmaxf(1.f - a, 1e-6f);
            if (!(w > 0.f) || !(raw < kAlphaClamp)) dalpha = 0.f;
            const float dsigma = -raw * dalpha;
            v[0] = -(row[2] * dx + row[3] * dy) * dsigma;
            v[1] = -(row[3] * dx + row[4] * dy) * dsigma;
            v[2] = 0.5f * dx * dx * dsigma;
            v[3] = dx * dy * dsigma;
            v[4] = 0.5f * dy * dy * dsigma;
            v[5] = esig[j] * dalpha;
            suffix_comp += lt;
            suffix_wgc += wgc;
          }
          // the row's 6 geometric and opacity sums: lane l < 6 adds value l
          const float s = reduce_scatter8(v, lane);
          if (lane < 6) atomicAdd(s_acc + (r0 + j) * A + lane, s);
        }
        s_buf[j * kBufStride + lane] = w;
      }
      __syncwarp();

      // 4. dcolour[row][c] = sum_p w[row][p] g_out[p][c] on the tensor cores: M the channels
      // (CM m tiles), N the kSub rows, K the warp's 32 pixels; into the batch's sums
      {
        float d[CM][4] = {};
#pragma unroll
        for (int k0 = 0; k0 < 32; k0 += 8) {
          const float* wr = s_buf + gq * kBufStride + k0 + tq;
          const float b[2] = {wr[0], wr[4]};
          const float* g = s_g + p0 + k0 + tq;
#pragma unroll
          for (int mt = 0; mt < CM; ++mt) {
            const int c0 = mt * 16 + gq, c1 = c0 + 8;
            const float a[4] = {c0 < C ? g[c0 * GS] : 0.f, c1 < C ? g[c1 * GS] : 0.f,
                                c0 < C ? g[c0 * GS + 4] : 0.f, c1 < C ? g[c1 * GS + 4] : 0.f};
            mma_3xtf32(d[mt], a, b);
          }
        }
        float* acc = s_acc + (r0 + 2 * tq) * A + 6;
#pragma unroll
        for (int mt = 0; mt < CM; ++mt) {
          const int c0 = mt * 16 + gq, c1 = c0 + 8;
          if (c0 < C) {
            atomicAdd(acc + c0, d[mt][0]);
            atomicAdd(acc + A + c0, d[mt][1]);
          }
          if (c1 < C) {
            atomicAdd(acc + c1, d[mt][2]);
            atomicAdd(acc + A + c1, d[mt][3]);
          }
        }
        __syncwarp();  // the buffer is read before the next sub-chunk writes it
      }
    }
    __syncthreads();
    float* dst = grows + (start + base) * A;
    for (int i = lin; i < n * A; i += Pc) {  // the two halves add into the same rows
      const float v = s_acc[i];
      if (v != 0.f) atomicAdd(dst + i, v);
    }
  }
}

// K2: two CTAs per tile, one per half of its pixels.
template <int C>
__global__ void __launch_bounds__(512, 2) composite_pairs_bwd_kernel(
    const int32_t* __restrict__ pair_gidx, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ counts, const float* __restrict__ attrs,
    const float* __restrict__ bg, const float* __restrict__ g_out,
    const float* __restrict__ g_alpha, const float* __restrict__ logt,
    const float* __restrict__ ncomp, int tw, int ts, float* __restrict__ gpairs) {
  grad_tile<C>(blockIdx.x >> 1, blockIdx.x & 1, PairRows{pair_gidx, starts, attrs}, counts, bg,
               g_out, g_alpha, logt, ncomp, tw, ts, gpairs);
}

// K4: as K2, rows from the packed (T, kt, 6 + C) table, sums into gattr (T, kt, 6 + C).
template <int C>
__global__ void __launch_bounds__(512, 2) composite_tables_bwd_kernel(
    const int32_t* __restrict__ counts, const float* __restrict__ tables, int kt,
    const float* __restrict__ bg, const float* __restrict__ g_out,
    const float* __restrict__ g_alpha, const float* __restrict__ logt,
    const float* __restrict__ ncomp, int tw, int ts, float* __restrict__ gattr) {
  grad_tile<C>(blockIdx.x >> 1, blockIdx.x & 1, TableRows{tables, kt}, counts, bg, g_out,
               g_alpha, logt, ncomp, tw, ts, gattr);
}

// K6: tiles 2j and 2j + 1 per four-CTA cluster j, cluster_ctarank r taking half r & 1 of tile
// 2j + (r >> 1).
template <int C>
__global__ void __launch_bounds__(512, 2) composite_pairs_bwd2_kernel(
    const int32_t* __restrict__ pair_gidx, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ counts, const float* __restrict__ attrs,
    const float* __restrict__ bg, const float* __restrict__ g_out,
    const float* __restrict__ g_alpha, const float* __restrict__ logt,
    const float* __restrict__ ncomp, int num_tiles, int tw, int ts,
    float* __restrict__ gpairs) {
  unsigned cluster, rank;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(cluster));
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const int t = 2 * (int)cluster + (int)(rank >> 1);
  if (t >= num_tiles) return;  // the phantom tile of an odd tile count: before any barrier
  grad_tile<C>(t, rank & 1, PairRows{pair_gidx, starts, attrs}, counts, bg, g_out, g_alpha, logt,
               ncomp, tw, ts, gpairs);
}

// Lets `kernel` take `bytes` of dynamic shared memory, with the SM's carveout at its most shared
// memory so that two CTAs fit an SM.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

cudaLaunchConfig_t pair_config(int num_tiles, int p, size_t bytes, cudaStream_t s,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(4 * ((num_tiles + 1) / 2));
  cfg.blockDim = dim3(p / 2);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 4;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int C>
int launch2(const void* pair_gidx, const void* starts, const void* counts, const void* attrs,
            const void* bg, const void* g_out, const void* g_alpha, const void* logt,
            const void* ncomp, int num_tiles, int tw, int ts, void* gpairs, cudaStream_t s) {
  const size_t bytes = smem_bytes<C>(ts * ts / 2);
  cudaError_t err = allow_smem(composite_pairs_bwd2_kernel<C>, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = pair_config(num_tiles, ts * ts, bytes, s, &attr);
  err = cudaLaunchKernelEx(&cfg, composite_pairs_bwd2_kernel<C>, (const int32_t*)pair_gidx,
                           (const int32_t*)starts, (const int32_t*)counts, (const float*)attrs,
                           (const float*)bg, (const float*)g_out, (const float*)g_alpha,
                           (const float*)logt, (const float*)ncomp, num_tiles, tw, ts,
                           (float*)gpairs);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int C>
int max_clusters2(int ts, int* n) {
  const size_t bytes = smem_bytes<C>(ts * ts / 2);
  cudaError_t err = allow_smem(composite_pairs_bwd2_kernel<C>, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = pair_config(2, ts * ts, bytes, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(n, composite_pairs_bwd2_kernel<C>, &cfg);
}

template <int C>
int launch(const void* pair_gidx, const void* starts, const void* counts, const void* attrs,
           const void* bg, const void* g_out, const void* g_alpha, const void* logt,
           const void* ncomp, int num_tiles, int tw, int ts, void* gpairs, cudaStream_t s) {
  const int pc = ts * ts / 2;
  const size_t bytes = smem_bytes<C>(pc);
  cudaError_t err = allow_smem(composite_pairs_bwd_kernel<C>, bytes);
  if (err != cudaSuccess) return (int)err;
  composite_pairs_bwd_kernel<C><<<2 * num_tiles, pc, bytes, s>>>(
      (const int32_t*)pair_gidx, (const int32_t*)starts, (const int32_t*)counts,
      (const float*)attrs, (const float*)bg, (const float*)g_out, (const float*)g_alpha,
      (const float*)logt, (const float*)ncomp, tw, ts, (float*)gpairs);
  return (int)cudaGetLastError();
}

template <int C>
int launch_tables(const void* counts, const void* tables, int kt, const void* bg,
                  const void* g_out, const void* g_alpha, const void* logt, const void* ncomp,
                  int num_tiles, int tw, int ts, void* gattr, cudaStream_t s) {
  const int pc = ts * ts / 2;
  const size_t bytes = smem_bytes<C>(pc);
  cudaError_t err = allow_smem(composite_tables_bwd_kernel<C>, bytes);
  if (err != cudaSuccess) return (int)err;
  composite_tables_bwd_kernel<C><<<2 * num_tiles, pc, bytes, s>>>(
      (const int32_t*)counts, (const float*)tables, kt, (const float*)bg, (const float*)g_out,
      (const float*)g_alpha, (const float*)logt, (const float*)ncomp, tw, ts, (float*)gattr);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K4 on `stream` and returns the CUDA error code; 0 is success. Device pointers: counts
// (T,) int32 with 0 <= counts[t] <= kt; tables (T, kt, 6 + C), bg (C,), g_out (T, ts*ts, C),
// g_alpha / logt / ncomp (T, ts*ts) float32 (logt and ncomp K3's); gattr (T, kt, 6 + C) float32,
// zero-filled by the caller.
extern "C" int ggt_composite_tables_bwd(const void* counts, const void* tables, const void* bg,
                                        const void* g_out, const void* g_alpha, const void* logt,
                                        const void* ncomp, int num_tiles, int kt, int tw, int ts,
                                        int channels, void* gattr, void* stream) {
  const int p = ts * ts;
  if (num_tiles <= 0 || kt < 0 || p < 64 || p > 1024 || p % 64 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (channels) {
    case 3:
      return launch_tables<3>(counts, tables, kt, bg, g_out, g_alpha, logt, ncomp, num_tiles, tw,
                              ts, gattr, s);
    case 39:
      return launch_tables<39>(counts, tables, kt, bg, g_out, g_alpha, logt, ncomp, num_tiles, tw,
                               ts, gattr, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Launches the kernel on `stream` (a cudaStream_t) and returns the CUDA error code; 0 is
// success. Pointers are device pointers: pair_gidx (B,), starts (T,), counts (T,) int32 with
// counts[t] <= B - starts[t]; attrs (N, 6 + C), bg (C,), g_out (T, ts*ts, C), g_alpha / logt /
// ncomp (T, ts*ts) float32; gpairs (B, 6 + C) float32, zero-filled by the caller.
extern "C" int ggt_composite_pairs_bwd(const void* pair_gidx, const void* starts,
                                       const void* counts, const void* attrs, const void* bg,
                                       const void* g_out, const void* g_alpha, const void* logt,
                                       const void* ncomp, int num_tiles, int tw, int ts,
                                       int channels, void* gpairs, void* stream) {
  const int p = ts * ts;
  if (num_tiles <= 0 || p < 64 || p > 1024 || p % 64 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (channels) {
    case 3:
      return launch<3>(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp,
                       num_tiles, tw, ts, gpairs, s);
    case 39:
      return launch<39>(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp,
                        num_tiles, tw, ts, gpairs, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Launches K6 (same arguments and output as K2) in four-CTA clusters; returns the CUDA error.
extern "C" int ggt_composite_pairs_bwd2(const void* pair_gidx, const void* starts,
                                        const void* counts, const void* attrs, const void* bg,
                                        const void* g_out, const void* g_alpha, const void* logt,
                                        const void* ncomp, int num_tiles, int tw, int ts,
                                        int channels, void* gpairs, void* stream) {
  const int p = ts * ts;
  if (num_tiles <= 0 || p < 64 || p > 1024 || p % 64 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (channels) {
    case 3:
      return launch2<3>(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp,
                        num_tiles, tw, ts, gpairs, s);
    case 39:
      return launch2<39>(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp,
                         num_tiles, tw, ts, gpairs, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// cudaOccupancyMaxActiveClusters for K6 at this channel count and tile size, with its dynamic
// shared memory: how many four-CTA clusters the card can hold at once (0: it cannot launch).
extern "C" int ggt_composite_pairs_bwd2_max_clusters(int channels, int ts, int* n) {
  const int p = ts * ts;
  if (p < 64 || p > 1024 || p % 64 != 0) return (int)cudaErrorInvalidValue;
  switch (channels) {
    case 3: return max_clusters2<3>(ts, n);
    case 39: return max_clusters2<39>(ts, n);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ggt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
