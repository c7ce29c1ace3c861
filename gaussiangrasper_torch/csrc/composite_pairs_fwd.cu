// Forward per-tile compositing, for Hopper (sm_90a).
//
// Replaces three kernels of the JAX package's rasterize_pallas.py, with one per-tile body:
//   K1 _fwd_pairs_kernel (launched by _call_fwd_pairs): one tile per kernel instance, rows from
//      the depth-sorted pair stream;
//   K5 _fwd_pairs2_kernel (launched by _call_fwd_pairs2 under GGT_TP=2): tiles 2j and 2j + 1
//      per kernel instance, bit-identical to K1;
//   K3 _fwd_kernel (launched by _call_fwd from composite_binned / composite_tiles): one tile per
//      kernel instance, rows from a packed per-tile (T, K, 6 + C) table.
// Same four outputs (the TPU's K3 has no ncomp; the port's K4 reads it):
//   out   (T, P, C) = sum_k w_k c_k + T_final * bg
//   alpha (T, P)    = 1 - T_final
//   logt  (T, P)    = sum of log(1 - alpha_k) over the composited entries (T_final = exp(logt))
//   ncomp (T, P)    = the per-pixel cut index: the entry whose running sum of log(1 - alpha)
//                     first falls to log(1e-4), or, for a pixel never cut, the walk length
//                     rounded up to K1's 128-row chunk (K1 counts the zero-alpha pad rows of its
//                     last chunk as composited; the port keeps that count so K2 can read it).
// alpha_k = min(0.999, o exp(-sigma)), zeroed when sigma < 0 or alpha_k < 1/255; sigma =
// 0.5 (a dx^2 + c dy^2) + b dx dy at integer pixel centres of the tile.
//
// Cut semantics are the JAX package's log form, not gsplat's product form: composite iff
// cum_all + log1pf(-alpha) > log(1e-4), with w = alpha expf(logt_comp). The alpha chain and the
// cut test use explicitly rounded operations (__fmul_rn / __fadd_rn, no FMA contraction) in the
// plain version's order, and expf / log1pf without fast math, so alpha, logt and ncomp equal
// the plain PyTorch version's on the same card; only `out` differs from it, by the rounding of
// the colour sums.
//
// What bounded the first design on this card (one 1024-thread CTA a tile, a warp a 32 x 1 pixel
// row, 64 registers): the 39 colour terms of each composited visit, 39 shared-memory loads and
// 39 FMAs a live warp-row, on rows of 45 floats that no vector load reads. The TPU kernel takes
// the same sum as a matrix product (_fwd_pairs_kernel's `mm`, rasterize_pallas.py:490); here it
// goes to the tensor cores.
//
// Design. One thread a pixel; the pixels of a tile are covered by up to four CTAs of up to 256
// threads (kParts), three of them an SM (kCtasPerSm), each rounded up to whole warps, the lanes
// past the tile's pixels idle. A warp covers an 8 x 4 pixel block (tile_pixel) where ts is a
// multiple of 8, so a splat's footprint meets fewer warps than with pixel rows; for other tile
// sizes it covers 32 pixels in row-major order. The tile's segment [start, start + count) is
// walked in batches of kBatch rows that the CTA stages itself through the row source
// (tile_rows.cuh): the geometry (x, y, conic, opacity and the row's cull box) in 8-float rows
// that two vector loads read, and the colours, split once into TF32 hi and lo parts, zero past C.
// Within a batch each warp works alone, on windows of 32 rows:
//   1. the cull: lane l tests row l of the window against the warp's pixel bounds; a row whose
//      box (the extent outside which alpha < 1/255, with a margin: cull_box) misses them is left
//      out for the whole warp, since no lane could composite it or be cut by it;
//   2. the kept rows in order, 8 at a time: sigma and alpha of the 8 rows (independent of one
//      another, so their latencies overlap), then the cut test and the weight w = alpha
//      T_before row by row on the CUDA cores, each lane its pixel, into a per-warp 8 x 40 buffer
//      (a stopped or idle lane writes 0 and keeps stepping with the warp);
//   3. if a lane composited one of the 8 rows: acc[32 px x 8 NT ch] += W[32 px x 8 rows] .
//      Colour[8 rows x 8 NT ch] by mma.sync m16n8k8 in 3xTF32 (mma_tf32.cuh), two m tiles of 16
//      pixels and NT n tiles of 8 channels, each lane's B fragments read from its rows'
//      colours, the accumulators in the D fragments (40 floats a lane at C = 39).
// A warp whose pixels have all stopped skips the rest of the batch; the CTA stops when all have.
// At the end each lane writes its pixel's alpha, logt and ncomp, and the D fragments go out with
// T_final bg, T_final taken from the owning lane by a shuffle. None of this changes a cut
// decision: a culled row changes no lane's state, a zero weight no sum.
//
// Two tiles per instance (K5). On the TPU the two tiles of one instance interleave their walks
// chunk by chunk so the scheduler has two independent dependency chains. On Hopper the SM's warp
// scheduler already interleaves independent warps, so K5 maps "one instance, two tiles" onto a
// thread-block cluster of two CTAs, the same part of tiles 2j and 2j + 1. The phantom CTAs of an
// odd T return before any barrier and write nothing.
// All three kernels call the one per-tile body (composite_tile), so K3 and K5 compute exactly
// K1's arithmetic and their outputs are bit-equal to K1's on the same rows.
//
// The table path (K3). composite_tile takes its rows from a row source (tile_rows.cuh): K1 / K5
// gather each batch through pair_gidx, K3 reads rows [t K, t K + count) of the packed table. The
// TPU kernel walks padded 128-row chunks with triangular-matmul prefix sums; the walk here is
// bounded by the count, so the table needs no padding. K3 is instantiated for C = 3, 7 (the
// kernel probe's width) and 39, K1 / K5 for 3 and 39; the wrappers cut wider colours into
// pieces of at most 39 channels, one launch each, and zero-pad each piece to one of these.
//
// Bound on this card (H100 SXM: 67 TFLOP/s f32 outside the tensor cores, 495 TFLOP/s dense TF32
// on them, so 165 for an f32-grade 3xTF32 product; 3.35 TB/s). Each pair-pixel visit that a
// warp's cull keeps costs ~16 f32 operations with one expf for sigma and alpha, each composited
// visit adds log1pf, expf and the weight (6) on the CUDA cores and the 2C flops of its colour
// terms on the tensor cores, and each warp tests every row of the 32-row windows it walks
// against its box (8). chip_smoke.py computes the bound from the run's own counts
// (composite_pairs_fwd_plain(count_warp_rows=True)), the two units' times added, and the
// compulsory bytes (the (N, 6 + C) table, pair_gidx, the (T, P, 3 + C) outputs): see PERF.md.
//
// Precision. The tensor core adds each m16n8k8 product into its accumulator with truncation,
// not round-to-nearest, so a running sum kept in the D fragments errs toward zero by up to about
// an ulp of that sum a product, three products (lo hi, hi lo, hi hi) a group of 8 rows: on a
// dense tile (thousands of live rows, |out| ~4) that passes the 1e-4 criterion. So each group's
// products are summed into a zeroed fragment, whose truncation is relative to that small sum,
// and added to the f32 accumulators with __fadd_rn, which rounds to nearest (colour_product).
//
// Times, ptxas's registers and spills, shared memory, cluster occupancy and the design variants
// timed against this one are in PERF.md §6.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "tile_rows.cuh"

namespace {

constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaCutoff = (float)(1.0 / 255.0);
constexpr float kLogEps = -9.2103403719761836f;  // log(1e-4)
constexpr int kWalkChunk = 128;                  // K1's KC: the rounding of an uncut ncomp
constexpr int kBatch = 128;     // rows staged in shared memory per batch
constexpr int kSub = 8;         // rows of a group of the walk: the k of the m16n8k8 products
constexpr int kBufStride = 40;  // row stride of a warp's weight buffer: the A fragments' loads
                                // (row tq, pixel gq) hit 32 banks
constexpr unsigned kFull = 0xffffffffu;
constexpr int kParts = 4;       // CTAs of a 1024-pixel tile, 256 threads each
constexpr int kCtasPerSm = 3;   // the launch bound: at most 65536 / (3 x 256) = 85 registers a
                                // thread (80 in use)

// Shared memory of the body, in 4-byte words: the batch's geometry (kBatch x 8), its colours split
// (kBatch x 8 NT x 2), each warp's weight buffer (kSub x kBufStride), the batch's indices
// (kBatch). Every region starts on 16 bytes.
template <int C>
struct FwdSmem {
  static constexpr int NT = (C + 7) / 8;  // 8-channel n tiles
  static constexpr int kGeo = kBatch * 8;
  static constexpr int kCol = kBatch * NT * 8 * 2;
  static constexpr int kWarp = kSub * kBufStride;

  static size_t bytes(int threads) {
    return 4 * (kGeo + kCol + (size_t)(threads / 32) * kWarp + kBatch);
  }
};

// Threads of each CTA and CTAs of each tile: whole warps, at most 1024 / kParts threads a CTA.
__host__ __device__ __forceinline__ int cta_threads(int p) {
  const int t = (p + 31) / 32 * 32;
  return t < 1024 / kParts ? t : 1024 / kParts;
}
__host__ __device__ __forceinline__ int tile_ctas(int p) {
  return (p + cta_threads(p) - 1) / cta_threads(p);
}

// Half-extents (rx, ry) of the box around a row's centre outside which no pixel passes the alpha
// test: alpha >= 1/255 needs sigma = 0.5 d^T [[a, b], [b, c]] d <= L = log(255 o), an ellipse
// with |dx| <= sqrt(2 L c / det), |dy| <= sqrt(2 L a / det). L takes 0.05 more and the extents
// 0.1% more, far beyond the rounding of the walk's sigma and alpha wherever the form is
// positive definite with det > 1e-4 a c; elsewhere the box is unbounded. Opacity below 1/255:
// no pixel passes, an empty box.
__device__ __forceinline__ float2 cull_box(float a, float b, float c, float o) {
  if (!(o >= kAlphaCutoff)) return make_float2(-1.f, -1.f);
  const float det = a * c - b * b;
  if (!(a > 0.f && c > 0.f && det > 1e-4f * a * c)) return make_float2(INFINITY, INFINITY);
  const float l2 = 2.f * (logf(255.f * o) + 0.05f);
  return make_float2(sqrtf(l2 * c / det) * 1.001f + 1e-3f, sqrtf(l2 * a / det) * 1.001f + 1e-3f);
}

// Lays out rows [0, n) of a batch, through the row source, for the walk and the product: geometry
// in 8-float rows (x, y, conic a, b | conic c, opacity, the cull box's half-extents); colours of
// rows [0, n) x channels [0, 8 NT) split into TF32 {hi, lo} at s_col[r 8 NT + c], zero past C.
template <int C, class Rows>
__device__ __forceinline__ void stage_batch(const Rows& rows, size_t first, int n,
                                            const int32_t* s_gid, float4* s_geo, float2* s_col) {
  constexpr int A = 6 + C;
  constexpr int CP = FwdSmem<C>::NT * 8;
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const float* src = rows.template row<A>(first, r, s_gid);
    const float2 box = cull_box(src[2], src[3], src[4], src[5]);
    s_geo[2 * r] = make_float4(src[0], src[1], src[2], src[3]);
    s_geo[2 * r + 1] = make_float4(src[4], src[5], box.x, box.y);
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < n * CP; i += blockDim.x) {
    const int r = i / CP, c = i - r * CP;
    uint32_t hi, lo;
    split_tf32(c < C ? rows.template row<A>(first, r, s_gid)[6 + c] : 0.f, hi, lo);
    s_col[i] = make_float2(__uint_as_float(hi), __uint_as_float(lo));
  }
}

// acc[pixel][channel] += sum_k w[k][pixel] colour[row k][channel] on the tensor cores, 3xTF32:
// M the warp's 32 pixels (two m tiles), N the channels (NT n tiles), K the 8 weight rows at
// w (kBufStride apart); the lane's B rows are lo (fragment row tq) and hi (tq + 4). Each n
// tile's three products go into a zeroed D fragment, which is then added to the f32
// accumulators in IEEE rounding, since the tensor core truncates its sums (see "Precision").
template <int NT>
__device__ __forceinline__ void colour_product(float (&acc)[2][NT][4], const float* w,
                                               const float2* s_col, int lo, int hi, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  const float2* c0 = s_col + lo * NT * 8 + gq;
  const float2* c1 = s_col + hi * NT * 8 + gq;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const float* wr = w + tq * kBufStride + mt * 16 + gq;
    uint32_t ah[4], al[4];
    split_tf32(wr[0], ah[0], al[0]);
    split_tf32(wr[8], ah[1], al[1]);
    split_tf32(wr[4 * kBufStride], ah[2], al[2]);
    split_tf32(wr[4 * kBufStride + 8], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 b0 = c0[nt * 8], b1 = c1[nt * 8];
      const uint32_t bh[2] = {__float_as_uint(b0.x), __float_as_uint(b1.x)};
      const uint32_t bl[2] = {__float_as_uint(b0.y), __float_as_uint(b1.y)};
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32_split(d, ah, al, bh, bl);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], d[e]);
    }
  }
}

// The whole per-tile forward of part `part` of tile t's pixels, run by one CTA (one thread a
// pixel), over the rows that `rows` (PairRows or TableRows) gives.
template <int C, class Rows>
__device__ __forceinline__ void composite_tile(
    int t, int part, const Rows& rows, const int32_t* __restrict__ counts,
    const float* __restrict__ bg, int tw, int ts, float* __restrict__ out,
    float* __restrict__ alpha_out, float* __restrict__ logt_out,
    float* __restrict__ ncomp_out) {
  constexpr int NT = FwdSmem<C>::NT;
  extern __shared__ float4 smem4[];
  float4* s_geo = smem4;  // kBatch x 2
  float2* s_col = reinterpret_cast<float2*>(smem4 + FwdSmem<C>::kGeo / 4);
  float* s_warps = reinterpret_cast<float*>(smem4) + FwdSmem<C>::kGeo + FwdSmem<C>::kCol;
  const int nthreads = blockDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* s_buf = s_warps + warp * FwdSmem<C>::kWarp;  // kSub x kBufStride
  int32_t* s_gid = reinterpret_cast<int32_t*>(s_warps + (nthreads / 32) * FwdSmem<C>::kWarp);
  const int tq = lane & 3;

  const int P = ts * ts;
  const bool blocks = ts % 8 == 0;  // 8 x 4 pixel warps, else 32 pixels in a row
  const int lin = part * nthreads + threadIdx.x;
  const int pl = blocks ? tile_pixel(lin, ts) : lin;
  const int ix = (t % tw) * ts + pl % ts, iy = (t / tw) * ts + pl / ts;
  const float px = (float)ix, py = (float)iy;
  const size_t start = rows.start(t);
  const int count = counts[t];
  // the warp's pixel bounds, for the cull test (an idle lane counts for none)
  const bool active = lin < P;
  const float xlo = (float)__reduce_min_sync(kFull, active ? ix : INT_MAX);
  const float xhi = (float)__reduce_max_sync(kFull, active ? ix : INT_MIN);
  const float ylo = (float)__reduce_min_sync(kFull, active ? iy : INT_MAX);
  const float yhi = (float)__reduce_max_sync(kFull, active ? iy : INT_MIN);

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  float cum_all = 0.f;    // sum of log(1 - alpha) over every walked entry
  float logt_comp = 0.f;  // the same over composited entries
  int cut = active ? -1 : 0;  // an idle lane (past the tile's pixels) is stopped from the start

  for (int base = 0; base < count; base += kBatch) {
    const int n = min(kBatch, count - base);
    const size_t first = start + base;
    rows.load_index(first, n, s_gid);  // the barrier that ended the last batch is behind us
    __syncthreads();
    stage_batch<C>(rows, first, n, s_gid, s_geo, s_col);
    __syncthreads();

    // each warp on its own, windows of 32 rows
    for (int w0 = 0; w0 < n; w0 += 32) {
      // the cull: lane l tests row w0 + l against the warp's pixels
      unsigned todo;
      {
        const int rl = w0 + lane;
        bool keep = rl < n;
        if (keep) {
          const float4 g0 = s_geo[2 * rl], g1 = s_geo[2 * rl + 1];
          keep = !(g0.x + g1.z < xlo || g0.x - g1.z > xhi || g0.y + g1.w < ylo ||
                   g0.y - g1.w > yhi);
        }
        todo = __ballot_sync(kFull, keep);
      }
      // the kept rows in order, kSub at a time
      while (todo != 0u && !__all_sync(kFull, cut >= 0)) {
        // 1. sigma and alpha of the group's rows (the lowest kSub bits of todo), independent of
        // one another; the lane's B rows of the product are slots tq and tq + 4
        const unsigned group = todo;
        float av[kSub];
        unsigned ok = 0u;
        int lo = w0, hi = w0;
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const bool has = todo != 0u;
          const int r = has ? w0 + __ffs(todo) - 1 : w0;
          todo &= todo - 1u;
          if (j == tq) lo = r;
          if (j == tq + 4) hi = r;
          const float4 g0 = s_geo[2 * r];      // x, y, conic a, conic b
          const float4 g1 = s_geo[2 * r + 1];  // conic c, opacity, cull box
          const float dx = __fsub_rn(px, g0.x);
          const float dy = __fsub_rn(py, g0.y);
          const float sa = __fmul_rn(__fmul_rn(g0.z, dx), dx);
          const float sc = __fmul_rn(__fmul_rn(g1.x, dy), dy);
          const float sb = __fmul_rn(__fmul_rn(g0.w, dx), dy);
          const float sigma = __fadd_rn(__fmul_rn(0.5f, __fadd_rn(sa, sc)), sb);
          av[j] = fminf(kAlphaClamp, __fmul_rn(g1.y, expf(-sigma)));
          if (has && sigma >= 0.f && av[j] >= kAlphaCutoff) ok |= 1u << j;  // else alpha 0
        }
        // 2. the cut test and the weight w = alpha T_before of each row, in order, into slot j
        bool live = false;
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          float w = 0.f;
          if ((ok >> j & 1u) && cut < 0) {
            const float lt = log1pf(-av[j]);
            const float cum = __fadd_rn(cum_all, lt);
            if (!(cum > kLogEps)) {
              unsigned m = group;  // the group's row j: the (j + 1)-th set bit of group
#pragma unroll
              for (int k = 0; k < j; ++k) m &= m - 1u;
              cut = base + w0 + __ffs(m) - 1;
            } else {
              w = __fmul_rn(av[j], expf(logt_comp));
              logt_comp = __fadd_rn(logt_comp, lt);
              cum_all = cum;
              live = true;
            }
          }
          s_buf[j * kBufStride + lane] = w;
        }
        // 3. the colour product of the group's rows, if some lane composited one
        if (__any_sync(kFull, live)) {
          __syncwarp();
          colour_product<NT>(acc, s_buf, s_col, lo, hi, lane);
          __syncwarp();  // the slots are read before the next group writes them
        }
      }
    }
    if (__syncthreads_count(cut >= 0) == nthreads) break;
  }

  const float t_final = expf(logt_comp);
  if (active) {
    const size_t pix = (size_t)t * P + pl;
    alpha_out[pix] = 1.0f - t_final;
    logt_out[pix] = logt_comp;
    ncomp_out[pix] =
        (float)(cut >= 0 ? cut : (count + kWalkChunk - 1) / kWalkChunk * kWalkChunk);
  }
  // the D fragments: rows gq and gq + 8 of each m tile are the warp's pixels (lanes) q, columns
  // 2 tq and 2 tq + 1 of each n tile the channels
  const int lin0 = part * nthreads + warp * 32;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = mt * 16 + h * 8 + (lane >> 2);
      const float tf = __shfl_sync(kFull, t_final, q);
      if (lin0 + q < P) {
        float* o = out + ((size_t)t * P + (blocks ? tile_pixel(lin0 + q, ts) : lin0 + q)) * C;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = nt * 8 + 2 * tq + e;
            if (c < C) o[c] = __fadd_rn(acc[mt][nt][2 * h + e], __fmul_rn(tf, bg[c]));
          }
        }
      }
    }
  }
}

// K1: tile_ctas CTAs per tile.
template <int C>
__global__ void __launch_bounds__(1024 / kParts, kCtasPerSm) composite_pairs_fwd_kernel(
    const int32_t* __restrict__ pair_gidx, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ counts, const float* __restrict__ attrs,
    const float* __restrict__ bg, int parts, int tw, int ts, float* __restrict__ out,
    float* __restrict__ alpha_out, float* __restrict__ logt_out,
    float* __restrict__ ncomp_out) {
  composite_tile<C>(blockIdx.x / parts, blockIdx.x % parts, PairRows{pair_gidx, starts, attrs},
                    counts, bg, tw, ts, out, alpha_out, logt_out, ncomp_out);
}

// K3: as K1, rows from the packed (T, kt, 6 + C) table.
template <int C>
__global__ void __launch_bounds__(1024 / kParts, kCtasPerSm) composite_tables_fwd_kernel(
    const int32_t* __restrict__ counts, const float* __restrict__ tables, int kt,
    const float* __restrict__ bg, int parts, int tw, int ts, float* __restrict__ out,
    float* __restrict__ alpha_out, float* __restrict__ logt_out,
    float* __restrict__ ncomp_out) {
  composite_tile<C>(blockIdx.x / parts, blockIdx.x % parts, TableRows{tables, kt}, counts, bg, tw,
                    ts, out, alpha_out, logt_out, ncomp_out);
}

// K5: clusters of two CTAs, cluster j holding part j % parts of tiles 2 (j / parts) and
// 2 (j / parts) + 1, one a CTA (cluster_ctarank 0 and 1).
template <int C>
__global__ void __launch_bounds__(1024 / kParts, kCtasPerSm) composite_pairs_fwd2_kernel(
    const int32_t* __restrict__ pair_gidx, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ counts, const float* __restrict__ attrs,
    const float* __restrict__ bg, int parts, int num_tiles, int tw, int ts,
    float* __restrict__ out, float* __restrict__ alpha_out, float* __restrict__ logt_out,
    float* __restrict__ ncomp_out) {
  unsigned cluster, rank;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(cluster));
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const int t = 2 * ((int)cluster / parts) + (int)rank;
  if (t >= num_tiles) return;  // the phantom tile of an odd tile count: before any barrier
  composite_tile<C>(t, (int)cluster % parts, PairRows{pair_gidx, starts, attrs}, counts, bg, tw,
                    ts, out, alpha_out, logt_out, ncomp_out);
}

// Lets `kernel` take `bytes` of dynamic shared memory, with the SM's carveout at its most shared
// memory so that kCtasPerSm CTAs fit an SM.
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
  const int parts = tile_ctas(p);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * parts * ((num_tiles + 1) / 2));
  cfg.blockDim = dim3(cta_threads(p));
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 2;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int C>
int launch_fwd2(const void* pair_gidx, const void* starts, const void* counts, const void* attrs,
                const void* bg, int num_tiles, int tw, int ts, void* out, void* alpha, void* logt,
                void* ncomp, cudaStream_t s) {
  const int p = ts * ts;
  const size_t bytes = FwdSmem<C>::bytes(cta_threads(p));
  cudaError_t err = allow_smem(composite_pairs_fwd2_kernel<C>, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = pair_config(num_tiles, p, bytes, s, &attr);
  err = cudaLaunchKernelEx(
      &cfg, composite_pairs_fwd2_kernel<C>, (const int32_t*)pair_gidx, (const int32_t*)starts,
      (const int32_t*)counts, (const float*)attrs, (const float*)bg, tile_ctas(p), num_tiles, tw,
      ts, (float*)out, (float*)alpha, (float*)logt, (float*)ncomp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int C>
int max_clusters_fwd2(int ts, int* n) {
  const int p = ts * ts;
  const size_t bytes = FwdSmem<C>::bytes(cta_threads(p));
  cudaError_t err = allow_smem(composite_pairs_fwd2_kernel<C>, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = pair_config(2, p, bytes, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(n, composite_pairs_fwd2_kernel<C>, &cfg);
}

template <int C>
int launch_fwd(const void* pair_gidx, const void* starts, const void* counts, const void* attrs,
               const void* bg, int num_tiles, int tw, int ts, void* out, void* alpha, void* logt,
               void* ncomp, cudaStream_t s) {
  const int p = ts * ts, threads = cta_threads(p), parts = tile_ctas(p);
  const size_t bytes = FwdSmem<C>::bytes(threads);
  cudaError_t err = allow_smem(composite_pairs_fwd_kernel<C>, bytes);
  if (err != cudaSuccess) return (int)err;
  composite_pairs_fwd_kernel<C><<<parts * num_tiles, threads, bytes, s>>>(
      (const int32_t*)pair_gidx, (const int32_t*)starts, (const int32_t*)counts,
      (const float*)attrs, (const float*)bg, parts, tw, ts, (float*)out, (float*)alpha,
      (float*)logt, (float*)ncomp);
  return (int)cudaGetLastError();
}

template <int C>
int launch_tables(const void* counts, const void* tables, int kt, const void* bg, int num_tiles,
                  int tw, int ts, void* out, void* alpha, void* logt, void* ncomp,
                  cudaStream_t s) {
  const int p = ts * ts, threads = cta_threads(p), parts = tile_ctas(p);
  const size_t bytes = FwdSmem<C>::bytes(threads);
  cudaError_t err = allow_smem(composite_tables_fwd_kernel<C>, bytes);
  if (err != cudaSuccess) return (int)err;
  composite_tables_fwd_kernel<C><<<parts * num_tiles, threads, bytes, s>>>(
      (const int32_t*)counts, (const float*)tables, kt, (const float*)bg, parts, tw, ts,
      (float*)out, (float*)alpha, (float*)logt, (float*)ncomp);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K1 on `stream` (a cudaStream_t) and returns the CUDA error code; 0 is success.
// Pointers are device pointers: pair_gidx (B,), starts (T,), counts (T,) int32 with
// counts[t] <= B - starts[t]; attrs (N, 6 + C), bg (C,) float32; outputs out (T, ts*ts, C),
// alpha / logt / ncomp (T, ts*ts) float32.
extern "C" int ggt_composite_pairs_fwd(const void* pair_gidx, const void* starts,
                                       const void* counts, const void* attrs, const void* bg,
                                       int num_tiles, int tw, int ts, int channels, void* out,
                                       void* alpha, void* logt, void* ncomp, void* stream) {
  const int p = ts * ts;
  if (num_tiles <= 0 || p < 1 || p > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (channels) {
    case 3:
      return launch_fwd<3>(pair_gidx, starts, counts, attrs, bg, num_tiles, tw, ts, out, alpha,
                           logt, ncomp, s);
    case 39:
      return launch_fwd<39>(pair_gidx, starts, counts, attrs, bg, num_tiles, tw, ts, out, alpha,
                            logt, ncomp, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Launches K3 on `stream` and returns the CUDA error code; 0 is success. Device pointers: counts
// (T,) int32 with 0 <= counts[t] <= kt; tables (T, kt, 6 + C), bg (C,) float32; outputs as K1's.
extern "C" int ggt_composite_tables_fwd(const void* counts, const void* tables, const void* bg,
                                        int num_tiles, int kt, int tw, int ts, int channels,
                                        void* out, void* alpha, void* logt, void* ncomp,
                                        void* stream) {
  const int p = ts * ts;
  if (num_tiles <= 0 || kt < 0 || p < 1 || p > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (channels) {
    case 3:
      return launch_tables<3>(counts, tables, kt, bg, num_tiles, tw, ts, out, alpha, logt, ncomp,
                              s);
    case 7:
      return launch_tables<7>(counts, tables, kt, bg, num_tiles, tw, ts, out, alpha, logt, ncomp,
                              s);
    case 39:
      return launch_tables<39>(counts, tables, kt, bg, num_tiles, tw, ts, out, alpha, logt, ncomp,
                               s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Launches K5 (same arguments and outputs as K1) in clusters of two tiles; returns the CUDA
// error.
extern "C" int ggt_composite_pairs_fwd2(const void* pair_gidx, const void* starts,
                                        const void* counts, const void* attrs, const void* bg,
                                        int num_tiles, int tw, int ts, int channels, void* out,
                                        void* alpha, void* logt, void* ncomp, void* stream) {
  const int p = ts * ts;
  if (num_tiles <= 0 || p < 1 || p > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (channels) {
    case 3:
      return launch_fwd2<3>(pair_gidx, starts, counts, attrs, bg, num_tiles, tw, ts, out, alpha,
                            logt, ncomp, s);
    case 39:
      return launch_fwd2<39>(pair_gidx, starts, counts, attrs, bg, num_tiles, tw, ts, out, alpha,
                             logt, ncomp, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// cudaOccupancyMaxActiveClusters for K5 at this channel count and tile size, with its dynamic
// shared memory: how many clusters the card can hold at once (0: it cannot launch).
extern "C" int ggt_composite_pairs_fwd2_max_clusters(int channels, int ts, int* n) {
  if (ts * ts < 1 || ts * ts > 1024) return (int)cudaErrorInvalidValue;
  switch (channels) {
    case 3: return max_clusters_fwd2<3>(ts, n);
    case 39: return max_clusters_fwd2<39>(ts, n);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one CTA of K1 / K3 / K5 at this channel count and tile size, in bytes.
extern "C" int ggt_composite_fwd_smem_bytes(int channels, int ts) {
  const int threads = cta_threads(ts * ts);
  switch (channels) {
    case 3: return (int)FwdSmem<3>::bytes(threads);
    case 7: return (int)FwdSmem<7>::bytes(threads);
    case 39: return (int)FwdSmem<39>::bytes(threads);
    default: return -1;
  }
}

extern "C" const char* ggt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
