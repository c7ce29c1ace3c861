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
// 0.5 (a dx^2 + c dy^2) + b dx dy at integer pixel centres px = (t % tw) ts + lin % ts.
//
// Design. One CTA per tile, one thread per pixel (ts 32 -> 1024 threads). The tile's segment
// [start, start + count) is walked in batches of kBatch rows that the block gathers itself
// through pair_gidx from the per-Gaussian attribute table (N, 6 + C) into shared memory
// (xy | conic | opacity | colour), so no (B, 6 + C) pair stream is materialised. Each pixel
// walks front to back and stops at its cut; the block stops when every pixel has stopped
// (__syncthreads_count). C is a template parameter (3 and 39, the channel counts the port
// renders) so the C accumulators live in registers; the wrapper raises for any other C.
// The walk is bounded by count, never by a padded window, so it never reads past B.
//
// The table path (K3). composite_tile takes its rows from a row source (tile_rows.cuh): K1 / K5
// gather each batch through pair_gidx, K3 copies it from rows [t K, t K + count) of the packed
// table. Everything after the staging is the same code, so K3 is bit-equal to K1 wherever the
// table and the stream hold the same rows (no K clip and no pair-budget clip). The TPU kernel
// walks padded 128-row chunks with triangular-matmul prefix sums; the walk here is bounded by
// the count, so the table needs no padding. K3 is instantiated for C = 3, 7 (the kernel probe's
// width) and 39.
//
// Two tiles per instance (K5). On the TPU the two tiles of one instance interleave their
// walks chunk by chunk so the scheduler has two independent dependency chains. On Hopper the
// SM's warp scheduler already interleaves 32 independent warps, so K5 maps "one instance, two
// tiles" onto a thread-block cluster of two CTAs, one tile each: a grid of 2 ceil(T/2) CTAs in
// clusters of {2, 1, 1}, tile = 2 clusterid + cluster_ctarank. The two CTAs of a cluster run at
// once on two SMs of one GPC. Both kernels call the one per-tile body (composite_tile), so K5
// computes exactly K1's arithmetic and its outputs are bit-equal. For an odd T the second CTA
// of the last cluster has no tile: it returns before any barrier and writes nothing, and the
// outputs are exactly (T, P, C) / (T, P) (no pad-and-crop as in _call_fwd_pairs2).
//
// Cut semantics are the JAX package's log form, not gsplat's product form: composite iff
// cum_all + log1pf(-alpha) > log(1e-4), with t_before = expf(logt_comp). The alpha chain and
// the cut test use explicitly rounded operations (__fmul_rn / __fadd_rn, no FMA contraction)
// in the plain version's order, and expf / log1pf without fast math, so every cut decision
// equals the plain PyTorch version's on the same card; only the colour sums use fmaf.
//
// Bound on this card (H100 SXM: 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s). At the
// full-width serving point (200k Gaussians, 800x800, T 625, P 1024, C 39; 0.81 M pairs walked)
// the pixels make 0.63 G pair-pixel visits up to their cuts. Each visit costs ~16 f32
// operations with one expf for sigma and alpha; each composited visit adds log1pf, expf and 2C
// FMA flops: 22.9 GFLOP, 0.34 ms at the f32 peak, against 0.15 GB of compulsory traffic (the
// (N, 45) table, pair_gidx, the (T, P, 42) outputs), 0.04 ms at 3.35 TB/s. The kernel is bound
// by operations. The design spends them only where needed: a rejected visit (alpha < 1/255,
// most of them) skips log1pf, the second expf and the 2C FMAs, and a pixel or a whole tile
// stops walking at its cut. K5 does the same work, so it has K1's bound. Measured by
// chip_smoke.py on an H100 80GB HBM3 at 700 W: K1 2.93 ms, 8.6x the bound; K5 2.95 ms beside
// K1's 2.92 ms in the same run. ptxas: C = 39 uses 64 registers (the cap at 1024 threads), 0
// spills, 23.5 KB static shared memory (K5 the same); C = 3 uses 28 registers (K5 30). The
// card holds 66 two-CTA clusters of K5 at C = 39 (132 at C = 3). K3 does K1's work on the same
// rows and reads the walked table rows (compulsory: counts x (6 + C) floats) where K1 reads
// pair_gidx and the (N, 6 + C) table, so it has K1's operations bound. Measured by chip_smoke.py
// on an H100 80GB HBM3 at 700 W: K3 2.97 ms beside K1's 2.89 ms in the same run, all four
// outputs bit-equal to K1's. ptxas: K3 at C = 39 uses 64 registers, 0 spills, 22.5 KB static
// shared memory; C = 7 38 registers, C = 3 27.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_rows.cuh"

namespace {

constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaCutoff = (float)(1.0 / 255.0);
constexpr float kLogEps = -9.2103403719761836f;  // log(1e-4)
constexpr int kWalkChunk = 128;                  // K1's KC: the rounding of an uncut ncomp
constexpr int kBatch = 128;                      // rows staged in shared memory per batch

// The whole per-tile forward of tile t, run by its CTA (one thread per pixel), over the rows
// that `rows` (PairRows or TableRows) gives.
template <int C, class Rows>
__device__ __forceinline__ void composite_tile(
    int t, const Rows& rows, const int32_t* __restrict__ counts,
    const float* __restrict__ bg, int tw, int ts, float* __restrict__ out,
    float* __restrict__ alpha_out, float* __restrict__ logt_out,
    float* __restrict__ ncomp_out) {
  constexpr int A = 6 + C;
  __shared__ float s_attr[kBatch * A];
  __shared__ int32_t s_gid[kBatch];

  const int lin = threadIdx.x;
  const int nthreads = blockDim.x;
  const size_t start = rows.start(t);
  const int count = counts[t];
  const float px = (float)((t % tw) * ts + lin % ts);
  const float py = (float)((t / tw) * ts + lin / ts);

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  float cum_all = 0.f;    // sum of log(1 - alpha) over every walked entry
  float logt_comp = 0.f;  // the same over composited entries
  int cut = -1;

  for (int base = 0; base < count; base += kBatch) {
    const int n = min(kBatch, count - base);
    __syncthreads();  // every pixel is done with the previous batch
    rows.template stage<A>(start + base, n, s_attr, s_gid);
    __syncthreads();
    if (cut < 0) {
      for (int j = 0; j < n; ++j) {
        const float* row = s_attr + j * A;
        const float dx = __fsub_rn(px, row[0]);
        const float dy = __fsub_rn(py, row[1]);
        const float sa = __fmul_rn(__fmul_rn(row[2], dx), dx);
        const float sc = __fmul_rn(__fmul_rn(row[4], dy), dy);
        const float sb = __fmul_rn(__fmul_rn(row[3], dx), dy);
        const float sigma = __fadd_rn(__fmul_rn(0.5f, __fadd_rn(sa, sc)), sb);
        const float a = fminf(kAlphaClamp, __fmul_rn(row[5], expf(-sigma)));
        if (!(sigma >= 0.f && a >= kAlphaCutoff)) continue;  // alpha 0: log term 0
        const float lt = log1pf(-a);
        const float cum = __fadd_rn(cum_all, lt);
        if (!(cum > kLogEps)) {
          cut = base + j;
          break;
        }
        const float w = __fmul_rn(a, expf(logt_comp));
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = fmaf(w, row[6 + c], acc[c]);
        logt_comp = __fadd_rn(logt_comp, lt);
        cum_all = cum;
      }
    }
    if (__syncthreads_count(cut >= 0) == nthreads) break;
  }

  const float t_final = expf(logt_comp);
  const size_t pix = (size_t)t * nthreads + lin;
  float* o = out + pix * C;
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = __fadd_rn(acc[c], __fmul_rn(t_final, bg[c]));
  alpha_out[pix] = 1.0f - t_final;
  logt_out[pix] = logt_comp;
  ncomp_out[pix] = (float)(cut >= 0 ? cut : (count + kWalkChunk - 1) / kWalkChunk * kWalkChunk);
}

// K1: one CTA per tile.
template <int C>
__global__ void __launch_bounds__(1024, 1) composite_pairs_fwd_kernel(
    const int32_t* __restrict__ pair_gidx, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ counts, const float* __restrict__ attrs,
    const float* __restrict__ bg, int tw, int ts, float* __restrict__ out,
    float* __restrict__ alpha_out, float* __restrict__ logt_out,
    float* __restrict__ ncomp_out) {
  composite_tile<C>(blockIdx.x, PairRows{pair_gidx, starts, attrs}, counts, bg, tw, ts, out,
                    alpha_out, logt_out, ncomp_out);
}

// K3: one CTA per tile, rows from the packed (T, kt, 6 + C) table.
template <int C>
__global__ void __launch_bounds__(1024, 1) composite_tables_fwd_kernel(
    const int32_t* __restrict__ counts, const float* __restrict__ tables, int kt,
    const float* __restrict__ bg, int tw, int ts, float* __restrict__ out,
    float* __restrict__ alpha_out, float* __restrict__ logt_out,
    float* __restrict__ ncomp_out) {
  composite_tile<C>(blockIdx.x, TableRows{tables, kt}, counts, bg, tw, ts, out, alpha_out,
                    logt_out, ncomp_out);
}

// Tile of this CTA in a grid of two-CTA clusters: 2 clusterid.x + cluster_ctarank.
__device__ __forceinline__ int cluster_pair_tile() {
  unsigned cluster, rank;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(cluster));
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  return 2 * (int)cluster + (int)rank;
}

// K5: two tiles per two-CTA cluster.
template <int C>
__global__ void __launch_bounds__(1024, 1) composite_pairs_fwd2_kernel(
    const int32_t* __restrict__ pair_gidx, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ counts, const float* __restrict__ attrs,
    const float* __restrict__ bg, int num_tiles, int tw, int ts, float* __restrict__ out,
    float* __restrict__ alpha_out, float* __restrict__ logt_out,
    float* __restrict__ ncomp_out) {
  const int t = cluster_pair_tile();
  if (t >= num_tiles) return;  // the phantom CTA of an odd tile count: before any barrier
  composite_tile<C>(t, PairRows{pair_gidx, starts, attrs}, counts, bg, tw, ts, out, alpha_out,
                    logt_out, ncomp_out);
}

cudaLaunchConfig_t pair_config(int num_tiles, int p, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * ((num_tiles + 1) / 2));
  cfg.blockDim = dim3(p);
  cfg.dynamicSmemBytes = 0;
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
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = pair_config(num_tiles, ts * ts, s, &attr);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, composite_pairs_fwd2_kernel<C>, (const int32_t*)pair_gidx, (const int32_t*)starts,
      (const int32_t*)counts, (const float*)attrs, (const float*)bg, num_tiles, tw, ts,
      (float*)out, (float*)alpha, (float*)logt, (float*)ncomp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int C>
int max_clusters_fwd2(int ts, int* n) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = pair_config(2, ts * ts, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(n, composite_pairs_fwd2_kernel<C>, &cfg);
}

}  // namespace

// Launches K1 on `stream` (a cudaStream_t) and returns cudaGetLastError(); 0 is success.
// Pointers are device pointers: pair_gidx (B,), starts (T,), counts (T,) int32 with
// counts[t] <= B - starts[t]; attrs (N, 6 + C), bg (C,) float32; outputs out (T, ts*ts, C),
// alpha / logt / ncomp (T, ts*ts) float32.
extern "C" int ggt_composite_pairs_fwd(const void* pair_gidx, const void* starts,
                                       const void* counts, const void* attrs, const void* bg,
                                       int num_tiles, int tw, int ts, int channels, void* out,
                                       void* alpha, void* logt, void* ncomp, void* stream) {
  const int p = ts * ts;
  if (num_tiles <= 0 || p < 1 || p > 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(num_tiles), block(p);
  cudaStream_t s = (cudaStream_t)stream;
#define GGT_LAUNCH(CH)                                                                   \
  composite_pairs_fwd_kernel<CH><<<grid, block, 0, s>>>(                                \
      (const int32_t*)pair_gidx, (const int32_t*)starts, (const int32_t*)counts,         \
      (const float*)attrs, (const float*)bg, tw, ts, (float*)out, (float*)alpha,         \
      (float*)logt, (float*)ncomp)
  switch (channels) {
    case 3: GGT_LAUNCH(3); break;
    case 39: GGT_LAUNCH(39); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef GGT_LAUNCH
  return (int)cudaGetLastError();
}

// Launches K3 on `stream` and returns cudaGetLastError(); 0 is success. Device pointers: counts
// (T,) int32 with 0 <= counts[t] <= kt; tables (T, kt, 6 + C), bg (C,) float32; outputs as K1's.
extern "C" int ggt_composite_tables_fwd(const void* counts, const void* tables, const void* bg,
                                        int num_tiles, int kt, int tw, int ts, int channels,
                                        void* out, void* alpha, void* logt, void* ncomp,
                                        void* stream) {
  const int p = ts * ts;
  if (num_tiles <= 0 || kt < 0 || p < 1 || p > 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(num_tiles), block(p);
  cudaStream_t s = (cudaStream_t)stream;
#define GGT_LAUNCH(CH)                                                                      \
  composite_tables_fwd_kernel<CH><<<grid, block, 0, s>>>(                                  \
      (const int32_t*)counts, (const float*)tables, kt, (const float*)bg, tw, ts, (float*)out, \
      (float*)alpha, (float*)logt, (float*)ncomp)
  switch (channels) {
    case 3: GGT_LAUNCH(3); break;
    case 7: GGT_LAUNCH(7); break;
    case 39: GGT_LAUNCH(39); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef GGT_LAUNCH
  return (int)cudaGetLastError();
}

// Launches K5 (same arguments and outputs as K1) in two-CTA clusters; returns the CUDA error.
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

// cudaOccupancyMaxActiveClusters for K5 at this channel count and tile size: how many two-CTA
// clusters the card can hold at once (0: it cannot launch). Returns the CUDA error.
extern "C" int ggt_composite_pairs_fwd2_max_clusters(int channels, int ts, int* n) {
  if (ts * ts < 1 || ts * ts > 1024) return (int)cudaErrorInvalidValue;
  switch (channels) {
    case 3: return max_clusters_fwd2<3>(ts, n);
    case 39: return max_clusters_fwd2<39>(ts, n);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ggt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
