// Forward per-tile compositing over the depth-sorted pair stream, for Hopper (sm_90a).
//
// Replaces rasterize_pallas.py:_fwd_pairs_kernel (K1) of the JAX package, launched there
// by _call_fwd_pairs. Same inputs, same four outputs:
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
// stops walking at its cut. Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W: 2.93 ms,
// 8.6x the bound. ptxas: C = 39 uses 64 registers (the cap at 1024 threads), 0 spills, 23.5 KB
// static shared memory; C = 3 uses 28 registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaCutoff = (float)(1.0 / 255.0);
constexpr float kLogEps = -9.2103403719761836f;  // log(1e-4)
constexpr int kWalkChunk = 128;                  // K1's KC: the rounding of an uncut ncomp
constexpr int kBatch = 128;                      // rows staged in shared memory per batch

template <int C>
__global__ void __launch_bounds__(1024, 1) composite_pairs_fwd_kernel(
    const int32_t* __restrict__ pair_gidx, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ counts, const float* __restrict__ attrs,
    const float* __restrict__ bg, int tw, int ts, float* __restrict__ out,
    float* __restrict__ alpha_out, float* __restrict__ logt_out,
    float* __restrict__ ncomp_out) {
  constexpr int A = 6 + C;
  __shared__ float s_attr[kBatch * A];
  __shared__ int32_t s_gid[kBatch];

  const int t = blockIdx.x;
  const int lin = threadIdx.x;
  const int nthreads = blockDim.x;
  const int start = starts[t];
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
    for (int r = lin; r < n; r += nthreads) s_gid[r] = pair_gidx[start + base + r];
    __syncthreads();
    for (int i = lin; i < n * A; i += nthreads) {
      const int r = i / A;
      s_attr[i] = attrs[(size_t)s_gid[r] * A + (i - r * A)];
    }
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

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns cudaGetLastError(); 0 is success.
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

extern "C" const char* ggt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
