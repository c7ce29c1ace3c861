// Backward of the per-tile compositing over the depth-sorted pair stream, for Hopper (sm_90a).
//
// Replaces rasterize_pallas.py:_bwd_pairs_kernel (K2) of the JAX package, launched there by
// _call_bwd_pairs from _composite_pairs_bwd. Inputs: the stream (pair_gidx, starts, counts),
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
// Design. One CTA per tile, one thread per pixel (ts 32 -> 1024 threads, so 64 registers a
// thread). A pixel's C = 39 upstream values would not fit in registers beside the walk, so the
// block stages g_out channel-major in shared memory (C x (P + 1) floats; the +1 keeps the
// transposing store free of bank conflicts). The walk covers rows [0, kmax), kmax the block's
// largest min(ncomp, count), in 128-row chunks from the last down: the chunk's rows are gathered
// through pair_gidx into shared memory (as K1 does), and a 128 x (6 + C) shared accumulator
// collects the row sums. For each row every thread computes its pixel's terms; a warp with any
// contributing lane reduces the 6 + C values in groups of 16 by a shuffle reduce-scatter
// (16 shuffles a group), and lanes 0-15 add the group's 16 sums to the accumulator with one
// shared-memory atomic instruction on 16 distinct addresses; the chunk's rows are then written
// once, coalesced. Float atomics make the order of the pixel sums vary from run to run, so the
// kernel agrees with the plain version to rounding, not bit for bit. The validity tests (sigma >= 0,
// alpha >= 1/255, o exp(-sigma) < 0.999) use K1's explicitly rounded operations, so they decide
// as the plain version does.
//
// Bound on this card (H100 SXM: 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s): each
// walked pair-pixel visit costs ~16 operations for sigma and alpha; each contributing visit
// adds log1p, two expf, the 2C-flop <c, g>, ~30 for dalpha and the conic chain, C products for
// dcolour and 6 + C adds for the pixel sums. chip_smoke.py computes the bound from the run's
// own visit counts; the kernel is bound by operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaCutoff = (float)(1.0 / 255.0);
constexpr int kBatch = 128;  // rows staged in shared memory per chunk
constexpr unsigned kFull = 0xffffffffu;

// Sums 16 values over the warp's 32 lanes and leaves the sum of value `lane & 15` in the
// lane: recursive halving (each level a lane keeps one half of its values and trades the other
// with its partner), 16 shuffles where 16 separate shuffle reductions take 80.
__device__ __forceinline__ float reduce_scatter16(float (&x)[16], int lane) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) {
    const bool hi = lane & o;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float send = hi ? x[i] : x[i + o];
      const float keep = hi ? x[i + o] : x[i];
      x[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  return x[0] + __shfl_xor_sync(kFull, x[0], 16);
}

template <int C>
size_t smem_bytes(int p) {
  return sizeof(float) * ((size_t)C * (p + 1) + 2 * (size_t)kBatch * (6 + C)) +
         sizeof(int32_t) * kBatch;
}

template <int C>
__global__ void __launch_bounds__(1024, 1) composite_pairs_bwd_kernel(
    const int32_t* __restrict__ pair_gidx, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ counts, const float* __restrict__ attrs,
    const float* __restrict__ bg, const float* __restrict__ g_out,
    const float* __restrict__ g_alpha, const float* __restrict__ logt,
    const float* __restrict__ ncomp, int tw, int ts, float* __restrict__ gpairs) {
  constexpr int A = 6 + C;
  extern __shared__ float smem[];
  __shared__ int s_kmax;
  const int P = blockDim.x;
  const int GS = P + 1;  // channel stride of the staged g_out
  float* s_g = smem;                 // C x GS
  float* s_attr = s_g + C * GS;      // kBatch x A
  float* s_acc = s_attr + kBatch * A;  // kBatch x A
  int32_t* s_gid = (int32_t*)(s_acc + kBatch * A);

  const int t = blockIdx.x;
  const int lin = threadIdx.x;
  const int lane = lin & 31;
  const int start = starts[t];
  const int count = counts[t];
  const float px = (float)((t % tw) * ts + lin % ts);
  const float py = (float)((t / tw) * ts + lin / ts);
  const size_t pix = (size_t)t * P + lin;

  // the tile's (P, C) block of g_out is contiguous: read it coalesced, store it transposed
  const float* gt = g_out + (size_t)t * P * C;
  for (int i = lin; i < P * C; i += P) {
    const int p = i / C;
    s_g[(i - p * C) * GS + p] = gt[i];
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
    __syncthreads();  // the previous chunk is written out
    for (int r = lin; r < n; r += P) s_gid[r] = pair_gidx[start + base + r];
    for (int i = lin; i < n * A; i += P) s_acc[i] = 0.f;
    __syncthreads();
    for (int i = lin; i < n * A; i += P) {
      const int r = i / A;
      s_attr[i] = attrs[(size_t)s_gid[r] * A + (i - r * A)];
    }
    __syncthreads();

    for (int j = n - 1; j >= 0; --j) {
      const float* row = s_attr + j * A;
      float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float w = 0.f;
      bool live = false;
      if (base + j < kstart) {
        const float dx = __fsub_rn(px, row[0]);
        const float dy = __fsub_rn(py, row[1]);
        const float sa = __fmul_rn(__fmul_rn(row[2], dx), dx);
        const float sc = __fmul_rn(__fmul_rn(row[4], dy), dy);
        const float sb = __fmul_rn(__fmul_rn(row[3], dx), dy);
        const float sigma = __fadd_rn(__fmul_rn(0.5f, __fadd_rn(sa, sc)), sb);
        const float esig = expf(-sigma);
        const float raw = __fmul_rn(row[5], esig);
        const float a = fminf(kAlphaClamp, raw);
        if (sigma >= 0.f && a >= kAlphaCutoff) {
          live = true;
          const float lt = log1pf(-a);
          const float t_before = expf(logt_total - (suffix_comp + lt));
          w = a * t_before;
          float gc = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) gc = fmaf(row[6 + c], s_g[c * GS + lin], gc);
          const float wgc = w * gc;
          float dalpha = t_before * gc - (suffix_wgc + tail) / fmaxf(1.f - a, 1e-6f);
          if (!(w > 0.f) || !(raw < kAlphaClamp)) dalpha = 0.f;
          const float dsigma = -raw * dalpha;
          v[0] = -(row[2] * dx + row[3] * dy) * dsigma;
          v[1] = -(row[3] * dx + row[4] * dy) * dsigma;
          v[2] = 0.5f * dx * dx * dsigma;
          v[3] = dx * dy * dsigma;
          v[4] = 0.5f * dy * dy * dsigma;
          v[5] = esig * dalpha;
          suffix_comp += lt;
          suffix_wgc += wgc;
        }
      }
      if (__any_sync(kFull, live)) {
        // the row's 6 + C values in groups of 16: lane l < 16 adds value 16 g + l
        float* acc = s_acc + j * A;
#pragma unroll
        for (int grp = 0; grp < (A + 15) / 16; ++grp) {
          float x[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int q = grp * 16 + i;
            x[i] = q < 6 ? v[q < 6 ? q : 0] : (q < A && live ? w * s_g[(q - 6) * GS + lin] : 0.f);
          }
          const float s = reduce_scatter16(x, lane);
          if (lane < 16 && grp * 16 + lane < A) atomicAdd(acc + grp * 16 + lane, s);
        }
      }
    }
    __syncthreads();
    float* dst = gpairs + (size_t)(start + base) * A;
    for (int i = lin; i < n * A; i += P) dst[i] = s_acc[i];
  }
}

template <int C>
int launch(const void* pair_gidx, const void* starts, const void* counts, const void* attrs,
           const void* bg, const void* g_out, const void* g_alpha, const void* logt,
           const void* ncomp, int num_tiles, int tw, int ts, void* gpairs, cudaStream_t s) {
  const int p = ts * ts;
  const size_t bytes = smem_bytes<C>(p);
  cudaError_t err = cudaFuncSetAttribute(composite_pairs_bwd_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  composite_pairs_bwd_kernel<C><<<num_tiles, p, bytes, s>>>(
      (const int32_t*)pair_gidx, (const int32_t*)starts, (const int32_t*)counts,
      (const float*)attrs, (const float*)bg, (const float*)g_out, (const float*)g_alpha,
      (const float*)logt, (const float*)ncomp, tw, ts, (float*)gpairs);
  return (int)cudaGetLastError();
}

}  // namespace

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
  if (num_tiles <= 0 || p < 32 || p > 1024 || p % 32 != 0) return (int)cudaErrorInvalidValue;
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

extern "C" const char* ggt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
