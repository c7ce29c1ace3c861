// Multiresolution hash-grid lookup and its VJP, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes the lookup (models/encodings.py,
// hash_grid_encode) in XLA ops, and the port first ran it as plain torch ops, whose backward on
// the card is autograd's index_put with accumulate: a radix sort of every corner row, then a
// serial walk of each run of equal rows in one warp. At the coarse levels (resolution 16 has at
// most 17^3 cells) thousands of corners land on one row, so those walks are long.
//
// Inputs: x (N, 3) in [0, 1], the table (L, T, 2), the level resolutions (L,). Output (N, 2 L):
// point n, level l at columns 2 l, 2 l + 1. One thread per (point, level), the level in
// blockIdx.y, so the lanes of a warp hold consecutive points at one level: consecutive samples
// of one ray, which share cells at the coarse levels.
//
// locate() repeats the plain path's arithmetic (models/encodings.py, hash_indices) operation for
// operation, each explicitly rounded so that nvcc contracts nothing into an FMA: pos = x res,
// the corner floor(pos), frac = pos - floor(pos), and each corner's row (c0 + i) ^ (c1 + j)
// 2654435761 ^ (c2 + k) 805459861 in uint32, mod T: the same rows, bit for bit. A corner's weight
// is (a0 a1) a2 with a_d = frac_d or 1 - frac_d, as the plain path takes it.
//
// hash_grid_fwd_kernel: the 8 corners' float2 entries (all 8 loads in flight before the sums), the
// weighted sum in the order of torch's CUDA sum over the corner axis (((p0 + p4) + (p1 + p5)) +
// (p2 + p6)) + (p3 + p7), corner c = 4 i + 2 j + k: the plain path's output on the card, bit for
// bit (torch 2.11; tests/test_torch_gpu.py holds it), one float2 store. Bound by the table
// reads: 8 random 8-byte reads a lookup, 32-byte sectors out of L2 (a level's table is at most
// 16 MB at T = 2^21 and its blocks run together, so the tables stay in L2).
//
// hash_grid_bwd_kernel: recomputes the corners and weights, reads dL/dout, and adds w dL/dout
// into the zeroed table gradient. Lanes of a warp whose corner row is equal are merged first
// (add_merged), and the group's lowest lane adds the group's sum by one float2 atomic. Only rows
// shared across warps meet in the atomics, so the coarse levels'
// contention shrinks by up to 32 times. The sum within a warp is in a fixed order; across warps
// the atomics' order, and so the gradient's last bits, varies from run to run.
// With kDx it also gives dL/dx: sum over corners of <dL/dout, table[row]> dw/dfrac_d, times
// res, the gradient that autograd takes through frac = pos - floor(pos); the levels' terms meet
// in three float atomics a (point, level).
//
// hash_grid_bwd2_kernel: the backward's own backward, for a gradient taken with create_graph
// (neus-facto's SDF gradient, which its eikonal loss differentiates again): from dL/d(dL/dx), the
// gradients of dL/dout, of the table and of x, in the same thread map, the table's merged and
// added as in the backward.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;
constexpr uint32_t kNoRow = 0xffffffffu;  // a lane past the last point: no table has 2^32 rows

struct Cell {
  uint32_t corner[3];  // floor(pos), wrapped to 32 bits as the plain path masks it
  float a[3][2];       // per axis: the weight of offset 0 (1 - frac) and of offset 1 (frac)
};

__device__ __forceinline__ Cell locate(const float* __restrict__ x, int n, float res) {
  Cell cell;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fmul_rn(x[3 * (size_t)n + d], res);
    const float p0 = floorf(pos);
    const float frac = __fsub_rn(pos, p0);
    cell.corner[d] = (uint32_t)(long long)p0;
    cell.a[d][0] = __fsub_rn(1.f, frac);
    cell.a[d][1] = frac;
  }
  return cell;
}

// corner c = 4 i + 2 j + k: the plain path's _OFFSETS order
__device__ __forceinline__ uint32_t corner_row(const Cell& cell, int c, uint32_t size, bool pow2) {
  const uint32_t h = (cell.corner[0] + ((c >> 2) & 1)) ^
                     ((cell.corner[1] + ((c >> 1) & 1)) * kPrime1) ^
                     ((cell.corner[2] + (c & 1)) * kPrime2);
  return pow2 ? (h & (size - 1)) : (h % size);
}

__device__ __forceinline__ float corner_weight(const Cell& cell, int c) {
  return __fmul_rn(__fmul_rn(cell.a[0][(c >> 2) & 1], cell.a[1][(c >> 1) & 1]), cell.a[2][c & 1]);
}

__device__ __forceinline__ void add_float2(float* p, float2 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(reinterpret_cast<float2*>(p), v);
#else
  atomicAdd(p, v.x);
  atomicAdd(p + 1, v.y);
#endif
}

__global__ void __launch_bounds__(kThreads) hash_grid_fwd_kernel(
    const float* __restrict__ x, const float2* __restrict__ table, const float* __restrict__ res,
    int n, int levels, uint32_t size, float2* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int l = blockIdx.y;
  if (i >= n) return;
  const bool pow2 = (size & (size - 1)) == 0;
  const Cell cell = locate(x, i, res[l]);
  const float2* tl = table + (size_t)l * size;
  float2 v[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = tl[corner_row(cell, c, size, pow2)];
  // torch's CUDA sum over the 8 corners keeps four accumulators (corners c and c + 4), then
  // adds them in order; the same order makes this output bit-equal to the plain path's there
  float2 acc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float w0 = corner_weight(cell, c), w1 = corner_weight(cell, c + 4);
    acc[c].x = __fadd_rn(__fmul_rn(w0, v[c].x), __fmul_rn(w1, v[c + 4].x));
    acc[c].y = __fadd_rn(__fmul_rn(w0, v[c].y), __fmul_rn(w1, v[c + 4].y));
  }
  out[(size_t)i * levels + l] = make_float2(
      __fadd_rn(__fadd_rn(__fadd_rn(acc[0].x, acc[1].x), acc[2].x), acc[3].x),
      __fadd_rn(__fadd_rn(__fadd_rn(acc[0].y, acc[1].y), acc[2].y), acc[3].y));
}

// Adds v into row `row` of one level's table gradient g_level (T, 2), merged across the warp:
// __match_any_sync groups the lanes whose row is equal, each lane sums the values of the group's
// lanes above it in ascending lane order by shuffles, and the group's lowest lane adds the group's
// sum by one float2 atomic. Every lane of the warp calls it; a lane past the last point passes
// kNoRow and adds nothing.
__device__ __forceinline__ void add_merged(float* g_level, uint32_t row, float2 v, int lane) {
  const unsigned peers = __match_any_sync(kFull, row);
  unsigned rest = peers & (lane == 31 ? 0u : kFull << (lane + 1));
  float2 sum = v;
  while (__any_sync(kFull, rest != 0)) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    const float sx = __shfl_sync(kFull, v.x, src);
    const float sy = __shfl_sync(kFull, v.y, src);
    if (rest) {
      sum.x += sx;
      sum.y += sy;
      rest &= rest - 1;
    }
  }
  if (row != kNoRow && lane == __ffs(peers) - 1) add_float2(g_level + 2 * (size_t)row, sum);
}

template <bool kDx>
__global__ void __launch_bounds__(kThreads) hash_grid_bwd_kernel(
    const float* __restrict__ x, const float2* __restrict__ table, const float* __restrict__ res,
    const float2* __restrict__ g_out, int n, int levels, uint32_t size, float* __restrict__ g_table,
    float* __restrict__ g_x) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int l = blockIdx.y;
  const int lane = threadIdx.x & 31;
  // no early return: every lane of the warp takes part in the merges
  const bool live = i < n;
  const bool pow2 = (size & (size - 1)) == 0;
  const float r = res[l];
  const Cell cell = locate(x, live ? i : 0, r);
  const float2 g = live ? g_out[(size_t)i * levels + l] : make_float2(0.f, 0.f);
  const float2* tl = table + (size_t)l * size;
  float* gl = g_table == nullptr ? nullptr : g_table + 2 * (size_t)l * size;
  float dfrac[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint32_t row = live ? corner_row(cell, c, size, pow2) : kNoRow;
    const float w = corner_weight(cell, c);
    if (kDx && live) {
      const float2 t = tl[row];
      const float s = g.x * t.x + g.y * t.y;
      const int o[3] = {(c >> 2) & 1, (c >> 1) & 1, c & 1};
      const float d0 = cell.a[1][o[1]] * cell.a[2][o[2]];
      const float d1 = cell.a[0][o[0]] * cell.a[2][o[2]];
      const float d2 = cell.a[0][o[0]] * cell.a[1][o[1]];
      dfrac[0] += o[0] ? s * d0 : -s * d0;
      dfrac[1] += o[1] ? s * d1 : -s * d1;
      dfrac[2] += o[2] ? s * d2 : -s * d2;
    }
    if (gl != nullptr) add_merged(gl, row, make_float2(w * g.x, w * g.y), lane);
  }
  if (kDx && live) {
#pragma unroll
    for (int d = 0; d < 3; ++d) atomicAdd(g_x + 3 * (size_t)i + d, dfrac[d] * r);
  }
}

// The backward's own backward, from gg_x = dL/d(dL/dx) (N, 3): the gradients that L takes through
// dL/dx. With sgn_d = +1 for offset 1 and -1 for offset 0, a corner's dw/dfrac_d is sgn_d times
// the other two axes' a, and u = res sum_d gg_x_d dw/dfrac_d is the corner's weight in dL/dx. So
//   dL/dg_out = sum_c u_c table[row_c]               (gg_out (N, 2 L), one float2 store a lookup)
//   dL/dtable += u_c g_out at row_c                    (merged and added as in the backward)
//   dL/dx_e   += res sum_c <g_out, table[row_c]> du_c/dfrac_e,
//                du_c/dfrac_e = res sgn_e sum_{d != e} gg_x_d sgn_d a_f (f the third axis)
// gg_out or g_table may be null where not wanted; g_x is written with kDx.
template <bool kDx>
__global__ void __launch_bounds__(kThreads) hash_grid_bwd2_kernel(
    const float* __restrict__ x, const float2* __restrict__ table, const float* __restrict__ res,
    const float2* __restrict__ g_out, const float* __restrict__ gg_x, int n, int levels,
    uint32_t size, float2* __restrict__ gg_out, float* __restrict__ g_table,
    float* __restrict__ g_x) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int l = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const bool live = i < n;
  const bool pow2 = (size & (size - 1)) == 0;
  const float r = res[l];
  const Cell cell = locate(x, live ? i : 0, r);
  const float2 g = live ? g_out[(size_t)i * levels + l] : make_float2(0.f, 0.f);
  float q[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) q[d] = live ? gg_x[3 * (size_t)i + d] : 0.f;
  const float2* tl = table + (size_t)l * size;
  float* gl = g_table == nullptr ? nullptr : g_table + 2 * (size_t)l * size;
  const bool reads = gg_out != nullptr || kDx;
  float2 acc = make_float2(0.f, 0.f);
  float dfrac[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint32_t row = live ? corner_row(cell, c, size, pow2) : kNoRow;
    const float a0 = cell.a[0][(c >> 2) & 1], a1 = cell.a[1][(c >> 1) & 1], a2 = cell.a[2][c & 1];
    const float s0 = (c >> 2) & 1 ? 1.f : -1.f, s1 = (c >> 1) & 1 ? 1.f : -1.f,
                s2 = c & 1 ? 1.f : -1.f;
    const float u = r * (s0 * q[0] * (a1 * a2) + s1 * q[1] * (a0 * a2) + s2 * q[2] * (a0 * a1));
    const float2 t = reads && live ? tl[row] : make_float2(0.f, 0.f);
    acc.x += u * t.x;
    acc.y += u * t.y;
    if (kDx) {
      const float p = g.x * t.x + g.y * t.y;
      dfrac[0] += p * s0 * (s1 * q[1] * a2 + s2 * q[2] * a1);
      dfrac[1] += p * s1 * (s0 * q[0] * a2 + s2 * q[2] * a0);
      dfrac[2] += p * s2 * (s0 * q[0] * a1 + s1 * q[1] * a0);
    }
    if (gl != nullptr) add_merged(gl, row, make_float2(u * g.x, u * g.y), lane);
  }
  if (live && gg_out != nullptr) gg_out[(size_t)i * levels + l] = acc;
  if (kDx && live) {
#pragma unroll
    for (int d = 0; d < 3; ++d) atomicAdd(g_x + 3 * (size_t)i + d, dfrac[d] * (r * r));
  }
}

int launch_check() { return (int)cudaGetLastError(); }

}  // namespace

// The entries check nothing: the Python wrappers (models/encodings.py) validate the shapes.
extern "C" int ggt_hash_grid_fwd(const void* x, const void* table, const void* res, int n,
                                 int levels, int size, void* out, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, levels);
  hash_grid_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float2*)table, (const float*)res, n, levels, (uint32_t)size,
      (float2*)out);
  return launch_check();
}

// g_table (L, T, 2) and g_x (N, 3) zero-filled by the caller; either may be null, where that
// gradient is not wanted (g_x null: no dL/dx, and the table is not read).
extern "C" int ggt_hash_grid_bwd(const void* x, const void* table, const void* res,
                                 const void* g_out, int n, int levels, int size, void* g_table,
                                 void* g_x, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, levels);
  if (g_x != nullptr) {
    hash_grid_bwd_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float2*)table, (const float*)res, (const float2*)g_out, n, levels,
        (uint32_t)size, (float*)g_table, (float*)g_x);
  } else {
    hash_grid_bwd_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float2*)table, (const float*)res, (const float2*)g_out, n, levels,
        (uint32_t)size, (float*)g_table, nullptr);
  }
  return launch_check();
}

// gg_out (N, 2 L) written whole; g_table (L, T, 2) and g_x (N, 3) zero-filled by the caller; each
// may be null, where that gradient is not wanted.
extern "C" int ggt_hash_grid_bwd2(const void* x, const void* table, const void* res,
                                  const void* g_out, const void* gg_x, int n, int levels, int size,
                                  void* gg_out, void* g_table, void* g_x, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, levels);
  if (g_x != nullptr) {
    hash_grid_bwd2_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float2*)table, (const float*)res, (const float2*)g_out,
        (const float*)gg_x, n, levels, (uint32_t)size, (float2*)gg_out, (float*)g_table,
        (float*)g_x);
  } else {
    hash_grid_bwd2_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float2*)table, (const float*)res, (const float2*)g_out,
        (const float*)gg_x, n, levels, (uint32_t)size, (float2*)gg_out, (float*)g_table,
        nullptr);
  }
  return launch_check();
}

extern "C" const char* ggt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
