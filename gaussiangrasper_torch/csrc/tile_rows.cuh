// Where a tile's walk takes its rows from, for the per-tile bodies of the compositor kernels
// (composite_tile in composite_pairs_fwd.cu, grad_tile in composite_pairs_bwd.cu).
//
// A row is 6 + C floats: xy | conic (a, b, c) | opacity | colour. Row k of tile t's walk
// (0 <= k < counts[t]) sits at position start(t) + k of the row source; `stage` copies positions
// [first, first + n) into shared memory (n x A floats, n <= the caller's batch), with every
// thread of the CTA taking part. The caller synchronises before and after. The backward kernels
// add their per-row gradients into the same positions of their output (two CTAs a tile).
//
//   PairRows  (K1, K2, K5, K6): the tile's segment of the depth-sorted pair stream, positions
//             [starts[t], starts[t] + counts[t]) of pair_gidx, each naming a row of the
//             per-Gaussian table (N, A), gathered through the index (two steps: the indices,
//             then the rows).
//   TableRows (K3, K4): row k of tile t is row t * kt + k of the packed (T, kt, A) table that the
//             wrapper gathered once (rasterize_cuda.gather_tables), a contiguous copy.
// Both bodies are otherwise the same code, so K3 computes K1's arithmetic on the same rows and
// K4 K2's.

#pragma once

#include <stddef.h>
#include <stdint.h>

namespace {

struct PairRows {
  const int32_t* pair_gidx;
  const int32_t* starts;
  const float* attrs;

  __device__ __forceinline__ size_t start(int t) const { return (size_t)starts[t]; }

  // s_gid: kBatch ints of the caller's shared memory for the batch's indices.
  template <int A>
  __device__ __forceinline__ void stage(size_t first, int n, float* s_attr,
                                        int32_t* s_gid) const {
    for (int r = threadIdx.x; r < n; r += blockDim.x) s_gid[r] = pair_gidx[first + r];
    __syncthreads();
    for (int i = threadIdx.x; i < n * A; i += blockDim.x) {
      const int r = i / A;
      s_attr[i] = attrs[(size_t)s_gid[r] * A + (i - r * A)];
    }
  }
};

struct TableRows {
  const float* tables;
  int kt;  // the table's row stride per tile (its second dimension)

  __device__ __forceinline__ size_t start(int t) const { return (size_t)t * kt; }

  template <int A>
  __device__ __forceinline__ void stage(size_t first, int n, float* s_attr, int32_t*) const {
    const float* src = tables + first * A;
    for (int i = threadIdx.x; i < n * A; i += blockDim.x) s_attr[i] = src[i];
  }
};

}  // namespace
