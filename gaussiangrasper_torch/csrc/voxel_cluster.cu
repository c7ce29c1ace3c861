// 26-connected components of occupied voxels, for Hopper (sm_90a): the grasp request's cluster
// (scripts/grasp.py, largest_cluster).
//
// Replaces no TPU kernel: the JAX package labels the voxels on the host, a union-find in Python
// (scripts/grasp.py, largest_cluster), as the port did before this kernel; at ~8,300 voxels that
// is ~216k interpreted iterations a request.
//
// Inputs: the occupied voxels' linear keys in C order of a grid of dims (d0, d1, d2), int64,
// strictly increasing, n of them. Output: roots (n,) int32, each voxel's component as the index
// of its lowest voxel in raster order; parent (n,) int32 is scratch.
//
// init_kernel: parent[i] = i.
//
// union_kernel: one thread per (voxel, forward offset), the offset in blockIdx.y. The 13 offsets
// (a, b, c) whose key step (a d1 + b) d2 + c is positive, so each edge of the 26-neighbourhood is
// visited once, from its lower end. A neighbour off the grid is skipped; one on it is looked up
// by binary search in keys[i + 1, i + 1 + step): the keys are distinct integers, so the
// neighbour's index exceeds i by at most its key's step. One thread an offset, not a voxel: at
// ~8,300 voxels one thread a voxel fills 33 blocks of the 132 SMs and runs its 13 searches one
// after another. A found neighbour is joined lock-free: find both roots (path halving), then link
// the larger root under the smaller by atomicCAS on the larger's parent, and where that root has
// gained a parent since, climb on from it and try again. Links only ever point from a root to a
// smaller index, so every set's root is its smallest member, and the roots that come out do not
// depend on the order in which the threads meet.
//
// flatten_kernel, after every union: roots[i] = find(i). The halving writes race with other
// threads' but each writes an ancestor of its node, so every path still ends at its root; the
// output is a separate array, written by one thread an entry, which a halving write cannot touch.
//
// Bound by launch latency at the grasp request's size (three launches, ~108k short threads).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kForward = 13;

__global__ void init_kernel(int* __restrict__ parent, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) parent[i] = i;
}

// the root of i, pointing each node on the way at its grandparent (path halving)
__device__ __forceinline__ int find(volatile int* parent, int i) {
  while (true) {
    const int p = parent[i];
    if (p == i) return i;
    const int g = parent[p];
    if (g == p) return p;
    parent[i] = g;
    i = g;
  }
}

__device__ __forceinline__ void unite(volatile int* parent, int i, int j) {
  int a = find(parent, i), b = find(parent, j);
  while (a != b) {
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicCAS(const_cast<int*>(parent + b), b, a);
    if (old == b) return;
    b = find(parent, old);  // b gained a parent since its find: climb on from it
    a = find(parent, a);
  }
}

__global__ void union_kernel(const long long* __restrict__ keys, int n, long long d0,
                             long long d1, long long d2, int* parent) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = blockIdx.y;  // 0-8: a = 1; 9-11: a = 0, b = 1; 12: a = b = 0, c = 1
  const int a = k < 9 ? 1 : 0;
  const int b = k < 9 ? k / 3 - 1 : (k < 12 ? 1 : 0);
  const int c = k < 9 ? k % 3 - 1 : (k < 12 ? k - 10 : 1);
  const long long key = keys[i];
  const long long z = key % d2, rest = key / d2;
  const long long y = rest % d1, x = rest / d1;
  if (x + a >= d0 || y + b < 0 || y + b >= d1 || z + c < 0 || z + c >= d2) return;
  const long long step = (a * d1 + b) * d2 + c;
  const long long want = key + step;
  // lower bound of want in keys[lo, hi)
  int lo = i + 1;
  int hi = (int)min((long long)n, (long long)i + 1 + step);
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (keys[mid] < want) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (lo < n && keys[lo] == want) unite(parent, i, lo);
}

__global__ void flatten_kernel(int* parent, int n, int* __restrict__ roots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) roots[i] = find(parent, i);
}

int launch_check() { return (int)cudaGetLastError(); }

}  // namespace

// The entry checks nothing: the Python wrapper (ops/voxel_cluster.py) validates the keys and dims.
extern "C" int ggt_voxel_cluster(const void* keys, int n, long long d0, long long d1,
                                 long long d2, void* parent, void* roots, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (n + kThreads - 1) / kThreads;
  init_kernel<<<blocks, kThreads, 0, s>>>((int*)parent, n);
  union_kernel<<<dim3(blocks, kForward), kThreads, 0, s>>>((const long long*)keys, n, d0, d1, d2,
                                                           (int*)parent);
  flatten_kernel<<<blocks, kThreads, 0, s>>>((int*)parent, n, (int*)roots);
  return launch_check();
}

extern "C" const char* ggt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
