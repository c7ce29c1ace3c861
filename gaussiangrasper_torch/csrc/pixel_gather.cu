// The EFD loss's pixel gather and its VJP, for Hopper (sm_90a): feats = fea[idx[:, 0], idx[:, 1]]
// (models/model.py, train_loss: the contrastive pairs' two ends and the distillation points, one
// fused read of the rendered feature map).
//
// Replaces no TPU kernel: the JAX package's gather is an XLA op. The port first ran it as torch's
// advanced index, whose backward on the card is autograd's index_put with accumulate: a radix
// sort of every row's pixel key, then a serial walk of each run of equal keys in one warp. The
// sampler pads the groups a view's instances leave empty with pixel (0, 0) (data/manager.py), so
// on the 4-instance tabletop 44,800 of the step's 52,200 rows are one key, walked one by one.
//
// Inputs: fea, an (H, W, F) float32 view with any strides (the composited image's feature
// channels: pixel stride 39 floats, starting 12 bytes into each pixel, so not float4-aligned),
// and idx, (N, 2) int32 (row, col), contiguous. A negative index counts from the end, as torch's
// does; one outside the image fails a device assertion, as torch's index kernel does.
//
// pixel_gather_fwd_kernel: one thread per (row, channel), channels fastest, so a warp reads a
// pixel's consecutive channels (coalesced in the view whatever its alignment) and writes the
// (N, F) output contiguously. A copy: the output is bit-equal to the plain read.
//
// pixel_gather_bwd_kernel<V>: adds each row of g_out (N, F) into its pixel of g_fea (H, W, F),
// contiguous and zero-filled by the caller. A warp holds 32 consecutive rows at one group of V
// channels (V = 4, 2 or 1: the widest that F and both pointers' alignment allow), the warps of a
// block the channel groups of the same rows. Lanes whose pixel is equal are merged first:
// __match_any_sync groups them, the group's lowest lane sums the group's values in ascending lane
// order by shuffles, then adds the sum by one V-wide float atomic (sm_90's float2 / float4
// atomicAdd). So a warp of 32 padding rows makes one atomic per channel group, not 32, and only
// rows of different warps meet in the atomics. Within a warp the order is fixed; across warps the
// atomics' order, and so the gradient's last bits, varies from run to run.

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kNoPixel = -1;  // a lane past the last row

// row r's pixel (y, x), negative indices wrapped as torch wraps them
__device__ __forceinline__ int2 pixel_of(const int* __restrict__ idx, int r, int h, int w) {
  int y = idx[2 * (size_t)r], x = idx[2 * (size_t)r + 1];
  if (y < 0) y += h;
  if (x < 0) x += w;
  assert(y >= 0 && y < h && x >= 0 && x < w);  // "index out of bounds", as torch's kernel asserts
  return make_int2(y, x);
}

__global__ void __launch_bounds__(kThreads) pixel_gather_fwd_kernel(
    const float* __restrict__ fea, const int* __restrict__ idx, int n, int f, int h, int w,
    long long stride_h, long long stride_w, long long stride_c, float* __restrict__ out) {
  const size_t t = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (size_t)n * f) return;
  const int r = (int)(t / f), c = (int)(t - (size_t)r * f);
  const int2 p = pixel_of(idx, r, h, w);
  out[t] = fea[p.x * stride_h + p.y * stride_w + c * stride_c];
}

template <int V>
__device__ __forceinline__ void atomic_add(float* p, const float (&v)[V]) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (V == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
#else
#pragma unroll
  for (int k = 0; k < V; ++k) atomicAdd(p + k, v[k]);
#endif
}

template <int V>
__global__ void __launch_bounds__(kThreads) pixel_gather_bwd_kernel(
    const int* __restrict__ idx, const float* __restrict__ g_out, int n, int f, int h, int w,
    float* __restrict__ g_fea) {
  const int lane = threadIdx.x;
  const int q = blockIdx.y * blockDim.y + threadIdx.y;  // the warp's channel group
  if (q * V >= f) return;  // a whole warp: the merges below see all 32 lanes
  const int r = blockIdx.x * 32 + lane;
  const bool live = r < n;
  long long pixel = kNoPixel;  // the linear index into (H, W)
  if (live) {
    const int2 p = pixel_of(idx, r, h, w);
    pixel = (long long)p.x * w + p.y;
  }
  float v[V];
  if (live) {
    const float* src = g_out + (size_t)r * f + q * V;
    if constexpr (V == 4) {
      const float4 a = *reinterpret_cast<const float4*>(src);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    } else if constexpr (V == 2) {
      const float2 a = *reinterpret_cast<const float2*>(src);
      v[0] = a.x, v[1] = a.y;
    } else {
      v[0] = *src;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = 0.f;
  }
  // each lane sums the values of its group's lanes above it, in ascending lane order; the
  // group's lowest lane ends with the group's sum
  const unsigned peers = __match_any_sync(kFull, pixel);
  unsigned rest = peers & (lane == 31 ? 0u : kFull << (lane + 1));
  float sum[V];
#pragma unroll
  for (int k = 0; k < V; ++k) sum[k] = v[k];
  while (__any_sync(kFull, rest != 0)) {
    const int from = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float s = __shfl_sync(kFull, v[k], from);
      if (rest) sum[k] += s;
    }
    rest &= rest - 1;
  }
  if (live && lane == __ffs(peers) - 1) atomic_add<V>(g_fea + (size_t)pixel * f + q * V, sum);
}

template <int V>
void launch_bwd(const int* idx, const float* g_out, int n, int f, int h, int w, float* g_fea,
                cudaStream_t s) {
  const int groups = f / V;
  const int warps = groups < kWarps ? groups : kWarps;
  const dim3 grid((n + 31) / 32, (groups + warps - 1) / warps);
  pixel_gather_bwd_kernel<V><<<grid, dim3(32, warps), 0, s>>>(idx, g_out, n, f, h, w, g_fea);
}

bool aligned(const void* p, size_t bytes) { return ((uintptr_t)p & (bytes - 1)) == 0; }

int launch_check() { return (int)cudaGetLastError(); }

}  // namespace

// The entries check nothing: the Python wrappers (ops/pixel_gather.py) validate the shapes and
// return before a launch where n or f is 0. Strides are in floats.
extern "C" int ggt_pixel_gather_fwd(const void* fea, const void* idx, int n, int f, int h, int w,
                                    long long stride_h, long long stride_w, long long stride_c,
                                    void* out, void* stream) {
  const size_t total = (size_t)n * f;
  pixel_gather_fwd_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                            (cudaStream_t)stream>>>((const float*)fea, (const int*)idx, n, f, h, w,
                                                    stride_h, stride_w, stride_c, (float*)out);
  return launch_check();
}

// g_out (N, F) contiguous; g_fea (H, W, F) contiguous and zero-filled by the caller.
extern "C" int ggt_pixel_gather_bwd(const void* idx, const void* g_out, int n, int f, int h, int w,
                                    void* g_fea, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int* i = (const int*)idx;
  const float* g = (const float*)g_out;
  float* out = (float*)g_fea;
  if (f % 4 == 0 && aligned(g, 16) && aligned(out, 16)) {
    launch_bwd<4>(i, g, n, f, h, w, out, s);
  } else if (f % 2 == 0 && aligned(g, 8) && aligned(out, 8)) {
    launch_bwd<2>(i, g, n, f, h, w, out, s);
  } else {
    launch_bwd<1>(i, g, n, f, h, w, out, s);
  }
  return launch_check();
}

extern "C" const char* ggt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
