// Platform probes for Hopper (sm_90a): the counterparts of the JAX package's TPU probes, which
// exist to show that the toolchain builds and launches a kernel on the card and that a kernel can
// move row blocks at dynamic, unaligned offsets.
//
//   P1 affine_kernel replaces pallas_probe.py:38 `kernel` (the minimal Mosaic
//      compile-and-run probe): o = 2 x + 1, one thread per element.
//   P2 read_at_kernel replaces dma_probe.py:37 `_read_kernel`: block t of the output
//      (T, 128, 128) is rows [starts[t], starts[t] + 128) of x (rows, 128). The TPU probe proves
//      `make_async_copy` from HBM at a dynamic, unaligned row offset; the Hopper counterpart is
//      the bulk copy engine (1-D TMA): one thread issues `cp.async.bulk.shared::cluster.global`
//      of the whole 64 KB block into shared memory, completion lands on an mbarrier (expect_tx of
//      the block's bytes, phase 0), and the CTA then stores the block coalesced, 16 bytes a
//      thread. A row is 512 B, so every row offset meets the copy's 16-byte alignment.
//   P3 write_at_kernel replaces dma_probe.py:65 `_write_kernel`: block t of vals
//      (T, 128, 128) is written to rows [starts[t], starts[t] + 128) of out, and where blocks
//      overlap the later block wins. The TPU grid runs its steps in order, so the last write
//      lands last; CUDA blocks run in no order, so the kernel computes the function instead: row
//      r comes from block max{t : s_t <= r < s_t + 128}, and each CTA writes only the rows of
//      its block that no later block covers (a scan of the later starts per row). Rows that no
//      block covers are left as the caller allocated them.
//
// Bound on this card (H100 SXM, 3.35 TB/s): each probe moves a few hundred KB at most (P1 8 KB,
// P2 and P3 192 KB of blocks each way in the probe's calls), at most 0.12 us by bytes, far below
// a kernel launch. Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W (CUDA events around
// one call): 28-43 us each, the host's launch path (the ctypes call and the output's
// allocation); the card's own share was not measured apart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;  // rows per block (the TPU probe's KC)
constexpr int kCols = 128;  // floats per row
constexpr unsigned kBlockBytes = kRows * kCols * sizeof(float);  // 64 KB
constexpr int kThreads = 256;

__global__ void affine_kernel(const float* __restrict__ x, int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __fadd_rn(__fmul_rn(x[i], 2.f), 1.f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__global__ void __launch_bounds__(kThreads) read_at_kernel(const float* __restrict__ x,
                                                           const int32_t* __restrict__ starts,
                                                           float* __restrict__ out) {
  extern __shared__ __align__(128) float s_blk[];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t b = smem_addr(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float* src = x + (size_t)starts[blockIdx.x] * kCols;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
                 "r"(kBlockBytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(s_blk)), "l"(src), "r"(kBlockBytes), "r"(b)
        : "memory");
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(b), "r"(0)
        : "memory");
  }
  const float4* s = reinterpret_cast<const float4*>(s_blk);
  float4* dst = reinterpret_cast<float4*>(out + (size_t)blockIdx.x * kRows * kCols);
  for (int i = threadIdx.x; i < kRows * kCols / 4; i += blockDim.x) dst[i] = s[i];
}

__global__ void __launch_bounds__(kThreads) write_at_kernel(const float* __restrict__ vals,
                                                            const int32_t* __restrict__ starts,
                                                            int num_blocks,
                                                            float* __restrict__ out) {
  const int t = blockIdx.x;
  const int s = starts[t];
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x / 32; i < kRows; i += blockDim.x / 32) {  // one row a warp
    const int r = s + i;
    bool later = false;
    for (int u = t + 1; u < num_blocks && !later; ++u) {
      const int su = starts[u];
      later = su <= r && r < su + kRows;
    }
    if (later) continue;
    const float4* src = reinterpret_cast<const float4*>(vals + ((size_t)t * kRows + i) * kCols);
    reinterpret_cast<float4*>(out + (size_t)r * kCols)[lane] = src[lane];
  }
}

}  // namespace

// Each entry launches on `stream` (a cudaStream_t) and returns the CUDA error code; 0 is
// success. Pointers are device pointers.

// P1: out[i] = 2 x[i] + 1 for i < n; x, out float32.
extern "C" int ggt_probe_affine(const void* x, int n, void* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  affine_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, n, (float*)out);
  return (int)cudaGetLastError();
}

// P2: x (rows, 128) float32, 16-byte aligned; starts (T,) int32 with 0 <= starts[t] <= rows - 128;
// out (T, 128, 128) float32.
extern "C" int ggt_probe_read_at(const void* x, const void* starts, int num_blocks, void* out,
                                 void* stream) {
  if (num_blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(read_at_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kBlockBytes);
  if (err != cudaSuccess) return (int)err;
  read_at_kernel<<<num_blocks, kThreads, kBlockBytes, (cudaStream_t)stream>>>(
      (const float*)x, (const int32_t*)starts, (float*)out);
  return (int)cudaGetLastError();
}

// P3: vals (T, 128, 128) float32; starts (T,) int32 with 0 <= starts[t] <= rows - 128; out
// (rows, 128) float32, of which only the rows some block covers are written.
extern "C" int ggt_probe_write_at(const void* vals, const void* starts, int num_blocks, void* out,
                                  void* stream) {
  if (num_blocks <= 0) return (int)cudaErrorInvalidValue;
  write_at_kernel<<<num_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)vals, (const int32_t*)starts, num_blocks, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* ggt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
