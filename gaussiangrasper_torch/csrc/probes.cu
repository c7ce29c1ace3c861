// Platform probes for Hopper (sm_90a): the counterparts of the JAX package's TPU probes, which
// exist to show that the toolchain builds and launches a kernel on the card and that a kernel can
// move row blocks at dynamic, unaligned offsets.
//
//   P1 affine_kernel replaces pallas_probe.py:38 `kernel` (the minimal Mosaic
//      compile-and-run probe): o = 2 x + 1, one thread per element.
//   P2 read_at_kernel replaces dma_probe.py:37 `_read_kernel`: block t of the output
//      (T, 128, 128) is rows [starts[t], starts[t] + 128) of x (rows, 128). The TPU probe proves
//      `make_async_copy` from HBM at a dynamic, unaligned row offset; the Hopper counterpart is
//      the bulk copy engine (1-D TMA) both ways, with no thread moving data. Each block is cut
//      into 32 pieces of 4 rows (2 KB), one single-warp CTA a piece, so T blocks run on 32 T
//      SMs at once. Lane 0 arms an mbarrier with the piece's bytes (expect_tx, phase 0), issues
//      `cp.async.bulk.shared::cluster.global` from the row offset into shared memory, waits on
//      the barrier, then writes the piece back with the bulk store
//      (`cp.async.bulk.global.shared::cta.bulk_group`, commit_group, wait_group 0). A row is
//      512 B, so every row offset meets the copies' 16-byte alignment.
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
// a kernel launch, so each sits at the launch floor. Measured by chip_smoke.py (profiler device
// time over 50 calls) on an NVIDIA H100 80GB HBM3 at 700.00 W: P1 0.95-1.06 us; P3 4.30-4.70 us;
// P2 1.12-1.29 us beside its library call (x.unfold(0, 128, 1).mT[starts]) at 1.20-1.38 us.
// P2's first design took 2.43-2.56 us on the same card: three CTAs, each one 64 KB bulk copy,
// a wait, then 256 threads storing the block, so 192 KB went through 3 of 132 SMs with the load
// and the store in series. Cut into 2 KB pieces, the copies run on 96 SMs at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;  // rows per block (the TPU probe's KC)
constexpr int kCols = 128;  // floats per row
constexpr int kPieceRows = 4;  // rows per P2 piece, one CTA each
constexpr int kPieces = kRows / kPieceRows;
constexpr unsigned kPieceBytes = kPieceRows * kCols * sizeof(float);  // 2 KB
constexpr int kThreads = 256;

__global__ void affine_kernel(const float* __restrict__ x, int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __fadd_rn(__fmul_rn(x[i], 2.f), 1.f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One CTA of one warp per piece: CTA i copies piece i % kPieces of block i / kPieces.
__global__ void __launch_bounds__(32) read_at_kernel(const float* __restrict__ x,
                                                     const int32_t* __restrict__ starts,
                                                     float* __restrict__ out) {
  __shared__ __align__(128) float s_piece[kPieceRows * kCols];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x != 0) return;
  const int t = blockIdx.x / kPieces;
  const int row0 = (blockIdx.x % kPieces) * kPieceRows;
  const float* src = x + ((size_t)starts[t] + row0) * kCols;
  float* dst = out + ((size_t)t * kRows + row0) * kCols;
  const uint32_t b = smem_addr(&bar);
  const uint32_t s = smem_addr(s_piece);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(1) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
               "r"(kPieceBytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(s), "l"(src), "r"(kPieceBytes), "r"(b)
      : "memory");
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(b), "r"(0)
        : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(s),
               "r"(kPieceBytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
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
  read_at_kernel<<<num_blocks * kPieces, 32, 0, (cudaStream_t)stream>>>(
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
