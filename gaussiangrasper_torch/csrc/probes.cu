// Platform probes for Hopper (sm_90a): the counterparts of the JAX package's TPU probes, which
// exist to show that the toolchain builds and launches a kernel on the card and that a kernel can
// move row blocks at dynamic, unaligned offsets.
//
//   P1 affine_kernel replaces pallas_probe.py:38 `kernel` (the minimal Mosaic
//      compile-and-run probe): o = 2 x + 1. It moves 8 bytes a float and does two operations, so
//      bytes bound it at any size: a grid of 8 CTAs an SM strides over float4s, or, where x fits
//      one wave of that grid, each thread takes one float4 (see affine_kernel).
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
//      r comes from block max{t : s_t <= r < s_t + 128}. Rows that no block covers are left as
//      the caller allocated them. See "P3's design" below.
//
// Bound on this card (H100 SXM, 3.35 TB/s): at the probes' own shapes each probe moves a few
// hundred KB at most, far less than a kernel launch takes, so each sits at the launch floor
// there. chip_smoke.py also times P1 on 2^26 floats and P3 on 2048 overlapping blocks into 2^17
// rows, where bytes decide, and computes each bound from its run's bytes. The times are in
// PERF.md §6.
//
// P3's design. Each CTA owns 32 output rows [r0, r0 + 32), so the grid spreads over the output
// (rows / 32 CTAs), and no row scans the starts. The CTA reads the T starts once, coalesced, 8
// loads in flight a thread, and for each block that starts in (r0 - 128, r0 + 32), the blocks
// that can cover one of its rows, it records the latest block at that start position (a shared
// atomicMax over 160 positions). Row r0 + i is covered by the blocks at window positions i + 1 ..
// i + 128, so its winner is the larger of a suffix max over the first 128 positions and a prefix
// max over the last 32: warp shuffles, then the warps' partial maxima (four barriers in all),
// give every row's winner at once, O(T + 160) a CTA and none a row. Each warp then copies 4 of
// the rows, their 4 float4 loads a lane issued before any store. A winner is kept as t * 160 +
// its window position, so the row's source offset needs no second read of starts.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;  // rows per block (the TPU probe's KC)
constexpr int kCols = 128;  // floats per row
constexpr int kPieceRows = 4;  // rows per P2 piece, one CTA each
constexpr int kPieces = kRows / kPieceRows;
constexpr unsigned kPieceBytes = kPieceRows * kCols * sizeof(float);  // 2 KB
constexpr int kThreads = 256;

// P1: with kStride, a grid of whole SMs striding over the float4s of x, each thread loading
// kUnroll of them before it stores any; without, one float4 a thread. The last n % 4 floats (or
// all of them, where x is not 16-byte aligned) in a scalar tail. The two explicitly rounded
// operations keep 2 x + 1 bit-equal to the plain version.
constexpr int kUnroll = 4;

__device__ __forceinline__ float affine(float v) { return __fadd_rn(__fmul_rn(v, 2.f), 1.f); }

__device__ __forceinline__ float4 affine4(float4 v) {
  return make_float4(affine(v.x), affine(v.y), affine(v.z), affine(v.w));
}

template <bool kStride>
__global__ void __launch_bounds__(256) affine_kernel(const float* __restrict__ x, int n, int n4,
                                                     float* __restrict__ out) {
  const int stride = gridDim.x * blockDim.x;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  if (!kStride) {
    if (i < n4) o4[i] = affine4(x4[i]);
    if (4 * n4 + i < n) out[4 * n4 + i] = affine(x[4 * n4 + i]);
    return;
  }
  for (int j = i; j < n4; j += kUnroll * stride) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + u * stride < n4) v[u] = x4[j + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + u * stride < n4) o4[j + u * stride] = affine4(v[u]);
  }
  for (int j = 4 * n4 + i; j < n; j += stride) out[j] = affine(x[j]);
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

constexpr int kWarps = kThreads / 32;
constexpr int kOwnRows = 32;                 // output rows a P3 CTA owns
constexpr int kWindow = kRows + kOwnRows;    // start positions that can cover one of them
constexpr int kWarpRows = kOwnRows / kWarps;  // rows a warp copies, all loaded before any store
constexpr int kScanLoads = 8;                // starts a thread loads before its atomics

__global__ void __launch_bounds__(kThreads) write_at_kernel(const float* __restrict__ vals,
                                                            const int32_t* __restrict__ starts,
                                                            int num_blocks, int rows,
                                                            float* __restrict__ out) {
  // s_win[j]: the latest block starting at row r0 - 128 + j, as t * kWindow + j (-1: none)
  __shared__ int s_win[kWindow];
  __shared__ int s_part[kWindow / 32];
  const int r0 = blockIdx.x * kOwnRows;
  const int k = threadIdx.x;
  const int warp = k >> 5, lane = k & 31;
  if (k < kWindow) s_win[k] = -1;
  __syncthreads();
  for (int t0 = 0; t0 < num_blocks; t0 += kThreads * kScanLoads) {
    int j[kScanLoads];
#pragma unroll
    for (int u = 0; u < kScanLoads; ++u) {
      const int t = t0 + u * kThreads + k;
      j[u] = t < num_blocks ? starts[t] - (r0 - kRows) : 0;
    }
#pragma unroll
    for (int u = 0; u < kScanLoads; ++u)
      if (j[u] > 0 && j[u] < kWindow)
        atomicMax(&s_win[j[u]], (t0 + u * kThreads + k) * kWindow + j[u]);
  }
  __syncthreads();
  // row r0 + i is covered by the blocks at window positions i + 1 .. i + 128: its winner is the
  // larger of a suffix max over positions [0, 128) (warps 0-3) and a prefix max over [128,
  // kWindow) (the next warp), each within its warps by shuffles, then across them
  if (k < kWindow) {
    const bool suffix = k < kRows;
    int v = s_win[k];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int down = __shfl_down_sync(0xffffffffu, v, d);
      const int up = __shfl_up_sync(0xffffffffu, v, d);
      if (suffix && lane + d < 32) v = max(v, down);
      if (!suffix && lane >= d) v = max(v, up);
    }
    if (lane == (suffix ? 0 : 31)) s_part[warp] = v;
    s_win[k] = v;
  }
  __syncthreads();
  if (k < kWindow) {
    int v = s_win[k];
    for (int u = k < kRows ? warp + 1 : kRows / 32; u < (k < kRows ? kRows / 32 : warp); ++u)
      v = max(v, s_part[u]);
    s_win[k] = v;
  }
  __syncthreads();
  float4 val[kWarpRows];
  int src[kWarpRows];
#pragma unroll
  for (int u = 0; u < kWarpRows; ++u) {
    const int i = warp * kWarpRows + u, r = r0 + i;
    const int w = r < rows ? max(i + 1 < kRows ? s_win[i + 1] : -1, s_win[kRows + i]) : -1;
    src[u] = w;
    if (w >= 0) {
      const int t = w / kWindow, s = r0 - kRows + w % kWindow;
      val[u] = reinterpret_cast<const float4*>(vals + ((size_t)t * kRows + (r - s)) * kCols)[lane];
    }
  }
#pragma unroll
  for (int u = 0; u < kWarpRows; ++u)
    if (src[u] >= 0)
      reinterpret_cast<float4*>(out + (size_t)(r0 + warp * kWarpRows + u) * kCols)[lane] = val[u];
}

}  // namespace

// Each entry launches on `stream` (a cudaStream_t) and returns the CUDA error code; 0 is
// success. Pointers are device pointers.

// P1: out[i] = 2 x[i] + 1 for i < n; x, out float32.
extern "C" int ggt_probe_affine(const void* x, int n, void* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  static int sms[64];  // each device's SM count, read at its first launch
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device >= 64) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && !sms[device])
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // float4s where x and out are 16-byte aligned (out is a fresh allocation); a thread a float4
  // where that fits one wave of 8 CTAs of 256 an SM, else that wave striding over them
  const int n4 = ((uintptr_t)x | (uintptr_t)out) % 16 ? 0 : n / 4;
  const int work = n4 ? n4 : n;
  const int blocks = (work + kThreads - 1) / kThreads;
  if (blocks <= 8 * sms[device])
    affine_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>((const float*)x, n, n4,
                                                                        (float*)out);
  else
    affine_kernel<true><<<8 * sms[device], kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, n, n4, (float*)out);
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
extern "C" int ggt_probe_write_at(const void* vals, const void* starts, int num_blocks, int rows,
                                  void* out, void* stream) {
  // a winner is kept as t * kWindow + a window position in an int
  if (num_blocks <= 0 || num_blocks > INT_MAX / kWindow || rows < kRows)
    return (int)cudaErrorInvalidValue;
  write_at_kernel<<<(rows + kOwnRows - 1) / kOwnRows, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)vals, (const int32_t*)starts, num_blocks, rows, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* ggt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
