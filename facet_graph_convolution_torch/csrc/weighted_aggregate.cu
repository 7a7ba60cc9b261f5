// Weighted neighbour aggregation (K3).
//
// Replaces facet_graph_convolution_tpu/ops/pallas_kernels.py::_aggregate_kernel
// (launched by weighted_aggregate): z[n, m, c] = sum_k q[n, k, m] * x[n, k, c]
// with f32 accumulation. Here the operands are slot-major, as the port's conv
// tables are: q [S, N, M] and x [S, N, C] (S slots, slot 0 the node's own
// row), and z [N, M * C] is written m-major (z[n, m * C + c]), the column
// order that the conv multiplies by W_flat. The kernel is a template on the
// storage type: float32, or bfloat16 (the conv's compute_dtype="bfloat16"),
// whose loads are upcast and whose z is rounded to bfloat16 once, from the
// f32 sum, so that the conv's bf16 GEMM reads it as it is (the Pallas kernel
// writes f32 and the JAX conv rounds it: the same values). In the JAX package the rotation-
// invariant conv computes this contraction as _aggregate_nminor
// (ops/conv.py:361-382, called at :514).
//
// What bounds it on an H100: bytes. At the rotation-invariant conv1 of a
// training step (N = 25,600 nodes, S = 13, M = 9, C = 6) a node reads
// S * M * 4 = 468 B of q and S * C * 4 = 312 B of x and writes M * C * 4 =
// 216 B of z, ~25.5 MB a launch, 7.6 us at 3.35 TB/s; its 2 * S * M * C
// flops a node (~36 MFLOP) take 0.5 us at the f32 rate. In bfloat16 every
// byte halves: ~12.7 MB, 3.8 us.
//
// Design: one thread per (node, filter m) pair and chunk of up to 8
// channels. Flat thread t = (n * M + m) * chunks + chunk, so a warp's q loads
// of one slot are consecutive floats (q[s] is [N * M] contiguous; the chunks
// of a pair share one), and the threads of a node read the same x row of that
// slot, which the L1 serves after the first. The thread keeps its 8 partial
// sums in registers, walks the S slots with one q load and up to 8 fused
// multiply-adds each, and writes its outputs once: every output belongs to
// one thread, with no atomics and no shared memory. At C = 6 a warp covers 32
// (node, m) pairs, ~3.6 nodes, so no lane idles for want of channels (a warp
// per node would leave 26 of 32 idle). Chunks of 8 at every C keep enough
// threads in flight at small N and wide C: at N = 512, C = 64 one thread
// over all 64 channels gives 4,608 threads for 132 SMs, and took 11x
// torch.einsum's time there on an H100.

#include <cuda_runtime.h>
#include <stddef.h>

#include "storage.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;
// The largest C and M the kernel takes. Nothing in it is sized by either
// (C is walked in chunks, M indexes threads); the bound keeps the C
// interface's int arguments far from overflow.
constexpr int kMaxC = 4096;
constexpr int kMaxM = 4096;

template <typename S>
__global__ void __launch_bounds__(kThreads)
weighted_aggregate_kernel(const S* __restrict__ q, const S* __restrict__ x,
                          S* __restrict__ z, int slots, int n, int m, int c, int chunks) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * m * chunks) return;
  const int chunk = (int)(t % chunks);
  const long long nm = t / chunks;  // node * M + filter
  const long long node = nm / m;
  const int c0 = chunk * kChunk;
  const int width = c - c0 < kChunk ? c - c0 : kChunk;

  float acc[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) acc[j] = 0.f;
  const size_t q_stride = (size_t)n * m;
  const size_t x_stride = (size_t)n * c;
  const S* qp = q + nm;
  const S* xp = x + node * c + c0;
  for (int s = 0; s < slots; ++s) {
    const float qv = load_f32(qp + s * q_stride);
    const S* xr = xp + s * x_stride;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < width) acc[j] = fmaf(qv, load_f32(xr + j), acc[j]);
    }
  }
  S* out = z + nm * c + c0;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (j < width) store_f32(out + j, acc[j]);
  }
}

template <typename S>
int launch(const S* q, const S* x, S* z, int slots, int n, int m, int c, void* stream) {
  if (slots < 0 || n < 1 || m < 1 || m > kMaxM || c < 1 || c > kMaxC)
    return (int)cudaErrorInvalidValue;
  const int chunks = (c + kChunk - 1) / kChunk;
  const long long threads = (long long)n * m * chunks;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  weighted_aggregate_kernel<S><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(q, x, z, slots, n,
                                                                              m, c, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int weighted_aggregate_max_c(void) { return kMaxC; }
int weighted_aggregate_max_m(void) { return kMaxM; }

// q [slots, n, m] and x [slots, n, c] -> z [n, m * c], f32, contiguous, on the
// current device; 1 <= m <= kMaxM, 1 <= c <= kMaxC, slots >= 0 (no slots
// gives zeros), n >= 1. Launches on `stream` and returns cudaGetLastError()
// after the launch (0 when it was accepted).
int weighted_aggregate_f32(const float* q, const float* x, float* z, int slots, int n, int m,
                           int c, void* stream) {
  return launch(q, x, z, slots, n, m, c, stream);
}

// The same in bfloat16: q, x and z bfloat16, the sums f32, z rounded once.
int weighted_aggregate_bf16(const __nv_bfloat16* q, const __nv_bfloat16* x, __nv_bfloat16* z,
                            int slots, int n, int m, int c, void* stream) {
  return launch(q, x, z, slots, n, m, c, stream);
}

}  // extern "C"
