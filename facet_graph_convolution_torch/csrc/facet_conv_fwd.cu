// Facet-conv forward epilogue with the neighbour gather fused in (K1).
//
// Replaces facet_graph_convolution_tpu/ops/pallas_conv.py::_epilogue_fwd_kernel
// (launched by _conv_epilogue_fwd). For node i and slot k = 0..K' (slot 0 is
// the node itself, slot k > 0 is j = adj_sm[k-1, i] - 1, and index 0 a pad):
//
//   logits[m]      = ux[i, m] + cat[j, C + m] + c[m]
//   q[m]           = softmax_M(logits)[m] * mult_rows[k, i]
//   z[i, m*C + ch] = sum_k q[m] * cat[j, ch]          (f32 accumulation)
//
// The TPU kernel reads a [K', N, C+M] tensor gathered beforehand by XLA,
// because Mosaic cannot lower a dynamic gather. Here each warp loads its
// neighbour rows of cat = [x | v.x] itself, so that tensor is never written.
//
// What bounds it on an H100: memory. z is M*C floats a node against C+M floats
// of input, so writing z dominates (57 MB of ~64 MB moved at N = 24,720,
// C = 64, M = 9: ~19 us at 3.35 TB/s), while the arithmetic, M*C FMAs per
// slot over ~13 slots, needs ~6 us at the 67 TFLOP/s f32 rate. cat (<= 13 MB
// on the path) fits the 50 MB L2, so the gathered rows are mostly L2 hits.
//
// Design: one warp per node, 8 nodes per block. The warp first loads its
// node's slot table, one slot per lane, so the indices and multiplicities
// cost one round trip instead of one per slot; a ballot gives the live slots.
// Slots with mult 0 (pads, and the padded nodes) are skipped: the TPU kernel
// multiplies their q by 0, so z is the same. Neighbour indices outside
// [1, N] are read as pad slots, so a bad table cannot read out of bounds.
// The live slots are walked with the next slot's row load in flight while
// the current one is reduced. Lanes m < M hold the logits; warp shuffles give
// the softmax max and sum and broadcast q[m]. Each lane keeps
// M x ceil(C/32) f32 accumulators in registers; a gathered row of x is read
// once, coalesced across lanes, and z is written once, coalesced per m.
//
// Widths: one launch takes C <= 128 for M <= 16 and C <= 64 for M <= 32 (the
// accumulators of M = 32 at C = 128 would spill); the wrapper
// (ops/facet_conv.py) runs wider convs as channel chunks [x[:, c0:c1] | vx],
// since the softmax reads only the vx columns.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarps = 8;

// One slot's row of cat for this lane: its logit input (lanes < M) and its
// channels lane + 32*b of x.
template <int CC>
__device__ __forceinline__ void load_row(const float* __restrict__ cat, int j,
                                         int width, int c_in, int lane,
                                         bool logit_lane, float& v, float (&x)[CC]) {
  const float* row = cat + (size_t)j * width;
  v = logit_lane ? __ldg(row + c_in + lane) : 0.f;
#pragma unroll
  for (int b = 0; b < CC; ++b) {
    const int ch = lane + 32 * b;
    x[b] = ch < c_in ? __ldg(row + ch) : 0.f;
  }
}

// Softmax over the M logit lanes, then acc[m][b] += q[m] * x[b].
template <int CC, int MM>
__device__ __forceinline__ void accumulate(float base, float v, float mult,
                                           bool logit_lane, const float (&x)[CC],
                                           float (&acc)[MM][CC]) {
  const float logit = logit_lane ? base + v : -INFINITY;
  float mx = logit;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
  const float e = logit_lane ? expf(logit - mx) : 0.f;
  float sum = e;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(kFullMask, sum, off);
  const float q = e / sum * mult;  // 0 on lanes >= M
#pragma unroll
  for (int a = 0; a < MM; ++a) {
    const float qa = __shfl_sync(kFullMask, q, a);
#pragma unroll
    for (int b = 0; b < CC; ++b) acc[a][b] = fmaf(qa, x[b], acc[a][b]);
  }
}

template <int CC, int MM>
__global__ void __launch_bounds__(kWarps * 32)
facet_conv_fwd_kernel(const float* __restrict__ cat, const float* __restrict__ ux,
                      const int* __restrict__ adj_sm,
                      const float* __restrict__ mult_rows,
                      const float* __restrict__ cvec, float* __restrict__ z,
                      int n, int k_nbr, int c_in, int m) {
  const int lane = threadIdx.x & 31;
  const int node = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (node >= n) return;  // warp-uniform: the whole warp leaves together
  const int width = c_in + m;
  const bool logit_lane = lane < m;
  const float base =
      logit_lane ? __ldg(ux + (size_t)node * m + lane) + __ldg(cvec + lane) : 0.f;

  float acc[MM][CC];
#pragma unroll
  for (int a = 0; a < MM; ++a)
#pragma unroll
    for (int b = 0; b < CC; ++b) acc[a][b] = 0.f;

  for (int k0 = 0; k0 <= k_nbr; k0 += 32) {
    // the slot table of up to 32 slots, one slot per lane, loaded at once
    const int k = k0 + lane;
    float mult_l = 0.f;
    int j_l = -1;
    if (k <= k_nbr) {
      mult_l = __ldg(mult_rows + (size_t)k * n + node);
      j_l = k == 0 ? node : __ldg(adj_sm + (size_t)(k - 1) * n + node) - 1;
    }
    unsigned live =
        __ballot_sync(kFullMask, mult_l != 0.f && (unsigned)j_l < (unsigned)n);
    if (live == 0u) continue;

    // two-stage pipeline: the next live slot's row is in flight while the
    // current one is reduced
    int s = __ffs(live) - 1;
    live &= live - 1u;
    float mult = __shfl_sync(kFullMask, mult_l, s);
    float v;
    float x[CC];
    load_row<CC>(cat, __shfl_sync(kFullMask, j_l, s), width, c_in, lane, logit_lane, v, x);
    while (true) {
      const bool more = live != 0u;  // warp-uniform
      float mult_next = 0.f, v_next = 0.f;
      float x_next[CC];
#pragma unroll
      for (int b = 0; b < CC; ++b) x_next[b] = 0.f;
      if (more) {
        s = __ffs(live) - 1;
        live &= live - 1u;
        mult_next = __shfl_sync(kFullMask, mult_l, s);
        load_row<CC>(cat, __shfl_sync(kFullMask, j_l, s), width, c_in, lane,
                     logit_lane, v_next, x_next);
      }
      accumulate<CC, MM>(base, v, mult, logit_lane, x, acc);
      if (!more) break;
      mult = mult_next;
      v = v_next;
#pragma unroll
      for (int b = 0; b < CC; ++b) x[b] = x_next[b];
    }
  }

  float* zrow = z + (size_t)node * m * c_in;
#pragma unroll
  for (int a = 0; a < MM; ++a) {
    if (a >= m) break;
#pragma unroll
    for (int b = 0; b < CC; ++b) {
      const int ch = lane + 32 * b;
      if (ch < c_in) zrow[a * c_in + ch] = acc[a][b];
    }
  }
}

template <int CC, int MM>
int launch(const float* cat, const float* ux, const int* adj_sm,
           const float* mult_rows, const float* c, float* z, int n, int k_nbr,
           int c_in, int m, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
  facet_conv_fwd_kernel<CC, MM><<<blocks, kWarps * 32, 0, stream>>>(
      cat, ux, adj_sm, mult_rows, c, z, n, k_nbr, c_in, m);
  return (int)cudaGetLastError();
}

// CC_MAX: the widest chunk of 32-channel columns instantiated for MM
template <int MM, int CC_MAX = (MM <= 16 ? 4 : 2)>
int dispatch_c(const float* cat, const float* ux, const int* adj_sm,
               const float* mult_rows, const float* c, float* z, int n,
               int k_nbr, int c_in, int m, cudaStream_t stream) {
  switch ((c_in + 31) / 32) {
    case 1: return launch<1, MM>(cat, ux, adj_sm, mult_rows, c, z, n, k_nbr, c_in, m, stream);
    case 2: return launch<2, MM>(cat, ux, adj_sm, mult_rows, c, z, n, k_nbr, c_in, m, stream);
    case 3:
      if constexpr (CC_MAX >= 3)
        return launch<3, MM>(cat, ux, adj_sm, mult_rows, c, z, n, k_nbr, c_in, m, stream);
      break;
    case 4:
      if constexpr (CC_MAX >= 4)
        return launch<4, MM>(cat, ux, adj_sm, mult_rows, c, z, n, k_nbr, c_in, m, stream);
      break;
    default: break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Largest channel count one launch takes at filter count m, and the largest
// filter count the kernel is instantiated for.
int facet_conv_fwd_max_c(int m) { return m <= 16 ? 128 : 64; }
int facet_conv_fwd_max_m(void) { return 32; }

// cat [n, c_in + m], ux [n, m], adj_sm [k_nbr, n] (one-indexed, 0 = pad),
// mult_rows [k_nbr + 1, n], c [m] -> z [n, m * c_in]; all f32 but adj_sm
// (int32), contiguous, on the current device. Launches on `stream` and
// returns cudaGetLastError() after the launch (0 when it was accepted).
int facet_conv_fwd_f32(const float* cat, const float* ux, const int* adj_sm,
                       const float* mult_rows, const float* c, float* z, int n,
                       int k_nbr, int c_in, int m, void* stream) {
  if (n <= 0) return 0;
  if (c_in < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // M = 9 is the model's filter count: its own width keeps registers low
  if (m <= 4) return dispatch_c<4>(cat, ux, adj_sm, mult_rows, c, z, n, k_nbr, c_in, m, s);
  if (m <= 8) return dispatch_c<8>(cat, ux, adj_sm, mult_rows, c, z, n, k_nbr, c_in, m, s);
  if (m == 9) return dispatch_c<9>(cat, ux, adj_sm, mult_rows, c, z, n, k_nbr, c_in, m, s);
  if (m <= 16) return dispatch_c<16>(cat, ux, adj_sm, mult_rows, c, z, n, k_nbr, c_in, m, s);
  if (m <= 32) return dispatch_c<32>(cat, ux, adj_sm, mult_rows, c, z, n, k_nbr, c_in, m, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
