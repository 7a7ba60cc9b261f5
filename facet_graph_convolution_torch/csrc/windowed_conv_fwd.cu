// The windowed fused facet conv, forward (K5).
//
// Replaces no Pallas kernel: its counterpart is the XLA scan of
// facet_graph_convolution_tpu/ops/windowed_conv.py::make_windowed_fused_conv
// (its forward `fused`, :110-131, and `_slab_forward`, :79-101), which the
// JAX package's sharded conv runs on levels of at least 262,144 rows a shard
// ordered by RCM. For output row i and slot k = 0..K' (slot 0 the row itself,
// else the source row j that the window tables give, windowed_conv.cuh):
//
//   logits[m] = (ux[i, m] + cat[j, C + m]) + c[m]    (summed in T)
//   q[m]      = T(softmax_M(logits)[m] * mult_rows[k, i])
//   z[m*C+ch] = T(sum_k T(q[m] * cat[j, ch]))         (f32 sum)
//   y[i, o]   = sum_{m,ch} T(wf[o, m*C+ch]) * z[m*C+ch]   (f32)
//
// T is the storage type of cat, ux and wf: float32 (every T() the identity)
// or bfloat16, whose roundings are the JAX package's casts. y is f32, without
// the bias. z never leaves the block: the flat path (K1, then a GEMM) writes
// z [N, M*C] to device memory and reads it back.
//
// What bounds it on an H100: operations. At the 1,048,576-face torus's level
// 0 (1,273,920 rows) upconv1 reads cat (73 floats a row), ux, mult_rows and
// the tables and writes y (32 floats): ~0.72 GB, 0.22 ms at 3.35 TB/s; its
// transform is 576 * 32 FMAs a row, 47 GFLOP, 0.70 ms at the 67 TFLOP/s f32
// rate, beside 13 * 576 FMAs a row for the slot sums.
//
// Design (f32 FMAs, no tensor cores yet): a block of 256 threads takes up
// to 128 consecutive rows (the model's M = 9 compiled apart, its filter loops
// unguarded).
//  1. slots: a thread a (row, slot) pair resolves the source row through the
//     tables, loads the M logit inputs at once and keeps q = T(softmax *
//     mult) in shared memory.
//  2. for each chunk of CW <= 8 channels: the block stages the chunk's rows
//     of wf^T (the wrapper passes wf transposed, [M*C, out]) in shared
//     memory; a thread a (row, channel) sums the slots for its M filters,
//     4 slots' rows loaded before their products, into z [M*CW][NB] in
//     shared memory; then each thread adds to its register tile of RB
//     rows x 4 outputs (the ceil(out / 4) column groups times the row groups
//     fill the 256 threads: 4 x 4 at out = 32, 8 x 4 at 64 and 128) the
//     chunk's z rows times its wf^T rows: a float4 of wf^T and RB z values a
//     step for 4 * RB FMAs.
// The gathered rows come through L2: the RCM band keeps a block's sources
// within a few thousand rows. Every sum runs in a fixed order, with no
// atomics: the kernel is bitwise repeatable. out <= 128 (a tile's RB <= 8).

#include <algorithm>

#include "windowed_conv.cuh"

namespace {

using namespace windowed;

constexpr int kMaxNb = 128;   // rows a block, at most
constexpr int kMaxRB = 8;     // rows a thread's output tile
constexpr int kMaxCW = 8;     // channels a chunk
constexpr int kSmemFwd = 110 * 1024;  // the block's shared memory budget (2 an SM)

struct Plan {
  int nb, cw, to, tr, rb, smem;
};

int fwd_bytes(int nb, int cw, int k1, int m, int to) {
  return 4 * (nb * k1 * (m + 1) + m * cw * (nb + 1) + m * cw * 4 * to);
}

// to thread columns of 4 outputs, tr row groups (a power of two, to * tr <=
// 256) of rb <= kMaxRB rows: nb = tr * rb rows a block, halved while the
// shared memory passes its budget
Plan plan_fwd(int k1, int in_ch, int m, int out) {
  Plan p;
  p.to = (out + 3) / 4;
  p.tr = 1;
  while (p.tr * 2 * p.to <= kThreads && p.tr * 2 <= kMaxNb) p.tr *= 2;
  p.nb = std::min(kMaxNb, kMaxRB * p.tr);
  p.cw = std::min(in_ch, kMaxCW);
  while (fwd_bytes(p.nb, p.cw, k1, m, p.to) > kSmemFwd && p.nb > p.tr) p.nb /= 2;
  while (fwd_bytes(p.nb, p.cw, k1, m, p.to) > kSmemMax && p.cw > 1) p.cw = (p.cw + 1) / 2;
  p.rb = p.nb / p.tr;
  p.smem = fwd_bytes(p.nb, p.cw, k1, m, p.to);
  return p;
}

template <typename T, int MM>
__global__ void __launch_bounds__(kThreads)
windowed_conv_fwd_kernel(const T* __restrict__ cat, const T* __restrict__ ux,
                         const T* __restrict__ wft, const float* __restrict__ c,
                         const float* __restrict__ mult_rows, FwdTables t, float* __restrict__ y,
                         int in_ch, int m_arg, int out, int nb, int cw, int to, int tr, int rb) {
  extern __shared__ float smem[];
  const int m = Filters<MM>::m(m_arg);
  const int k1 = t.k_nbr + 1, cm = in_ch + m, zw = m * cw, op = 4 * to, zrs = nb + 1;
  float* w = smem;                  // first: its float4 rows stay 16-byte aligned
  float* z = w + zw * op;
  float* q = z + zw * zrs;
  int* src = reinterpret_cast<int*>(q + nb * k1 * m);
  const int row0 = blockIdx.x * nb;
  const int tc = threadIdx.x % to, tg = threadIdx.x / to;
  const bool tiled = tg < tr;

  slot_phase<T, true, MM>(t, cat, ux, c, mult_rows, row0, nb, cm, in_ch, m, src, q, nullptr);
  float acc[kMaxRB][4];
#pragma unroll
  for (int i = 0; i < kMaxRB; ++i)
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[i][o] = 0.f;
  for (int c0 = 0; c0 < in_ch; c0 += cw) {
    __syncthreads();  // the slot phase, or the last chunk's reads of z and w
    for (int e = threadIdx.x; e < zw * op; e += blockDim.x) {
      const int fc = e / op, o = e - fc * op;
      const int f = fc / cw, cc = fc - f * cw;
      w[e] = c0 + cc < in_ch && o < out
                 ? load_f32(wft + (size_t)(f * in_ch + c0 + cc) * out + o) : 0.f;
    }
    slot_sums<T, MM>(cat, src, q, nb, k1, cm, m, c0, cw, in_ch, z, zrs);
    __syncthreads();
    if (tiled) {
      const float* zt = z + tg * rb;
#pragma unroll 4
      for (int fc = 0; fc < zw; ++fc) {
        const float4 wv = *reinterpret_cast<const float4*>(w + fc * op + 4 * tc);
#pragma unroll
        for (int i = 0; i < kMaxRB; ++i) {
          if (i < rb) {
            const float zv = zt[fc * zrs + i];
            acc[i][0] += zv * wv.x;
            acc[i][1] += zv * wv.y;
            acc[i][2] += zv * wv.z;
            acc[i][3] += zv * wv.w;
          }
        }
      }
    }
  }
  if (!tiled) return;
#pragma unroll
  for (int i = 0; i < kMaxRB; ++i) {
    const int row = row0 + tg * rb + i;
    if (i < rb && row < t.n) {
#pragma unroll
      for (int o = 0; o < 4; ++o)
        if (4 * tc + o < out) y[(size_t)row * out + 4 * tc + o] = acc[i][o];
    }
  }
}

template <typename T, int MM>
int launch_m(const T* cat, const T* ux, const T* wft, const float* c, const float* mult_rows,
             const FwdTables& t, float* y, int in_ch, int m, int out, cudaStream_t stream) {
  const Plan p = plan_fwd(t.k_nbr + 1, in_ch, m, out);
  if (p.smem > kSmemMax || p.rb > kMaxRB) return (int)cudaErrorInvalidValue;
  // raised once past 48 KB (and not again while a CUDA graph captures)
  static int raised = 48 * 1024;
  if (p.smem > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        windowed_conv_fwd_kernel<T, MM>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return (int)err;
    raised = p.smem;
  }
  windowed_conv_fwd_kernel<T, MM><<<(t.n + p.nb - 1) / p.nb, kThreads, p.smem, stream>>>(
      cat, ux, wft, c, mult_rows, t, y, in_ch, m, out, p.nb, p.cw, p.to, p.tr, p.rb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* cat, const T* ux, const T* wft, const float* c, const float* mult_rows,
           const int* out_starts, const int* win_starts, const int* relT, const uint8_t* not_tail,
           const int* tailT, float* y, int n, int n_src, int in_ch, int m, int out, int k_nbr,
           int block, int nblk, void* stream) {
  if (n <= 0) return 0;
  if (m < 1 || m > kMaxM || in_ch < 1 || out < 1 || out > kMaxOut || k_nbr < 0 ||
      block < 1 || nblk < 1 || n_src < n || (size_t)(k_nbr + 1) * n >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  const FwdTables t{out_starts, win_starts, relT, not_tail, tailT, n, k_nbr, block, nblk};
  cudaStream_t s = (cudaStream_t)stream;
  // the model's M = 9 compiled apart: its filter loops have no guards
  return m == 9 ? launch_m<T, 9>(cat, ux, wft, c, mult_rows, t, y, in_ch, m, out, s)
                : launch_m<T, 0>(cat, ux, wft, c, mult_rows, t, y, in_ch, m, out, s);
}

}  // namespace

extern "C" {

// cat [n_src, C+M], ux [n, M], wft [M*C, out] (wf transposed; all T), c [M]
// and mult_rows [K'+1, n] f32, the forward window tables (out_starts,
// win_starts, relT; not_tail and tailT, or null without halo rows) -> y
// [n, out] f32, all
// contiguous on the current device. Launches on `stream` and returns
// cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue for sizes the kernel does not take.
int windowed_conv_fwd_f32(const float* cat, const float* ux, const float* wft, const float* c,
                          const float* mult_rows, const int* out_starts, const int* win_starts,
                          const int* relT, const uint8_t* not_tail, const int* tailT, float* y,
                          int n, int n_src, int in_ch, int m, int out, int k_nbr, int block,
                          int nblk, void* stream) {
  return launch(cat, ux, wft, c, mult_rows, out_starts, win_starts, relT, not_tail, tailT, y, n,
                n_src, in_ch, m, out, k_nbr, block, nblk, stream);
}

// The same with cat, ux and wf in bfloat16 (the JAX package's casts).
int windowed_conv_fwd_bf16(const __nv_bfloat16* cat, const __nv_bfloat16* ux,
                           const __nv_bfloat16* wft, const float* c, const float* mult_rows,
                           const int* out_starts, const int* win_starts, const int* relT,
                           const uint8_t* not_tail, const int* tailT, float* y, int n, int n_src,
                           int in_ch, int m, int out, int k_nbr, int block, int nblk,
                           void* stream) {
  return launch(cat, ux, wft, c, mult_rows, out_starts, win_starts, relT, not_tail, tailT, y, n,
                n_src, in_ch, m, out, k_nbr, block, nblk, stream);
}

}  // extern "C"
