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
// What bounds it on an H100. At the 1,048,576-face torus's level 0
// (1,273,920 rows) upconv1 (C = 64, M = 9, out = 32, K' = 12) reads cat (73
// floats a row), ux, mult_rows and the tables and writes y (32 floats):
// ~0.72 GB, 0.22 ms at 3.35 TB/s. Its transform is 576 * 32 multiply-adds a
// row, 47 GFLOP: 0.28 ms on the tensor cores at 495 / 3 TFLOP/s (3xTF32, f32)
// or 0.05 ms at 989 (bf16), beside the slot sums' ~13 * 576 f32 FMAs a row on
// the CUDA cores, 19 GFLOP, 0.28 ms at 67 TFLOP/s. Once the transform is on
// the tensor cores the slot phase and the slot sums, gathers through L2 and
// f32 FMAs at 16 warps an SM, take most of a launch (PERF.md, PR 21).
//
// Design: a block of 256 threads takes nb = 64 consecutive rows (32 or 16
// where shared memory is short) and an out tile of up to 128 columns
// (blockIdx.y; a wider conv recomputes its rows' z a tile; the model's out is
// 32 or 64). Any M: the model's M = 9 compiled apart (loops unguarded, values
// in registers), other M through shared memory; the wrapper refuses only a
// conv whose 16-row tile passes 227 KB (windowed_conv_fwd_bytes -1).
//  1. slots: a thread a (row, slot) pair resolves the source row through the
//     tables, loads the M logit inputs and keeps q = T(softmax * mult) in
//     shared memory.
//  2. for each chunk of cw <= 8 channels: the chunk's rows of wf^T (the
//     wrapper passes wf transposed, [M*C, out], its rows padded with zeros
//     to 16 bytes for the 16-byte copies) are staged by cp.async into
//     one of two buffers, issued before the previous chunk's slot sums, so
//     chunk c+1's weights load while chunk c is summed and multiplied; a
//     thread a (row, channel) sums the slots for its M filters, 8 slots' rows
//     loaded before their products, into z [nb][M*cw] (T) in shared memory;
//     then the warps multiply: 8 warps over (nb / 16 row groups) x (out tile
//     / 8 column tiles), an m16n8 tile a step of mma.sync, the accumulators
//     kept in registers across the chunks. f32: m16n8k8 TF32, each operand
//     split hi + lo on the integer units, three products a k-step summed
//     apart and added to the accumulator (3xTF32, windowed_conv.cuh); bf16:
//     m16n8k16, z and wf as they are (exact products, f32 sums).
//  3. each lane writes its accumulators to y, rows past N and columns past
//     out skipped.
// Shared memory rows are padded, not swizzled, so that a fragment's 32 loads
// hit 32 banks: z's row stride is M*cw rounded up to the k step plus 4
// floats (4 mod 8: rows gid land 4 banks apart, columns tig fill them) or
// plus 8 bfloat16 (8 mod 16 halves: 32-bit loads of k-pairs); wf^T's row
// stride is the out tile plus 8 (8 mod 16: a B fragment's rows tig 8 banks
// apart, its columns gid fill them; the same for the bfloat16 half pairs).
// The gathered rows come through L2: the RCM band keeps a block's sources
// within a few thousand rows. Every sum runs in a fixed order, with no
// atomics: the kernel is bitwise repeatable.

#include <algorithm>

#include "windowed_conv.cuh"

namespace {

using namespace windowed;

constexpr int kMaxCW = 8;     // channels a chunk
constexpr int kMaxOT = 128;   // out columns a block
constexpr int kNF = 8;        // n8 column tiles a warp, at most (64 rows x 128 columns)

struct Plan {
  int nb, cw, kp, ot, ytiles, zld, wld;
  int off_z, off_q, off_src, smem;
};

int region(int bytes) { return round_up(bytes, 128); }

template <typename T>
Plan plan_with(int k1, int m, int out, int nb, int cw) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int ks = kF32 ? 8 : 16, sz = (int)sizeof(T);
  Plan p;
  p.nb = nb;
  p.cw = cw;
  p.kp = round_up(m * cw, ks);
  p.ot = std::min(round_up(out, 16), kMaxOT);
  p.ytiles = (out + p.ot - 1) / p.ot;
  p.zld = kF32 ? p.kp + 4 : p.kp + 8;
  p.wld = p.ot + 8;
  p.off_z = region(2 * p.kp * p.wld * sz);
  p.off_q = p.off_z + region(nb * p.zld * sz);
  p.off_src = p.off_q + region(nb * k1 * m * 4);
  p.smem = p.off_src + region(nb * k1 * 4);
  return p;
}

// the most rows a block (64, 32, 16), then the widest chunk, that fit two
// blocks an SM, else one; smem = -1 when nothing fits
template <typename T>
Plan plan_fwd(int k1, int in_ch, int m, int out) {
  for (const int budget : {kSmemBudget, kSmemMax}) {
    for (const int nb : {64, 32, 16}) {
      for (int cw = std::min(in_ch, kMaxCW); cw >= 1; cw /= 2) {
        const Plan p = plan_with<T>(k1, m, out, nb, cw);
        if (p.smem <= budget) return p;
      }
    }
  }
  Plan p = plan_with<T>(k1, m, out, 16, 1);
  p.smem = -1;
  return p;
}

// chunk ci's rows of wf^T (columns o0 .. o0 + ot - 1) into buffer w by
// 16-byte cp.async copies (wf^T's rows, wftld = out rounded up to 16 bytes,
// zeros past out, start 16-byte aligned); zeros past in_ch and wftld
template <typename T>
__device__ void stage_w(const T* __restrict__ wft, T* w, int c0, int cw, int m, int in_ch,
                        int wftld, int o0, int ot, int wld) {
  constexpr int kVec = 16 / sizeof(T);
  const int pieces = ot / kVec, zw = m * cw;
  for (int e = threadIdx.x; e < zw * pieces; e += blockDim.x) {
    const int kk = e / pieces, piece = e - kk * pieces;
    const int f = kk / cw, cc = kk - f * cw;
    const int o = o0 + piece * kVec;
    T* d = w + kk * wld + piece * kVec;
    if (c0 + cc < in_ch && o < wftld) {
      cp_async16(d, wft + (size_t)(f * in_ch + c0 + cc) * wftld + o);
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v) store_f32(d + v, 0.f);
    }
  }
}

template <typename T, int MM>
__global__ void __launch_bounds__(kThreads, 2)
windowed_conv_fwd_kernel(const T* __restrict__ cat, const T* __restrict__ ux,
                         const T* __restrict__ wft, const float* __restrict__ c,
                         const float* __restrict__ mult_rows, FwdTables t, float* __restrict__ y,
                         int in_ch, int m_arg, int out, Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int KS = kF32 ? 8 : 16;
  const int m = Filters<MM>::m(m_arg);
  const int k1 = t.k_nbr + 1, cm = in_ch + m, zw = m * p.cw;
  T* w = reinterpret_cast<T*>(smem);  // [2][kp][wld]
  T* z = reinterpret_cast<T*>(smem + p.off_z);  // [nb][zld]
  float* q = reinterpret_cast<float*>(smem + p.off_q);
  int* src = reinterpret_cast<int*>(smem + p.off_src);
  const int row0 = blockIdx.x * p.nb, o0 = blockIdx.y * p.ot;
  const int chunks = (in_ch + p.cw - 1) / p.cw, wftld = round_up(out, 16 / (int)sizeof(T));

  // the k padding past M*cw: zero rows of both wf^T buffers, zero columns of z
  const int pad = p.kp - zw;
  for (int e = threadIdx.x; e < 2 * pad * p.wld; e += blockDim.x) {
    const int b = e / (pad * p.wld), r = e - b * pad * p.wld;
    store_f32(w + (size_t)b * p.kp * p.wld + zw * p.wld + r, 0.f);
  }
  for (int e = threadIdx.x; e < p.nb * pad; e += blockDim.x) {
    const int r = e / pad;
    store_f32(z + r * p.zld + zw + (e - r * pad), 0.f);
  }
  stage_w(wft, w, 0, p.cw, m, in_ch, wftld, o0, p.ot, p.wld);
  cp_async_commit();
  slot_phase<T, true, MM>(t, cat, ux, c, mult_rows, row0, p.nb, cm, in_ch, m, src, q, nullptr);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = p.nb / 16, tr = warp % rg, tn0 = warp / rg, tstep = 8 / rg, ntn = p.ot / 8;
  float acc[kNF][4];
#pragma unroll
  for (int u = 0; u < kNF; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;

  for (int ci = 0; ci < chunks; ++ci) {
    if (ci + 1 < chunks)
      stage_w(wft, w + ((ci + 1) & 1) * p.kp * p.wld, (ci + 1) * p.cw, p.cw, m, in_ch, wftld,
              o0, p.ot, p.wld);
    cp_async_commit();
    slot_sums<T, MM>(cat, src, q, p.nb, k1, cm, m, ci * p.cw, p.cw, in_ch, z, p.zld);
    cp_async_wait_prev();  // this thread's copies of chunk ci
    __syncthreads();       // everyone's copies and z
    const T* wb = w + (ci & 1) * p.kp * p.wld;
    if constexpr (kF32) {
      const float* zr = z + (tr * 16 + gid) * p.zld + tig;
      const float* wk = wb + tig * p.wld + gid;
      for (int k0 = 0; k0 < p.kp; k0 += KS) {
        SplitA a;
        a.set(zr[k0], zr[8 * p.zld + k0], zr[k0 + 4], zr[8 * p.zld + k0 + 4]);
        const float* wr = wk + k0 * p.wld;
#pragma unroll
        for (int u = 0; u < kNF; ++u) {
          const int tn = tn0 + tstep * u;
          if (tn < ntn) mma_split<true>(acc[u], a, wr[tn * 8], wr[4 * p.wld + tn * 8]);
        }
      }
    } else {
      const uint16_t* zr = reinterpret_cast<const uint16_t*>(z) + (tr * 16 + gid) * p.zld + 2 * tig;
      const uint16_t* wk = reinterpret_cast<const uint16_t*>(wb) + 2 * tig * p.wld + gid;
      for (int k0 = 0; k0 < p.kp; k0 += KS) {
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(zr + k0);
        a[1] = *reinterpret_cast<const uint32_t*>(zr + 8 * p.zld + k0);
        a[2] = *reinterpret_cast<const uint32_t*>(zr + k0 + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(zr + 8 * p.zld + k0 + 8);
        const uint16_t* wr = wk + k0 * p.wld;
#pragma unroll
        for (int u = 0; u < kNF; ++u) {
          const int tn = tn0 + tstep * u;
          if (tn < ntn)
            mma_bf16(acc[u], a, pack_bf16(wr + tn * 8, p.wld),
                     pack_bf16(wr + 8 * p.wld + tn * 8, p.wld));
        }
      }
    }
    __syncthreads();  // the reads of z and of this buffer before they are refilled
  }

#pragma unroll
  for (int u = 0; u < kNF; ++u) {
    const int tn = tn0 + tstep * u;
    if (tn >= ntn) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + tr * 16 + gid + 8 * h;
      if (row >= t.n) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = o0 + tn * 8 + 2 * tig + e;
        if (o < out) y[(size_t)row * out + o] = acc[u][2 * h + e];
      }
    }
  }
}

template <typename T, int MM>
int launch_m(const T* cat, const T* ux, const T* wft, const float* c, const float* mult_rows,
             const FwdTables& t, float* y, int in_ch, int m, int out, cudaStream_t stream) {
  const Plan p = plan_fwd<T>(t.k_nbr + 1, in_ch, m, out);
  if (p.smem < 0) return (int)cudaErrorInvalidValue;
  // raised once past 48 KB (and not again while a CUDA graph captures)
  static int raised = 48 * 1024;
  if (p.smem > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        windowed_conv_fwd_kernel<T, MM>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return (int)err;
    raised = p.smem;
  }
  const dim3 grid((t.n + p.nb - 1) / p.nb, p.ytiles);
  windowed_conv_fwd_kernel<T, MM><<<grid, kThreads, p.smem, stream>>>(
      cat, ux, wft, c, mult_rows, t, y, in_ch, m, out, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* cat, const T* ux, const T* wft, const float* c, const float* mult_rows,
           const int* out_starts, const int* win_starts, const int* relT, const uint8_t* not_tail,
           const int* tailT, float* y, int n, int n_src, int in_ch, int m, int out, int k_nbr,
           int block, int nblk, void* stream) {
  if (n <= 0) return 0;
  if (m < 1 || in_ch < 1 || out < 1 || k_nbr < 0 || block < 1 || nblk < 1 || n_src < n ||
      (size_t)(k_nbr + 1) * n >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  const FwdTables t{out_starts, win_starts, relT, not_tail, tailT, n, k_nbr, block, nblk};
  cudaStream_t s = (cudaStream_t)stream;
  // the model's M = 9 compiled apart: its filter loops have no guards
  return m == 9 ? launch_m<T, 9>(cat, ux, wft, c, mult_rows, t, y, in_ch, m, out, s)
                : launch_m<T, 0>(cat, ux, wft, c, mult_rows, t, y, in_ch, m, out, s);
}

}  // namespace

extern "C" {

// The device-memory bytes one launch moves at these sizes under the kernel's
// plan (bf16: the bfloat16 entry's), or -1 where even 16 rows and one channel
// a chunk do not fit a block's 227 KB: each out tile's blocks read cat and
// the row inputs (fwd_row_bytes) once (the RCM band keeps a block's gathered
// rows in L2), wf^T and c are read once, y is written once.
double windowed_conv_fwd_bytes(int n, int n_src, int in_ch, int m, int out, int k_nbr,
                               int block, int nblk, int bf16) {
  const Plan p = bf16 ? plan_fwd<__nv_bfloat16>(k_nbr + 1, in_ch, m, out)
                      : plan_fwd<float>(k_nbr + 1, in_ch, m, out);
  if (p.smem < 0) return -1.0;
  const double sz = bf16 ? 2.0 : 4.0;
  const double cat = (double)n_src * (in_ch + m) * sz;
  const double wft = (double)m * in_ch * round_up(out, bf16 ? 8 : 4) * sz;
  return p.ytiles * (cat + fwd_row_bytes(n, n_src, m, k_nbr, block, nblk, sz)) + wft +
         4.0 * m + 4.0 * n * out;
}

// cat [n_src, C+M], ux [n, M], wft [M*C, out rounded up to 16 bytes] (wf
// transposed, zeros past out; all T), c [M] and mult_rows [K'+1, n] f32,
// the forward window tables (out_starts, win_starts, relT; not_tail and
// tailT, or null without halo rows) -> y [n, out] f32, all contiguous on
// the current device. Launches on `stream` and returns cudaGetLastError()
// after the launch (0 when it was accepted), or cudaErrorInvalidValue for
// sizes the kernel does not take (windowed_conv_fwd_bytes -1).
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
