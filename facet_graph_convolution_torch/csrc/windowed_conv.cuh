// What K5's forward (windowed_conv_fwd.cu) and backward (windowed_conv_bwd.cu)
// share: the rounding to the storage type, the source row of a slot through
// the window tables, the slot phase that fills a block's softmax tiles, the
// slot sums, and the tensor-core products (mma.sync, 3xTF32 / 2xTF32 / bf16).
//
// The window tables are those of graph/convert.py::windowed_lane_tables: row
// i of the N outputs lies in slab b = min(i / block, nblk - 1) at column
// jj = i - out_starts[b] (the last slab starts at N - block and overlaps its
// predecessor; both give a row the same source rows, so either slab serves
// it, and each row is computed once). Neighbour slot k reads source row
// win_starts[b] + relT[b, k, jj] or, where the halo pack says so
// (not_tail[b, k, jj] == 0), halo row N + tailT[b, k, jj] - 1 (0: a zero row).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "storage.cuh"

namespace windowed {

constexpr int kThreads = 256;
constexpr int kMGroup = 16;     // filters a thread sums at once (any M)
constexpr int kSmemMax = 232448;
constexpr int kSmemBudget = 112 * 1024;  // a block's shared memory at two blocks an SM

__host__ __device__ constexpr int round_up(int x, int a) { return (x + a - 1) / a * a; }

// the smallest y >= x with y % mod == rem: row strides that spread a
// fragment's loads over the 32 banks
__host__ __device__ constexpr int ld_pad(int x, int mod, int rem) {
  return x + ((rem - x % mod) % mod + mod) % mod;
}

// v rounded to the storage type and back: the JAX package's casts to the
// compute dtype (identity in float32)
template <typename T>
__device__ __forceinline__ float rd(float v);
template <>
__device__ __forceinline__ float rd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct FwdTables {
  const int* out_starts;     // [nblk]
  const int* win_starts;     // [nblk]
  const int* relT;           // [nblk, K, block]
  const uint8_t* not_tail;   // [nblk, K, block], null without halo rows
  const int* tailT;          // [nblk, K, block], null without halo rows
  int n, k_nbr, block, nblk;
};

// The device-memory bytes of what a pass reads for its rows besides cat: ux
// [n, M] (sz bytes an element), mult_rows [K'+1, n] (f32) and the forward
// tables (out_starts and win_starts int32 [nblk]; relT int32 [nblk, K',
// block]; with halo rows not_tail uint8 and tailT int32 of relT's shape)
inline double fwd_row_bytes(int n, int n_src, int m, int k_nbr, int block, int nblk,
                            double sz) {
  const double cells = (double)nblk * k_nbr * block;
  const double tabs = 8.0 * nblk + 4.0 * cells + (n_src > n ? 5.0 * cells : 0.0);
  return (double)n * m * sz + 4.0 * (k_nbr + 1) * n + tabs;
}

// the source row of neighbour slot k (0-based) of row i, -1 for a zero row
__device__ __forceinline__ int source_row(const FwdTables& t, int i, int k) {
  const int b = min(i / t.block, t.nblk - 1);
  const int jj = i - __ldg(t.out_starts + b);
  const size_t e = ((size_t)b * t.k_nbr + k) * t.block + jj;
  if (t.not_tail != nullptr && __ldg(t.not_tail + e) == 0) {
    const int tt = __ldg(t.tailT + e);
    return tt > 0 ? t.n + tt - 1 : -1;
  }
  return __ldg(t.win_starts + b) + __ldg(t.relT + e);
}

// Filter counts the kernels are compiled for: MM > 0 fixes M (the model's
// M = 9: loops of exactly M steps, values in registers); MM = 0 takes any M,
// its per-filter values in shared memory.
template <int MM>
struct Filters {
  __device__ __forceinline__ static int m(int m_arg) { return MM > 0 ? MM : m_arg; }
};

// The slot phase for rows row0 .. row0 + nb - 1 (k1 = K' + 1 slots a row,
// slot 0 the row itself): a thread a (row, slot) pair. For a live slot
// (mult_rows > 0) it keeps the source row in src (-1: a zero row) and either
// (kQ) the assignment q = T(softmax * mult) over the M filters in q, or the
// softmax s (f32) in q and mult in mr; a dead slot (mult 0, or a row past n)
// gets src = -1 and zeros, and adds nothing downstream. The logits are summed
// in T: (ux + vx) + c. Under MM > 0 their M loads are issued together into
// registers; under MM = 0 the logits go through the pair's q row in shared
// memory (max, exp and sum in the same order).
template <typename T, bool kQ, int MM>
__device__ void slot_phase(const FwdTables& t, const T* __restrict__ cat,
                           const T* __restrict__ ux, const float* __restrict__ c,
                           const float* __restrict__ mult_rows, int row0, int nb, int cm,
                           int in_ch, int m_arg, int* src, float* q, float* mr) {
  const int k1 = t.k_nbr + 1, m = Filters<MM>::m(m_arg);
  for (int p = threadIdx.x; p < nb * k1; p += blockDim.x) {
    const int r = p / k1, k = p - r * k1;
    const int i = row0 + r;
    float* qp = q + (size_t)p * m;
    const float w = i < t.n ? __ldg(mult_rows + (size_t)k * t.n + i) : 0.f;
    if (w == 0.f) {
      src[p] = -1;
      if (!kQ) mr[p] = 0.f;
      for (int f = 0; f < m; ++f) qp[f] = 0.f;
      continue;
    }
    const int j = k == 0 ? i : source_row(t, i, k - 1);
    src[p] = j;
    if (!kQ) mr[p] = w;
    if constexpr (MM > 0) {
      float l[MM];
      float mx = -INFINITY;
#pragma unroll
      for (int f = 0; f < MM; ++f) {
        const float vx = j >= 0 ? load_f32(cat + (size_t)j * cm + in_ch + f) : 0.f;
        l[f] = rd<T>(rd<T>(load_f32(ux + (size_t)i * MM + f) + vx) + rd<T>(__ldg(c + f)));
        mx = fmaxf(mx, l[f]);
      }
      float sum = 0.f;
#pragma unroll
      for (int f = 0; f < MM; ++f) {
        l[f] = expf(l[f] - mx);
        sum += l[f];
      }
#pragma unroll
      for (int f = 0; f < MM; ++f) qp[f] = kQ ? rd<T>(l[f] / sum * w) : l[f] / sum;
    } else {
      float mx = -INFINITY;
      for (int f = 0; f < m; ++f) {
        const float vx = j >= 0 ? load_f32(cat + (size_t)j * cm + in_ch + f) : 0.f;
        const float l =
            rd<T>(rd<T>(load_f32(ux + (size_t)i * m + f) + vx) + rd<T>(__ldg(c + f)));
        qp[f] = l;
        mx = fmaxf(mx, l);
      }
      float sum = 0.f;
      for (int f = 0; f < m; ++f) {
        const float e = expf(qp[f] - mx);
        qp[f] = e;
        sum += e;
      }
      for (int f = 0; f < m; ++f) qp[f] = kQ ? rd<T>(qp[f] / sum * w) : qp[f] / sum;
    }
  }
}

constexpr int kInFlight = 8;  // slot rows a thread loads at once in the slot sums

// z for the channels c0 .. c0 + cw - 1 of rows 0 .. nb - 1 from the slot
// phase's kQ tiles: a thread a (row, channel), M filters at once (kMGroup
// under MM = 0), kInFlight slots' rows loaded before their products; each
// product q · x is rounded to T before the f32 slot sum (JAX's sum(q·x)), and
// z to T after it. Writes z[r * zld + f * cw + cc] as Z (float, or T's
// bfloat16: the value is exact in it); a channel past in_ch gets zeros.
template <typename T, int MM, typename Z>
__device__ void slot_sums(const T* __restrict__ cat, const int* src, const float* q, int nb,
                          int k1, int cm, int m_arg, int c0, int cw, int in_ch, Z* z, int zld) {
  constexpr int G = MM > 0 ? MM : kMGroup;
  const int m = Filters<MM>::m(m_arg);
  for (int p = threadIdx.x; p < nb * cw; p += blockDim.x) {
    const int r = p / cw, cc = p - r * cw;
    const int ch = c0 + cc;
    for (int f0 = 0; f0 < m; f0 += G) {
      float acc[G];
#pragma unroll
      for (int f = 0; f < G; ++f) acc[f] = 0.f;
      for (int k0 = 0; k0 < k1; k0 += kInFlight) {
        float x[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int j = k0 + u < k1 ? src[r * k1 + k0 + u] : -1;
          x[u] = j >= 0 && ch < in_ch ? load_f32(cat + (size_t)j * cm + ch) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (k0 + u < k1) {
            const float* qs = q + (size_t)(r * k1 + k0 + u) * m + f0;
#pragma unroll
            for (int f = 0; f < G; ++f)
              if (MM > 0 || f0 + f < m) acc[f] += rd<T>(qs[f] * x[u]);
          }
        }
      }
#pragma unroll
      for (int f = 0; f < G; ++f)
        if (MM > 0 || f0 + f < m)
          store_f32(z + (size_t)r * zld + (f0 + f) * cw + cc, rd<T>(acc[f]));
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core products: mma.sync.m16n8k8 in TF32 and m16n8k16 in bfloat16,
// f32 accumulators. A lane's fragment elements (gid = lane / 4, tig = lane %
// 4): A (16 x 8 TF32) a0 (gid, tig), a1 (gid + 8, tig), a2 (gid, tig + 4), a3
// (gid + 8, tig + 4); B (8 x 8) b0 (tig, gid), b1 (tig + 4, gid); in bfloat16
// each register holds two k-neighbours (the lower k in the low half): A
// {(gid, 2tig), (gid, 2tig+1)}, then gid + 8, then k + 8; B {(2tig, gid),
// (2tig+1, gid)}, then k + 8. C and D: c0 (gid, 2tig), c1 (gid, 2tig + 1),
// c2 (gid + 8, 2tig), c3 (gid + 8, 2tig + 1).
//
// Float32 operands are split a = hi + lo, hi = tf32(a), lo = tf32(a - hi)
// (round to nearest, ties away, as cvt.rna), and a·b is summed as lo·hi +
// hi·lo + hi·hi (3xTF32): what is lost, lo·lo and the remainders below
// tf32(a - hi), is ~2^-22 of |a·b|, near f32's own rounding; each k-step's
// three products are summed apart and added to the f32 sum (mma_split). A bfloat16 value
// is exact in TF32 (8 bits of mantissa in 11), so its lo is 0 and a product
// with a split f32 operand takes two terms (2xTF32).

// tf32(v) as cvt.rna.tf32.f32 rounds it (to nearest, ties away from zero,
// for finite v), on the integer units: cvt runs on the conversion pipe at a
// quarter of the ALU rate, and a split takes two
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A's four f32 elements split for the TF32 products: split here (set), or
// read as split when they were stored so (load: hi and lo arrays of TF32
// bit patterns at the same offsets)
struct SplitA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
  __device__ __forceinline__ void load(const uint32_t* h, const uint32_t* l, int e0, int e1,
                                       int e2, int e3) {
    hi[0] = h[e0], hi[1] = h[e1], hi[2] = h[e2], hi[3] = h[e3];
    lo[0] = l[e0], lo[1] = l[e1], lo[2] = l[e2], lo[3] = l[e3];
  }
};

// v split into shared memory: hi at h[e], lo at l[e]
__device__ __forceinline__ void store_split(uint32_t* h, uint32_t* l, int e, float v) {
  uint32_t hi, lo;
  split_tf32(v, hi, lo);
  h[e] = hi;
  l[e] = lo;
}

// d += a·b for a split A and B's two f32 elements: 3xTF32 when B is split
// (kSplitB), else 2xTF32 (B exact in TF32, a bfloat16 value). The step's
// products go into a zeroed fragment that is then added to d on the CUDA
// cores: the tensor cores truncate as they accumulate, so a long chain of
// mma into d drifts one way (~1e-5 of max|y| after the 432 mma of M*C =
// 1152 on an H100); a step's partial truncates only at its own scale, and
// the rounded FADDs do not drift.
template <bool kSplitB>
__device__ __forceinline__ void mma_split(float (&d)[4], const SplitA& a, uint32_t bh0,
                                          uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, a.lo, bh0, bh1);
  if (kSplitB) mma_tf32(t, a.hi, bl0, bl1);
  mma_tf32(t, a.hi, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// the same for B's two f32 elements, split here (B exact in TF32 unless
// kSplitB: its lo is then 0 and unused)
template <bool kSplitB>
__device__ __forceinline__ void mma_split(float (&d)[4], const SplitA& a, float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_split<kSplitB>(d, a, bh0, bh1, bl0, bl1);
}

// two bfloat16 values from shared memory into one register, p[0] low
__device__ __forceinline__ uint32_t pack_bf16(const uint16_t* p, int stride) {
  return (uint32_t)p[0] | ((uint32_t)p[stride] << 16);
}

// cp.async: a 16-byte copy from device to shared memory that bypasses the
// registers and L1; a group a commit, waited for by wait_group
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {  // all but the newest group done
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

}  // namespace windowed
