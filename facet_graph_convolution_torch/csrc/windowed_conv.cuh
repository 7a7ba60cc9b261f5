// What K5's forward (windowed_conv_fwd.cu) and backward (windowed_conv_bwd.cu)
// share: the rounding to the storage type, the source row of a slot through
// the window tables, and the slot phase that fills a block's softmax tiles.
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

#include "storage.cuh"

namespace windowed {

constexpr int kThreads = 256;
constexpr int kMaxM = 32;       // filters a kernel takes (the slot phase's logits)
constexpr int kMaxOut = 128;    // outputs a kernel takes (its register tiles)
constexpr int kMGroup = 16;     // filters a thread sums at once in the slot sums
constexpr int kSmemMax = 232448;

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

// Filter counts the kernels are compiled for: a template's MM > 0 fixes M
// (the model's M = 9: loops of exactly M steps), MM = 0 takes any M <= kMaxM
// through loops guarded at kMaxM steps.
template <int MM>
struct Filters {
  static constexpr int kLoop = MM > 0 ? MM : kMaxM;  // a loop's steps
  __device__ __forceinline__ static int m(int m_arg) { return MM > 0 ? MM : m_arg; }
  __device__ __forceinline__ static bool has(int f, int m) { return MM > 0 || f < m; }
};

// The slot phase for rows row0 .. row0 + nb - 1 (k1 = K' + 1 slots a row,
// slot 0 the row itself): a thread a (row, slot) pair. For a live slot
// (mult_rows > 0) it keeps the source row in src (-1: a zero row) and either
// (kQ) the assignment q = T(softmax * mult) over the M filters in q, or the
// softmax s (f32) in q and mult in mr; a dead slot (mult 0, or a row past n)
// gets src = -1 and zeros, and adds nothing downstream. The logits are summed
// in T: (ux + vx) + c; their M loads are issued together.
template <typename T, bool kQ, int MM>
__device__ void slot_phase(const FwdTables& t, const T* __restrict__ cat,
                           const T* __restrict__ ux, const float* __restrict__ c,
                           const float* __restrict__ mult_rows, int row0, int nb, int cm,
                           int in_ch, int m_arg, int* src, float* q, float* mr) {
  using F = Filters<MM>;
  const int k1 = t.k_nbr + 1, m = F::m(m_arg);
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
    float l[F::kLoop];
    float mx = -INFINITY;
#pragma unroll
    for (int f = 0; f < F::kLoop; ++f) {
      if (F::has(f, m)) {
        const float vx = j >= 0 ? load_f32(cat + (size_t)j * cm + in_ch + f) : 0.f;
        l[f] = rd<T>(rd<T>(load_f32(ux + (size_t)i * m + f) + vx) + rd<T>(__ldg(c + f)));
        mx = fmaxf(mx, l[f]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int f = 0; f < F::kLoop; ++f) {
      if (F::has(f, m)) {
        l[f] = expf(l[f] - mx);
        sum += l[f];
      }
    }
#pragma unroll
    for (int f = 0; f < F::kLoop; ++f)
      if (F::has(f, m)) qp[f] = kQ ? rd<T>(l[f] / sum * w) : l[f] / sum;
  }
}

constexpr int kInFlight = 4;  // slot rows a thread loads at once in the slot sums

// z[f*cw + cc][r] for the channels c0 .. c0 + cw - 1 of rows 0 .. nb - 1
// from the slot phase's kQ tiles: a thread a (row, channel), M filters at
// once (kMGroup under MM = 0), kInFlight slots' rows loaded before their products; each product
// q · x is rounded to T before the f32 slot sum (JAX's sum(q·x)), and z to T
// after it. Writes z[(f * cw + cc) * zrs + r].
template <typename T, int MM>
__device__ void slot_sums(const T* __restrict__ cat, const int* src, const float* q, int nb,
                          int k1, int cm, int m_arg, int c0, int cw, int in_ch, float* z,
                          int zrs) {
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
        if (MM > 0 || f0 + f < m) z[(size_t)((f0 + f) * cw + cc) * zrs + r] = rd<T>(acc[f]);
    }
  }
}

}  // namespace windowed
