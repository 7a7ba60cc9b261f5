// The windowed fused facet conv, backward (K5's backward).
//
// Replaces no Pallas kernel: its counterpart is the custom VJP of
// facet_graph_convolution_tpu/ops/windowed_conv.py::make_windowed_fused_conv
// (`_bwd`, :137-232), an XLA scan over the slabs. For the cotangent gy [n, out]
// (f32) of the forward's y (windowed_conv_fwd.cu), with q_raw = softmax and
// q = T(q_raw * mult) recomputed per slot:
//
//   dz[m*C+ch]   = sum_o T(wf[o, m*C+ch]) * gy[i, o]                 (f32)
//   dq[k, m]     = sum_ch dz[m*C+ch] * x_j[ch]
//   dx[k, ch]    = T(sum_m dz[m*C+ch] * q[k, m])
//   dlog[k, m]   = q_raw[m] * (dq_raw[m] - sum_m' q_raw[m'] dq_raw[m']),  dq_raw = dq * mult
//   dux[i, m]    = sum_k dlog[k, m];  dc = sum_i dux[i];  dwf = sum_i gy[i] z[i]^T
//   dcat[j]      = T(sum of the rows [dx | T(dlog)] of the slots that read j, f32)
//
// Five launches from one entry, in stream order:
//  A. windowed_bwd_slots_kernel: a block of 256 threads a tile of up to 16
//     rows: the slot phase (windowed_conv.cuh); dz of the tile in shared
//     memory (a thread a column of wf, a float4 of each row's gy a step);
//     then a team of 8 lanes a (row, slot) pair: its channels over the
//     lanes, dq summed over the team by shuffles, and the slot's row
//     [dx | dlog] written to dG [(K'+1) * n, C+M] in T (row k*n + i: the
//     self rows first; a dead slot's row is zeros); dux per row and the
//     block's dc partial.
//  W. windowed_bwd_dwf_kernel: a block a (group of rows, chunk of channels)
//     pair; for each tile of 32 rows the slot phase again, the chunk's z
//     columns (rounded to T, as the forward makes them) and gy in shared
//     memory, and a thread adds to its register tile of 4 outputs x up to 8
//     z columns gy[r, o..o+3] * z[r, f*C+ch], a float4 of gy and the z
//     values a row; at the end the block writes its group's partial of dwf.
//  D. windowed_bwd_dcat_kernel: a warp a source row, its lanes first
//     decoding the slots that the backward tables list (relS, validS: slot
//     k, row bwd_starts + offset; for a halo row tailS, tailV) into dG rows,
//     then summing those rows over the channels, coalesced, in slot order,
//     then the self row; in f32, rounded once (the JAX package sums them in
//     bfloat16).
//  R. windowed_sum_*: dwf and dc, the groups' and the tiles' partials summed
//     in a fixed order.
// No atomics anywhere: the backward is bitwise repeatable. z and dz stay in
// shared memory; only dG (the slots' cotangents, as K2's dg) reaches device
// memory.
//
// What bounds it on an H100: operations. A row costs M*C*out FMAs for dz and
// as many for dwf, 2*(K'+1)*M*C for dq and dx, and (K'+1)*M*C to recompute z
// in W: at upconv1 of the torus's level 0 ~47,000 FMAs a row, 120 GFLOP,
// ~1.8 ms at the f32 rate, against ~2.9 GB of bytes (dG written and read,
// cat read twice, dcat written), ~0.9 ms at 3.35 TB/s.

#include <algorithm>

#include "windowed_conv.cuh"

namespace {

using namespace windowed;

constexpr int kNbA = 16;     // rows a pass-A tile, at most
constexpr int kTeam = 8;     // lanes a (row, slot) pair in pass A
constexpr int kSmemA = 100 * 1024;  // pass A's shared memory budget (2+ blocks an SM)
constexpr int kNbW = 32;     // rows a pass-W tile
constexpr int kMaxFB = 8;    // z columns a thread's dwf tile in pass W (x 4 outputs)
constexpr int kTargetBlocks = 132 * 8;
constexpr int kDcatCh = 4;   // channels a lane in pass D (a warp a row, 128 channels a pass)

int a_bytes(int nb, int k1, int in_ch, int m, int out) {
  return 4 * (nb * ((out + 3) / 4 * 4) + nb * (m * in_ch + 1) + nb * k1 * (2 * m + 2) + nb * m);
}

int plan_a(int k1, int in_ch, int m, int out) {
  int nb = kNbA;
  while (a_bytes(nb, k1, in_ch, m, out) > kSmemA && nb > 1) nb /= 2;
  return nb;
}

struct PlanW {
  int cw, chunks, rows, groups, to, tf, fb, smem;
};

// to thread columns of 4 outputs and tf column groups of the chunk's M * cw
// z columns, fb = ceil(M * cw / tf) <= kMaxFB of them a thread; cw as wide as
// that allows
PlanW plan_w(int n, int k1, int in_ch, int m, int out) {
  PlanW p;
  p.to = (out + 3) / 4;
  p.tf = std::max(1, kThreads / p.to);
  p.cw = std::max(1, std::min(in_ch, kMaxFB * p.tf / m));
  p.fb = (m * p.cw + p.tf - 1) / p.tf;
  p.chunks = (in_ch + p.cw - 1) / p.cw;
  const int tiles = (n + kNbW - 1) / kNbW;
  const int groups = std::max(1, std::min(tiles, (kTargetBlocks + p.chunks - 1) / p.chunks));
  p.rows = (tiles + groups - 1) / groups * kNbW;
  p.groups = (n + p.rows - 1) / p.rows;
  p.smem = 4 * (kNbW * 4 * p.to + m * p.cw * (kNbW + 1) + kNbW * k1 * (m + 1));
  return p;
}

template <typename T, int MM>
__global__ void __launch_bounds__(kThreads)
windowed_bwd_slots_kernel(const T* __restrict__ cat, const T* __restrict__ ux,
                          const T* __restrict__ wf, const float* __restrict__ c,
                          const float* __restrict__ mult_rows, const float* __restrict__ gy,
                          FwdTables t, T* __restrict__ dG, float* __restrict__ dux,
                          float* __restrict__ dc_part, int in_ch, int m_arg, int out, int nb) {
  extern __shared__ float smem[];
  using F = Filters<MM>;
  const int m = F::m(m_arg);
  const int k1 = t.k_nbr + 1, cm = in_ch + m, mc = m * in_ch, op = (out + 3) / 4 * 4;
  const int dzs = mc + 1;             // dz's row stride: rows on distinct banks
  float* sgy = smem;                  // first: its float4 rows stay 16-byte aligned
  float* dz = sgy + nb * op;
  float* qraw = dz + nb * dzs;
  float* mr = qraw + nb * k1 * m;
  float* dlog = mr + nb * k1;
  float* sdux = dlog + nb * k1 * m;
  int* src = reinterpret_cast<int*>(sdux + nb * m);
  const int row0 = blockIdx.x * nb;

  slot_phase<T, false, MM>(t, cat, ux, c, mult_rows, row0, nb, cm, in_ch, m, src, qraw, mr);
  for (int p = threadIdx.x; p < nb * op; p += blockDim.x) {
    const int r = p / op, o = p - r * op;
    sgy[p] = row0 + r < t.n && o < out ? __ldg(gy + (size_t)(row0 + r) * out + o) : 0.f;
  }
  __syncthreads();
  // dz = gy · wf_T, a thread a column of wf: 4 outputs' weights, then a
  // float4 of each row's gy, 4 * nb FMAs
  for (int zi = threadIdx.x; zi < mc; zi += blockDim.x) {
    float a[kNbA];
#pragma unroll
    for (int r = 0; r < kNbA; ++r) a[r] = 0.f;
    for (int o = 0; o < op; o += 4) {
      float w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        w[u] = o + u < out ? load_f32(wf + (size_t)(o + u) * mc + zi) : 0.f;
#pragma unroll
      for (int r = 0; r < kNbA; ++r) {
        if (r < nb) {
          const float4 g = *reinterpret_cast<const float4*>(sgy + r * op + o);
          a[r] += w[0] * g.x + w[1] * g.y + w[2] * g.z + w[3] * g.w;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kNbA; ++r)
      if (r < nb) dz[r * dzs + zi] = a[r];
  }
  __syncthreads();

  // a team of kTeam lanes a (row, slot) pair: its channels over the lanes,
  // dq summed over the team by shuffles, the slot's row [dx | dlog] written
  // in kTeam-wide runs. Every lane of a warp runs the same iterations (the
  // shuffles need them all); a team past the tile's pairs computes zeros and
  // writes nothing.
  const int lane = threadIdx.x % kTeam, teams = blockDim.x / kTeam;
  const int warp_team0 = threadIdx.x / 32 * (32 / kTeam);
  for (int p0 = warp_team0; p0 < nb * k1; p0 += teams) {
    const int p = p0 + (threadIdx.x % 32) / kTeam;
    const bool pair = p < nb * k1;
    const int r = pair ? p / k1 : 0, k = pair ? p - r * k1 : 0;
    const int i = row0 + r;
    const bool store = pair && i < t.n;
    const float w = pair ? mr[p] : 0.f;
    const bool live = store && w != 0.f;
    const int j = live ? src[p] : -1;
    T* g = dG + ((size_t)k * t.n + (store ? i : 0)) * cm;
    const float* qr = qraw + (size_t)(pair ? p : 0) * m;
    const float* dzr = dz + (size_t)r * dzs;
    float q[F::kLoop], dq[F::kLoop];
#pragma unroll
    for (int f = 0; f < F::kLoop; ++f) {
      q[f] = F::has(f, m) && live ? rd<T>(qr[f] * w) : 0.f;
      dq[f] = 0.f;
    }
#pragma unroll 4
    for (int ch = lane; ch < in_ch; ch += kTeam) {
      const float x = j >= 0 ? load_f32(cat + (size_t)j * cm + ch) : 0.f;
      float dx = 0.f;
#pragma unroll
      for (int f = 0; f < F::kLoop; ++f) {
        if (F::has(f, m)) {
          const float d = dzr[f * in_ch + ch];
          dq[f] += d * x;
          dx += d * q[f];
        }
      }
      if (store) store_f32(g + ch, dx);
    }
    float s = 0.f;
#pragma unroll
    for (int f = 0; f < F::kLoop; ++f) {
      if (F::has(f, m)) {
        float v = dq[f];
#pragma unroll
        for (int off = kTeam / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        dq[f] = v * w;  // dq_raw
        s += (live ? qr[f] : 0.f) * dq[f];
      }
    }
#pragma unroll
    for (int f = 0; f < F::kLoop; ++f) {
      if (F::has(f, m) && f % kTeam == lane && pair) {
        const float dl = live ? qr[f] * (dq[f] - s) : 0.f;
        dlog[p * m + f] = dl;
        if (store) store_f32(g + in_ch + f, dl);
      }
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < nb * m; p += blockDim.x) {
    const int r = p / m, f = p - r * m;
    float d = 0.f;
    if (row0 + r < t.n) {
      for (int k = 0; k < k1; ++k) d += dlog[(r * k1 + k) * m + f];
      dux[(size_t)(row0 + r) * m + f] = d;
    }
    sdux[p] = d;
  }
  __syncthreads();
  for (int f = threadIdx.x; f < m; f += blockDim.x) {
    float d = 0.f;
    for (int r = 0; r < nb; ++r) d += sdux[r * m + f];
    dc_part[(size_t)blockIdx.x * m + f] = d;
  }
}

template <typename T, int MM>
__global__ void __launch_bounds__(kThreads)
windowed_bwd_dwf_kernel(const T* __restrict__ cat, const T* __restrict__ ux,
                        const float* __restrict__ c, const float* __restrict__ mult_rows,
                        const float* __restrict__ gy, FwdTables t, float* __restrict__ dw_part,
                        int in_ch, int m_arg, int out, int cw, int rows, int to, int tf,
                        int fb) {
  extern __shared__ float smem[];
  const int m = Filters<MM>::m(m_arg);
  const int k1 = t.k_nbr + 1, cm = in_ch + m, mc = m * in_ch, zw = m * cw, op = 4 * to;
  const int zrs = kNbW + 1;
  float* sgy = smem;                   // first: its float4 rows stay 16-byte aligned
  float* z = sgy + kNbW * op;
  float* q = z + zw * zrs;
  int* src = reinterpret_cast<int*>(q + kNbW * k1 * m);
  const int c0 = blockIdx.y * cw;
  const int rbeg = blockIdx.x * rows, rend = min(t.n, rbeg + rows);
  const int tc = threadIdx.x % to, tg = threadIdx.x / to;
  const bool tiled = tg < tf;
  float acc[kMaxFB][4];
#pragma unroll
  for (int u = 0; u < kMaxFB; ++u)
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[u][o] = 0.f;
  for (int row0 = rbeg; row0 < rend; row0 += kNbW) {
    const int nb = min(kNbW, rend - row0);
    __syncthreads();  // the last tile's reads of z and sgy
    slot_phase<T, true, MM>(t, cat, ux, c, mult_rows, row0, nb, cm, in_ch, m, src, q, nullptr);
    for (int p = threadIdx.x; p < kNbW * op; p += blockDim.x) {
      const int r = p / op, o = p - r * op;
      sgy[p] = r < nb && o < out ? __ldg(gy + (size_t)(row0 + r) * out + o) : 0.f;
    }
    __syncthreads();
    slot_sums<T, MM>(cat, src, q, nb, k1, cm, m, c0, cw, in_ch, z, zrs);
    __syncthreads();
    if (tiled) {
#pragma unroll 4
      for (int r = 0; r < nb; ++r) {
        const float4 g = *reinterpret_cast<const float4*>(sgy + r * op + 4 * tc);
#pragma unroll
        for (int u = 0; u < kMaxFB; ++u) {
          const int fc = tg + tf * u;
          if (u < fb && fc < zw) {
            const float zv = z[fc * zrs + r];
            acc[u][0] += g.x * zv;
            acc[u][1] += g.y * zv;
            acc[u][2] += g.z * zv;
            acc[u][3] += g.w * zv;
          }
        }
      }
    }
  }
  if (!tiled) return;
#pragma unroll
  for (int u = 0; u < kMaxFB; ++u) {
    const int fc = tg + tf * u;
    if (u < fb && fc < zw) {
      const int f = fc / cw, cc = fc - f * cw;
      if (c0 + cc < in_ch) {
#pragma unroll
        for (int o = 0; o < 4; ++o)
          if (4 * tc + o < out)
            dw_part[((size_t)blockIdx.x * out + 4 * tc + o) * mc + f * in_ch + c0 + cc] =
                acc[u][o];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
windowed_bwd_dcat_kernel(const T* __restrict__ dG, const int* __restrict__ out_starts,
                         const int* __restrict__ bwd_starts, const int* __restrict__ relS,
                         const uint8_t* __restrict__ validS, const int* __restrict__ tailS,
                         const uint8_t* __restrict__ tailV, T* __restrict__ dcat, int n,
                         int n_src, int cm, int block, int nblk, int bwd_window, int s_nbr,
                         int s_tail) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= n_src) return;  // a warp a row: uniform
  const bool owned = row < n;
  const int slots = owned ? s_nbr : s_tail;
  int b = 0, jj = 0, bs = 0;
  if (owned) {
    b = min(row / block, nblk - 1);
    jj = row - __ldg(out_starts + b);
    bs = __ldg(bwd_starts + b);
  }
  for (int c0 = 0; c0 < cm; c0 += 32 * kDcatCh) {
    float acc[kDcatCh];
#pragma unroll
    for (int v = 0; v < kDcatCh; ++v) acc[v] = 0.f;
    for (int s0 = 0; s0 < slots; s0 += 32) {
      // lane u decodes slot s0 + u's dG row (-1: not listed)
      int mine = -1;
      const int s = s0 + lane;
      if (s < slots) {
        if (owned) {
          const size_t e = ((size_t)b * s_nbr + s) * block + jj;
          if (__ldg(validS + e) != 0) {
            const int rel = __ldg(relS + e);
            const int k = rel / bwd_window;
            mine = (k + 1) * n + bs + (rel - k * bwd_window);
          }
        } else {
          const size_t e = (size_t)s * (n_src - n) + (row - n);
          if (__ldg(tailV + e) != 0) mine = n + __ldg(tailS + e);
        }
      }
      const int count = min(32, slots - s0);
      for (int u = 0; u < count; ++u) {
        const int src = __shfl_sync(0xffffffffu, mine, u);
        if (src < 0) continue;
        const T* g = dG + (size_t)src * cm;
#pragma unroll
        for (int v = 0; v < kDcatCh; ++v) {
          const int ch = c0 + lane + 32 * v;
          if (ch < cm) acc[v] += load_f32(g + ch);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < kDcatCh; ++v) {
      const int ch = c0 + lane + 32 * v;
      if (ch < cm) {
        if (owned) acc[v] += load_f32(dG + (size_t)row * cm + ch);
        store_f32(dcat + (size_t)row * cm + ch, acc[v]);
      }
    }
  }
}

// out[e] = sum over p of part[p, e], p in order: a thread an entry
__global__ void __launch_bounds__(kThreads)
windowed_sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out, int parts,
                          int count) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += __ldg(part + (size_t)p * count + e);
  out[e] = s;
}

// the same for many parts of few entries: a block an entry, a thread every
// 256th part in order, then a fixed tree over the threads
__global__ void __launch_bounds__(kThreads)
windowed_sum_many_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                               int parts, int count) {
  __shared__ float s[kThreads];
  const int e = blockIdx.x;
  float v = 0.f;
  for (int p = threadIdx.x; p < parts; p += kThreads) v += __ldg(part + (size_t)p * count + e);
  s[threadIdx.x] = v;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[e] = s[0];
}

// passes A and W, the kernels compiled for MM filters
template <typename T, int MM>
int launch_aw(const T* cat, const T* ux, const T* wf, const float* c, const float* mult_rows,
              const float* gy, const FwdTables& t, T* dG, float* dux, float* dc_part,
              float* dw_part, int in_ch, int m, int out, int nb, int smem_a, int grid_a,
              const PlanW& w, cudaStream_t s) {
  // each raised once past 48 KB (and not again while a CUDA graph captures)
  const cudaFuncAttribute smem_attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  static int raised_a = 48 * 1024, raised_w = 48 * 1024;
  cudaError_t err = cudaSuccess;
  if (smem_a > raised_a) {
    if ((err = cudaFuncSetAttribute(windowed_bwd_slots_kernel<T, MM>, smem_attr, smem_a)) != 0)
      return (int)err;
    raised_a = smem_a;
  }
  if (w.smem > raised_w) {
    if ((err = cudaFuncSetAttribute(windowed_bwd_dwf_kernel<T, MM>, smem_attr, w.smem)) != 0)
      return (int)err;
    raised_w = w.smem;
  }
  windowed_bwd_slots_kernel<T, MM><<<grid_a, kThreads, smem_a, s>>>(
      cat, ux, wf, c, mult_rows, gy, t, dG, dux, dc_part, in_ch, m, out, nb);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  windowed_bwd_dwf_kernel<T, MM><<<dim3(w.groups, w.chunks), kThreads, w.smem, s>>>(
      cat, ux, c, mult_rows, gy, t, dw_part, in_ch, m, out, w.cw, w.rows, w.to, w.tf, w.fb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* cat, const T* ux, const T* wf, const float* c, const float* mult_rows,
           const float* gy, const int* out_starts, const int* win_starts, const int* relT,
           const uint8_t* not_tail, const int* tailT, const int* bwd_out_starts,
           const int* bwd_starts, const int* relS, const uint8_t* validS, const int* tailS,
           const uint8_t* tailV, T* dG, float* dc_part, float* dw_part, T* dcat, float* dux,
           float* dwf, float* dc, int n, int n_src, int in_ch, int m, int out, int k_nbr,
           int block, int nblk, int bwd_window, int s_nbr, int s_tail, int n_dc_part,
           int n_dw_part, void* stream) {
  if (n <= 0) return 0;
  const int k1 = k_nbr + 1, cm = in_ch + m;
  if (m < 1 || m > kMaxM || in_ch < 1 || out < 1 || out > kMaxOut || k_nbr < 0 ||
      block < 1 || nblk < 1 || bwd_window < 1 || n_src < n || (n_src > n && tailS == nullptr) ||
      (size_t)k1 * n >= (1u << 31) || (size_t)n_src * cm >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  const int nb = plan_a(k1, in_ch, m, out);
  const PlanW w = plan_w(n, k1, in_ch, m, out);
  const int smem_a = a_bytes(nb, k1, in_ch, m, out);
  const int grid_a = (n + nb - 1) / nb;
  if (smem_a > kSmemMax || w.smem > kSmemMax || w.fb > kMaxFB || grid_a != n_dc_part ||
      w.groups != n_dw_part)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const FwdTables t{out_starts, win_starts, relT, not_tail, tailT, n, k_nbr, block, nblk};
  // the model's M = 9 compiled apart: its filter loops have no guards
  cudaError_t err = (cudaError_t)(
      m == 9 ? launch_aw<T, 9>(cat, ux, wf, c, mult_rows, gy, t, dG, dux, dc_part, dw_part,
                               in_ch, m, out, nb, smem_a, grid_a, w, s)
             : launch_aw<T, 0>(cat, ux, wf, c, mult_rows, gy, t, dG, dux, dc_part, dw_part,
                               in_ch, m, out, nb, smem_a, grid_a, w, s));
  if (err != cudaSuccess) return (int)err;
  const int rows_a_block = kThreads / 32;
  windowed_bwd_dcat_kernel<T><<<(n_src + rows_a_block - 1) / rows_a_block, kThreads, 0, s>>>(
      dG, bwd_out_starts, bwd_starts, relS, validS, tailS, tailV, dcat, n, n_src, cm, block,
      nblk, bwd_window, s_nbr, s_tail);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int count = out * m * in_ch;
  windowed_sum_parts_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      dw_part, dwf, w.groups, count);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  windowed_sum_many_parts_kernel<<<m, kThreads, 0, s>>>(dc_part, dc, grid_a, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The partials' counts that the entries expect for these sizes: sizes[0] the
// dc partials (pass A's blocks), sizes[1] the dwf partials (pass W's groups).
void windowed_conv_bwd_partials(int n, int in_ch, int m, int out, int k_nbr, int* sizes) {
  sizes[0] = (n + plan_a(k_nbr + 1, in_ch, m, out) - 1) / plan_a(k_nbr + 1, in_ch, m, out);
  sizes[1] = plan_w(n, k_nbr + 1, in_ch, m, out).groups;
}

// cat [n_src, C+M], ux [n, M], wf [out, M*C] (T), c [M], mult_rows [K'+1, n]
// and gy [n, out] (f32); the forward tables (out_starts, win_starts, relT,
// not_tail, tailT) and the backward ones (out_starts, bwd_starts, relS
// [nblk, S, block], validS; tailS [S_t, n_src - n] and tailV, or null without
// halo rows); scratch dG [(K'+1) * n, C+M] (T), dc_part [n_dc_part, M] and
// dw_part [n_dw_part, out * M*C] (f32, counts from windowed_conv_bwd_partials)
// -> dcat [n_src, C+M] (T), dux [n, M], dwf [out, M*C], dc [M] (f32), all
// contiguous on the current device. Launches on `stream` and returns
// cudaGetLastError() after the last launch (0 when all were accepted), or
// cudaErrorInvalidValue for sizes the kernels do not take.
int windowed_conv_bwd_f32(const float* cat, const float* ux, const float* wf, const float* c,
                          const float* mult_rows, const float* gy, const int* out_starts,
                          const int* win_starts, const int* relT, const uint8_t* not_tail,
                          const int* tailT, const int* bwd_out_starts, const int* bwd_starts,
                          const int* relS, const uint8_t* validS, const int* tailS,
                          const uint8_t* tailV, float* dG, float* dc_part, float* dw_part,
                          float* dcat, float* dux, float* dwf, float* dc, int n, int n_src,
                          int in_ch, int m, int out, int k_nbr, int block, int nblk,
                          int bwd_window, int s_nbr, int s_tail, int n_dc_part, int n_dw_part,
                          void* stream) {
  return launch(cat, ux, wf, c, mult_rows, gy, out_starts, win_starts, relT, not_tail, tailT,
                bwd_out_starts, bwd_starts, relS, validS, tailS, tailV, dG, dc_part, dw_part,
                dcat, dux, dwf, dc, n, n_src, in_ch, m, out, k_nbr, block, nblk, bwd_window,
                s_nbr, s_tail, n_dc_part, n_dw_part, stream);
}

// The same with cat, ux, wf, dG and dcat in bfloat16 (the JAX package's casts;
// dcat rounded once after its f32 sum).
int windowed_conv_bwd_bf16(const __nv_bfloat16* cat, const __nv_bfloat16* ux,
                           const __nv_bfloat16* wf, const float* c, const float* mult_rows,
                           const float* gy, const int* out_starts, const int* win_starts,
                           const int* relT, const uint8_t* not_tail, const int* tailT,
                           const int* bwd_out_starts, const int* bwd_starts, const int* relS,
                           const uint8_t* validS, const int* tailS, const uint8_t* tailV,
                           __nv_bfloat16* dG, float* dc_part, float* dw_part,
                           __nv_bfloat16* dcat, float* dux, float* dwf, float* dc, int n,
                           int n_src, int in_ch, int m, int out, int k_nbr, int block, int nblk,
                           int bwd_window, int s_nbr, int s_tail, int n_dc_part, int n_dw_part,
                           void* stream) {
  return launch(cat, ux, wf, c, mult_rows, gy, out_starts, win_starts, relT, not_tail, tailT,
                bwd_out_starts, bwd_starts, relS, validS, tailS, tailV, dG, dc_part, dw_part,
                dcat, dux, dwf, dc, n, n_src, in_ch, m, out, k_nbr, block, nblk, bwd_window,
                s_nbr, s_tail, n_dc_part, n_dw_part, stream);
}

}  // extern "C"
