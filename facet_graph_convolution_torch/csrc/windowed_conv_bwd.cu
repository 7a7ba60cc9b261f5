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
//  A. windowed_bwd_slots_kernel: a block of 256 threads a tile of 32 rows
//     (16 where shared memory is short: the model's convs), three blocks an
//     SM: the slot phase (windowed_conv.cuh); gy split hi + lo into shared
//     memory; dz = gy · wf of the tile on the tensor cores into shared
//     memory, a warp an n8 column tile of dz at a time for the tile's row
//     groups, wf's fragments straight from device memory (L2; zeros past
//     out and M*C), the next tile's loaded while this one's are multiplied;
//     then a team of 8 lanes a (row, slot) pair: its channels over the
//     lanes, dq summed over the team by shuffles, and the slot's row
//     [dx | dlog] written to dG [(K'+1) * n, C+M] in T (row k*n + i: the
//     self rows first; a dead slot's row is zeros); dux per row and the
//     block's dc partial. Under MM = 0 (any M) the team makes two sweeps
//     over the channels, dq by groups of 16 filters into shared memory,
//     then dx.
//  W. windowed_bwd_dwf_kernel: a block a (group of rows, chunk of channels,
//     out tile of 64, 32 or 16 columns) triple; for each tile of 64 rows (32
//     where a wider chunk then fits: each chunk repeats the slot phase) the
//     slot phase again, the tile's gy split into shared memory, the chunk's
//     z columns (rounded to T, as the forward makes them), then dW[o, kk] +=
//     gy^T · z on the tensor cores, a warp an m16 tile of out by up to 16 n8
//     tiles of the chunk's M*cw columns, the accumulators in registers across
//     the row tiles; at the end the block writes its group's partial of dwf.
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
// The products on the tensor cores (mma.sync.m16n8k8 TF32, windowed_conv.cuh):
// in f32 both operands are split hi + lo (3xTF32); in bf16 gy stays f32 (the
// plain version does not round it) and is split, while wf and z are bfloat16
// values, exact in TF32 (2xTF32). Each k-step's products are summed apart
// and added to the f32 accumulator (the tensor cores truncate as they
// accumulate). Shared memory strides, padded, not swizzled: gy's rows in
// pass A out + 4 floats (4 mod 8: an A fragment's rows gid 4 banks apart);
// dz's rows M*C rounded to 8, then to 16 mod 32 (the teams of a warp that
// straddle two rows read the two halves of the banks); in pass W gy's and
// z's rows 8 mod 16 (a fragment's rows tig 8 banks apart, its columns gid
// fill them).
//
// What bounds it on an H100. At upconv1 of the torus's level 0 (1,273,920
// rows, C = 64, M = 9, out = 32, K' = 12) a row costs M*C*out = 18,432
// multiply-adds for dz and as many for dwf, 94 GFLOP a launch, 0.57 ms at
// 495 / 3 TFLOP/s (3xTF32); on the CUDA cores 2*(K'+1)*M*C for dq and dx and
// (K'+1)*M*C to recompute z in W, ~22,500 FMAs a row, 57 GFLOP, 0.86 ms at
// 67 TFLOP/s; against ~2.9 GB of bytes (dG written and read, cat read twice,
// dcat written), ~0.9 ms at 3.35 TB/s. The passes run far from that: their
// phases (slot phase, products, teams; W's slot phase a chunk) follow each
// other within a block, and the gathers through L2 wait at ~24 warps an SM
// (PERF.md, PR 21: the phase split).

#include <algorithm>

#include "windowed_conv.cuh"

namespace {

using namespace windowed;

constexpr int kTeam = 8;     // lanes a (row, slot) pair in pass A
constexpr int kNFW = 16;     // n8 column tiles a warp in pass W, at most
constexpr int kTargetBlocks = 132 * 8;
constexpr int kDcatCh = 4;   // channels a lane in pass D (a warp a row, 128 channels a pass)

int region(int bytes) { return round_up(bytes, 128); }

struct PlanA {
  int nb, gyld, dzs, off_dz, off_q, off_mr, off_dlog, off_dux, off_src, smem;
};

PlanA plan_a_with(int k1, int in_ch, int m, int out, int nb) {
  PlanA p;
  p.nb = nb;
  p.gyld = round_up(out, 8) + 4;
  p.dzs = ld_pad(round_up(m * in_ch, 8), 32, 16);
  p.off_dz = region(2 * nb * p.gyld * 4);  // gy's hi and lo
  p.off_q = p.off_dz + region(nb * p.dzs * 4);
  p.off_mr = p.off_q + region(nb * k1 * m * 4);
  p.off_dlog = p.off_mr + region(nb * k1 * 4);
  p.off_dux = p.off_dlog + region(nb * k1 * m * 4);
  p.off_src = p.off_dux + region(nb * m * 4);
  p.smem = p.off_src + region(nb * k1 * 4);
  return p;
}

// 32 rows a tile, else 16, at two blocks an SM, else one (16 rows take
// ~60 KB at the model's level 0: three blocks); smem = -1 when
// even 16 rows do not fit (dz's M*C floats a row, gy's out)
PlanA plan_a(int k1, int in_ch, int m, int out) {
  for (const int budget : {kSmemBudget, kSmemMax})
    for (const int nb : {32, 16}) {
      const PlanA p = plan_a_with(k1, in_ch, m, out, nb);
      if (p.smem <= budget) return p;
    }
  PlanA p = plan_a_with(k1, in_ch, m, out, 16);
  p.smem = -1;
  return p;
}

struct PlanW {
  int nbw, cw, chunks, otw, otiles, kwp, zld, gyld, rows, groups, off_z, off_q, off_src, smem;
};

PlanW plan_w_with(int n, int k1, int in_ch, int m, int out, int otw, int cw, int nbw) {
  PlanW p;
  p.nbw = nbw;
  p.otw = otw;
  p.otiles = (out + otw - 1) / otw;
  p.chunks = (in_ch + cw - 1) / cw;
  p.cw = (in_ch + p.chunks - 1) / p.chunks;  // the chunks balanced
  p.kwp = round_up(m * p.cw, 8);
  p.zld = ld_pad(p.kwp, 16, 8);
  p.gyld = otw + 8;
  p.off_z = region(2 * nbw * p.gyld * 4);  // gy's hi and lo
  p.off_q = p.off_z + region(nbw * p.zld * 4);
  p.off_src = p.off_q + region(nbw * k1 * m * 4);
  p.smem = p.off_src + region(nbw * k1 * 4);
  const int tiles = (n + nbw - 1) / nbw;
  const int per = p.chunks * p.otiles;
  const int groups = std::max(1, std::min(tiles, (kTargetBlocks + per - 1) / per));
  p.rows = (tiles + groups - 1) / groups * nbw;
  p.groups = (n + p.rows - 1) / p.rows;
  return p;
}

// an out tile of 64, 32 or 16 columns (the least of those that holds out,
// then halved), mt = otw / 16 m16 tiles: mt divides the 8 warps, so warp w
// takes m16 tile w % mt and every (8 / mt)-th n8 tile from w / mt, kNFW of
// them, and the chunk's M*cw z columns, rounded to 8, stay within the
// 8 * kNFW * 8 / mt that the warps cover; the widest chunk (each chunk
// repeats the slot phase), then the most rows a tile (64, 32), that fit
// the shared memory
PlanW plan_w(int n, int k1, int in_ch, int m, int out) {
  for (const int budget : {kSmemBudget, kSmemMax})
    for (int otw = out > 32 ? 64 : out > 16 ? 32 : 16; otw >= 16; otw /= 2) {
      const int max_kwp = 8 * kNFW * 8 / (otw / 16);
      for (int cw = std::min(in_ch, max_kwp / m); cw >= 1; cw /= 2)
        for (const int nbw : {64, 32}) {
          const PlanW p = plan_w_with(n, k1, in_ch, m, out, otw, cw, nbw);
          if (p.smem <= budget) return p;
        }
    }
  PlanW p = plan_w_with(n, k1, in_ch, m, out, 16, 1, 32);
  p.smem = -1;
  return p;
}

template <typename T, int MM>
__global__ void __launch_bounds__(kThreads, 3)
windowed_bwd_slots_kernel(const T* __restrict__ cat, const T* __restrict__ ux,
                          const T* __restrict__ wf, const float* __restrict__ c,
                          const float* __restrict__ mult_rows, const float* __restrict__ gy,
                          FwdTables t, T* __restrict__ dG, float* __restrict__ dux,
                          float* __restrict__ dc_part, int in_ch, int m_arg, int out, PlanA pa) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int m = Filters<MM>::m(m_arg);
  const int k1 = t.k_nbr + 1, cm = in_ch + m, mc = m * in_ch, nb = pa.nb;
  const int outp = round_up(out, 8), gyld = pa.gyld, dzs = pa.dzs;
  uint32_t* gyh = reinterpret_cast<uint32_t*>(smem);  // [nb][gyld], gy split
  uint32_t* gyl = gyh + nb * gyld;
  float* dz = reinterpret_cast<float*>(smem + pa.off_dz);  // [nb][dzs]
  float* qraw = reinterpret_cast<float*>(smem + pa.off_q);
  float* mr = reinterpret_cast<float*>(smem + pa.off_mr);
  float* dlog = reinterpret_cast<float*>(smem + pa.off_dlog);
  float* sdux = reinterpret_cast<float*>(smem + pa.off_dux);
  int* src = reinterpret_cast<int*>(smem + pa.off_src);
  const int row0 = blockIdx.x * nb;

  slot_phase<T, false, MM>(t, cat, ux, c, mult_rows, row0, nb, cm, in_ch, m, src, qraw, mr);
  for (int e = threadIdx.x; e < nb * outp; e += blockDim.x) {
    const int r = e / outp, o = e - r * outp;
    store_split(gyh, gyl, r * gyld + o,
                row0 + r < t.n && o < out ? __ldg(gy + (size_t)(row0 + r) * out + o) : 0.f);
  }
  __syncthreads();
  {
    // dz = gy · wf: a warp an n8 tile of dz's M*C columns for both row
    // groups, k over out in steps of 8, kKC steps an item (tile, chunk of
    // out); the next item's wf values (device memory, L2) are loaded while
    // this one's are multiplied
    constexpr int kKC = 8;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gid = lane >> 2, tig = lane & 3, rg = nb / 16;
    const int ntn = (mc + 7) / 8, nkc = (outp + 8 * kKC - 1) / (8 * kKC);
    const int items = warp < ntn ? (ntn - warp + 7) / 8 * nkc : 0;
    auto load_b = [&](int it, float (&b)[kKC][2]) {
      const int col = (warp + 8 * (it / nkc)) * 8 + gid, kc = it % nkc * 8 * kKC;
#pragma unroll
      for (int u = 0; u < kKC; ++u) {
        const int o = kc + 8 * u + tig;
        b[u][0] = col < mc && o < out ? load_f32(wf + (size_t)o * mc + col) : 0.f;
        b[u][1] = col < mc && o + 4 < out ? load_f32(wf + (size_t)(o + 4) * mc + col) : 0.f;
      }
    };
    float bv[kKC][2], d[2][4];
    if (items > 0) load_b(0, bv);
    for (int it = 0; it < items; ++it) {
      const int tn = warp + 8 * (it / nkc), kc = it % nkc * 8 * kKC;
      float bn[kKC][2];
      if (it + 1 < items) load_b(it + 1, bn);
      if (kc == 0) {
#pragma unroll
        for (int g = 0; g < 2; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[g][e] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < kKC; ++u) {
        const int k0 = kc + 8 * u;
        if (k0 >= outp) break;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(bv[u][0], bh0, bl0);
        split_tf32(bv[u][1], bh1, bl1);
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          if (g < rg) {
            const int e = (g * 16 + gid) * gyld + k0 + tig;
            SplitA a;
            a.load(gyh, gyl, e, e + 8 * gyld, e + 4, e + 8 * gyld + 4);
            mma_split<kF32>(d[g], a, bh0, bh1, bl0, bl1);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kKC; ++u) bv[u][0] = bn[u][0], bv[u][1] = bn[u][1];
      if (kc + 8 * kKC < outp) continue;
      for (int g = 0; g < 2; ++g) {
        if (g < rg) {
          float* dr = dz + (g * 16 + gid) * dzs + tn * 8 + 2 * tig;
          dr[0] = d[g][0];
          dr[1] = d[g][1];
          dr[8 * dzs] = d[g][2];
          dr[8 * dzs + 1] = d[g][3];
        }
      }
    }
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
    if constexpr (MM > 0) {
      float q[MM], dq[MM];
#pragma unroll
      for (int f = 0; f < MM; ++f) {
        q[f] = live ? rd<T>(qr[f] * w) : 0.f;
        dq[f] = 0.f;
      }
#pragma unroll 4
      for (int ch = lane; ch < in_ch; ch += kTeam) {
        const float x = j >= 0 ? load_f32(cat + (size_t)j * cm + ch) : 0.f;
        float dx = 0.f;
#pragma unroll
        for (int f = 0; f < MM; ++f) {
          const float d = dzr[f * in_ch + ch];
          dq[f] += d * x;
          dx += d * q[f];
        }
        if (store) store_f32(g + ch, dx);
      }
      float s = 0.f;
#pragma unroll
      for (int f = 0; f < MM; ++f) {
        float v = dq[f];
#pragma unroll
        for (int off = kTeam / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        dq[f] = v * w;  // dq_raw
        s += (live ? qr[f] : 0.f) * dq[f];
      }
#pragma unroll
      for (int f = 0; f < MM; ++f) {
        if (f % kTeam == lane && pair) {
          const float dl = live ? qr[f] * (dq[f] - s) : 0.f;
          dlog[p * MM + f] = dl;
          if (store) store_f32(g + in_ch + f, dl);
        }
      }
    } else {
      // any M: dq by groups of kMGroup filters into the pair's dlog row
      // (dq_raw), then dx, then dlog in place
      for (int f0 = 0; f0 < m; f0 += kMGroup) {
        float dq[kMGroup];
#pragma unroll
        for (int f = 0; f < kMGroup; ++f) dq[f] = 0.f;
        for (int ch = lane; ch < in_ch; ch += kTeam) {
          const float x = j >= 0 ? load_f32(cat + (size_t)j * cm + ch) : 0.f;
#pragma unroll
          for (int f = 0; f < kMGroup; ++f)
            if (f0 + f < m) dq[f] += dzr[(f0 + f) * in_ch + ch] * x;
        }
#pragma unroll
        for (int f = 0; f < kMGroup; ++f) {
          if (f0 + f < m) {
            float v = dq[f];
#pragma unroll
            for (int off = kTeam / 2; off > 0; off >>= 1)
              v += __shfl_xor_sync(0xffffffffu, v, off);
            if ((f0 + f) % kTeam == lane && pair) dlog[p * m + f0 + f] = v * w;
          }
        }
      }
      __syncwarp();
      for (int ch = lane; ch < in_ch; ch += kTeam) {
        float dx = 0.f;
        for (int f = 0; f < m; ++f) dx += dzr[f * in_ch + ch] * (live ? rd<T>(qr[f] * w) : 0.f);
        if (store) store_f32(g + ch, dx);
      }
      float s = 0.f;
      if (pair)
        for (int f = 0; f < m; ++f) s += (live ? qr[f] : 0.f) * dlog[p * m + f];
      __syncwarp();
      if (pair) {
        for (int f = lane; f < m; f += kTeam) {
          const float dl = live ? qr[f] * (dlog[p * m + f] - s) : 0.f;
          dlog[p * m + f] = dl;
          if (store) store_f32(g + in_ch + f, dl);
        }
      }
      __syncwarp();
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
__global__ void __launch_bounds__(kThreads, 2)
windowed_bwd_dwf_kernel(const T* __restrict__ cat, const T* __restrict__ ux,
                        const float* __restrict__ c, const float* __restrict__ mult_rows,
                        const float* __restrict__ gy, FwdTables t, float* __restrict__ dw_part,
                        int in_ch, int m_arg, int out, PlanW pw) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int m = Filters<MM>::m(m_arg);
  const int k1 = t.k_nbr + 1, cm = in_ch + m, mc = m * in_ch, zw = m * pw.cw;
  const int gyld = pw.gyld, zld = pw.zld;
  // gy's out-tile columns split [nbw][gyld]; z [nbw][zld] (a bfloat16 z
  // is exact in TF32)
  const int nbw = pw.nbw;
  uint32_t* gyh = reinterpret_cast<uint32_t*>(smem);
  uint32_t* gyl = gyh + nbw * gyld;
  float* z = reinterpret_cast<float*>(smem + pw.off_z);
  float* q = reinterpret_cast<float*>(smem + pw.off_q);
  int* src = reinterpret_cast<int*>(smem + pw.off_src);
  const int c0 = blockIdx.y * pw.cw, o0 = blockIdx.z * pw.otw;
  const int rbeg = blockIdx.x * pw.rows, rend = min(t.n, rbeg + pw.rows);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mt = pw.otw / 16, tm = warp % mt, tn0 = warp / mt, tstep = 8 / mt;
  const int ntn = pw.kwp / 8;
  float acc[kNFW][4];
#pragma unroll
  for (int u = 0; u < kNFW; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
  // z's k padding and the rows a short tile leaves stay zero
  for (int e = threadIdx.x; e < nbw * zld; e += blockDim.x) z[e] = 0.f;
  for (int row0 = rbeg; row0 < rend; row0 += nbw) {
    const int nb = min(nbw, rend - row0);
    __syncthreads();  // the last tile's reads of z and sgy
    slot_phase<T, true, MM>(t, cat, ux, c, mult_rows, row0, nb, cm, in_ch, m, src, q, nullptr);
    for (int e = threadIdx.x; e < nbw * pw.otw; e += blockDim.x) {
      const int r = e / pw.otw, o = e - r * pw.otw;
      store_split(gyh, gyl, r * gyld + o,
                  r < nb && o0 + o < out ? __ldg(gy + (size_t)(row0 + r) * out + o0 + o) : 0.f);
    }
    __syncthreads();
    slot_sums<T, MM>(cat, src, q, nb, k1, cm, m, c0, pw.cw, in_ch, z, zld);
    __syncthreads();
    // dW[o, kk] += sum_r gy[r, o] z[r, kk]: A = gy^T (out x rows), B = z
#pragma unroll 4
    for (int k0 = 0; k0 < nbw; k0 += 8) {
      const int ea = (k0 + tig) * gyld + tm * 16 + gid;
      SplitA a;
      a.load(gyh, gyl, ea, ea + 8, ea + 4 * gyld, ea + 4 * gyld + 8);
      const float* zb = z + (k0 + tig) * zld + gid;
#pragma unroll
      for (int u = 0; u < kNFW; ++u) {
        const int tn = tn0 + tstep * u;
        if (tn < ntn) mma_split<kF32>(acc[u], a, zb[tn * 8], zb[4 * zld + tn * 8]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kNFW; ++u) {
    const int tn = tn0 + tstep * u;
    if (tn >= ntn) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + tm * 16 + gid + 8 * h;
      if (o >= out) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = tn * 8 + 2 * tig + e;
        const int f = kk / pw.cw, cc = kk - f * pw.cw;
        if (kk < zw && c0 + cc < in_ch)
          dw_part[((size_t)blockIdx.x * out + o) * mc + f * in_ch + c0 + cc] = acc[u][2 * h + e];
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
              float* dw_part, int in_ch, int m, int out, const PlanA& a, int grid_a,
              const PlanW& w, cudaStream_t s) {
  // each raised once past 48 KB (and not again while a CUDA graph captures)
  const cudaFuncAttribute smem_attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  static int raised_a = 48 * 1024, raised_w = 48 * 1024;
  cudaError_t err = cudaSuccess;
  if (a.smem > raised_a) {
    if ((err = cudaFuncSetAttribute(windowed_bwd_slots_kernel<T, MM>, smem_attr, a.smem)) != 0)
      return (int)err;
    raised_a = a.smem;
  }
  if (w.smem > raised_w) {
    if ((err = cudaFuncSetAttribute(windowed_bwd_dwf_kernel<T, MM>, smem_attr, w.smem)) != 0)
      return (int)err;
    raised_w = w.smem;
  }
  windowed_bwd_slots_kernel<T, MM><<<grid_a, kThreads, a.smem, s>>>(
      cat, ux, wf, c, mult_rows, gy, t, dG, dux, dc_part, in_ch, m, out, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  windowed_bwd_dwf_kernel<T, MM><<<dim3(w.groups, w.chunks, w.otiles), kThreads, w.smem, s>>>(
      cat, ux, c, mult_rows, gy, t, dw_part, in_ch, m, out, w);
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
  if (m < 1 || in_ch < 1 || out < 1 || k_nbr < 0 || block < 1 || nblk < 1 || bwd_window < 1 ||
      n_src < n || (n_src > n && tailS == nullptr) || (size_t)k1 * n >= (1u << 31) ||
      (size_t)n_src * cm >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  const PlanA a = plan_a(k1, in_ch, m, out);
  const PlanW w = plan_w(n, k1, in_ch, m, out);
  const int grid_a = (n + a.nb - 1) / a.nb;
  if (a.smem < 0 || w.smem < 0 || grid_a != n_dc_part || w.groups != n_dw_part)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const FwdTables t{out_starts, win_starts, relT, not_tail, tailT, n, k_nbr, block, nblk};
  // the model's M = 9 compiled apart: its filter loops have no guards
  cudaError_t err = (cudaError_t)(
      m == 9 ? launch_aw<T, 9>(cat, ux, wf, c, mult_rows, gy, t, dG, dux, dc_part, dw_part,
                               in_ch, m, out, a, grid_a, w, s)
             : launch_aw<T, 0>(cat, ux, wf, c, mult_rows, gy, t, dG, dux, dc_part, dw_part,
                               in_ch, m, out, a, grid_a, w, s));
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
// dc partials (pass A's blocks), sizes[1] the dwf partials (pass W's groups);
// -1 for a pass whose smallest tile does not fit a block's 227 KB of shared
// memory (pass A: dz's M*C floats and gy's out a row, for 16 rows).
void windowed_conv_bwd_partials(int n, int in_ch, int m, int out, int k_nbr, int* sizes) {
  const PlanA a = plan_a(k_nbr + 1, in_ch, m, out);
  const PlanW w = plan_w(n, k_nbr + 1, in_ch, m, out);
  sizes[0] = a.smem < 0 ? -1 : (n + a.nb - 1) / a.nb;
  sizes[1] = w.smem < 0 ? -1 : w.groups;
}

// The device-memory bytes one launch moves at these sizes under the passes'
// plans (-1 where a pass does not fit), each pass reading what it touches
// once (the RCM band keeps a block's gathered rows in L2). Pass A reads cat,
// the row inputs (fwd_row_bytes), wf, c and gy and writes dG, dux and the dc
// partials; pass W reads, a chunk and an out tile, the row inputs and cat's
// M logit columns, cat's channels once an out tile and gy once a chunk, and
// writes the dwf partials; pass D reads dG and the backward tables and
// writes dcat; the sums read the partials and write dwf and dc.
double windowed_conv_bwd_bytes(int n, int n_src, int in_ch, int m, int out, int k_nbr,
                               int block, int nblk, int s_nbr, int s_tail, int bf16) {
  const PlanA a = plan_a(k_nbr + 1, in_ch, m, out);
  const PlanW w = plan_w(n, k_nbr + 1, in_ch, m, out);
  if (a.smem < 0 || w.smem < 0) return -1.0;
  const double sz = bf16 ? 2.0 : 4.0, cm = in_ch + m;
  const double rows = fwd_row_bytes(n, n_src, m, k_nbr, block, nblk, sz);
  const double cat = n_src * cm * sz, wf = (double)out * m * in_ch * sz, gy = 4.0 * n * out;
  const double dg = (double)(k_nbr + 1) * n * cm * sz;
  const double dw_part = 4.0 * w.groups * out * m * in_ch;
  const double dc_part = 4.0 * ((n + a.nb - 1) / a.nb) * m;
  const double bwd_tabs = 4.0 * nblk + 5.0 * nblk * s_nbr * block +
                          (n_src > n ? 5.0 * s_tail * (n_src - n) : 0.0);
  const double pass_a = cat + rows + wf + 4.0 * m + gy + dg + 4.0 * n * m + dc_part;
  const double pass_w = (double)w.chunks * w.otiles * (rows + (double)n_src * m * sz) +
                        (double)w.otiles * n_src * in_ch * sz + w.chunks * gy + dw_part;
  const double pass_d = dg + bwd_tabs + cat;
  const double sums = dw_part + dc_part + 4.0 * out * m * in_ch + 4.0 * m;
  return pass_a + pass_w + pass_d + sums;
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
