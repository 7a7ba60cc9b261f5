// Facet-conv backward epilogue with the gather's transpose fused in (K2).
//
// Replaces facet_graph_convolution_tpu/ops/pallas_conv.py::_epilogue_bwd_kernel
// (launched by _conv_epilogue_bwd) and the scatter-free gather backward
// _gsm_bwd that XLA runs after it. For node i and live slot k = 0..K' (slot 0
// is the node itself, slot k > 0 is j = adj_sm[k-1, i] - 1; w = mult_rows[k, i]),
// with s = softmax_M(ux[i] + cat[j, C:] + c) recomputed as the TPU kernel does
// and dz_m = dz[i, m*C : (m+1)*C]:
//
//   dx[ch]  = sum_m w * s[m] * dz_m[ch]
//   dq[m]   = w * <cat[j, :C], dz_m>
//   dlog[m] = s[m] * (dq[m] - <s, dq>)
//   dux[i]  = sum_k dlog                 (dc = sum_i dux[i], in the wrapper)
//
// and the row [dx | dlog] of slot k belongs to cat[j]:
//
//   dcat[j] = [dx | dlog] of j's self slot + sum over the slots that read j
//
// cat may hold more rows than the N outputs (N_src >= N, the halo rows of a
// shard of a partitioned graph after its own rows; parallel/halo.py): the
// neighbour slots index into all N_src rows, and dcat has N_src rows, of
// which only the first N have a self slot.
//
// The kernels are templates on the storage type of cat, ux, dz and dcat:
// float32, or bfloat16 (compute_dtype="bfloat16", as _conv_epilogue_bwd runs
// it there). Each load is upcast and everything is computed in f32; dux is
// f32 in both (the wrapper casts it to ux's dtype, and takes dc from the f32
// sum); dcat is rounded to bfloat16 once, after the f32 transpose-map sum
// (the TPU kernel rounds each slot's dg row before XLA sums them). The
// scratch dg and the dz tiles in shared memory stay f32 in both: a bf16 dg
// would round every slot's row before the sum and add a rounding that
// neither the f32 kernel nor the JAX package has at that point, for half of
// its ~100 MB round trip; the f32 tiles keep the shared-memory limits
// (facet_conv_bwd_max_m) the same for both types. In bfloat16 the dz tile is
// loaded with plain loads, converted, rather than by cp.async. The bfloat16
// entry is compiled apart, by facet_conv_bwd_bf16.cu (which includes this
// file with FACET_CONV_BWD_BF16 defined), so that nvcc builds the two types'
// ~50 kernels as two libraries in parallel.
//
// What bounds it on an H100: memory. Per node it reads M*C floats of dz and
// writes C+M floats per live slot; dz alone is 57 MB at dconv1 (N' = 24,576,
// C = 64, M = 9), against ~13 * 4 * M * C flops a node (~0.7 GFLOP, ~11 us at
// the 67 TFLOP/s f32 rate). The two-pass split below adds the scratch dg,
// written once and read once: its round trip, ~42 us at dconv1, is the floor
// of this design beside the ~23 us bound. Measured (PERF.md, PR 6), pass A
// stays ~2x above its own bytes: with its dz loads, x loads and stores all
// removed it still takes half its time at dconv1, so per-slot instruction
// issue and latency, not bytes, bound it now.
//
// Design, two passes, no atomics, bitwise repeatable:
// - Pass A, a team of T lanes per (node, slot), T = 1, 2, 4, 8 or 16 by width
//   class (C <= 8, 32, 64, 128, more): a lane owns ~8-16 channels, and at
//   C = 6 a thread owns a slot, so conv1 keeps every lane busy. A block
//   takes NB consecutive nodes and all their slot teams (~500 threads). It
//   copies the NB nodes' dz rows into shared memory (16-byte cp.async when
//   they are one aligned range), so dz is read from HBM once. Each team
//   computes its slot's softmax over its lanes (a lane holds M / T logits;
//   max and sum are log2(T) shuffle rounds), walks the channels 4 * T at a
//   time (the lane's 4 channels of x, coalesced over the team; the node's dz
//   as float4 from the tile; dq partials and 4 channels of dx), writes dx as
//   float4 stores the team coalesces, and reduces dq over the team in log2(T)
//   rounds of M shuffles. (The earlier design, one warp per node, spent ~45
//   shuffles a slot on warp-wide reductions and left 26 of 32 lanes idle at
//   C = 6.) Every slot's row [dx | dlog | 0 pad] goes to dg[k*N + i], the self
//   slot's included; rows are padded to 8 floats and written as whole float4s
//   (the row's tail by the lanes in turn), so that whole 32-byte sectors are
//   written. Dead slots write nothing. dux[i] sums i's dlog in slot order,
//   from shared memory after a block barrier.
//   At the model's shapes the blocks are persistent and pipelined
//   (slot_cotangents_pipelined): each walks groups of NB nodes with the next
//   group's dz rows copying into a second tile and its slots' indices, logits
//   and first channels of x loading while the current group computes. Wider
//   shapes take one block a group (slot_cotangents_kernel), in rounds of
//   slot teams and tiles of channels as the block and the budget allow.
//   M > 32 takes one general kernel (slot_cotangents_any_m): a warp a node,
//   its slot's s and dq in shared memory rather than registers.
// - Pass B, source-centric: a team of 8, 16 or 32 lanes per node j (the
//   smallest that covers C+M, up to 32) starts from j's self row (if live)
//   and adds the rows of dg that its transpose map adj_t_sm[j] lists (one-
//   indexed flat slots k*N + i, 0 = pad: row N + that) in the map's order,
//   four rows' loads in flight at a time, into dcat[j], for each of the N_src
//   source rows (only j < N has a self row). A slot is read only
//   when pass A wrote it (mult != 0 and adj_sm at that slot names j), so dg
//   needs no clearing and a bad table cannot read unwritten memory.
// dg at dconv1 is ~100 MB and outlives L2 (50 MB); reading dz from the source
// side instead would read it about K' times.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "storage.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreadsA = 512;   // pass A: the most threads a block takes
constexpr int kThreadsB = 256;
constexpr int kThreadsAnyM = 128;   // pass A for M > 32: 4 warps, a node each
constexpr int kSmemMax = 232448;    // the most a block can use (227 KB)
// dynamic shared memory a pass-A block may take (the SM has 227 KB)
constexpr int kSmemBudget = 96 * 1024;

// Asynchronous copies global -> shared (cp.async, sm_80+): the copies of a
// phase are all in flight at once and hold no registers. 4 bytes, zero-filled
// when !valid, for a ragged tile; 16 bytes (L2 only) for a contiguous one.
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src) : "memory");
}

// waits for this thread's copies; a __syncthreads() must follow
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// dz[i0 .. i0+nb) columns [t0, t0+tcn) into the tile [nb][m][tc] (node
// stride ns), zeros past C and past N: cp.async in f32; in bfloat16 plain
// loads, upcast, stored to the f32 tile (no copy stays in flight)
template <typename S>
__device__ __forceinline__ void tile_put(float* dst, const S* src, bool valid) {
  if constexpr (std::is_same<S, float>::value) copy_async(dst, src, valid);
  else *dst = valid ? load_f32(src) : 0.f;
}

template <typename S>
__device__ __forceinline__ void load_tile(float* tile, const S* __restrict__ dz, int i0,
                                          int nb, int n, int m, int c_in, int t0, int tcn,
                                          int tc, int ns, int P, int tid) {
  const int total = nb * m * tcn;
  for (int e = tid; e < total; e += P) {
    const int row = e / tcn, col = e - (e / tcn) * tcn;
    const int nl = row / m, a = row - (row / m) * m;
    const int ii = i0 + nl;
    const bool ok = ii < n && t0 + col < c_in;
    tile_put(tile + nl * ns + a * tc + col,
             dz + ((size_t)min(ii, n - 1) * m + a) * c_in + (ok ? t0 + col : 0), ok);
  }
}

// The block's dz rows when one tile holds all C channels unpadded: one
// contiguous range of dz (nb * M * C floats), copied 16 bytes at a time
// (4-byte copies cost ~40 cycles a warp instruction). Rows of nodes past N
// are left unset: no live slot reads them. In bfloat16 each thread loads 4
// values (two aligned bf16 pairs, 8 bytes) and stores them upcast as a float4.
template <typename S>
__device__ __forceinline__ void vec_put(float* dst, const S* src) {
  if constexpr (std::is_same<S, float>::value) copy_async16(dst, src);
  else *reinterpret_cast<float4*>(dst) = load4_f32(src);
}

template <typename S>
__device__ __forceinline__ void load_tile_contiguous(float* tile, const S* __restrict__ dz,
                                                     int i0, int nb, int n, int m, int c_in,
                                                     int ns, int P, int tid) {
  const int row = m * c_in;   // values a node, a multiple of 4
  const int vecs = min(nb, n - i0) * row / 4;
  const S* src = dz + (size_t)i0 * row;
  for (int v = tid; v < vecs; v += P) {
    const int e = 4 * v, nl = e / row;
    vec_put(tile + nl * ns + (e - nl * row), src + e);
  }
}

// A slot's index: w = mult_rows[k, i] and its source row j, or w = 0, j = -1
// for a dead slot (mult 0, a pad, or no slot at all).
__device__ __forceinline__ void slot_index(const float* __restrict__ mult_rows,
                                           const int* __restrict__ adj_sm, int n, int n_src,
                                           int k, int i, bool in, float& w, int& j) {
  w = 0.f;
  j = -1;
  if (in) {
    w = __ldg(mult_rows + (size_t)k * n + i);
    j = k == 0 ? i : __ldg(adj_sm + (size_t)(k - 1) * n + i) - 1;
  }
  if (!(w != 0.f && (unsigned)j < (unsigned)n_src)) {
    w = 0.f;
    j = -1;
  }
}

// The loads that depend on a live slot's row j: this lane's logit inputs
// ux[i, a] + cat[j, C + a] + c[a], a = tl + T * u (-inf past M and for a
// dead slot).
template <int MM, int T, typename S>
__device__ __forceinline__ void slot_logits(const S* __restrict__ cat,
                                            const S* __restrict__ ux,
                                            const float* __restrict__ cvec, int i, int j,
                                            int width, int c_in, int m, int tl,
                                            float (&lg)[(MM + T - 1) / T]) {
  const S* vrow = cat + (size_t)(j >= 0 ? j : 0) * width + c_in;
#pragma unroll
  for (int u = 0; u < (MM + T - 1) / T; ++u) {
    const int a = tl + T * u;
    lg[u] = j >= 0 && a < m
                ? load_f32(ux + (size_t)i * m + a) + load_f32(vrow + a) + __ldg(cvec + a)
                : -INFINITY;
  }
}

constexpr int kXS = 2;   // steps of 4 channels of x a lane loads ahead

// The lane's first kXS steps of 4 channels of x from row j (0 for a dead
// slot or past C).
template <int T, typename S>
__device__ __forceinline__ void slot_x(const S* __restrict__ cat, int j, int width,
                                       int c_in, int tl, float (&xp)[kXS][4]) {
  const S* xrow = cat + (size_t)(j >= 0 ? j : 0) * width;
#pragma unroll
  for (int st = 0; st < kXS; ++st)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = 4 * tl + 4 * T * st + e;
      xp[st][e] = j >= 0 && ch < c_in ? load_f32(xrow + ch) : 0.f;
    }
}

// softmax over the team's lanes (max and sum in log2(T) shuffle rounds),
// then every lane gets all M values of s
template <int MM, int T>
__device__ __forceinline__ void slot_softmax(float (&lg)[(MM + T - 1) / T], bool live, int m,
                                             int tl, float (&s)[MM]) {
  constexpr int UA = (MM + T - 1) / T;
  float mx = -INFINITY;
#pragma unroll
  for (int u = 0; u < UA; ++u) mx = fmaxf(mx, lg[u]);
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off, T));
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < UA; ++u) {
    lg[u] = live && tl + T * u < m ? expf(lg[u] - mx) : 0.f;
    sum += lg[u];
  }
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(kFullMask, sum, off, T);
#pragma unroll
  for (int u = 0; u < UA; ++u) lg[u] = live ? lg[u] / sum : 0.f;
#pragma unroll
  for (int a = 0; a < MM; ++a) s[a] = __shfl_sync(kFullMask, lg[a / T], a % T, T);
}

// A live slot's channels [t0, t0 + tcn) of one tile: the lane's 4 channels a
// step (x from xp for the first kXS steps of the first tile), dq partials,
// and dx written as float4 to the slot's row `out`; the 4 channels that
// straddle C (C not a multiple of 4) stay in `tail` for slot_finish.
template <int MM, int T, typename S>
__device__ __forceinline__ void slot_channels(const float* tnode, int tc, int t0, int tcn,
                                              const S* __restrict__ xrow, int c_in, int m,
                                              int tl, float w, const float (&s)[MM],
                                              const float (&xp)[kXS][4], float* out,
                                              float (&dq)[MM], float (&tail)[4]) {
  int step = 0;
  for (int c0 = 4 * tl; c0 < tcn; c0 += 4 * T, ++step) {
    const int ch = t0 + c0;
    float4 x;
    if (t0 == 0 && step == 0) {
      x = make_float4(xp[0][0], xp[0][1], xp[0][2], xp[0][3]);
    } else if (t0 == 0 && step == 1) {
      x = make_float4(xp[1][0], xp[1][1], xp[1][2], xp[1][3]);
    } else {
      x.x = ch < c_in ? load_f32(xrow + ch) : 0.f;
      x.y = ch + 1 < c_in ? load_f32(xrow + ch + 1) : 0.f;
      x.z = ch + 2 < c_in ? load_f32(xrow + ch + 2) : 0.f;
      x.w = ch + 3 < c_in ? load_f32(xrow + ch + 3) : 0.f;
    }
    float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int a = 0; a < MM; ++a) {
      if (a >= m) break;
      const float4 t = *reinterpret_cast<const float4*>(tnode + a * tc + c0);
      dq[a] = fmaf(x.w, t.w, fmaf(x.z, t.z, fmaf(x.y, t.y, fmaf(x.x, t.x, dq[a]))));
      const float ws = w * s[a];
      d.x = fmaf(ws, t.x, d.x);
      d.y = fmaf(ws, t.y, d.y);
      d.z = fmaf(ws, t.z, d.z);
      d.w = fmaf(ws, t.w, d.w);
    }
    if (ch + 3 < c_in) {
      *reinterpret_cast<float4*>(out + ch) = d;
    } else if (ch < c_in) {
      tail[0] = d.x;
      tail[1] = d.y;
      tail[2] = d.z;
      tail[3] = d.w;
    }
  }
}

// dq over the team's lanes, then dlog. The row's tail from the float4 that
// holds channel C - 1 (or C itself) to the end of the padded row is written
// as whole float4s, vector v by lane v mod T: the straddling channels from
// `tail`, then dlog, then zeros in the pad, so that whole 32-byte sectors are
// written. Lane tl also puts dlog[m] for m = tl + T * u into dl, the
// block's dlog in shared memory.
template <int MM, int T>
__device__ __forceinline__ void slot_finish(float (&dq)[MM], const float (&s)[MM], float w,
                                            bool live, bool in, int m, int c_in, int wp,
                                            int tl, const float (&tail)[4], float* out,
                                            float* dl_row) {
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1)
#pragma unroll
    for (int a = 0; a < MM; ++a) dq[a] += __shfl_xor_sync(kFullMask, dq[a], off, T);
  float t = 0.f;
#pragma unroll
  for (int a = 0; a < MM; ++a) {
    dq[a] *= w;
    t = fmaf(dq[a], s[a], t);
  }
  // dq becomes dlog (0 past M: s is 0 there)
#pragma unroll
  for (int a = 0; a < MM; ++a) dq[a] = live ? s[a] * (dq[a] - t) : 0.f;
#pragma unroll
  for (int a = 0; a < MM; ++a)
    if (a < m && a % T == tl && in) dl_row[a] = dq[a];
  if (!live) return;
  const int v0 = c_in / 4;
  for (int v = v0 + (tl - v0 % T + T) % T; 4 * v < wp; v += T) {
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 4 * v + e;
      float val = col < c_in ? tail[e] : 0.f;
#pragma unroll
      for (int a = 0; a < MM; ++a)
        if (col - c_in == a) val = dq[a];
      o[e] = val;
    }
    *reinterpret_cast<float4*>(out + 4 * v) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// dux[i] for the block's nodes: each (node, m) sums the node's dlog in slot
// order
__device__ __forceinline__ void block_dux(const float* dl, float* __restrict__ dux, int i0,
                                          int nb, int ks, int n, int m, int ls, int P,
                                          int tid) {
  for (int o = tid; o < nb * m; o += P) {
    const int nl = o / m, a = o - (o / m) * m;
    if (i0 + nl >= n) continue;
    float acc = 0.f;
    for (int k = 0; k < ks; ++k) acc += dl[(nl * ks + k) * ls + a];
    dux[(size_t)(i0 + nl) * m + a] = acc;
  }
}

// Pass A for any shape: a block takes one group of NB nodes, in rounds of
// slot teams when (K'+1) * T exceeds the block, and in tiles of TC channels
// when the dz rows exceed the shared-memory budget. MM = 9, the model's filter
// count, is instantiated for M = 9 alone, so that every division by M is by a
// constant; the others take any M <= MM.
template <typename S, int MM, int T>
__global__ void __launch_bounds__(kThreadsA, 2)
slot_cotangents_kernel(const S* __restrict__ cat, const S* __restrict__ ux,
                       const int* __restrict__ adj_sm,
                       const float* __restrict__ mult_rows,
                       const float* __restrict__ cvec, const S* __restrict__ dz,
                       float* __restrict__ dg, float* __restrict__ dux, int n, int n_src,
                       int k_nbr, int c_in, int m_rt, int nb, int tc, int wp, int contiguous) {
  constexpr int LS = MM | 1;
  constexpr int UA = (MM + T - 1) / T;
  const int m = MM == 9 ? 9 : m_rt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = blockDim.x, tid = threadIdx.x;
  const int ns = m * tc + 4;   // a node's tile stride; +4 puts the next node on other banks
  float* tile = reinterpret_cast<float*>(smem_raw);                 // [nb][m][tc]
  const int ks = k_nbr + 1;
  const int np = nb * ks;
  float* dl = tile + (size_t)nb * ns;                               // [np][LS] dlog
  const int width = c_in + m;
  const int i0 = blockIdx.x * nb;
  const int tl = tid % T, team = tid / T;
  const int teams = min(np, P / T);    // slot teams a round; the last warp may pad
  const bool one_tile = tc >= c_in;

  for (int g0 = 0; g0 < np; g0 += teams) {
    const int pair = g0 + team;
    const int node_l = pair / ks, k = pair - (pair / ks) * ks;
    const int i = i0 + node_l;
    const bool in = team < teams && pair < np && i < n;
    float w;
    int j;
    slot_index(mult_rows, adj_sm, n, n_src, k, i, in, w, j);
    const bool live = j >= 0;   // uniform over the team: its lanes share the slot
    float lg[UA], xp[kXS][4], s[MM], dq[MM], tail[4] = {0.f, 0.f, 0.f, 0.f};
    slot_logits<MM, T>(cat, ux, cvec, i, j, width, c_in, m, tl, lg);
    slot_x<T>(cat, j, width, c_in, tl, xp);
    slot_softmax<MM, T>(lg, live, m, tl, s);
#pragma unroll
    for (int a = 0; a < MM; ++a) dq[a] = 0.f;
    float* out = dg + ((size_t)k * n + (live ? i : 0)) * wp;
    for (int t0 = 0; t0 < c_in; t0 += tc) {
      const int tcn = min(tc, (c_in - t0 + 4 * T - 1) / (4 * T) * (4 * T));
      if (!one_tile || g0 == 0) {   // block-uniform
        __syncthreads();   // the previous tile's readers are done
        if (contiguous) load_tile_contiguous(tile, dz, i0, nb, n, m, c_in, ns, P, tid);
        else load_tile(tile, dz, i0, nb, n, m, c_in, t0, tcn, tc, ns, P, tid);
        copy_wait();
        __syncthreads();
      }
      if (live)
        slot_channels<MM, T>(tile + node_l * ns, tc, t0, tcn, cat + (size_t)j * width, c_in,
                             m, tl, w, s, xp, out, dq, tail);
    }
    slot_finish<MM, T>(dq, s, w, live, in, m, c_in, wp, tl, tail, out, dl + pair * LS);
  }
  __syncthreads();
  block_dux(dl, dux, i0, nb, ks, n, m, LS, P, tid);
}

// Pass A when a block's slot teams and its dz rows fit at once (the model's
// convs): persistent blocks walk the groups of NB nodes, and each round's
// loads are in flight behind the previous round's work. At the top of a
// round the next group's dz rows start to copy into the other of two tiles
// (cp.async) and its slots' indices load; at the end of the round its logit
// inputs and first channels of x load.
template <typename S, int MM, int T>
__global__ void __launch_bounds__(kThreadsA, 2)
slot_cotangents_pipelined(const S* __restrict__ cat, const S* __restrict__ ux,
                          const int* __restrict__ adj_sm,
                          const float* __restrict__ mult_rows,
                          const float* __restrict__ cvec, const S* __restrict__ dz,
                          float* __restrict__ dg, float* __restrict__ dux, int n, int n_src,
                          int k_nbr, int c_in, int m_rt, int nb, int tc, int wp, int contiguous,
                          int groups) {
  constexpr int LS = MM | 1;
  constexpr int UA = (MM + T - 1) / T;
  const int m = MM == 9 ? 9 : m_rt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = blockDim.x, tid = threadIdx.x;
  const int ns = m * tc + 4;
  float* tiles = reinterpret_cast<float*>(smem_raw);                // [2][nb][m][tc]
  const int ks = k_nbr + 1;
  const int np = nb * ks;
  float* dl = tiles + 2 * (size_t)nb * ns;                          // [np][LS] dlog
  const int width = c_in + m;
  const int tl = tid % T, team = tid / T;
  const bool member = team < np;
  const int node_l = team / ks, k = team - (team / ks) * ks;

  // the first group: its tile in flight, its indices, then its rows
  int g = blockIdx.x;
  if (contiguous) load_tile_contiguous(tiles, dz, g * nb, nb, n, m, c_in, ns, P, tid);
  else load_tile(tiles, dz, g * nb, nb, n, m, c_in, 0, tc, tc, ns, P, tid);
  float w, lg[UA], xp[kXS][4];
  int j;
  slot_index(mult_rows, adj_sm, n, n_src, k, g * nb + node_l, member && g * nb + node_l < n, w,
             j);
  slot_logits<MM, T>(cat, ux, cvec, g * nb + node_l, j, width, c_in, m, tl, lg);
  slot_x<T>(cat, j, width, c_in, tl, xp);

  for (int r = 0; g < groups; ++r) {
    float* tile = tiles + (size_t)(r & 1) * nb * ns;
    const int i0 = g * nb, i = i0 + node_l;
    const bool in = member && i < n;
    const int gn = g + gridDim.x;
    copy_wait();
    __syncthreads();   // this group's tile is in; the last round's readers are done
    if (gn < groups) {
      float* next = tiles + (size_t)((r + 1) & 1) * nb * ns;
      if (contiguous) load_tile_contiguous(next, dz, gn * nb, nb, n, m, c_in, ns, P, tid);
      else load_tile(next, dz, gn * nb, nb, n, m, c_in, 0, tc, tc, ns, P, tid);
    }
    float wn;
    int jn;
    slot_index(mult_rows, adj_sm, n, n_src, k, gn * nb + node_l,
               member && gn < groups && gn * nb + node_l < n, wn, jn);

    const bool live = j >= 0;   // uniform over the team: its lanes share the slot
    float s[MM], dq[MM], tail[4] = {0.f, 0.f, 0.f, 0.f};
    slot_softmax<MM, T>(lg, live, m, tl, s);
#pragma unroll
    for (int a = 0; a < MM; ++a) dq[a] = 0.f;
    float* out = dg + ((size_t)k * n + (live ? i : 0)) * wp;
    if (live)
      slot_channels<MM, T>(tile + node_l * ns, tc, 0, tc, cat + (size_t)j * width, c_in, m,
                           tl, w, s, xp, out, dq, tail);
    slot_finish<MM, T>(dq, s, w, live, in, m, c_in, wp, tl, tail, out, dl + team * LS);
    __syncthreads();
    block_dux(dl, dux, i0, nb, ks, n, m, LS, P, tid);

    w = wn;
    j = jn;
    slot_logits<MM, T>(cat, ux, cvec, gn * nb + node_l, j, width, c_in, m, tl, lg);
    slot_x<T>(cat, j, width, c_in, tl, xp);
    g = gn;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

// Pass A for M > 32, any M and C: a warp a node walks its live slots in
// order, with the slot's s and dq and the node's dux sum (3 * M floats a
// warp) in shared memory in place of registers. Lanes take the M filters
// for the softmax and dlog and the C channels for dx; dq[m] is a warp sum
// over the channels. One general path, not tuned: the model's M = 9 runs
// the kernels above.
template <typename S>
__global__ void __launch_bounds__(kThreadsAnyM)
slot_cotangents_any_m(const S* __restrict__ cat, const S* __restrict__ ux,
                      const int* __restrict__ adj_sm, const float* __restrict__ mult_rows,
                      const float* __restrict__ cvec, const S* __restrict__ dz,
                      float* __restrict__ dg, float* __restrict__ dux, int n, int n_src,
                      int k_nbr, int c_in, int m, int wp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * (blockDim.x >> 5) + warp;
  if (i >= n) return;   // warp-uniform; no block barrier follows
  float* s = reinterpret_cast<float*>(smem_raw) + (size_t)warp * 3 * m;
  float* dq = s + m;
  float* du = dq + m;
  const int width = c_in + m;
  const S* dzi = dz + (size_t)i * m * c_in;
  for (int a = lane; a < m; a += 32) du[a] = 0.f;
  for (int k = 0; k <= k_nbr; ++k) {
    const float w = __ldg(mult_rows + (size_t)k * n + i);
    const int j = k == 0 ? i : __ldg(adj_sm + (size_t)(k - 1) * n + i) - 1;
    if (!(w != 0.f && (unsigned)j < (unsigned)n_src)) continue;   // warp-uniform
    const S* row = cat + (size_t)j * width;
    float mx = -INFINITY;
    for (int a = lane; a < m; a += 32) {
      const float l =
          load_f32(ux + (size_t)i * m + a) + load_f32(row + c_in + a) + __ldg(cvec + a);
      s[a] = l;
      mx = fmaxf(mx, l);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int a = lane; a < m; a += 32) {
      const float e = expf(s[a] - mx);
      s[a] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int a = lane; a < m; a += 32) s[a] = s[a] / sum;
    __syncwarp();
    float* out = dg + ((size_t)k * n + i) * wp;
    for (int ch = lane; ch < c_in; ch += 32) {
      float d = 0.f;
      for (int a = 0; a < m; ++a) d = fmaf(w * s[a], load_f32(dzi + (size_t)a * c_in + ch), d);
      out[ch] = d;
    }
    for (int a = 0; a < m; ++a) {
      float p = 0.f;
      for (int ch = lane; ch < c_in; ch += 32)
        p = fmaf(load_f32(row + ch), load_f32(dzi + (size_t)a * c_in + ch), p);
      p = warp_sum(p);
      if (lane == 0) dq[a] = p * w;
    }
    __syncwarp();
    float t = 0.f;
    for (int a = lane; a < m; a += 32) t = fmaf(dq[a], s[a], t);
    t = warp_sum(t);
    for (int a = lane; a < m; a += 32) {
      const float dl = s[a] * (dq[a] - t);
      out[c_in + a] = dl;
      du[a] += dl;
    }
    __syncwarp();   // s and dq are rewritten by the next slot
  }
  for (int a = lane; a < m; a += 32) dux[(size_t)i * m + a] = du[a];
}

template <typename S, int TB, int WB>
__global__ void __launch_bounds__(kThreadsB)
transpose_sum_kernel(const float* __restrict__ dg, const int* __restrict__ adj_t,
                     const int* __restrict__ adj_sm,
                     const float* __restrict__ mult_rows, S* __restrict__ dcat,
                     int n, int n_src, int k_nbr, int k_t, int width, int wp) {
  const int lane = threadIdx.x & 31;
  const int t = lane % TB;
  const unsigned team = (TB == 32 ? kFullMask : ((1u << TB) - 1u)) << (lane - t);
  const int node = (blockIdx.x * blockDim.x + threadIdx.x) / TB;
  const bool valid = node < n_src;
  S* row = dcat + (size_t)(valid ? node : 0) * width;
  // the self slot's row, written by pass A when the slot is live (a source
  // row past N has none)
  const float* self = dg + (size_t)(node < n ? node : 0) * wp;
  const bool self_live = node < n && __ldg(mult_rows + node) != 0.f;
  const long long total = (long long)k_nbr * n;
  for (int b0 = 0; b0 < width; b0 += TB * WB) {   // one block of columns up to 32 * WB
    float acc[WB];
#pragma unroll
    for (int b = 0; b < WB; ++b) {
      const int ch = b0 + t + TB * b;
      acc[b] = self_live && ch < width ? __ldg(self + ch) : 0.f;
    }
    for (int t0 = 0; t0 < k_t; t0 += TB) {
      int slot = -1;
      if (valid && t0 + t < k_t) {
        const int sl = __ldg(adj_t + (size_t)node * k_t + t0 + t) - 1;
        // read only a slot that pass A wrote: live, and naming this node
        if (sl >= 0 && sl < total && __ldg(mult_rows + (size_t)n + sl) != 0.f &&
            __ldg(adj_sm + sl) == node + 1)
          slot = sl;
      }
      unsigned live = __ballot_sync(kFullMask, slot >= 0) & team;
      while (__any_sync(kFullMask, live != 0u)) {
        // up to four of the team's slots, in map order, loads in flight together
        int src[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          src[u] = live != 0u ? __ffs(live) - 1 : lane;
          const bool has = live != 0u;
          live &= live - 1u;
          const int sl = __shfl_sync(kFullMask, slot, src[u]);
          src[u] = has ? sl : -1;
        }
        float v[4][WB];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int b = 0; b < WB; ++b) {
            const int ch = b0 + t + TB * b;
            // flat slot sl is row N + sl of dg (rows 0..N-1: the self slots)
            v[u][b] = src[u] >= 0 && ch < width
                          ? __ldg(dg + ((size_t)src[u] + n) * wp + ch) : 0.f;
          }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (src[u] >= 0) {
#pragma unroll
            for (int b = 0; b < WB; ++b) acc[b] += v[u][b];
          }
      }
    }
#pragma unroll
    for (int b = 0; b < WB; ++b) {
      const int ch = b0 + t + TB * b;
      if (valid && ch < width) store_f32(row + ch, acc[b]);
    }
  }
}

template <typename S>
struct Args {
  const S* cat;
  const S* ux;
  const int* adj_sm;
  const int* adj_t;
  const float* mult_rows;
  const float* c;
  const S* dz;
  float* dg;
  S* dcat;
  float* dux;
  int n, n_src, k_nbr, k_t, c_in, m, wp;
  cudaStream_t stream;
};

int round_up(int v, int to) { return (v + to - 1) / to * to; }

// The dynamic shared memory a kernel may take, raised past the 48 KB default
// where a launch needs it.
template <typename K>
int allow_smem(K kernel, size_t smem, size_t& raised) {
  if (smem <= raised) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  raised = smem;
  return 0;
}

// Pass A's block: NB nodes and their (K'+1) slot teams of T lanes, within
// kThreadsA threads. When the teams fit one round and two tiles of all C
// channels (rounded up to 4T) fit the shared-memory budget, persistent
// pipelined blocks; otherwise one block a group, with a tile of TC channels
// (a multiple of 4T) within the budget.
template <typename S, int MM, int T>
int launch_a(const Args<S>& a) {
  constexpr int LS = MM | 1;
  const int ks = a.k_nbr + 1;
  const int step = 4 * T;
  const int c_pad = round_up(a.c_in, step);
  int nb = kThreadsA / (ks * T);
  if (nb < 1) nb = 1;
  const size_t dl = (size_t)nb * ks * LS * sizeof(float);
  const size_t tile = (size_t)nb * (a.m * c_pad + 4) * sizeof(float);
  const int teams = nb * ks < kThreadsA / T ? nb * ks : kThreadsA / T;
  const int threads = round_up(teams * T, 32);
  const int groups = (a.n + nb - 1) / nb;
  // one tile of all channels, unpadded, 16-byte aligned: dz's rows of a
  // group are one contiguous range
  const int contiguous = c_pad == a.c_in && reinterpret_cast<uintptr_t>(a.dz) % 16 == 0;
  if (teams == nb * ks && dl + 2 * tile <= (size_t)kSmemBudget) {
    const size_t smem = dl + 2 * tile;
    static size_t raised = 48 * 1024;
    int err = allow_smem(slot_cotangents_pipelined<S, MM, T>, smem, raised);
    if (err != 0) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = (int)cudaGetDevice(&dev)) != 0) return err;
    if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0)
      return err;
    if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, slot_cotangents_pipelined<S, MM, T>, threads, smem)) != 0)
      return err;
    const int grid = groups < per_sm * sms ? groups : per_sm * sms;
    slot_cotangents_pipelined<S, MM, T><<<grid > 0 ? grid : 1, threads, smem, a.stream>>>(
        a.cat, a.ux, a.adj_sm, a.mult_rows, a.c, a.dz, a.dg, a.dux, a.n, a.n_src, a.k_nbr,
        a.c_in, a.m, nb, c_pad, a.wp, contiguous, groups);
    return (int)cudaGetLastError();
  }
  int tc = 0;
  size_t smem = 0;
  for (;; nb /= 2) {
    if (nb == 0) return (int)cudaErrorInvalidValue;
    const size_t dl_nb = (size_t)nb * ks * LS * sizeof(float);
    const size_t per_step = (size_t)nb * a.m * step * sizeof(float);
    const size_t pad = (size_t)nb * 4 * sizeof(float);
    if (dl_nb + pad + per_step > kSmemBudget) continue;
    const int fit = (int)((kSmemBudget - dl_nb - pad) / per_step) * step;
    tc = fit < c_pad ? fit : c_pad;
    smem = dl_nb + pad + (size_t)nb * a.m * tc * sizeof(float);
    break;
  }
  static size_t raised = 48 * 1024;
  const int err = allow_smem(slot_cotangents_kernel<S, MM, T>, smem, raised);
  if (err != 0) return err;
  const int threads_g = round_up((nb * ks < kThreadsA / T ? nb * ks : kThreadsA / T) * T, 32);
  slot_cotangents_kernel<S, MM, T><<<(a.n + nb - 1) / nb, threads_g, smem, a.stream>>>(
      a.cat, a.ux, a.adj_sm, a.mult_rows, a.c, a.dz, a.dg, a.dux, a.n, a.n_src, a.k_nbr,
      a.c_in, a.m, nb, tc, a.wp, tc == a.c_in && contiguous);
  return (int)cudaGetLastError();
}

// T lanes a slot by width class: each lane owns ~16 channels
template <typename S, int MM>
int dispatch_t(const Args<S>& a) {
  if (a.c_in <= 8) return launch_a<S, MM, 1>(a);
  if (a.c_in <= 32) return launch_a<S, MM, 2>(a);
  if (a.c_in <= 64) return launch_a<S, MM, 4>(a);
  if (a.c_in <= 128) return launch_a<S, MM, 8>(a);
  return launch_a<S, MM, 16>(a);
}

constexpr int kWarpsAnyM = kThreadsAnyM / 32;

template <typename S>
int launch_a_any_m(const Args<S>& a) {
  const size_t smem = (size_t)kWarpsAnyM * 3 * a.m * sizeof(float);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  static size_t raised = 48 * 1024;
  const int err = allow_smem(slot_cotangents_any_m<S>, smem, raised);
  if (err != 0) return err;
  slot_cotangents_any_m<S><<<(a.n + kWarpsAnyM - 1) / kWarpsAnyM, kThreadsAnyM, smem,
                             a.stream>>>(
      a.cat, a.ux, a.adj_sm, a.mult_rows, a.c, a.dz, a.dg, a.dux, a.n, a.n_src, a.k_nbr,
      a.c_in, a.m, a.wp);
  return (int)cudaGetLastError();
}

template <typename S, int TB, int WB>
int launch_b(const Args<S>& a) {
  const long long threads = (long long)a.n_src * TB;
  const unsigned blocks = (unsigned)((threads + kThreadsB - 1) / kThreadsB);
  transpose_sum_kernel<S, TB, WB><<<blocks, kThreadsB, 0, a.stream>>>(
      a.dg, a.adj_t, a.adj_sm, a.mult_rows, a.dcat, a.n, a.n_src, a.k_nbr, a.k_t,
      a.c_in + a.m, a.wp);
  return (int)cudaGetLastError();
}

template <typename S>
int run(const S* cat, const S* ux, const int* adj_sm, const int* adj_t, const float* mult_rows,
        const float* c, const S* dz, float* dg, S* dcat, float* dux, int n, int n_src,
        int k_nbr, int k_t, int c_in, int m, void* stream) {
  if (n <= 0) return 0;
  // pass B's thread index (n_src * 32 at most) stays below 2^31
  if (c_in < 1 || m < 1 || k_nbr < 0 || k_t < 0 || n_src < n || n_src > (1 << 26) ||
      reinterpret_cast<uintptr_t>(dg) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Args<S> a{cat, ux, adj_sm, adj_t, mult_rows, c, dz, dg, dcat, dux,
                  n, n_src, k_nbr, k_t, c_in, m, round_up(c_in + m, 8), (cudaStream_t)stream};
  int err;
  if (m <= 4) err = dispatch_t<S, 4>(a);
  else if (m <= 8) err = dispatch_t<S, 8>(a);
  else if (m == 9) err = dispatch_t<S, 9>(a);
  else if (m <= 16) err = dispatch_t<S, 16>(a);
  else if (m <= 32) err = dispatch_t<S, 32>(a);
  else err = launch_a_any_m(a);
  if (err != 0) return err;
  const int width = c_in + m;
  if (width <= 8) return launch_b<S, 8, 1>(a);
  if (width <= 16) return launch_b<S, 16, 1>(a);
  switch ((width + 31) / 32) {
    case 1: return launch_b<S, 32, 1>(a);
    case 2: return launch_b<S, 32, 2>(a);
    case 3: return launch_b<S, 32, 3>(a);
    case 4: return launch_b<S, 32, 4>(a);
    default: return launch_b<S, 32, 5>(a);   // 160 columns at a time
  }
}

}  // namespace

extern "C" {

// Largest filter count the kernel takes (past M = 32, pass A keeps 3 * M
// floats a warp in shared memory); any channel count runs.
int facet_conv_bwd_max_m(void) { return kSmemMax / (kWarpsAnyM * 3 * (int)sizeof(float)); }

#ifndef FACET_CONV_BWD_BF16

// cat [n_src, c_in + m] (n_src >= n), ux [n, m], adj_sm [k_nbr, n] (one-indexed
// into cat's rows, 0 = pad), adj_t [n_src, k_t] (one-indexed flat slots k*n + i,
// 0 = pad), mult_rows [k_nbr + 1, n], c [m], dz [n, m * c_in] -> dcat
// [n_src, c_in + m], dux [n, m],
// with dg [(k_nbr + 1) * n, wp] as scratch (wp: c_in + m rounded up to 8,
// 16-byte aligned); all f32 but the int32 tables, contiguous, on the current
// device. Launches both passes on `stream` and returns cudaGetLastError()
// after the first that fails (0 when both were accepted).
int facet_conv_bwd_f32(const float* cat, const float* ux, const int* adj_sm,
                       const int* adj_t, const float* mult_rows, const float* c,
                       const float* dz, float* dg, float* dcat, float* dux, int n,
                       int n_src, int k_nbr, int k_t, int c_in, int m, void* stream) {
  return run(cat, ux, adj_sm, adj_t, mult_rows, c, dz, dg, dcat, dux, n, n_src, k_nbr, k_t,
             c_in, m, stream);
}

#else

// The same with cat, ux, dz and dcat in bfloat16 (mult_rows, c, dg and dux
// f32): f32 inside, dcat rounded once after its sum.
int facet_conv_bwd_bf16(const __nv_bfloat16* cat, const __nv_bfloat16* ux, const int* adj_sm,
                        const int* adj_t, const float* mult_rows, const float* c,
                        const __nv_bfloat16* dz, float* dg, __nv_bfloat16* dcat, float* dux,
                        int n, int n_src, int k_nbr, int k_t, int c_in, int m,
                        void* stream) {
  return run(cat, ux, adj_sm, adj_t, mult_rows, c, dz, dg, dcat, dux, n, n_src, k_nbr, k_t,
             c_in, m, stream);
}

#endif  // FACET_CONV_BWD_BF16

}  // extern "C"
