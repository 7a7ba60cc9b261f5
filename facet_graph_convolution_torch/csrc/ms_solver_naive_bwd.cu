// The adjoint of one scale of the naive multi-scale vertex solver in one
// persistent kernel: the backward of ms_solver_naive.cu, for training.
//
// Stands for the backward that the JAX package leaves to XLA: jax.grad of
// facet_graph_convolution_tpu/ops/vertex_update.py::update_positions_multiscale
// (body :260-273, a fori_loop XLA differentiates). The plain version is
// ops/ms_solver_kernel.py::naive_scale_backward_plain.
//
// Inputs: xs [iters + 1, V, 3] f32, the iterates the scale kernel stored
// (xs[i] is x before iteration i); faces, v_faces, fn and shift as in the
// scale kernel; lmbd [V] = 1 / (real slots of v) (0 for none); the face->slot
// map of this scale, CSR over the level-s nodes (slot_off [F_s + 1],
// slot_ids: the flat slots v * K + k whose v_faces[v, k] >> shift is the
// node); the vertex->corner map, CSR over the vertices (corner_off [V + 1],
// corner_ids: the fine faces whose corners name v, once a corner). In/out:
// gx [V, 3], the cotangent of the scale's result on entry and of its start
// point on exit; gfn [F_s, 3], zero on entry, the cotangent of fn on exit.
// Scratch: g_leaf [F0, 3]. For i = iters - 1 down to 0, with g = gx:
//
//   phase R-A, per level-s node f (the scale kernel's phase-A team): the
//     fine centroids and the pool from xs[i], as the scale kernel computes
//     them (the same operations from ms_solver_naive.cuh), keeping each
//     round's zero flags; t_f = <n_f, c_f>. Over f's slots (v, k) from the
//     face->slot map: a = lmbd_v <n_f, g_v>, g t_f = sum a, and
//     gfn[f] += g t_f c_f + sum [lmbd_v (t_f - <n_f, x_v>) g_v - a x_v]
//     (f's own row, written by the same lane every iteration: no race). The
//     pool's adjoint from g c_f = g t_f n_f: each round's factor is the
//     gradient of jnp.where (an all-zero row beside a live one takes none,
//     the live one all; two live or two zero rows half each), known to each
//     lane from the flags it kept, so it needs no shuffles; a lane pooling
//     several leaves (shift > 5) walks its block's tree top-down, pooling
//     each half again for its flag. g_leaf[fine face] = g c / 3;
//   grid-wide barrier;
//   phase R-B, per vertex v (the scale kernel's phase-B team):
//     gx_v = g_v - sum_k lmbd_v <n_k, g_v> n_k + sum over v's corners of
//     g_leaf, read through the vertex->corner map;
//   grid-wide barrier (none after the last iteration).
//
// Gathers only: every sum is taken by the one team that owns its row, in
// the maps' order, with no atomics, so two launches give the same bits.
//
// What bounds it on an H100: as the scale kernel, the barriers (2 an
// iteration, 239 for the (80, 20, 20) schedule) and the chains of dependent
// loads of each phase (map entry, then vertex, then its rows), not bytes or
// operations: an iteration reads ~2-3 MB, L2-resident.
//
// Design: the scale kernel's launch and teams (cooperative, 1024-thread
// blocks, one an SM at most, grid-stride loops). Data written inside the
// kernel (gx, g_leaf, gfn) is read through L2 (__ldcg); the iterates and the
// tables, written before the launch, go through __ldg. Simple and right
// first; R-B walks its slots one at a time.

#include "ms_solver_naive.cuh"

namespace {

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1])),
                   __fmul_rn(a[2], b[2]));
}

// The cotangent share of a pooled row from its parent's: the gradient of
// jnp.where(z, partner, own) + jnp.where(zo, own, partner), halved.
__device__ __forceinline__ void pool_share(bool z, bool zo, float g[3]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    g[ch] = z ? (zo ? __fmul_rn(g[ch], 0.5f) : 0.f) : (zo ? g[ch] : __fmul_rn(g[ch], 0.5f));
  }
}

__device__ __forceinline__ void write_leaf(float* g_leaf, int face, const float g[3]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) g_leaf[(size_t)face * 3 + ch] = __fdiv_rn(g[ch], 3.f);
}

// The pool's adjoint inside a lane's block of `count` consecutive leaves
// (shift > 5): top-down over the block's tree from the cotangent g of its
// pooled row, each half's flag from its pooled value, as leaf_block_center
// pools it.
__device__ __noinline__ void leaf_block_adjoint(const float* x, const int* __restrict__ faces,
                                                int first, int count, const float g[3],
                                                float* g_leaf) {
  int lo[kStack], len[kStack];
  float gs[kStack][3];
  int depth = 1;
  lo[0] = first;
  len[0] = count;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) gs[0][ch] = g[ch];
  while (depth > 0) {
    --depth;
    const int l = lo[depth], n = len[depth];
    float gg[3] = {gs[depth][0], gs[depth][1], gs[depth][2]};
    if (n == 1) {
      write_leaf(g_leaf, l, gg);
      continue;
    }
    const int h = n / 2;
    float cl[3], cr[3];
    leaf_block_center(x, faces, l, h, cl);
    leaf_block_center(x, faces, l + h, h, cr);
    const bool zl = all_zero(cl), zr = all_zero(cr);
    float gr[3] = {gg[0], gg[1], gg[2]};
    pool_share(zr, zl, gr);
    pool_share(zl, zr, gg);
    lo[depth] = l + h;  // the right half, walked after the left
    len[depth] = h;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) gs[depth][ch] = gr[ch];
    ++depth;
    lo[depth] = l;
    len[depth] = h;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) gs[depth][ch] = gg[ch];
    ++depth;
  }
}

// Phase R-A over the level-s nodes, grid-stride by warp, with the scale
// kernel's teams. The loop bounds are warp-uniform: every lane reaches the
// shuffles.
__device__ __forceinline__ void adjoint_a(const float* __restrict__ x,
                                          const int* __restrict__ faces,
                                          const float* __restrict__ fn,
                                          const float* __restrict__ lmbd,
                                          const int* __restrict__ slot_off,
                                          const int* __restrict__ slot_ids, const float* gx,
                                          float* gfn, float* g_leaf, int nodes, int k,
                                          int shift) {
  const int lane = threadIdx.x & 31;
  const int warp = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int warps = (int)((gridDim.x * blockDim.x) >> 5);
  const int team = 1 << (shift < 5 ? shift : 5);        // lanes a node
  const int per_lane = 1 << (shift < 5 ? 0 : shift - 5);  // leaves a lane
  const int per_warp = 32 / team;                          // nodes a warp
  const int sub = lane & (team - 1);
  const int tasks = (nodes + per_warp - 1) / per_warp;
  for (int task = warp; task < tasks; task += warps) {
    const int f = task * per_warp + lane / team;
    const bool live = f < nodes;  // team-uniform
    const int first = (f << shift) + sub * per_lane;
    float c[3] = {0.f, 0.f, 0.f};
    if (live) {
      if (per_lane == 1) {
        leaf_center(x, faces, first, c);
      } else {
        leaf_block_center(x, faces, first, per_lane, c);
      }
    }
    // the scale kernel's rounds; bit r of own / other: round r's zero flags
    // of this lane's row and of its partner's
    bool z = all_zero(c);
    unsigned own = 0u, other = 0u;
    int rounds = 0;
    for (int m = 1; m < team; m <<= 1, ++rounds) {
      float o[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) o[ch] = __shfl_xor_sync(kFullMask, c[ch], m);
      const bool zo = all_zero(o);
      own |= (unsigned)z << rounds;
      other |= (unsigned)zo << rounds;
      if (sub & m) {
        pair_mean(o, zo, c, z, c);
      } else {
        pair_mean(c, z, o, zo, c);
      }
      z = all_zero(c);
    }
    float n[3] = {0.f, 0.f, 0.f};
    float gt = 0.f;
    float gn[3] = {0.f, 0.f, 0.f};
    if (live) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) n[ch] = __ldg(fn + (size_t)f * 3 + ch);
      const float t = dot3(n, c);
      const int end = __ldg(slot_off + f + 1);
      for (int j = __ldg(slot_off + f) + sub; j < end; j += team) {
        const int v = __ldg(slot_ids + j) / k;
        const float lam = __ldg(lmbd + v);
        float g[3], xv[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          g[ch] = __ldcg(gx + (size_t)v * 3 + ch);
          xv[ch] = __ldg(x + (size_t)v * 3 + ch);
        }
        const float a = __fmul_rn(lam, dot3(n, g));
        const float w = __fmul_rn(lam, __fsub_rn(t, dot3(n, xv)));
        gt = __fadd_rn(gt, a);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          gn[ch] = __fadd_rn(gn[ch], __fsub_rn(__fmul_rn(w, g[ch]), __fmul_rn(a, xv[ch])));
        }
      }
    }
    for (int m = 1; m < team; m <<= 1) {
      gt = __fadd_rn(gt, __shfl_xor_sync(kFullMask, gt, m));
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        gn[ch] = __fadd_rn(gn[ch], __shfl_xor_sync(kFullMask, gn[ch], m));
      }
    }
    if (!live) continue;  // team-uniform, after the last shuffle
    if (sub == 0) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float* row = gfn + (size_t)f * 3 + ch;
        *row = __fadd_rn(__ldcg(row), __fadd_rn(__fmul_rn(gt, c[ch]), gn[ch]));
      }
    }
    float g[3] = {__fmul_rn(gt, n[0]), __fmul_rn(gt, n[1]), __fmul_rn(gt, n[2])};
    for (int r = rounds - 1; r >= 0; --r) pool_share((own >> r) & 1u, (other >> r) & 1u, g);
    if (per_lane == 1) {
      write_leaf(g_leaf, first, g);
    } else {
      leaf_block_adjoint(x, faces, first, per_lane, g, g_leaf);
    }
  }
}

// Phase R-B: a team of kVertexTeam lanes a vertex; lane i walks slots i,
// i + kVertexTeam, ... and corners likewise; the team sums by shuffles and
// its first lane writes gx_v. The loop bounds are warp-uniform.
__device__ __forceinline__ void adjoint_b(float* gx, const int* __restrict__ v_faces,
                                          const float* __restrict__ fn,
                                          const float* __restrict__ lmbd,
                                          const int* __restrict__ corner_off,
                                          const int* __restrict__ corner_ids,
                                          const float* g_leaf, int num_vertices, int k,
                                          int shift) {
  const int lane = threadIdx.x & 31;
  const int warp = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int warps = (int)((gridDim.x * blockDim.x) >> 5);
  const int sub = lane & (kVertexTeam - 1);
  constexpr int per_warp = 32 / kVertexTeam;
  const int tasks = (num_vertices + per_warp - 1) / per_warp;
  for (int task = warp; task < tasks; task += warps) {
    const int v = task * per_warp + lane / kVertexTeam;
    const bool live = v < num_vertices;  // team-uniform
    float g[3] = {0.f, 0.f, 0.f};
    float acc[3] = {0.f, 0.f, 0.f};
    float leaf[3] = {0.f, 0.f, 0.f};
    if (live) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) g[ch] = __ldcg(gx + (size_t)v * 3 + ch);
      const float lam = __ldg(lmbd + v);
      const int* row = v_faces + (size_t)v * k;
      for (int j = sub; j < k; j += kVertexTeam) {
        const int face = __ldg(row + j);
        if (face < 0) continue;  // a pad
        const float* np = fn + (size_t)(face >> shift) * 3;
        const float n[3] = {__ldg(np), __ldg(np + 1), __ldg(np + 2)};
        const float a = __fmul_rn(lam, dot3(n, g));
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) acc[ch] = __fadd_rn(acc[ch], __fmul_rn(a, n[ch]));
      }
      const int end = __ldg(corner_off + v + 1);
      for (int j = __ldg(corner_off + v) + sub; j < end; j += kVertexTeam) {
        const int face = __ldg(corner_ids + j);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          leaf[ch] = __fadd_rn(leaf[ch], __ldcg(g_leaf + (size_t)face * 3 + ch));
        }
      }
    }
#pragma unroll
    for (int m = 1; m < kVertexTeam; m <<= 1) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        acc[ch] = __fadd_rn(acc[ch], __shfl_xor_sync(kFullMask, acc[ch], m));
        leaf[ch] = __fadd_rn(leaf[ch], __shfl_xor_sync(kFullMask, leaf[ch], m));
      }
    }
    if (live && sub == 0) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        gx[(size_t)v * 3 + ch] = __fadd_rn(__fsub_rn(g[ch], acc[ch]), leaf[ch]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ms_solver_adjoint_kernel(const float* __restrict__ xs, const int* __restrict__ faces,
                         const int* __restrict__ v_faces, const float* __restrict__ fn,
                         const float* __restrict__ lmbd, const int* __restrict__ slot_off,
                         const int* __restrict__ slot_ids, const int* __restrict__ corner_off,
                         const int* __restrict__ corner_ids, float* gx, float* gfn,
                         float* g_leaf, int num_vertices, int k, int nodes, int shift,
                         int iters) {
  cg::grid_group grid = cg::this_grid();
  for (int it = iters - 1; it >= 0; --it) {
    adjoint_a(xs + (size_t)it * num_vertices * 3, faces, fn, lmbd, slot_off, slot_ids, gx, gfn,
              g_leaf, nodes, k, shift);
    grid.sync();
    adjoint_b(gx, v_faces, fn, lmbd, corner_off, corner_ids, g_leaf, num_vertices, k, shift);
    if (it > 0) grid.sync();
  }
}

}  // namespace

extern "C" {

// The adjoint kernel's grid for one scale (solver_grid's rule, with this
// kernel's occupancy), or minus a cudaError_t.
int ms_solver_adjoint_grid(int num_vertices, int nodes, int shift) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ms_solver_adjoint_kernel, kThreads, 0);
  return solver_grid(err == cudaSuccess ? per_sm : -(int)err, num_vertices, nodes, shift);
}

// One scale's adjoint: `iters` iterations in reverse from xs [iters + 1,
// num_vertices, 3], gx [num_vertices, 3] in place, gfn [nodes, 3] added to,
// g_leaf [nodes << shift, 3] scratch, in one cooperative launch of `grid`
// blocks on `stream`. Returns the launch's cudaError_t.
int ms_solver_adjoint_f32(const float* xs, const int* faces, const int* v_faces, const float* fn,
                          const float* lmbd, const int* slot_off, const int* slot_ids,
                          const int* corner_off, const int* corner_ids, float* gx, float* gfn,
                          float* g_leaf, int num_vertices, int k, int nodes, int shift,
                          int iters, int grid, void* stream) {
  if (num_vertices < 0 || k < 1 || nodes < 0 || shift < 0 || shift > kMaxShift || iters < 0 ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&xs,      &faces,  &v_faces,      &fn,     &lmbd,  &slot_off,
                  &slot_ids, &corner_off, &corner_ids, &gx,   &gfn,   &g_leaf,
                  &num_vertices, &k, &nodes, &shift, &iters};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)ms_solver_adjoint_kernel, dim3((unsigned)grid), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  // a refused launch leaves its error as the last one: clear it
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // extern "C"
