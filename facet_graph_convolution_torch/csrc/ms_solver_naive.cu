// One scale of the naive multi-scale vertex solver in one persistent kernel,
// with the zero-ignoring tree pool (K4) inside it.
//
// Replaces facet_graph_convolution_tpu/ops/pallas_kernels.py::_pool_iz_kernel
// (launched by tree_pool_ignore_zeros, K4) on the path that runs it, the naive
// solver's face-centre pyramid, together with the loop around it, which the
// JAX package leaves to XLA as one fori_loop
// (facet_graph_convolution_tpu/ops/vertex_update.py::update_positions_multiscale,
// body :260-273). One launch runs every iteration of one scale s; the plain
// version is ops/ms_solver_kernel.py::naive_scale_plain.
//
// Inputs: x [V, 3] f32, updated in place; faces [F0, 3] int32 (-1 marks the
// corners of a fake face); v_faces [V, K] int32, -1 padded; fn [F_s, 3] f32,
// the level-s normals; shift = coarsening_steps * s, so that fine face f lies
// in level-s node f >> shift and F0 = F_s << shift; iters. Each iteration:
//
//   phase A, per level-s node f: the centroid of each of its 2^shift fine
//     faces (a -1 corner reads a zero vertex), then `shift` rounds of K4's
//     pairwise mean over those leaves in tree order, where an all-zero row
//     takes its partner's value; t[f] = <fn[f], c_f>. One pool of shift
//     rounds is what the s chained pools of coarsening_steps rounds compute:
//     the pairing is the same.
//   grid-wide barrier;
//   phase B, per vertex v: n_w = t[f >> shift] - <fn[f >> shift], x_v> over
//     its real slots (a -1 pad contributes nothing), and
//     x_v += lambda_v * sum_k n_w * fn[f >> shift], lambda_v = 1 / (real slots)
//     (0 for a vertex without faces);
//   grid-wide barrier (none after the last iteration).
//
// The pool's float operations are K4's (csrc/tree_pool_iz.cu), in its order:
// the zero test by == (-0.0 counts as zero, NaN does not), the partner chosen
// by the same rule, (a + b) * 0.5f with no contraction. So the level-s centres
// of ms_solver_centers_f32 equal tree_pool_ignore_zeros_plain of its level-0
// centres (shift 0) bit for bit.
//
// What bounds it on an H100: the barriers and each phase's chain of dependent
// loads, not bytes or operations. At the largest served patch (24,544 fine
// faces, 10,041 vertices, K = 25) an iteration touches ~2 MB, all of it
// L2-resident, and does ~4 M flops; the loop needs 2 barriers an iteration,
// 239 for the (80, 20, 20) schedule. Before this kernel the same loop was ~20
// small launches an iteration from Python (K4 among them, 180 a patch at
// ~3 us each): launch latency.
//
// Design: a cooperative launch (cudaLaunchCooperativeKernel: every block is
// resident, so cooperative_groups::this_grid().sync() cannot deadlock) of
// 1024-thread blocks, one an SM at most and no more than the work fills
// (ms_solver_naive_grid), grid-stride loops
// over nodes and vertices. Phase A gives each node a team of
// min(2^shift, 32) lanes of one warp: lane i of a team computes leaf i's
// centroid (for shift > 5 it first pools its 2^(shift-5) consecutive leaves in
// tree order with K4's stack rule) and the team does the remaining rounds by
// __shfl_xor_sync, with no shared memory. Phase B gives each vertex a team of
// 8 lanes that load their slots' indices, normals and t several at once and
// sum by shuffles. Data written inside the kernel (x, t) is read through L2
// (__ldcg), never from a possibly stale L1 line; the read-only tables go
// through __ldg.
//
// Training: the launch with a store (ms_solver_naive_kernel<true>) also
// writes every iterate into [iters + 1, V, 3], ~14.8 MB a step over the three
// scales at the largest training patch (10,027 vertices), which the adjoint
// kernel (ms_solver_naive_bwd.cu) reads back in reverse. The arithmetic is
// the same with or without the store: serving's launch, without it, gives
// the same bits as before the store existed.

#include "ms_solver_naive.cuh"

namespace {

// Phase A over the level-s nodes, grid-stride by warp. With CENTERS the team
// leader writes the node's centre to out [F_s, 3], else t = <fn[f], c_f> to
// out [F_s]. The loop bounds are warp-uniform: every lane reaches the shuffles.
template <bool CENTERS>
__device__ __forceinline__ void phase_a(const float* x, const int* __restrict__ faces,
                                        const float* __restrict__ fn, float* out, int nodes,
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
    float c[3] = {0.f, 0.f, 0.f};
    if (live) {
      const int first = (f << shift) + sub * per_lane;
      if (per_lane == 1) {
        leaf_center(x, faces, first, c);
      } else {
        leaf_block_center(x, faces, first, per_lane, c);
      }
    }
    bool z = all_zero(c);
    for (int m = 1; m < team; m <<= 1) {
      float o[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) o[ch] = __shfl_xor_sync(kFullMask, c[ch], m);
      const bool zo = all_zero(o);
      if (sub & m) {  // the partner is the left row
        pair_mean(o, zo, c, z, c);
      } else {
        pair_mean(c, z, o, zo, c);
      }
      z = all_zero(c);
    }
    if (live && sub == 0) {
      if constexpr (CENTERS) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) out[(size_t)f * 3 + ch] = c[ch];
      } else {
        const float* n = fn + (size_t)f * 3;
        out[f] = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(n), c[0]), __fmul_rn(__ldg(n + 1), c[1])),
                           __fmul_rn(__ldg(n + 2), c[2]));
      }
    }
  }
}

// Phase B: a team of kVertexTeam lanes a vertex. Lane i of a team walks
// slots i, i + kVertexTeam, ..., loading kSlotsInFlight slots' indices, then
// their normals and t, at once; the team sums its partial updates and slot
// counts by __shfl_xor_sync, and its first lane moves x_v (and, with STORE,
// writes the new x_v to `stored` too). The loop bounds are warp-uniform: every
// lane reaches the shuffles.
template <bool STORE>
__device__ __forceinline__ void phase_b(float* x, const int* __restrict__ v_faces,
                                        const float* __restrict__ fn, const float* t,
                                        float* stored, int num_vertices, int k, int shift) {
  const int lane = threadIdx.x & 31;
  const int warp = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int warps = (int)((gridDim.x * blockDim.x) >> 5);
  const int sub = lane & (kVertexTeam - 1);
  constexpr int per_warp = 32 / kVertexTeam;
  const int tasks = (num_vertices + per_warp - 1) / per_warp;
  for (int task = warp; task < tasks; task += warps) {
    const int v = task * per_warp + lane / kVertexTeam;
    const bool live = v < num_vertices;  // team-uniform
    float xv[3] = {0.f, 0.f, 0.f};
    float a[3] = {0.f, 0.f, 0.f};
    int real = 0;
    if (live) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) xv[ch] = __ldcg(x + (size_t)v * 3 + ch);
      const int* row = v_faces + (size_t)v * k;
      for (int base = sub; base < k; base += kVertexTeam * kSlotsInFlight) {
        int f[kSlotsInFlight];
#pragma unroll
        for (int u = 0; u < kSlotsInFlight; ++u) {
          const int j = base + u * kVertexTeam;
          f[u] = j < k ? __ldg(row + j) : -1;
        }
#pragma unroll
        for (int u = 0; u < kSlotsInFlight; ++u) {
          if (f[u] < 0) continue;  // a pad: its zero normal contributes nothing
          ++real;
          const int fs = f[u] >> shift;
          const float* n = fn + (size_t)fs * 3;
          const float n0 = __ldg(n), n1 = __ldg(n + 1), n2 = __ldg(n + 2);
          const float dot = __fadd_rn(__fadd_rn(__fmul_rn(n0, xv[0]), __fmul_rn(n1, xv[1])),
                                      __fmul_rn(n2, xv[2]));
          const float w = __fsub_rn(__ldcg(t + fs), dot);
          a[0] = __fadd_rn(a[0], __fmul_rn(w, n0));
          a[1] = __fadd_rn(a[1], __fmul_rn(w, n1));
          a[2] = __fadd_rn(a[2], __fmul_rn(w, n2));
        }
      }
    }
#pragma unroll
    for (int m = 1; m < kVertexTeam; m <<= 1) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        a[ch] = __fadd_rn(a[ch], __shfl_xor_sync(kFullMask, a[ch], m));
      }
      real += __shfl_xor_sync(kFullMask, real, m);
    }
    if (live && sub == 0) {
      const float lmbd = real > 0 ? __fdiv_rn(1.f, (float)real) : 0.f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float moved = __fadd_rn(xv[ch], __fmul_rn(lmbd, a[ch]));
        x[(size_t)v * 3 + ch] = moved;
        if constexpr (STORE) stored[(size_t)v * 3 + ch] = moved;
      }
    }
  }
}

// With STORE, iteration `it` also writes its new x to store[it + 1] (store
// [iters + 1, V, 3]; the caller writes store[0]), for the adjoint kernel.
template <bool STORE>
__global__ void __launch_bounds__(kThreads)
ms_solver_naive_kernel(float* x, const int* __restrict__ faces, const int* __restrict__ v_faces,
                       const float* __restrict__ fn, float* t, float* store, int num_vertices,
                       int k, int nodes, int shift, int iters) {
  cg::grid_group grid = cg::this_grid();
  for (int it = 0; it < iters; ++it) {
    phase_a<false>(x, faces, fn, t, nodes, shift);
    grid.sync();
    phase_b<STORE>(x, v_faces, fn, t, STORE ? store + (size_t)(it + 1) * num_vertices * 3
                                            : nullptr, num_vertices, k, shift);
    if (it + 1 < iters) grid.sync();
  }
}

__global__ void __launch_bounds__(kThreads)
ms_solver_centers_kernel(const float* x, const int* __restrict__ faces, float* centers,
                         int nodes, int shift) {
  phase_a<true>(x, faces, nullptr, centers, nodes, shift);
}

}  // namespace

extern "C" {

// Largest number of blocks of the solver kernel that can be resident on one
// SM of the current device (the cooperative launch's limit is this times the
// SM count), or minus a cudaError_t.
int ms_solver_naive_blocks_per_sm(void) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ms_solver_naive_kernel<false>, kThreads, 0);
  return err == cudaSuccess ? per_sm : -(int)err;
}

// The solver kernel's grid for one scale (solver_grid's rule).
int ms_solver_naive_grid(int num_vertices, int nodes, int shift) {
  return solver_grid(ms_solver_naive_blocks_per_sm(), num_vertices, nodes, shift);
}

// One scale: `iters` iterations on x [num_vertices, 3] in place, t [nodes]
// scratch, in one cooperative launch of `grid` blocks on `stream`; with
// `store` (else null) also each iteration's new x into store[1..iters]
// ([iters + 1, num_vertices, 3]; the caller writes store[0]). Returns the
// launch's cudaError_t (0 when accepted; cudaErrorCooperativeLaunchTooLarge
// when `grid` blocks cannot all be resident).
int ms_solver_naive_f32(float* x, const int* faces, const int* v_faces, const float* fn,
                        float* t, float* store, int num_vertices, int k, int nodes, int shift,
                        int iters, int grid, void* stream) {
  if (num_vertices < 0 || k < 0 || nodes < 0 || shift < 0 || shift > kMaxShift || iters < 0 ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&x,    &faces, &v_faces, &fn,    &t,    &store,
                  &num_vertices, &k, &nodes, &shift, &iters};
  const void* kernel = store ? (const void*)ms_solver_naive_kernel<true>
                             : (const void*)ms_solver_naive_kernel<false>;
  const cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)grid),
                                                      dim3(kThreads), args, 0,
                                                      (cudaStream_t)stream);
  // a refused launch also leaves its error as the last one: clear it, or the
  // next accepted launch would read it back below
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// Phase A alone: the level-s centres [nodes, 3] of x's faces (shift 0 gives
// the level-0 centroids). An ordinary launch; for checks only.
int ms_solver_centers_f32(const float* x, const int* faces, float* centers, int nodes, int shift,
                          void* stream) {
  if (nodes < 0 || shift < 0 || shift > kMaxShift) return (int)cudaErrorInvalidValue;
  if (nodes == 0) return 0;
  const long long team = 1LL << (shift < 5 ? shift : 5);
  const unsigned blocks = (unsigned)(((long long)nodes * team + kThreads - 1) / kThreads);
  ms_solver_centers_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, faces, centers,
                                                                           nodes, shift);
  return (int)cudaGetLastError();
}

}  // extern "C"
