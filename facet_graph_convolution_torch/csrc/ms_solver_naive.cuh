// Shared by the naive solver's scale kernel (ms_solver_naive.cu) and its
// adjoint (ms_solver_naive_bwd.cu): the launch shape, K4's pair rule and the
// face centroids in tree order. Both kernels take the same float operations
// in the same order from here, so the adjoint recomputes the forward's
// centres bit for bit.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kVertexTeam = 8;     // phase B: lanes a vertex
constexpr int kSlotsInFlight = 4;  // phase B: slots a lane loads at once
constexpr int kMaxShift = 30;
// a lane pools at most 2^(kMaxShift - 5) leaves with a stack this deep
constexpr int kStack = kMaxShift - 5 + 1;

__device__ __forceinline__ bool all_zero(const float c[3]) {
  return c[0] == 0.f && c[1] == 0.f && c[2] == 0.f;
}

// K4's pair rule: an all-zero row takes its partner's value, then (a + b) / 2.
__device__ __forceinline__ void pair_mean(const float a[3], bool za, const float b[3], bool zb,
                                          float r[3]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float ca = za ? b[ch] : a[ch];
    const float cb = zb ? a[ch] : b[ch];
    r[ch] = __fmul_rn(__fadd_rn(ca, cb), 0.5f);
  }
}

// Centroid of fine face `face`; a -1 corner reads a zero vertex.
__device__ __forceinline__ void leaf_center(const float* x, const int* __restrict__ faces,
                                            int face, float c[3]) {
  const int* corners = faces + (size_t)face * 3;
  float s[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int vid = __ldg(corners + j);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float v = vid >= 0 ? __ldcg(x + (size_t)vid * 3 + ch) : 0.f;
      s[ch] = j == 0 ? v : __fadd_rn(s[ch], v);
    }
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) c[ch] = __fdiv_rn(s[ch], 3.f);
}

// The pooled centre of `count` consecutive leaves starting at `first`, in
// tree order: K4's stack rule (csrc/tree_pool_iz.cu). Only for shift > 5.
__device__ __noinline__ void leaf_block_center(const float* x, const int* __restrict__ faces,
                                               int first, int count, float c[3]) {
  float stack[kStack][3];
  unsigned zero = 0u;  // bit d: stack row d is all zero
  int depth = 0;
  for (int leaf = 0; leaf < count; ++leaf) {
    leaf_center(x, faces, first + leaf, stack[depth]);
    zero = all_zero(stack[depth]) ? zero | (1u << depth) : zero & ~(1u << depth);
    ++depth;
    for (int t = leaf + 1; (t & 1) == 0; t >>= 1) {
      float r[3];
      pair_mean(stack[depth - 2], (zero >> (depth - 2)) & 1u, stack[depth - 1],
                (zero >> (depth - 1)) & 1u, r);
      --depth;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) stack[depth - 1][ch] = r[ch];
      zero = all_zero(r) ? zero | (1u << (depth - 1)) : zero & ~(1u << (depth - 1));
    }
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) c[ch] = stack[0][ch];
}

// Grid of a solver kernel for one scale: enough blocks for the work (a team
// of min(2^shift, 32) lanes a level-s node, kVertexTeam lanes a vertex) and
// at most one an SM; or minus a cudaError_t. `per_sm` is the kernel's
// occupancy (blocks an SM). More blocks an SM measured slower: every block
// arrives at each barrier, and the phases slow too.
inline int solver_grid(int per_sm, int num_vertices, int nodes, int shift) {
  if (num_vertices < 0 || nodes < 0 || shift < 0 || shift > kMaxShift)
    return -(int)cudaErrorInvalidValue;
  if (per_sm < 1) return per_sm < 0 ? per_sm : -(int)cudaErrorCooperativeLaunchTooLarge;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  const long long lanes_a = (long long)nodes << (shift < 5 ? shift : 5);
  const long long lanes_b = (long long)num_vertices * kVertexTeam;
  const long long grid = ((lanes_a > lanes_b ? lanes_a : lanes_b) + kThreads - 1) / kThreads;
  return grid < 1 ? 1 : (grid > sms ? sms : (int)grid);
}

}  // namespace
