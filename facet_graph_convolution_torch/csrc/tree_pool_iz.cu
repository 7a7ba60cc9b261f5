// Zero-ignoring binary-tree pool (K4).
//
// Replaces facet_graph_convolution_tpu/ops/pallas_kernels.py::_pool_iz_kernel
// (launched by tree_pool_ignore_zeros), which fuses two rounds; here the
// number of rounds `steps` is an argument, so K4 is its steps = 2 case. For
// x [N, C] f32, each group of G = 2^steps consecutive rows (tree-ordered
// siblings) is reduced by `steps` rounds of pairwise mean: rows (0,1), (2,3),
// ... then the results pairwise, and so on. In each pair a row whose every
// channel == 0 is replaced by its partner before (a + b) * 0.5f, so a fake
// (all-zero) sibling does not pull the mean to zero; an all-zero pair stays
// zero. out [N / G, C].
//
// The float operations are the plain version's, in its order: the same
// pairing, the zero test by == (-0.0 counts as zero, NaN does not), the
// partner chosen by the same rule, and (a + b) * 0.5f (an add and a multiply
// by a power of two: no contraction into an FMA). So the kernel matches
// tree_pool_ignore_zeros_plain bit for bit.
//
// What bounds it on an H100: launch latency. The vertex solver pools face
// centres, C = 3: at the ~24,600 faces of a subdivision-5 patch one launch
// moves ~0.37 MB (0.11 us at 3.35 TB/s) and does ~4 flops a value, while a
// launch costs a few microseconds. The design is therefore the simple one:
// no tiling, one pass over the input, each value read once and each result
// written once.
//
// Design: a team of lanes per output row, one lane (C <= 8) or a warp
// (C > 8); lane t of a team owns channels t, t + TEAM, ... The team walks the
// group's G leaves in order and keeps a stack of partial results in shared
// memory, at most steps + 1 rows of C floats: after pushing leaf i it merges
// the two top rows once for every trailing zero bit of i + 1, which is the
// round-by-round pairing of a full binary tree. A row's zero test is its
// lanes' "any channel != 0" reduced across the team (__any_sync for a warp),
// and each row's flag is a bit of a register mask. A lane only ever reads
// back the channels it wrote, so the stack needs no barrier.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;  // the most shared memory a block can have on sm_90

template <int TEAM>
__device__ __forceinline__ bool team_any(bool v) {
  if constexpr (TEAM == 1) {
    return v;
  } else {
    return __any_sync(kFullMask, v);
  }
}

template <int TEAM>
__global__ void __launch_bounds__(kThreads)
tree_pool_iz_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int groups, int c, int steps) {
  extern __shared__ float stack_mem[];
  const int team = threadIdx.x / TEAM;
  const int lane = threadIdx.x % TEAM;
  const int g = blockIdx.x * (blockDim.x / TEAM) + team;
  if (g >= groups) return;  // team-uniform: a warp team leaves together
  float* stack = stack_mem + (size_t)team * (steps + 1) * c;
  const int leaves = 1 << steps;
  const float* src = x + (size_t)g * leaves * c;

  unsigned zero = 0u;  // bit d: stack row d is all zero
  int depth = 0;
  for (int leaf = 0; leaf < leaves; ++leaf) {
    float* top = stack + (size_t)depth * c;
    const float* row = src + (size_t)leaf * c;
    bool nz = false;
    for (int ch = lane; ch < c; ch += TEAM) {
      const float v = __ldg(row + ch);
      top[ch] = v;
      nz |= v != 0.f;
    }
    zero = team_any<TEAM>(nz) ? zero & ~(1u << depth) : zero | (1u << depth);
    ++depth;
    for (int t = leaf + 1; (t & 1) == 0; t >>= 1) {
      float* a = stack + (size_t)(depth - 2) * c;
      const float* b = stack + (size_t)(depth - 1) * c;
      const bool za = (zero >> (depth - 2)) & 1u;
      const bool zb = (zero >> (depth - 1)) & 1u;
      nz = false;
      for (int ch = lane; ch < c; ch += TEAM) {
        const float av = a[ch], bv = b[ch];
        const float ca = za ? bv : av;
        const float cb = zb ? av : bv;
        const float r = (ca + cb) * 0.5f;
        a[ch] = r;
        nz |= r != 0.f;
      }
      --depth;
      zero = team_any<TEAM>(nz) ? zero & ~(1u << (depth - 1)) : zero | (1u << (depth - 1));
    }
  }
  float* dst = out + (size_t)g * c;
  for (int ch = lane; ch < c; ch += TEAM) dst[ch] = stack[ch];
}

template <int TEAM>
int launch(const float* x, float* out, int groups, int c, int steps, cudaStream_t stream) {
  const size_t per_team = (size_t)(steps + 1) * c * sizeof(float);
  if (per_team > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  int teams = kThreads / TEAM;
  if ((size_t)teams * per_team > (size_t)kDefaultSmem)
    teams = per_team > (size_t)kDefaultSmem ? 1 : (int)(kDefaultSmem / per_team);
  const size_t smem = (size_t)teams * per_team;
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        tree_pool_iz_kernel<TEAM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((groups + teams - 1) / teams);
  tree_pool_iz_kernel<TEAM><<<blocks, teams * TEAM, smem, stream>>>(x, out, groups, c, steps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest (steps + 1) * C the kernel takes: its stack must fit one block's
// shared memory.
int tree_pool_iz_max_stack_floats(void) { return kMaxSmem / (int)sizeof(float); }

// x [groups * 2^steps, c] -> out [groups, c], f32, contiguous, on the current
// device; 0 <= steps <= 30, c >= 1. Launches on `stream` and returns
// cudaGetLastError() after the launch (0 when it was accepted).
int tree_pool_iz_f32(const float* x, float* out, int groups, int c, int steps, void* stream) {
  if (groups < 0 || c < 1 || steps < 0 || steps > 30) return (int)cudaErrorInvalidValue;
  if (groups == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return c <= 8 ? launch<1>(x, out, groups, c, steps, s) : launch<32>(x, out, groups, c, steps, s);
}

}  // extern "C"
