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
//
// Backward (tree_pool_iz_bwd): dx [N, C] from the saved x and dy [N / G, C].
// The JAX package has no backward kernel for K4: jax.grad differentiates its
// plain tree_pool, whose jnp.where pairs route a cotangent thus: in a pair
// (a, b) with out = (where(za, b, a) + where(zb, a, b)) * 0.5, h = dout * 0.5
// reaches a once for each of "a is not zero" and "b is zero", and b likewise,
// so a zero sibling's share goes to its partner (in an all-zero pair each
// takes the other's). A team recomputes its group's forward as above,
// keeping every node's zero flag (the leaves' and each merge's, 2G - 1 bits:
// a 64-bit register up to 5 rounds, a bit array in local memory beyond),
// then walks each leaf's path from the root: d = dy; per round from the top,
// h = d * 0.5 and d = (a-share ? h : 0) + (b-share ? h : 0), the products
// and sums autograd of the plain version takes, by __fmul_rn / __fadd_rn (no
// contraction), so the kernel matches that backward bit for bit up to the
// sign of a zero. Each dx row is written once by one team: no atomics, the
// same bits on every run. At C = 3 a thread owns a group and writes its
// 2^steps leaf rows as one run, 48 floats from the next thread's at 4
// rounds, so its stores do not coalesce: on an NVIDIA H100 80GB HBM3 at
// 700 W, at 1.27M rows, it runs at about a tenth of its bytes bound (x and
// dy read once, dx written once). Staging dx through shared memory would
// coalesce them (untried). The zero flags of 2^(steps + 1) - 1 nodes bound
// steps to kMaxBwdSteps.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;  // the most shared memory a block can have on sm_90
constexpr int kMaxBwdSteps = 10;   // 2047 zero flags a group
constexpr int kRegisterFlagSteps = 5;  // 63 zero flags: one 64-bit register
constexpr int kFlagWords = ((2 << kMaxBwdSteps) + 31) / 32;

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

// Node (level r, index j) of a group's tree, leaves at level 0: its bit in
// the flag array, the levels laid out one after another from the leaves.
__device__ __forceinline__ int node_bit(int steps, int level, int j) {
  return (2 << steps) - (2 << (steps - level)) + j;
}

// A group's zero flags: one 64-bit register for up to 5 rounds (63 nodes),
// else a bit array in local memory.
struct RegisterFlags {
  unsigned long long bits = 0ull;
  __device__ __forceinline__ void set(int b) { bits |= 1ull << b; }
  __device__ __forceinline__ bool get(int b) const { return (bits >> b) & 1ull; }
};

struct LocalFlags {
  unsigned words[kFlagWords];
  __device__ __forceinline__ LocalFlags() {
    for (int w = 0; w < kFlagWords; ++w) words[w] = 0u;
  }
  __device__ __forceinline__ void set(int b) { words[b >> 5] |= 1u << (b & 31); }
  __device__ __forceinline__ bool get(int b) const { return (words[b >> 5] >> (b & 31)) & 1u; }
};

template <int TEAM, typename Flags>
__global__ void __launch_bounds__(kThreads)
tree_pool_iz_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                        float* __restrict__ dx, int groups, int c, int steps) {
  extern __shared__ float stack_mem[];
  const int team = threadIdx.x / TEAM;
  const int lane = threadIdx.x % TEAM;
  const int g = blockIdx.x * (blockDim.x / TEAM) + team;
  if (g >= groups) return;  // team-uniform: a warp team leaves together
  float* stack = stack_mem + (size_t)team * (steps + 1) * c;
  const int leaves = 1 << steps;
  const float* src = x + (size_t)g * leaves * c;

  Flags flags;
  unsigned zero = 0u;  // bit d: stack row d is all zero (as in the forward)
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
    bool z = !team_any<TEAM>(nz);
    zero = z ? zero | (1u << depth) : zero & ~(1u << depth);
    if (z) flags.set(node_bit(steps, 0, leaf));
    ++depth;
    int level = 0;
    for (int t = leaf + 1; (t & 1) == 0;) {
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
      t >>= 1;
      ++level;
      z = !team_any<TEAM>(nz);
      zero = z ? zero | (1u << (depth - 1)) : zero & ~(1u << (depth - 1));
      if (z) flags.set(node_bit(steps, level, t - 1));
    }
  }

  const float* gy = dy + (size_t)g * c;
  float* dst = dx + (size_t)g * leaves * c;
  for (int leaf = 0; leaf < leaves; ++leaf) {
    for (int ch = lane; ch < c; ch += TEAM) {
      float d = gy[ch];
      for (int r = steps - 1; r >= 0; --r) {
        const int p = leaf >> (r + 1);
        const int ba = node_bit(steps, r, 2 * p);
        const bool za = flags.get(ba), zb = flags.get(ba + 1);
        const float h = __fmul_rn(d, 0.5f);
        const bool is_b = (leaf >> r) & 1;
        // a's shares: a itself where a is not zero, b's slot where b is
        const bool first = is_b ? za : !za;
        const bool second = is_b ? !zb : zb;
        d = __fadd_rn(first ? h : 0.f, second ? h : 0.f);
      }
      dst[(size_t)leaf * c + ch] = d;
    }
  }
}

// The launch shape of either kernel: teams of TEAM lanes, each with its
// stack of (steps + 1) * C floats in dynamic shared memory.
template <typename Kernel>
cudaError_t launch_shape(Kernel kernel, int team_size, int groups, int c, int steps,
                         unsigned* blocks, int* threads, size_t* smem) {
  const size_t per_team = (size_t)(steps + 1) * c * sizeof(float);
  if (per_team > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  int teams = kThreads / team_size;
  if ((size_t)teams * per_team > (size_t)kDefaultSmem)
    teams = per_team > (size_t)kDefaultSmem ? 1 : (int)(kDefaultSmem / per_team);
  *smem = (size_t)teams * per_team;
  if (*smem > (size_t)kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (err != cudaSuccess) return err;
  }
  *blocks = (unsigned)((groups + teams - 1) / teams);
  *threads = teams * team_size;
  return cudaSuccess;
}

template <int TEAM>
int launch(const float* x, float* out, int groups, int c, int steps, cudaStream_t stream) {
  unsigned blocks;
  int threads;
  size_t smem;
  const cudaError_t err = launch_shape(tree_pool_iz_kernel<TEAM>, TEAM, groups, c, steps,
                                       &blocks, &threads, &smem);
  if (err != cudaSuccess) return (int)err;
  tree_pool_iz_kernel<TEAM><<<blocks, threads, smem, stream>>>(x, out, groups, c, steps);
  return (int)cudaGetLastError();
}

template <int TEAM, typename Flags>
int launch_bwd(const float* x, const float* dy, float* dx, int groups, int c, int steps,
               cudaStream_t stream) {
  unsigned blocks;
  int threads;
  size_t smem;
  const cudaError_t err = launch_shape(tree_pool_iz_bwd_kernel<TEAM, Flags>, TEAM, groups, c,
                                       steps, &blocks, &threads, &smem);
  if (err != cudaSuccess) return (int)err;
  tree_pool_iz_bwd_kernel<TEAM, Flags><<<blocks, threads, smem, stream>>>(x, dy, dx, groups, c,
                                                                          steps);
  return (int)cudaGetLastError();
}

template <int TEAM>
int launch_bwd(const float* x, const float* dy, float* dx, int groups, int c, int steps,
               cudaStream_t stream) {
  return steps <= kRegisterFlagSteps
             ? launch_bwd<TEAM, RegisterFlags>(x, dy, dx, groups, c, steps, stream)
             : launch_bwd<TEAM, LocalFlags>(x, dy, dx, groups, c, steps, stream);
}

}  // namespace

extern "C" {

// Largest (steps + 1) * C the kernels take: their stack must fit one block's
// shared memory.
int tree_pool_iz_max_stack_floats(void) { return kMaxSmem / (int)sizeof(float); }

// Most rounds the backward takes (its zero flags are a fixed bit array).
int tree_pool_iz_bwd_max_steps(void) { return kMaxBwdSteps; }

// x [groups * 2^steps, c] -> out [groups, c], f32, contiguous, on the current
// device; 0 <= steps <= 30, c >= 1. Launches on `stream` and returns
// cudaGetLastError() after the launch (0 when it was accepted).
int tree_pool_iz_f32(const float* x, float* out, int groups, int c, int steps, void* stream) {
  if (groups < 0 || c < 1 || steps < 0 || steps > 30) return (int)cudaErrorInvalidValue;
  if (groups == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return c <= 8 ? launch<1>(x, out, groups, c, steps, s) : launch<32>(x, out, groups, c, steps, s);
}

// The backward: x [groups * 2^steps, c] (the forward's input) and dy
// [groups, c] -> dx [groups * 2^steps, c], f32, contiguous, on the current
// device; 0 <= steps <= kMaxBwdSteps, c >= 1. Returns as tree_pool_iz_f32.
int tree_pool_iz_bwd_f32(const float* x, const float* dy, float* dx, int groups, int c,
                         int steps, void* stream) {
  if (groups < 0 || c < 1 || steps < 0 || steps > kMaxBwdSteps)
    return (int)cudaErrorInvalidValue;
  if (groups == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return c <= 8 ? launch_bwd<1>(x, dy, dx, groups, c, steps, s)
                : launch_bwd<32>(x, dy, dx, groups, c, steps, s);
}

}  // extern "C"
