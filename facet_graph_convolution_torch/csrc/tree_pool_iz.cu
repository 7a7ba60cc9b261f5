// Zero-ignoring binary-tree pool (K4) and its backward.
//
// The forward replaces facet_graph_convolution_tpu/ops/pallas_kernels.py::
// _pool_iz_kernel (launched by tree_pool_ignore_zeros), which fuses two
// rounds; here the number of rounds `steps` is an argument, so K4 is its
// steps = 2 case. For x [N, C] f32, each group of G = 2^steps consecutive
// rows (tree-ordered siblings) is reduced by `steps` rounds of pairwise mean:
// rows (0,1), (2,3), ... then the results pairwise, and so on. In each pair a
// row whose every channel == 0 is replaced by its partner before
// (a + b) * 0.5f, so a fake (all-zero) sibling does not pull the mean to
// zero; an all-zero pair stays zero. out [N / G, C].
//
// The float operations are the plain version's, in its order: the same
// pairing, the zero test by == (-0.0 counts as zero, NaN does not), the
// partner chosen by the same rule, and (a + b) * 0.5f (an add and a multiply
// by a power of two, by __fadd_rn / __fmul_rn: no contraction into an FMA).
// So the forward matches tree_pool_ignore_zeros_plain bit for bit.
//
// The backward (tree_pool_iz_bwd): dx [N, C] from the saved x and dy
// [N / G, C]. The JAX package has no backward kernel for K4: jax.grad
// differentiates its plain tree_pool, whose jnp.where pairs route a
// cotangent thus: in a pair (a, b) with out = (where(za, b, a) +
// where(zb, a, b)) * 0.5, h = dout * 0.5 reaches a once for each of "a is
// not zero" and "b is zero", and b likewise, so a zero sibling's share goes
// to its partner (in an all-zero pair each takes the other's). Walking a
// leaf's path from the root, d = dy and per round h = d * 0.5,
// d = (first ? h : 0) + (second ? h : 0), by __fmul_rn / __fadd_rn: the
// products and sums autograd of the plain version takes, so the kernel
// matches that backward bit for bit up to the sign of a zero. Each dx row is
// written once by one thread: no atomics, the same bits on every run.
//
// What bounds them on an H100: bytes. On the sharded naive solver's path
// (C = 3, 4 and 2 rounds, 126,256 to 1,273,920 face centres) the forward
// reads x once and writes out once (15.3 + 1.0 MB at 1.27M rows and 4
// rounds: 4.85 us at 3.35 TB/s), the backward reads x and dy and writes dx
// (31.5 MB: 9.4 us); each does a few flops a value.
//
// Design, C <= kMaxLaneC and steps <= kMaxLaneSteps (the path's shapes): a
// lane per leaf row, one thread an input row, 256 a block, no shared
// memory. A team of 2^steps consecutive lanes holds a group, and a warp
// 32 / 2^steps groups, so a warp's loads of x (and the backward's stores of
// dx) are 32 consecutive rows. Each lane keeps its row in registers (the
// kernels are templates on C and on the number of rounds) and the team does
// round m = 1, 2, 4, ... by __shfl_xor_sync of the row: the zero tests on
// registers, the partner's flag from a ballot of the lanes' own flags, then
// the pair rule in a form that both lanes of a pair evaluate to the same
// bits (`pair_round`), so after the rounds every lane of the team holds the
// group's row. Where no lane of the warp holds a zero row (warp-uniform, and
// most rounds of real face centres) the rule is (own + partner) * 0.5: the
// selects cost issue slots, and the rounds' instructions, more than the
// bytes, are what remains of these kernels' time. The forward's team writes
// its output row, lane t channels t, t + 2^steps, ... The backward recomputes
// the forward the same way (its last round a ballot alone) and keeps a bit a
// round of its own node's zero flag and one of its partner's, in two
// registers: all the flags its own leaf's path needs. Then each lane loads
// its group's dy row (a team's lanes on one address) and walks its leaf's
// path from the top. The shuffles and ballots need every lane of the warp,
// so no lane leaves before the rounds: lanes past N (whole teams, as N is a
// multiple of 2^steps) load zeros, take part, and store nothing.
//
// Wider rows or more rounds keep the team design the kernels had first,
// written for a 24,600-face patch where launch latency bounds K4: a team of
// lanes per output row, one lane (C <= 8) or a warp (C > 8); lane t of a team
// owns channels t, t + TEAM, ... The team walks the group's G leaves in order
// and keeps a stack of partial results in shared memory, at most steps + 1
// rows of C floats: after pushing leaf i it merges the two top rows once for
// every trailing zero bit of i + 1, which is the round-by-round pairing of a
// full binary tree. A row's zero test is its lanes' "any channel != 0"
// reduced across the team (__any_sync for a warp), and each row's flag is a
// bit of a register mask. A lane only ever reads back the channels it wrote,
// so the stack needs no barrier. The team backward keeps every node's zero
// flag (2G - 1 bits: a 64-bit register up to 5 rounds, a bit array in local
// memory beyond), then walks each leaf's path from the root as above. The
// zero flags of 2^(steps + 1) - 1 nodes bound steps to kMaxBwdSteps.

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
constexpr int kMaxLaneC = 8;      // the lane kernels: a row of C floats in registers
constexpr int kMaxLaneSteps = 5;  // a team of 2^steps lanes within one warp

template <int C>
__device__ __forceinline__ bool all_zero(const float (&v)[C]) {
  bool z = true;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) z &= v[ch] == 0.f;
  return z;
}

// Row `row` of x [n, C] into v, zeros past n.
template <int C>
__device__ __forceinline__ void load_row(const float* __restrict__ x, long long row, bool live,
                                         float (&v)[C]) {
  const float* src = x + row * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) v[ch] = live ? __ldg(src + ch) : 0.f;
}

// The zero flag of the lane's partner in round m, from the warp's ballot of
// the lanes' own flags (`zeros`).
__device__ __forceinline__ bool partner_zero(unsigned zeros, int m) {
  return (zeros >> ((threadIdx.x & 31u) ^ (unsigned)m)) & 1u;
}

// Round m of the butterfly: the partner's row by shuffle, then K4's pair
// rule. With a the left row and b the right one the pair's value is
// ((za ? b : a) + (zb ? a : b)) * 0.5: from either side the same two terms,
// (own zero ? partner : own) and (partner zero ? own : partner), and an IEEE
// add is commutative, so both lanes of a pair compute the same bits without
// asking which side they are. Where no lane of the warp holds a zero row
// (warp-uniform) that is (own + partner) * 0.5. v and z become the merged
// node's; returns the partner's zero flag.
template <int C>
__device__ __forceinline__ bool pair_round(float (&v)[C], bool& z, int m) {
  float o[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) o[ch] = __shfl_xor_sync(kFullMask, v[ch], m);
  const unsigned zeros = __ballot_sync(kFullMask, z);
  const bool zo = partner_zero(zeros, m);
  if (zeros == 0u) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) v[ch] = __fmul_rn(__fadd_rn(v[ch], o[ch]), 0.5f);
  } else {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      v[ch] = __fmul_rn(__fadd_rn(z ? o[ch] : v[ch], zo ? v[ch] : o[ch]), 0.5f);
    }
  }
  z = all_zero(v);
  return zo;
}

// A lane per leaf row: x [n, C] -> out [n >> STEPS, C], one thread a row.
template <int C, int STEPS>
__global__ void __launch_bounds__(kThreads)
tree_pool_iz_lane_kernel(const float* __restrict__ x, float* __restrict__ out, long long n) {
  constexpr int team = 1 << STEPS;
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < n;  // team-uniform: n is a multiple of the team
  float v[C];
  load_row<C>(x, row, live, v);
  bool z = all_zero(v);
#pragma unroll
  for (int r = 0; r < STEPS; ++r) pair_round<C>(v, z, 1 << r);  // every lane of the warp
  if (!live) return;
  const int sub = threadIdx.x & (team - 1);
  float* dst = out + (row >> STEPS) * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    if ((ch & (team - 1)) == sub) dst[ch] = v[ch];
  }
}

// Its backward: x [n, C] and dy [n >> STEPS, C] -> dx [n, C], one thread a
// row. Bit r of `own` is the lane's node at level r all zero, bit r of
// `other` its partner's.
template <int C, int STEPS>
__global__ void __launch_bounds__(kThreads)
tree_pool_iz_lane_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                             float* __restrict__ dx, long long n) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < n;  // team-uniform: n is a multiple of the team
  float v[C];
  load_row<C>(x, row, live, v);
  bool z = all_zero(v);
  unsigned own = 0u, other = 0u;
#pragma unroll
  for (int r = 0; r < STEPS; ++r) {  // every lane of the warp
    own |= (z ? 1u : 0u) << r;
    // the last round needs only the partner's flag
    const bool zo = r + 1 < STEPS ? pair_round<C>(v, z, 1 << r)
                                  : partner_zero(__ballot_sync(kFullMask, z), 1 << r);
    other |= (zo ? 1u : 0u) << r;
  }
  if (!live) return;
  const float* gy = dy + (row >> STEPS) * C;
  float d[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) d[ch] = __ldg(gy + ch);
  // From the top: the lane's node takes h once where it is not zero and once
  // where its partner is (autograd's two where terms, added in either order).
#pragma unroll
  for (int r = STEPS - 1; r >= 0; --r) {
    const bool keep = !((own >> r) & 1u), take = (other >> r) & 1u;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const float h = __fmul_rn(d[ch], 0.5f);
      d[ch] = __fadd_rn(keep ? h : 0.f, take ? h : 0.f);
    }
  }
  float* dst = dx + row * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) dst[ch] = d[ch];
}

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

template <int C, int STEPS>
int launch_lane_kernel(const float* x, const float* dy, float* out, long long n,
                       cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (dy == nullptr) {
    tree_pool_iz_lane_kernel<C, STEPS><<<blocks, kThreads, 0, stream>>>(x, out, n);
  } else {
    tree_pool_iz_lane_bwd_kernel<C, STEPS><<<blocks, kThreads, 0, stream>>>(x, dy, out, n);
  }
  return (int)cudaGetLastError();
}

template <int C>
int launch_lane(const float* x, const float* dy, float* out, long long n, int steps,
                cudaStream_t stream) {
  switch (steps) {
    case 0: return launch_lane_kernel<C, 0>(x, dy, out, n, stream);
    case 1: return launch_lane_kernel<C, 1>(x, dy, out, n, stream);
    case 2: return launch_lane_kernel<C, 2>(x, dy, out, n, stream);
    case 3: return launch_lane_kernel<C, 3>(x, dy, out, n, stream);
    case 4: return launch_lane_kernel<C, 4>(x, dy, out, n, stream);
    case 5: return launch_lane_kernel<C, 5>(x, dy, out, n, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The lane kernels for C in 1..kMaxLaneC: the forward when dy is null, else
// the backward into out = dx.
int launch_lanes(const float* x, const float* dy, float* out, int groups, int c, int steps,
                 cudaStream_t stream) {
  const long long n = (long long)groups << steps;
  switch (c) {
    case 1: return launch_lane<1>(x, dy, out, n, steps, stream);
    case 2: return launch_lane<2>(x, dy, out, n, steps, stream);
    case 3: return launch_lane<3>(x, dy, out, n, steps, stream);
    case 4: return launch_lane<4>(x, dy, out, n, steps, stream);
    case 5: return launch_lane<5>(x, dy, out, n, steps, stream);
    case 6: return launch_lane<6>(x, dy, out, n, steps, stream);
    case 7: return launch_lane<7>(x, dy, out, n, steps, stream);
    case 8: return launch_lane<8>(x, dy, out, n, steps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool takes_lanes(int c, int steps) { return c <= kMaxLaneC && steps <= kMaxLaneSteps; }

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
  if (takes_lanes(c, steps)) return launch_lanes(x, nullptr, out, groups, c, steps, s);
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
  if (takes_lanes(c, steps)) return launch_lanes(x, dy, dx, groups, c, steps, s);
  // past kMaxLaneSteps at C <= 8: the zero flags in local memory
  return c <= 8 ? launch_bwd<1, LocalFlags>(x, dy, dx, groups, c, steps, s)
                : launch_bwd<32>(x, dy, dx, groups, c, steps, s);
}

}  // extern "C"
