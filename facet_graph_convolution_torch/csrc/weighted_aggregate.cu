// K3: the rotation-invariant conv's assignment and slot sums, forward and
// backward.
//
// The forward replaces facet_graph_convolution_tpu/ops/pallas_kernels.py::
// _aggregate_kernel (launched by weighted_aggregate), z[n, m, c] =
// sum_k q[n, k, m] * x[n, k, c] with f32 sums, and takes in the
// softmax_M·mult that the JAX package computes before it
// (_facet_conv_nminor_rotinv, ops/conv.py:509-511): from the logits
// [S, N, M] (f32), the slots' multipliers rows [S, N] (f32) and the slots
// x [S, N, C] it computes q = softmax_M(logits) * rows in f32 and
// z [N, M * C], m-major (z[n, m * C + c], the column order the conv
// multiplies by W_flat). Fused, q never reaches device memory: unfused, q
// was written by the multiply, read by the cast (bf16) and read again by the
// slot sums, on top of the softmax's own pass over the logits. Operands are
// slot-major as the port's tables are (slot 0 the node's own row). The
// kernels are templates on the storage type of x, z, dz and dx: float32, or
// bfloat16 (the conv's compute_dtype="bfloat16"), whose loads are upcast. In
// bfloat16 q is rounded to bfloat16 before the sums, where the JAX conv and
// the unfused port round it, the sums stay f32 and z is rounded once (not a
// bf16 product a slot, as JAX's _aggregate_nminor rounds them).
//
// The backward replaces no Pallas kernel: XLA differentiates
// _aggregate_nminor (ops/conv.py:361-382) and the softmax before it. Per
// node, from the same inputs and dz [N, M * C]:
//   dq[s, m]      = sum_c dz[m, c] * x[s, c]                (kept on chip)
//   dlogits[s, m] = rows[s] * p[s, m] * (dq[s, m] - sum_m' p[s, m'] dq[s, m'])
// with p the softmax before rows, in f32, and, when asked for,
//   dx[s, c]      = sum_m dz[m, c] * q[s, m]
// in x's dtype, rounded once. rows get no gradient (they are tables).
//
// What bounds them on an H100: bytes. At the rotation-invariant conv1 of a
// training step (N = 25,600, S = 13, M = 9, C = 6) the forward reads 468 B of
// logits, 52 B of rows and 312 B of x and writes 216 B of z a node, 26.8 MB,
// 8.0 us at 3.35 TB/s; its ~54 M operations (the slot sums' multiply-adds
// and ~6 a softmax element) take 0.8 us at the f32 rate. The backward reads
// logits, rows, x and dz and writes dlogits, 1,516 B a node, 11.6 us (dx, when
// asked for, adds 312 B). In bfloat16 x, z and dz halve.
//
// Design (after K1's, csrc/facet_conv_fwd.cu): a block of 128 threads takes
// a tile of up to 16 nodes. It stages the tile's logits, rows and x, and in
// the backward dz, in shared memory as f32, each segment a slot contiguous in
// device memory (the operands are slot-major), loaded coalesced: f32 by
// cp.async, every copy of the tile in flight at once, bfloat16 by loads a
// few a thread in flight before their upcast stores; 16 bytes a copy or load
// where the segments are so aligned (at conv1 they are; 4 and 2 byte copies
// took ~1.4x and ~1.2x the time on an H100). Then a thread a (slot, node)
// pair takes the softmax (an M row of odd stride in shared memory, so that
// the pairs of a warp fall in different banks). In the forward a thread then
// owns a (node, m, chunk of 8 channels) run of z: S shared loads of q and x a
// slot, multiply-adds into registers; the tile's z goes through shared memory
// and out coalesced (its rows are contiguous in z). In the backward the
// pair's thread goes on to dq (its M·C multiply-adds from the staged dz and x
// row), the dot with p, dlogits (staged, then written coalesced a slot at a
// time) and q; dx is a thread a (slot, node, chunk). At the model's M = 9 and
// the rotation-invariant conv's C = 3, 4 or 6 the kernels are instantiated
// with both fixed, so that a pair's row, its dq and its x row stay in
// registers and the loops unroll (dynamic loops keep about one shared load
// in flight a thread); any other M and C run the same arithmetic through
// shared memory. Every output element belongs to one thread: no atomics,
// bitwise repeatable. The tile takes up to 48 KB of shared memory (16 nodes
// at conv1: 16.8 KB forward, 24.3 KB backward) and shrinks to fit wider
// rows, down to one node; a launch whose one-node tile passes 227 KB is
// refused (weighted_aggregate_smem -1). 16 nodes and 128 threads were the
// fastest of 8-32 nodes and 64-256 threads at conv1 on an H100, all within
// 10%.

#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

#include "storage.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 16;             // nodes a block, at most
constexpr int kSmemAim = 48 * 1024;   // a block's shared memory aimed for
constexpr int kSmemMax = 232448;      // the most a block can use (227 KB)
constexpr int kBatch = 8;             // loads a thread has in flight while staging
constexpr int kChunk = 8;             // channels a thread sums

// the row stride of the M-wide tiles: odd
__host__ __device__ __forceinline__ int m_stride(int m) { return m % 2 == 0 ? m + 1 : m; }

struct Plan {
  int tile;
  long long smem;   // bytes, -1 when a one-node tile does not fit
};

Plan plan(int slots, int m, int c, bool bwd) {
  const long long mp = m_stride(m);
  const long long floats = (long long)slots * ((bwd ? 2 : 1) * mp + 1 + c) + (long long)m * c;
  const long long per_node = floats * (long long)sizeof(float);
  long long tile = kSmemAim / per_node;
  tile = tile > kTile ? kTile : (tile < 1 ? 1 : tile);
  const long long smem = tile * per_node;
  return {(int)tile, smem > kSmemMax ? -1 : smem};
}

// v as the storage type holds it: itself in f32, rounded to bfloat16 in bf16
__device__ __forceinline__ float as_stored(float v, const float*) { return v; }
__device__ __forceinline__ float as_stored(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a 4-byte copy from device to shared memory that does not wait for the
// load (cp.async); cp_async_wait_all waits for the thread's copies
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Copies `slots` segments of `seg` values, segment s at src + s * src_stride,
// to shared memory at dst + s * dst_stride as f32. Value e of a segment lands
// at e + e / w when `pad` (rows of w values, each padded by one), else at e.
// f32 values go by cp.async, all of a thread's in flight at once (the
// caller waits for them), 16 bytes a copy where every segment's start is
// 16-byte aligned on both sides and no row is padded (conv1 of a node count
// that is a multiple of 4), else 4; bfloat16 ones are loaded several a
// thread before their upcast stores, 8 to a 16-byte load where aligned so.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int slots,
                                      size_t src_stride, int dst_stride, int seg, int w,
                                      bool pad) {
  if (seg <= 0) return;
  if (!pad && seg % 4 == 0 && src_stride % 4 == 0 && dst_stride % 4 == 0 &&
      (reinterpret_cast<size_t>(src) | reinterpret_cast<size_t>(dst)) % 16 == 0) {
    const int seg4 = seg / 4;
    const int ds = blockDim.x / seg4, de = blockDim.x - ds * seg4;
    for (int s = threadIdx.x / seg4, e = threadIdx.x % seg4; s < slots;) {
      cp_async16(dst + s * dst_stride + 4 * e, src + s * src_stride + 4 * e);
      s += ds;
      e += de;
      if (e >= seg4) {
        e -= seg4;
        ++s;
      }
    }
    return;
  }
  const int ds = blockDim.x / seg, de = blockDim.x - ds * seg;
  for (int s = threadIdx.x / seg, e = threadIdx.x % seg; s < slots;) {
    cp_async4(dst + s * dst_stride + e + (pad ? e / w : 0), src + s * src_stride + e);
    s += ds;
    e += de;
    if (e >= seg) {
      e -= seg;
      ++s;
    }
  }
}

__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* __restrict__ src,
                                      int slots, size_t src_stride, int dst_stride, int seg,
                                      int w, bool pad) {
  if (seg <= 0) return;
  if (!pad && seg % 8 == 0 && src_stride % 8 == 0 && dst_stride % 4 == 0 &&
      (reinterpret_cast<size_t>(src) | reinterpret_cast<size_t>(dst)) % 16 == 0) {
    // 16-byte loads of 8 values, kBatch / 2 of them a thread in flight
    constexpr int kVec = kBatch / 2;
    const int seg8 = seg / 8;
    const int ds = blockDim.x / seg8, de = blockDim.x - ds * seg8;
    int s = threadIdx.x / seg8, e = threadIdx.x - s * seg8;
    while (s < slots) {
      uint4 v[kVec];
      int at[kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        at[u] = -1;
        if (s < slots) {
          v[u] = __ldg(reinterpret_cast<const uint4*>(src + s * src_stride) + e);
          at[u] = s * dst_stride + 8 * e;
          s += ds;
          e += de;
          if (e >= seg8) {
            e -= seg8;
            ++s;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        if (at[u] < 0) continue;
        const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&v[u]);
        float4* d = reinterpret_cast<float4*>(dst + at[u]);
        d[0] = make_float4(__bfloat162float(b[0]), __bfloat162float(b[1]),
                           __bfloat162float(b[2]), __bfloat162float(b[3]));
        d[1] = make_float4(__bfloat162float(b[4]), __bfloat162float(b[5]),
                           __bfloat162float(b[6]), __bfloat162float(b[7]));
      }
    }
    return;
  }
  const int ds = blockDim.x / seg, de = blockDim.x - ds * seg;
  int s = threadIdx.x / seg, e = threadIdx.x - s * seg;
  while (s < slots) {
    float v[kBatch];
    int at[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      v[u] = 0.f;
      at[u] = -1;
      if (s < slots) {
        v[u] = load_f32(src + s * src_stride + e);
        at[u] = s * dst_stride + e + (pad ? e / w : 0);
        s += ds;
        e += de;
        if (e >= seg) {
          e -= seg;
          ++s;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (at[u] >= 0) dst[at[u]] = v[u];
    }
  }
}

// The softmax over M sums its exponentials in torch.softmax's order on the
// card (for a last dimension of at most 1024, aten/src/ATen/native/cuda/
// PersistentSoftmax.cuh softmax_warp_forward): W = min(2^ceil(log2 M), 32)
// lanes, lane l summing e[l], e[l + W], ... in turn, then a butterfly over
// the lanes. EXACT (bfloat16 storage) also takes its e = expf(x - max) and
// p = e / sum, so that p has torch's bits and q = p * rows rounds to
// bfloat16 as the plain version's does: a q one bfloat16 ulp apart moves a z
// near its largest magnitude across a rounding of z's, past the kernel
// checks' 2^-8 of max|plain| (the fast form below did, on an H100). In f32,
// checked at 1e-5, the hardware's __expf and a multiply by 1/sum. The sum
// is unrolled with no array (an array of partials went to local memory and
// cost ~40% of the kernels' time).
__host__ __device__ constexpr int lanes_of(int m) {
  int p = 1;
  while (p < m && p < 32) p *= 2;
  return p;
}

// The butterfly's sum of e[0, MM) over W lanes, unrolled at compile time
// with no array: lane L's value once the offsets W/2 .. D are added is
// at<L, D> = at<L, 2D> + at<L + D, 2D>, a lane's own partial at D = W. A
// lane past MM holds only zeros, and adding +0 to a sum of exponentials
// (>= +0) changes no bit, so those additions are left out.
template <int MM, int W, int L, int D>
struct Butterfly {
  static __device__ __forceinline__ float at(const float (&e)[MM]) {
    if constexpr (D >= W) {
      float a = e[L];
#pragma unroll
      for (int k = L + W; k < MM; k += W) a += e[k];
      return a;
    } else if constexpr (L + D < MM) {
      return Butterfly<MM, W, L, 2 * D>::at(e) + Butterfly<MM, W, L + D, 2 * D>::at(e);
    } else {
      return Butterfly<MM, W, L, 2 * D>::at(e);
    }
  }
};

template <bool EXACT>
__device__ __forceinline__ float softmax_exp(float x) {
  return EXACT ? expf(x) : __expf(x);
}

// p * mult from e and the sum
template <bool EXACT>
__device__ __forceinline__ float softmax_scale(float e, float sum, float mult) {
  return EXACT ? e / sum * mult : e * (mult / sum);
}

// softmax_M of the row in place, times mult, each value as the storage type
// of `tag` holds it (any M: the row in shared memory)
template <bool EXACT, typename T>
__device__ __forceinline__ void softmax_times(float* row, int m, float mult, const T* tag) {
  float mx = row[0];
  for (int k = 1; k < m; ++k) mx = fmaxf(mx, row[k]);
  for (int k = 0; k < m; ++k) row[k] = softmax_exp<EXACT>(row[k] - mx);
  const int w = lanes_of(m);
  float part[32];
#pragma unroll
  for (int l = 0; l < 32; ++l) {
    float a = 0.f;
    if (l < w) {
      for (int k = l; k < m; k += w) a += row[k];
    }
    part[l] = a;
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
#pragma unroll
    for (int l = 0; l < off; ++l) {
      if (off < w) part[l] += part[l + off];
    }
  }
  const float sum = part[0];
  for (int k = 0; k < m; ++k) row[k] = as_stored(softmax_scale<EXACT>(row[k], sum, mult), tag);
}

// the same in registers, M fixed: v <- softmax_M(v) * mult
template <bool EXACT, int MM>
__device__ __forceinline__ void softmax_regs(float (&v)[MM], float mult) {
  constexpr int kW = lanes_of(MM);
  float mx = v[0];
#pragma unroll
  for (int k = 1; k < MM; ++k) mx = fmaxf(mx, v[k]);
#pragma unroll
  for (int k = 0; k < MM; ++k) v[k] = softmax_exp<EXACT>(v[k] - mx);
  const float sum = Butterfly<MM, kW, 0, 1>::at(v);
#pragma unroll
  for (int k = 0; k < MM; ++k) v[k] = softmax_scale<EXACT>(v[k], sum, mult);
}

// MM, CC > 0: M and C fixed at compile time (the model's M = 9 at the 3, 4 or
// 6 input channels the rotation-invariant conv takes), each row of a (slot,
// node) pair in registers; 0: any M and C, rows walked in shared memory.
// Both do the same arithmetic in the same order.
template <typename S, int MM, int CC>
__global__ void __launch_bounds__(kThreads)
weighted_aggregate_kernel(const float* __restrict__ logits, const float* __restrict__ rows,
                          const S* __restrict__ x, S* __restrict__ z, int slots, int n,
                          int m_arg, int c_arg, int tile) {
  constexpr bool kFixed = MM > 0;
  constexpr bool kExact = std::is_same<S, __nv_bfloat16>::value;
  const int m = kFixed ? MM : m_arg, c = kFixed ? CC : c_arg;
  extern __shared__ float smem[];
  const int mp = m_stride(m), mc = m * c;
  float* q = smem;                        // [slots][tile][mp]: the logits, then q
  float* r = q + slots * tile * mp;       // [slots][tile]
  float* xs = r + slots * tile;           // [slots][tile][c]
  float* zs = xs + slots * tile * c;      // [tile][m * c]: z
  const int n0 = blockIdx.x * tile;
  const int tn = min(tile, n - n0);
  stage(q, logits + (size_t)n0 * m, slots, (size_t)n * m, tile * mp, tn * m, m, mp != m);
  stage(r, rows + n0, slots, (size_t)n, tile, tn, 1, false);
  stage(xs, x + (size_t)n0 * c, slots, (size_t)n * c, tile * c, tn * c, c, false);
  cp_async_wait_all();
  __syncthreads();

  // q = softmax_M(logits) * rows, a thread a (slot, node)
  for (int i = threadIdx.x; i < slots * tn; i += blockDim.x) {
    const int s = i / tn, t = i - s * tn;
    float* row = q + (s * tile + t) * mp;
    if constexpr (kFixed) {
      float v[MM];
#pragma unroll
      for (int k = 0; k < MM; ++k) v[k] = row[k];
      softmax_regs<kExact>(v, r[s * tile + t]);
#pragma unroll
      for (int k = 0; k < MM; ++k) row[k] = as_stored(v[k], x);
    } else {
      softmax_times<kExact>(row, m, r[s * tile + t], x);
    }
  }
  __syncthreads();

  // z into shared memory, a thread a (node, m, chunk of channels)
  if constexpr (kFixed) {
    for (int i = threadIdx.x; i < tn * MM; i += blockDim.x) {
      const int t = i / MM, k = i - t * MM;
      float acc[CC];
#pragma unroll
      for (int j = 0; j < CC; ++j) acc[j] = 0.f;
      for (int s = 0; s < slots; ++s) {
        const float qv = q[(s * tile + t) * mp + k];
        const float* xr = xs + (s * tile + t) * CC;
        float xv[CC];
        if constexpr (CC % 2 == 0) {  // 8-byte aligned rows: the tile offsets are even
#pragma unroll
          for (int j = 0; j < CC; j += 2) {
            const float2 v = *reinterpret_cast<const float2*>(xr + j);
            xv[j] = v.x;
            xv[j + 1] = v.y;
          }
        } else {
#pragma unroll
          for (int j = 0; j < CC; ++j) xv[j] = xr[j];
        }
#pragma unroll
        for (int j = 0; j < CC; ++j) acc[j] = fmaf(qv, xv[j], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < CC; ++j) zs[i * CC + j] = acc[j];
    }
  } else {
    const int chunks = (c + kChunk - 1) / kChunk;
    for (int i = threadIdx.x; i < tn * m * chunks; i += blockDim.x) {
      const int tk = i / chunks, chunk = i - tk * chunks;
      const int t = tk / m;
      const int c0 = chunk * kChunk;
      const int width = min(kChunk, c - c0);
      float acc[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) acc[j] = 0.f;
      for (int s = 0; s < slots; ++s) {
        const float qv = q[(s * tile + t) * mp + tk - t * m];
        const float* xr = xs + (s * tile + t) * c + c0;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (j < width) acc[j] = fmaf(qv, xr[j], acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < width) zs[tk * c + c0 + j] = acc[j];
      }
    }
  }
  __syncthreads();

  // the tile's z rows are contiguous in z: written coalesced
  S* out = z + (size_t)n0 * mc;
  for (int e = threadIdx.x; e < tn * mc; e += blockDim.x) store_f32(out + e, zs[e]);
}

template <typename S, int MM, int CC>
__global__ void __launch_bounds__(kThreads)
weighted_aggregate_bwd_kernel(const float* __restrict__ logits, const float* __restrict__ rows,
                              const S* __restrict__ x, const S* __restrict__ dz,
                              float* __restrict__ dlogits, S* __restrict__ dx, int slots, int n,
                              int m_arg, int c_arg, int tile) {
  constexpr bool kFixed = MM > 0;
  constexpr bool kExact = std::is_same<S, __nv_bfloat16>::value;
  const int m = kFixed ? MM : m_arg, c = kFixed ? CC : c_arg;
  extern __shared__ float smem[];
  const int mp = m_stride(m), mc = m * c;
  float* p = smem;                        // [slots][tile][mp]: the logits, p, then q
  float* d = p + slots * tile * mp;       // [slots][tile][mp]: dq, then dlogits
  float* r = d + slots * tile * mp;       // [slots][tile]
  float* xs = r + slots * tile;           // [slots][tile][c]
  float* g = xs + slots * tile * c;       // [tile][m * c]: dz
  const int n0 = blockIdx.x * tile;
  const int tn = min(tile, n - n0);
  stage(p, logits + (size_t)n0 * m, slots, (size_t)n * m, tile * mp, tn * m, m, mp != m);
  stage(r, rows + n0, slots, (size_t)n, tile, tn, 1, false);
  stage(xs, x + (size_t)n0 * c, slots, (size_t)n * c, tile * c, tn * c, c, false);
  stage(g, dz + (size_t)n0 * mc, 1, 0, 0, tn * mc, mc, false);
  cp_async_wait_all();
  __syncthreads();

  // a thread a (slot, node): p, dq and its dot with p, dlogits, then q
  for (int i = threadIdx.x; i < slots * tn; i += blockDim.x) {
    const int s = i / tn, t = i - s * tn;
    float* pr = p + (s * tile + t) * mp;
    float* dr = d + (s * tile + t) * mp;
    const float* xr = xs + (s * tile + t) * c;
    const float* gr = g + t * mc;
    const float mult = r[s * tile + t];
    if constexpr (kFixed) {
      float v[MM], xv[CC], dq[MM];
#pragma unroll
      for (int k = 0; k < MM; ++k) v[k] = pr[k];
#pragma unroll
      for (int j = 0; j < CC; ++j) xv[j] = xr[j];
      softmax_regs<kExact>(v, 1.f);
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < CC; ++j) acc = fmaf(gr[k * CC + j], xv[j], acc);
        dq[k] = acc;
        dot = fmaf(v[k], acc, dot);
      }
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        dr[k] = mult * v[k] * (dq[k] - dot);
        pr[k] = as_stored(v[k] * mult, x);
      }
    } else {
      softmax_times<kExact>(pr, m, 1.f, static_cast<const float*>(nullptr));
      float dot = 0.f;
      for (int k = 0; k < m; ++k) {
        float acc = 0.f;
        for (int j = 0; j < c; ++j) acc = fmaf(gr[k * c + j], xr[j], acc);
        dr[k] = acc;
        dot = fmaf(pr[k], acc, dot);
      }
      for (int k = 0; k < m; ++k) {
        dr[k] = mult * pr[k] * (dr[k] - dot);
        pr[k] = as_stored(pr[k] * mult, x);
      }
    }
  }
  __syncthreads();

  // dlogits, a slot's segment of the tile at a time, coalesced
  {
    const int seg = tn * m;
    const int ds = blockDim.x / seg, de = blockDim.x - ds * seg;
    int s = threadIdx.x / seg, e = threadIdx.x - s * seg;
    float* out = dlogits + (size_t)n0 * m;
    while (s < slots) {
      out[s * (size_t)n * m + e] = d[s * tile * mp + e + (mp != m ? e / m : 0)];
      s += ds;
      e += de;
      if (e >= seg) {
        e -= seg;
        ++s;
      }
    }
  }
  if (dx == nullptr) return;

  // dx, a thread a (slot, node, chunk of channels)
  const int chunks = (c + kChunk - 1) / kChunk;
  for (int i = threadIdx.x; i < slots * tn * chunks; i += blockDim.x) {
    const int st = i / chunks, chunk = i - st * chunks;
    const int s = st / tn, t = st - s * tn;
    const int c0 = chunk * kChunk;
    const int width = min(kChunk, c - c0);
    float acc[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) acc[j] = 0.f;
    const float* qr = p + (s * tile + t) * mp;
    const float* gr = g + t * mc + c0;
    for (int k = 0; k < m; ++k) {
      const float qv = qr[k];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < width) acc[j] = fmaf(gr[k * c + j], qv, acc[j]);
      }
    }
    S* out = dx + ((size_t)s * n + n0 + t) * c + c0;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < width) store_f32(out + j, acc[j]);
    }
  }
}

// raises the kernel's dynamic shared memory limit past 48 KB once (before a
// CUDA graph captures it: the path's first launch runs eagerly)
template <typename K>
cudaError_t allow_smem(K kernel, long long smem, long long* raised) {
  if (smem <= *raised) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *raised = smem;
  return err;
}

template <typename S, int MM, int CC>
int launch_fixed(const float* logits, const float* rows, const S* x, S* z, int slots, int n,
                 int m, int c, void* stream) {
  const Plan p = plan(slots, m, c, false);
  if (p.smem < 0) return (int)cudaErrorInvalidValue;
  static long long raised = 48 * 1024;
  const cudaError_t err = allow_smem(weighted_aggregate_kernel<S, MM, CC>, p.smem, &raised);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + p.tile - 1) / p.tile);
  weighted_aggregate_kernel<S, MM, CC><<<blocks, kThreads, (size_t)p.smem,
                                         (cudaStream_t)stream>>>(logits, rows, x, z, slots, n,
                                                                 m, c, p.tile);
  return (int)cudaGetLastError();
}

template <typename S, int MM, int CC>
int launch_bwd_fixed(const float* logits, const float* rows, const S* x, const S* dz,
                     float* dlogits, S* dx, int slots, int n, int m, int c, void* stream) {
  const Plan p = plan(slots, m, c, true);
  if (p.smem < 0) return (int)cudaErrorInvalidValue;
  static long long raised = 48 * 1024;
  const cudaError_t err = allow_smem(weighted_aggregate_bwd_kernel<S, MM, CC>, p.smem, &raised);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + p.tile - 1) / p.tile);
  weighted_aggregate_bwd_kernel<S, MM, CC><<<blocks, kThreads, (size_t)p.smem,
                                             (cudaStream_t)stream>>>(
      logits, rows, x, dz, dlogits, dx, slots, n, m, c, p.tile);
  return (int)cudaGetLastError();
}

template <typename S>
int launch(const float* logits, const float* rows, const S* x, S* z, int slots, int n, int m,
           int c, void* stream) {
  if (slots < 1 || n < 1 || m < 1 || c < 1) return (int)cudaErrorInvalidValue;
  if (m == 9 && c == 6) return launch_fixed<S, 9, 6>(logits, rows, x, z, slots, n, m, c, stream);
  if (m == 9 && c == 4) return launch_fixed<S, 9, 4>(logits, rows, x, z, slots, n, m, c, stream);
  if (m == 9 && c == 3) return launch_fixed<S, 9, 3>(logits, rows, x, z, slots, n, m, c, stream);
  return launch_fixed<S, 0, 0>(logits, rows, x, z, slots, n, m, c, stream);
}

template <typename S>
int launch_bwd(const float* logits, const float* rows, const S* x, const S* dz, float* dlogits,
               S* dx, int slots, int n, int m, int c, void* stream) {
  if (slots < 1 || n < 1 || m < 1 || c < 1) return (int)cudaErrorInvalidValue;
  if (m == 9 && c == 6)
    return launch_bwd_fixed<S, 9, 6>(logits, rows, x, dz, dlogits, dx, slots, n, m, c, stream);
  if (m == 9 && c == 4)
    return launch_bwd_fixed<S, 9, 4>(logits, rows, x, dz, dlogits, dx, slots, n, m, c, stream);
  if (m == 9 && c == 3)
    return launch_bwd_fixed<S, 9, 3>(logits, rows, x, dz, dlogits, dx, slots, n, m, c, stream);
  return launch_bwd_fixed<S, 0, 0>(logits, rows, x, dz, dlogits, dx, slots, n, m, c, stream);
}

}  // namespace

extern "C" {

// The shared memory bytes of a launch's block at these sizes (forward, or
// the backward when bwd != 0), -1 when a one-node tile passes 227 KB (the
// launch is refused).
int weighted_aggregate_smem(int slots, int m, int c, int bwd) {
  if (slots < 1 || m < 1 || c < 1) return -1;
  return (int)plan(slots, m, c, bwd != 0).smem;
}

// logits [slots, n, m] f32, rows [slots, n] f32, x [slots, n, c] -> z [n, m * c],
// contiguous, on the current device; slots, n, m, c >= 1 and a tile that fits
// (weighted_aggregate_smem >= 0). Launches on `stream` and returns
// cudaGetLastError() after the launch (0 when it was accepted).
int weighted_aggregate_f32(const float* logits, const float* rows, const float* x, float* z,
                           int slots, int n, int m, int c, void* stream) {
  return launch(logits, rows, x, z, slots, n, m, c, stream);
}

// The same with x and z bfloat16: q rounded to bfloat16, the sums f32, z
// rounded once.
int weighted_aggregate_bf16(const float* logits, const float* rows, const __nv_bfloat16* x,
                            __nv_bfloat16* z, int slots, int n, int m, int c, void* stream) {
  return launch(logits, rows, x, z, slots, n, m, c, stream);
}

// The backward: dz [n, m * c] in x's dtype -> dlogits [slots, n, m] f32 and,
// unless dx is null, dx [slots, n, c] in x's dtype.
int weighted_aggregate_bwd_f32(const float* logits, const float* rows, const float* x,
                               const float* dz, float* dlogits, float* dx, int slots, int n,
                               int m, int c, void* stream) {
  return launch_bwd(logits, rows, x, dz, dlogits, dx, slots, n, m, c, stream);
}

int weighted_aggregate_bwd_bf16(const float* logits, const float* rows, const __nv_bfloat16* x,
                                const __nv_bfloat16* dz, float* dlogits, __nv_bfloat16* dx,
                                int slots, int n, int m, int c, void* stream) {
  return launch_bwd(logits, rows, x, dz, dlogits, dx, slots, n, m, c, stream);
}

}  // extern "C"
