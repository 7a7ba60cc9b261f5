// A thread-block-cluster design of the naive solver's scale adjoint, kept
// for measurement only (tools/adjoint_cluster_probe.py builds and times it
// against the port's kernel, csrc/ms_solver_naive_bwd.cu, which it
// measured slower than). The same mathematics, phases and teams as that
// kernel, so the same bits; only where the rows live and how the CTAs wait
// for each other differ:
//
// * one cluster of up to 16 CTAs of 1024 threads (cudaLaunchKernelEx with a
//   cluster dimension; 16 is a non-portable size). CTA r owns a contiguous
//   range of vertices (v_chunk of them) and of level-s nodes (n_chunk) with
//   their fine leaves, and keeps their mutable rows in its shared memory: gx
//   and g_leaf as 16-byte rows, one load each (gx's fourth float is lmbd_v),
//   and gfn. A phase reads another CTA's gx or g_leaf rows through
//   distributed shared memory (map_shared_rank); the read-only tables stay
//   in L1/L2 through __ldg, but for each own vertex's v_faces row length up
//   to its last real slot, counted once;
// * the iterate xs[i], read at random by R-A (three corners a leaf, a
//   vertex a slot), is held whole in every CTA: each CTA fetches xs[i - 1]
//   with one bulk asynchronous copy (cp.async.bulk on an mbarrier) while R-B
//   of iteration i runs, which does not read it. R-A loads its slots' rows
//   two at a time;
// * barriers are cluster.sync(), two an iteration; the second is also the
//   last one before exit, so that no CTA leaves while another may still
//   read its shared memory.
//
// Only for shift <= 5 (one leaf a lane) and an xs on a 16-byte boundary.
// Built with the port's flags and -I to its csrc/ (ms_solver_naive.cuh).

#include <stdint.h>

#include "ms_solver_naive.cuh"

namespace {

constexpr int kMaxClusterCtas = 16;
constexpr int kSlotBatch = 2;  // R-A's slots a lane loads at once

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1])),
                   __fmul_rn(a[2], b[2]));
}

// The cotangent share of a pooled row from its parent's (the port's kernel's
// pool_share).
__device__ __forceinline__ void pool_share(bool z, bool zo, float g[3]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    g[ch] = z ? (zo ? __fmul_rn(g[ch], 0.5f) : 0.f) : (zo ? g[ch] : __fmul_rn(g[ch], 0.5f));
  }
}

// The rows of one CTA. Vertex v is CTA v / v_chunk's, at v % v_chunk; node
// f is CTA f / n_chunk's, and so are its leaves; the rows sit at the same
// offsets in every CTA.
struct ClusterRows {
  const float* xi;  // this iteration's xs[i] in this CTA's shared memory
  float4* gx_;
  float* gfn_;
  float4* leaf_;
  const int* len_;
  int me, v_chunk, n_chunk, shift, v_lo, n_lo;
  float v_inv, n_inv;  // 1 / v_chunk, 1 / n_chunk
  double k_inv;        // 1 / K

  // slot / k for slot < 2^31: the double quotient, then corrected by one
  __device__ int slot_vertex(int slot, int k) const {
    long long q = (long long)((double)slot * k_inv);
    q -= q * k > slot;
    q += (q + 1) * k <= slot;
    return (int)q;
  }
  // i / chunk for i < 2^24: the float quotient, then corrected by one
  __device__ static int owner(int i, int chunk, float inv) {
    int r = __float2int_rz(__fmul_rn((float)i, inv));
    r -= r * chunk > i;
    r += (r + 1) * chunk <= i;
    return r;
  }
  __device__ float4 remote(float4* local, int rank) const {
    return rank == me ? *local : *cg::this_cluster().map_shared_rank(local, rank);
  }
  __device__ void x(int v, float o[3]) const {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) o[ch] = xi[3 * v + ch];
  }
  // g of vertex v; returns lmbd_v
  __device__ float gx(int v, float o[3]) const {
    const int r = owner(v, v_chunk, v_inv);
    const float4 g = remote(gx_ + (v - r * v_chunk), r);
    o[0] = g.x, o[1] = g.y, o[2] = g.z;
    return g.w;
  }
  __device__ void leaf(int face, float o[3]) const {
    const int r = owner(face >> shift, n_chunk, n_inv);
    const float4 g = remote(leaf_ + (face - ((r * n_chunk) << shift)), r);
    o[0] = g.x, o[1] = g.y, o[2] = g.z;
  }
};

// Centroid of fine face `face` from the iterate in shared memory, in
// leaf_center's float operations and order; a -1 corner reads a zero vertex.
__device__ __forceinline__ void leaf_center_smem(const ClusterRows& rows,
                                                 const int* __restrict__ faces, int face,
                                                 float c[3]) {
  const int* corners = faces + (size_t)face * 3;
  float s[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int vid = __ldg(corners + j);
    float v[3] = {0.f, 0.f, 0.f};
    if (vid >= 0) rows.x(vid, v);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) s[ch] = j == 0 ? v[ch] : __fadd_rn(s[ch], v[ch]);
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) c[ch] = __fdiv_rn(s[ch], 3.f);
}

// Phase R-A over the CTA's level-s nodes [node_lo, node_hi), by warp, with
// the scale kernel's teams. The loop bounds are warp-uniform: every lane
// reaches the shuffles.
__device__ __forceinline__ void adjoint_a(const ClusterRows& rows, const int* __restrict__ faces,
                                          const float* __restrict__ fn,
                                          const int* __restrict__ slot_off,
                                          const int* __restrict__ slot_ids, int node_lo,
                                          int node_hi, int warp, int warps, int k, int shift) {
  const int lane = threadIdx.x & 31;
  const int team = 1 << shift;        // lanes a node (shift <= 5)
  const int per_warp = 32 / team;     // nodes a warp
  const int sub = lane & (team - 1);
  const int tasks = (node_hi - node_lo + per_warp - 1) / per_warp;
  for (int task = warp; task < tasks; task += warps) {
    const int f = node_lo + task * per_warp + lane / team;
    const bool live = f < node_hi;  // team-uniform
    const int first = (f << shift) + sub;
    float c[3] = {0.f, 0.f, 0.f};
    if (live) leaf_center_smem(rows, faces, first, c);
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
      // lane sub walks slots sub, sub + team, ..., kSlotBatch at once: their
      // indices, then their rows, then the sums in the walk's order
      const int end = __ldg(slot_off + f + 1);
      for (int base = __ldg(slot_off + f) + sub; base < end; base += team * kSlotBatch) {
        int vs[kSlotBatch];
#pragma unroll
        for (int u = 0; u < kSlotBatch; ++u) {
          const int j = base + u * team;
          vs[u] = j < end ? rows.slot_vertex(__ldg(slot_ids + j), k) : -1;
        }
        float g[kSlotBatch][3], xv[kSlotBatch][3], lam[kSlotBatch];
#pragma unroll
        for (int u = 0; u < kSlotBatch; ++u) {
          if (vs[u] < 0) continue;
          lam[u] = rows.gx(vs[u], g[u]);
          rows.x(vs[u], xv[u]);
        }
#pragma unroll
        for (int u = 0; u < kSlotBatch; ++u) {
          if (vs[u] < 0) continue;
          const float a = __fmul_rn(lam[u], dot3(n, g[u]));
          const float w = __fmul_rn(lam[u], __fsub_rn(t, dot3(n, xv[u])));
          gt = __fadd_rn(gt, a);
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            gn[ch] = __fadd_rn(gn[ch],
                               __fsub_rn(__fmul_rn(w, g[u][ch]), __fmul_rn(a, xv[u][ch])));
          }
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
      float* row = rows.gfn_ + (f - rows.n_lo) * 3;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        row[ch] = __fadd_rn(row[ch], __fadd_rn(__fmul_rn(gt, c[ch]), gn[ch]));
      }
    }
    float g[3] = {__fmul_rn(gt, n[0]), __fmul_rn(gt, n[1]), __fmul_rn(gt, n[2])};
    for (int r = rounds - 1; r >= 0; --r) pool_share((own >> r) & 1u, (other >> r) & 1u, g);
    rows.leaf_[first - (rows.n_lo << shift)] = make_float4(
        __fdiv_rn(g[0], 3.f), __fdiv_rn(g[1], 3.f), __fdiv_rn(g[2], 3.f), 0.f);
  }
}

// Phase R-B over the CTA's vertices [v_lo, v_hi), by warp: a team of
// kVertexTeam lanes a vertex; lane i walks slots i, i + kVertexTeam, ... and
// corners likewise; the team sums by shuffles and its first lane writes
// gx_v. The loop bounds are warp-uniform.
__device__ __forceinline__ void adjoint_b(const ClusterRows& rows,
                                          const int* __restrict__ v_faces,
                                          const float* __restrict__ fn,
                                          const int* __restrict__ corner_off,
                                          const int* __restrict__ corner_ids, int v_lo, int v_hi,
                                          int warp, int warps, int k, int shift) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kVertexTeam - 1);
  constexpr int per_warp = 32 / kVertexTeam;
  const int tasks = (v_hi - v_lo + per_warp - 1) / per_warp;
  for (int task = warp; task < tasks; task += warps) {
    const int v = v_lo + task * per_warp + lane / kVertexTeam;
    const bool live = v < v_hi;  // team-uniform
    float g[3] = {0.f, 0.f, 0.f};
    float acc[3] = {0.f, 0.f, 0.f};
    float leaf[3] = {0.f, 0.f, 0.f};
    float lam = 0.f;
    if (live) {
      const float4 own = rows.gx_[v - v_lo];
      g[0] = own.x, g[1] = own.y, g[2] = own.z, lam = own.w;
      const int* row = v_faces + (size_t)v * k;
      const int len = rows.len_[v - v_lo];
      for (int j = sub; j < len; j += kVertexTeam) {
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
        float l[3];
        rows.leaf(__ldg(corner_ids + j), l);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) leaf[ch] = __fadd_rn(leaf[ch], l[ch]);
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
      float out[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) out[ch] = __fadd_rn(__fsub_rn(g[ch], acc[ch]), leaf[ch]);
      rows.gx_[v - v_lo] = make_float4(out[0], out[1], out[2], lam);
    }
  }
}

// Shared memory, in bytes from its start: the mbarrier, the iterate (the
// whole of xs[i] from the 16-byte boundary at or before it, with room for a
// 3-float head and the copy's rounding), then the CTA's rows: gx and g_leaf
// as 16-byte rows, gfn as 12-byte ones, a row length a vertex.
struct ClusterLayout {
  long long x, gx, leaf, gfn, len, bytes;
};

__host__ __device__ inline ClusterLayout cluster_layout(int num_vertices, int v_chunk,
                                                        int n_chunk, int shift) {
  ClusterLayout l;
  l.x = 16;
  l.gx = l.x + (12LL * num_vertices + 12 + 15) / 16 * 16;
  l.leaf = l.gx + 16LL * v_chunk;
  l.gfn = l.leaf + (16LL * n_chunk << shift);
  l.len = l.gfn + 12LL * n_chunk;
  l.bytes = l.len + 4LL * v_chunk;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ bool mbarrier_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__global__ void __launch_bounds__(kThreads)
ms_solver_adjoint_cluster_kernel(const float* __restrict__ xs, const int* __restrict__ faces,
                                 const int* __restrict__ v_faces, const float* __restrict__ fn,
                                 const float* __restrict__ lmbd,
                                 const int* __restrict__ slot_off,
                                 const int* __restrict__ slot_ids,
                                 const int* __restrict__ corner_off,
                                 const int* __restrict__ corner_ids, float* gx, float* gfn,
                                 int num_vertices, int k, int nodes, int shift, int iters,
                                 int v_chunk, int n_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int me = (int)cluster.block_rank();
  const ClusterLayout lay = cluster_layout(num_vertices, v_chunk, n_chunk, shift);
  float* x_s = reinterpret_cast<float*>(smem + lay.x);
  float4* gx_s = reinterpret_cast<float4*>(smem + lay.gx);
  float4* leaf_s = reinterpret_cast<float4*>(smem + lay.leaf);
  float* gfn_s = reinterpret_cast<float*>(smem + lay.gfn);
  int* len_s = reinterpret_cast<int*>(smem + lay.len);
  const uint32_t bar = smem_addr(smem);
  const int v_lo = me * v_chunk, n_lo = me * n_chunk;
  const int v_cnt = max(0, min(v_chunk, num_vertices - v_lo));
  const int n_cnt = max(0, min(n_chunk, nodes - n_lo));

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // The whole of xs[it] into x_s, from the 16-byte boundary at or before it
  // (xs is 16-byte aligned, so its head is at most 3 floats, and the
  // rounded end stays inside xs, which holds xs[it + 1] after it).
  auto head = [&](int it) { return (int)(((long long)it * num_vertices * 3) & 3); };
  auto fetch = [&](int it) {
    if (threadIdx.x != 0) return;
    const long long start = (long long)it * num_vertices * 3;
    const uint32_t bytes = (uint32_t)((4 * (head(it) + 3LL * num_vertices) + 15) / 16 * 16);
    // x_s was last read through the generic proxy, before a barrier
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(x_s)), "l"(xs + start - head(it)), "r"(bytes), "r"(bar)
        : "memory");
  };
  uint32_t parity = 0u;
  auto await = [&]() {
    while (!mbarrier_try_wait(bar, parity)) {
    }
    parity ^= 1u;
  };

  fetch(iters - 1);
  for (int i = threadIdx.x; i < v_cnt; i += kThreads) {
    const float* g = gx + 3LL * (v_lo + i);
    gx_s[i] = make_float4(g[0], g[1], g[2], __ldg(lmbd + v_lo + i));
    const int* row = v_faces + (size_t)(v_lo + i) * k;
    int len = k;
    while (len > 0 && __ldg(row + len - 1) < 0) --len;
    len_s[i] = len;
  }
  for (int i = threadIdx.x; i < 3 * n_cnt; i += kThreads) gfn_s[i] = gfn[3LL * n_lo + i];
  await();
  cluster.sync();  // every CTA started, its rows and the first iterate in place

  const int warp = (int)(threadIdx.x >> 5);
  constexpr int warps = kThreads / 32;
  for (int it = iters - 1; it >= 0; --it) {
    const ClusterRows rows{x_s + head(it), gx_s, gfn_s, leaf_s, len_s, me, v_chunk, n_chunk,
                           shift, v_lo, n_lo, 1.f / (float)v_chunk, 1.f / (float)n_chunk,
                           1.0 / (double)k};
    adjoint_a(rows, faces, fn, slot_off, slot_ids, n_lo, n_lo + n_cnt, warp, warps, k, shift);
    cluster.sync();
    if (it > 0) fetch(it - 1);  // x_s is free: this CTA's R-A is done
    adjoint_b(rows, v_faces, fn, corner_off, corner_ids, v_lo, v_lo + v_cnt, warp, warps, k,
              shift);
    if (it > 0) await();
    // R-B -> the next R-A; after the last iteration, no CTA may leave while
    // another still reads its g_leaf
    cluster.sync();
  }
  for (int i = threadIdx.x; i < v_cnt; i += kThreads) {
    const float4 g = gx_s[i];
    float* out = gx + 3LL * (v_lo + i);
    out[0] = g.x, out[1] = g.y, out[2] = g.z;
  }
  for (int i = threadIdx.x; i < 3 * n_cnt; i += kThreads) gfn[3LL * n_lo + i] = gfn_s[i];
}

// `count` barriers and nothing else: cluster.sync() in one cluster, or
// grid.sync() in a cooperative grid.
__global__ void __launch_bounds__(kThreads) cluster_barrier_probe_kernel(int count) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < count; ++i) cluster.sync();
}

__global__ void __launch_bounds__(kThreads) grid_barrier_probe_kernel(int count) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < count; ++i) grid.sync();
}

// The launch configuration of one cluster of `ctas` CTAs.
struct ClusterLaunch {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int ctas, size_t smem, cudaStream_t stream) : config{}, attr{} {
    config.gridDim = dim3((unsigned)ctas);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
  }
};

cudaError_t allow_cluster(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(ms_solver_adjoint_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(ms_solver_adjoint_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

// The launch's own error, else the last one it left (which this clears).
int launch_result(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

// Shared memory a CTA needs for these owner ranges.
long long adjoint_cluster_smem(int num_vertices, int v_chunk, int n_chunk, int shift) {
  return cluster_layout(num_vertices, v_chunk, n_chunk, shift).bytes;
}

// How many clusters of `ctas` CTAs with `smem` bytes each the current
// device can hold at once (0: none can be scheduled), or minus a
// cudaError_t; an error pending from before is returned untouched. Sets the
// kernel's attributes its launch needs.
int adjoint_cluster_max_clusters(int ctas, long long smem) {
  if (ctas < 1 || ctas > kMaxClusterCtas || smem < 0) return -(int)cudaErrorInvalidValue;
  const cudaError_t pending = cudaPeekAtLastError();
  if (pending != cudaSuccess) return -(int)pending;
  cudaError_t err = allow_cluster((size_t)smem);
  const ClusterLaunch launch(ctas, (size_t)smem, nullptr);
  int clusters = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(&clusters, ms_solver_adjoint_cluster_kernel,
                                         &launch.config);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // the refused call's own error, not an earlier one
    return -(int)err;
  }
  return clusters;
}

// One scale's adjoint, as the port's ms_solver_adjoint_f32 (gx in place,
// gfn added to), in one cluster of `ctas` CTAs on `stream`, CTA r owning
// vertices [r v_chunk, (r + 1) v_chunk) and nodes [r n_chunk, (r + 1)
// n_chunk) (clipped), with `smem` bytes of shared memory each
// (adjoint_cluster_smem's). xs must be 16-byte aligned and shift at most 5.
// Returns the launch's cudaError_t.
int adjoint_cluster_f32(const float* xs, const int* faces, const int* v_faces, const float* fn,
                        const float* lmbd, const int* slot_off, const int* slot_ids,
                        const int* corner_off, const int* corner_ids, float* gx, float* gfn,
                        int num_vertices, int k, int nodes, int shift, int iters, int ctas,
                        int v_chunk, int n_chunk, long long smem, void* stream) {
  if (num_vertices < 1 || k < 1 || nodes < 0 || shift < 0 || shift > 5 || iters < 1 ||
      ctas < 1 || ctas > kMaxClusterCtas || v_chunk < 1 || n_chunk < 1 ||
      (long long)v_chunk * ctas < num_vertices || (long long)n_chunk * ctas < nodes ||
      num_vertices >= (1 << 24) || nodes >= (1 << 24) ||
      smem != cluster_layout(num_vertices, v_chunk, n_chunk, shift).bytes ||
      reinterpret_cast<uintptr_t>(xs) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_cluster((size_t)smem);
  if (err == cudaSuccess) {
    const ClusterLaunch launch(ctas, (size_t)smem, (cudaStream_t)stream);
    err = cudaLaunchKernelEx(&launch.config, ms_solver_adjoint_cluster_kernel, xs, faces,
                             v_faces, fn, lmbd, slot_off, slot_ids, corner_off, corner_ids, gx,
                             gfn, num_vertices, k, nodes, shift, iters, v_chunk, n_chunk);
  }
  return launch_result(err);
}

// `count` barriers alone: with `cluster`, in one cluster of `blocks` CTAs
// of 1024 threads; else in a cooperative grid of `blocks` blocks. Returns
// the launch's cudaError_t.
int adjoint_barrier_probe(int cluster, int blocks, int count, void* stream) {
  if (blocks < 1 || count < 0 || (cluster && blocks > kMaxClusterCtas))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (cluster) {
    err = cudaFuncSetAttribute(cluster_barrier_probe_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) {
      const ClusterLaunch launch(blocks, 0, (cudaStream_t)stream);
      err = cudaLaunchKernelEx(&launch.config, cluster_barrier_probe_kernel, count);
    }
  } else {
    void* args[] = {&count};
    err = cudaLaunchCooperativeKernel((const void*)grid_barrier_probe_kernel,
                                      dim3((unsigned)blocks), dim3(kThreads), args, 0,
                                      (cudaStream_t)stream);
  }
  return launch_result(err);
}

}  // extern "C"
