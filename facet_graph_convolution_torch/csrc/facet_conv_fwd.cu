// Facet-conv forward epilogue with the neighbour gather fused in (K1).
//
// Replaces facet_graph_convolution_tpu/ops/pallas_conv.py::_epilogue_fwd_kernel
// (launched by _conv_epilogue_fwd). For node i and slot k = 0..K' (slot 0 is
// the node itself, slot k > 0 is j = adj_sm[k-1, i] - 1, and index 0 a pad):
//
//   logits[m]      = ux[i, m] + cat[j, C + m] + c[m]
//   q[m]           = softmax_M(logits)[m] * mult_rows[k, i]
//   z[i, m*C + ch] = sum_k q[m] * cat[j, ch]          (f32 accumulation)
//
// The kernel is a template on the storage type of cat, ux and z: float32, or
// bfloat16 (compute_dtype="bfloat16", as _conv_epilogue_fwd runs it there):
// each load is upcast, the softmax and the slot sums are f32, and z is
// rounded to bfloat16 once, when it is written. mult_rows and c are f32 in
// both, and so are the q tile and the staged z rows in shared memory, so
// the shared-memory limits (facet_conv_fwd_max_m) hold for both.
//
// The TPU kernel reads a [K', N, C+M] tensor gathered beforehand by XLA,
// because Mosaic cannot lower a dynamic gather. Here the block loads its
// nodes' neighbour rows of cat = [x | v.x] itself, so that tensor is never
// written.
//
// What bounds it on an H100: memory. z is M*C floats a node against C+M floats
// of input, so writing z dominates (57 MB of ~64 MB moved at N = 24,576,
// C = 64, M = 9: ~19 us at 3.35 TB/s), while the arithmetic, M*C FMAs per
// slot over ~13 slots, needs ~6 us at the 67 TFLOP/s f32 rate. cat (<= 13 MB
// on the path) fits the 50 MB L2, so the gathered rows are mostly L2 hits.
// In bfloat16 every byte of cat, ux and z halves (~32 MB at that conv).
//
// Design: a block takes NB consecutive nodes and works in two phases, with
// one barrier between them.
//  1. slots: a thread a slot (k-major, so a warp reads one row of adj_sm and
//     mult_rows coalesced) keeps j, or -1 for a dead slot (mult 0, a pad, or
//     an index outside [1, N]), in shared memory; for a live slot it loads
//     the M logit inputs and computes the softmax in the thread (max, exp,
//     sum: no shuffles), leaving q = softmax * mult in its row of the block's
//     q tile [NB * (K'+1)][MP] in shared memory (MP: M rounded up to 4).
//  2. aggregation: a team of TPN threads a node and M-group of MG filters;
//     a thread owns CB channels (ch = tl + TPN * b) and MG x CB accumulators.
//     It walks the node's slots in order, eight at a time: the eight rows'
//     loads (coalesced over the team) are issued before the FMAs, and q
//     comes from the tile as float4 broadcasts. z is written coalesced per
//     m; at C <= 16 the block's z rows (one contiguous range) are staged in
//     shared memory and written as float4.
// Measured (PERF.md, tools/k1_phase_probe.py): the kernel is bound by the
// latency of its dependent loads (table, logits, rows) at ~32 resident warps
// an SM, not by bytes. Splitting the slot phase in three (table; logits a
// thread an (slot, m) pair; softmax), with a barrier between each, took 15%
// longer; so did loading phase 2's first rows before the softmax (registers
// held across it) and walking consecutive groups in one block. The earlier
// design, a warp a node with each slot's softmax by warp shuffles and one
// row in flight, took 40% longer and left 26 of 32 lanes idle at C = 6.
// Slots are summed in a fixed order, with no atomics: the kernel is bitwise
// repeatable. Any M runs whose tile fits shared memory
// (facet_conv_fwd_max_m); a conv wider than 1024 channels (256 threads of 4)
// runs as channel chunks in the wrapper (ops/facet_conv_kernel.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "storage.cuh"

namespace {

constexpr int kThreads = 256;          // a block's threads
constexpr int kMaxC = 4 * kThreads;    // one launch's channels: a team of <= 256 x 4
constexpr int kSmemBudget = 96 * 1024; // a block's shared memory while NB > 1
constexpr int kSmemMax = 232448;       // the most a block can use (227 KB)
constexpr int kStageC = 16;            // z rows staged in shared memory at C <= 16
constexpr int kInFlight = 8;           // phase D: a node's slots whose rows load at once

int round_up(int v, int to) { return (v + to - 1) / to * to; }

// The shared memory of a block of nb nodes, in floats: the q tile (and 16
// floats that an M-group's last float4 may read past it), then j of each
// slot, then the staged z rows.
size_t smem_floats(int nb, int ks, int m, int c_in) {
  const size_t slots = (size_t)nb * ks;
  return slots * round_up(m, 4) + 16 + (size_t)round_up((int)slots, 4) +
         (c_in <= kStageC ? (size_t)nb * m * c_in : 0);
}

template <typename S, int CB, int MG>
__global__ void __launch_bounds__(kThreads)
facet_conv_fwd_kernel(const S* __restrict__ cat, const S* __restrict__ ux,
                      const int* __restrict__ adj_sm,
                      const float* __restrict__ mult_rows,
                      const float* __restrict__ cvec, S* __restrict__ z,
                      int n, int k_nbr, int c_in, int m_rt, int nb, int tpn, int groups) {
  // MG = 9, the model's filter count, is instantiated for M = 9 alone, so
  // that every division by M is by a constant
  const int m = MG == 9 ? 9 : m_rt;
  const int mp = (m + 3) & ~3;
  const int ks = k_nbr + 1;
  const int slots = ks * nb;            // slot s = k * nb + node_l
  const int slots4 = (slots + 3) & ~3;
  const int P = blockDim.x, tid = threadIdx.x;
  const int i0 = blockIdx.x * nb;
  const int nv = min(nb, n - i0);       // the block's nodes below N
  const int width = c_in + m;
  extern __shared__ __align__(16) float smem[];
  float* q = smem;                                            // [slots][mp]
  int* sj = reinterpret_cast<int*>(q + (size_t)slots * mp + 16);
  float* st = reinterpret_cast<float*>(sj + slots4);          // [nb][m * c_in]

  // 1. slots: a thread a slot, j (or -1 for a dead slot), then for a live
  // slot its logits, softmax and mult into its row of the q tile
  for (int s = tid; s < slots; s += P) {
    const int k = s / nb, nl = s - k * nb;
    const int i = i0 + nl;
    float w = 0.f;
    int j = -1;
    if (nl < nv) {
      w = __ldg(mult_rows + (size_t)k * n + i);
      j = k == 0 ? i : __ldg(adj_sm + (size_t)(k - 1) * n + i) - 1;
    }
    const bool live = w != 0.f && (unsigned)j < (unsigned)n;
    sj[s] = live ? j : -1;
    if (!live) continue;
    float* row = q + s * mp;
    const S* v = cat + (size_t)j * width + c_in;
    const S* u = ux + (size_t)i * m;
    float mx = -INFINITY;
    for (int a = 0; a < m; ++a) {
      const float l = load_f32(u + a) + load_f32(v + a) + __ldg(cvec + a);
      row[a] = l;
      mx = fmaxf(mx, l);
    }
    float sum = 0.f;
    for (int a = 0; a < m; ++a) {
      const float e = expf(row[a] - mx);
      row[a] = e;
      sum += e;
    }
    for (int a = 0; a < m; ++a) row[a] = row[a] / sum * w;
  }
  __syncthreads();

  // 2. aggregation: item = (node, M-group, team lane)
  const bool stage = c_in <= kStageC;
  const int items = nb * groups * tpn;
  for (int it = tid; it < items; it += P) {
    const int tl = it % tpn, r = it / tpn;
    const int g = r % groups, nl = r / groups;
    if (nl >= nv) continue;
    const int m0 = g * MG;
    float acc[MG][CB];
#pragma unroll
    for (int a = 0; a < MG; ++a)
#pragma unroll
      for (int b = 0; b < CB; ++b) acc[a][b] = 0.f;
    for (int k0 = 0; k0 < ks; k0 += kInFlight) {
      int js[kInFlight];
      float x[kInFlight][CB];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        js[u] = k0 + u < ks ? sj[(k0 + u) * nb + nl] : -1;
        const S* xrow = cat + (size_t)(js[u] >= 0 ? js[u] : 0) * width;
#pragma unroll
        for (int b = 0; b < CB; ++b) {
          const int ch = tl + tpn * b;
          x[u][b] = js[u] >= 0 && ch < c_in ? load_f32(xrow + ch) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (js[u] < 0) continue;
        const float* qr = q + ((k0 + u) * nb + nl) * mp + m0;
#pragma unroll
        for (int a4 = 0; a4 < MG; a4 += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + a4);
          const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (a4 + e >= MG) break;
#pragma unroll
            for (int b = 0; b < CB; ++b) acc[a4 + e][b] = fmaf(qa[e], x[u][b], acc[a4 + e][b]);
          }
        }
      }
    }
    const int mg = min(MG, m - m0);
    float* so = st + (size_t)nl * m * c_in;            // staged: shared memory, f32
    S* zo = z + ((size_t)i0 + nl) * m * c_in;          // else z itself
#pragma unroll
    for (int a = 0; a < MG; ++a) {
      if (a >= mg) break;
#pragma unroll
      for (int b = 0; b < CB; ++b) {
        const int ch = tl + tpn * b;
        if (ch >= c_in) continue;
        if (stage) so[(m0 + a) * c_in + ch] = acc[a][b];
        else store_f32(zo + (m0 + a) * c_in + ch, acc[a][b]);
      }
    }
  }
  if (!stage) return;
  __syncthreads();
  // the block's z rows are one contiguous range of nv * M * C values, written
  // 4 at a time where 4-value aligned (16 bytes in f32, 8 in bfloat16)
  const int total = nv * m * c_in;
  S* dst = z + (size_t)i0 * m * c_in;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & (4 * sizeof(S) - 1)) == 0) {
    done = total & ~3;
    for (int v = 4 * tid; v < done; v += 4 * P)
      store4_f32(dst + v, *reinterpret_cast<const float4*>(st + v));
  }
  for (int v = done + tid; v < total; v += P) store_f32(dst + v, st[v]);
}

template <typename S>
struct Args {
  const S* cat;
  const S* ux;
  const int* adj_sm;
  const float* mult_rows;
  const float* c;
  S* z;
  int n, k_nbr, c_in, m;
  cudaStream_t stream;
};

// The block: NB nodes, each a team of TPN threads per M-group, about
// kThreads threads in all, NB halved while the shared memory exceeds the
// budget; at C <= 16 NB is a multiple of 4, so that a block's z range starts
// 16-byte aligned.
template <typename S, int CB, int MG>
int launch(const Args<S>& a) {
  const int ks = a.k_nbr + 1;
  const int tpn = (a.c_in + CB - 1) / CB;
  const int groups = (a.m + MG - 1) / MG;
  const int team = tpn * groups;
  int nb = kThreads / team > 0 ? kThreads / team : 1;
  if (a.c_in <= kStageC && nb >= 4) nb &= ~3;
  while (nb > 1 && smem_floats(nb, ks, a.m, a.c_in) * sizeof(float) > (size_t)kSmemBudget) {
    nb /= 2;
    if (a.c_in <= kStageC && nb >= 4) nb &= ~3;
  }
  const size_t smem = smem_floats(nb, ks, a.m, a.c_in) * sizeof(float);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  static size_t raised = 48 * 1024;
  if (smem > raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        facet_conv_fwd_kernel<S, CB, MG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    raised = smem;
  }
  const int threads = round_up(nb * team < kThreads ? nb * team : kThreads, 32);
  const unsigned blocks = (unsigned)((a.n + nb - 1) / nb);
  facet_conv_fwd_kernel<S, CB, MG><<<blocks, threads, smem, a.stream>>>(
      a.cat, a.ux, a.adj_sm, a.mult_rows, a.c, a.z, a.n, a.k_nbr, a.c_in, a.m, nb, tpn,
      groups);
  return (int)cudaGetLastError();
}

// CB channels a thread: 1 to C = 32, 2 to 128 (C = 128 takes two warps a
// node), 4 beyond
template <typename S, int MG>
int dispatch_c(const Args<S>& a) {
  if (a.c_in <= 32) return launch<S, 1, MG>(a);
  if (a.c_in <= 128) return launch<S, 2, MG>(a);
  return launch<S, 4, MG>(a);
}

template <typename S>
int run(const S* cat, const S* ux, const int* adj_sm, const float* mult_rows, const float* c,
        S* z, int n, int k_nbr, int c_in, int m, void* stream) {
  if (n <= 0) return 0;
  if (c_in < 1 || c_in > kMaxC || m < 1 || k_nbr < 0) return (int)cudaErrorInvalidValue;
  const Args<S> a{cat, ux, adj_sm, mult_rows, c, z, n, k_nbr, c_in, m, (cudaStream_t)stream};
  // M-groups of MG filters: M = 9, the model's, in one group of its own
  // width; wider M in groups of 16
  if (m <= 4) return dispatch_c<S, 4>(a);
  if (m <= 8) return dispatch_c<S, 8>(a);
  if (m == 9) return dispatch_c<S, 9>(a);
  return dispatch_c<S, 16>(a);
}

}  // namespace

extern "C" {

// Largest channel count one launch takes.
int facet_conv_fwd_max_c(void) { return kMaxC; }

// Largest filter count a launch takes at k_nbr neighbour slots and c_in
// channels: one node's q tile (and staged z row) must fit a block's shared
// memory.
int facet_conv_fwd_max_m(int k_nbr, int c_in) {
  int lo = 0, hi = 1 << 20;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (smem_floats(1, k_nbr + 1, mid, c_in) * sizeof(float) <= (size_t)kSmemMax) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// cat [n, c_in + m], ux [n, m], adj_sm [k_nbr, n] (one-indexed, 0 = pad),
// mult_rows [k_nbr + 1, n], c [m] -> z [n, m * c_in]; all f32 but adj_sm
// (int32), contiguous, on the current device. Launches on `stream` and
// returns cudaGetLastError() after the launch (0 when it was accepted).
int facet_conv_fwd_f32(const float* cat, const float* ux, const int* adj_sm,
                       const float* mult_rows, const float* c, float* z, int n,
                       int k_nbr, int c_in, int m, void* stream) {
  return run(cat, ux, adj_sm, mult_rows, c, z, n, k_nbr, c_in, m, stream);
}

// The same with cat, ux and z in bfloat16 (mult_rows and c f32): f32 inside,
// z rounded once.
int facet_conv_fwd_bf16(const __nv_bfloat16* cat, const __nv_bfloat16* ux, const int* adj_sm,
                        const float* mult_rows, const float* c, __nv_bfloat16* z, int n,
                        int k_nbr, int c_in, int m, void* stream) {
  return run(cat, ux, adj_sm, mult_rows, c, z, n, k_nbr, c_in, m, stream);
}

}  // extern "C"
