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
// What bounds it on an H100: memory. Per node it reads M*C floats of dz and
// writes C+M floats per live slot; dz alone is 57 MB at dconv1 (N' = 24,576,
// C = 64, M = 9), against ~13 * 2 * M * C FMAs a node (~0.8 GFLOP, ~12 us at
// the 67 TFLOP/s f32 rate). Reading dz once is what the split below is for.
//
// Design, two passes, no atomics (deterministic):
// - Pass A, destination-centric: one warp per node i, 8 nodes per block.
//   The warp loads dz[i] into registers once (M x ceil(C/32) floats a lane),
//   then its slot table as K1 does (one slot per lane, a ballot gives the
//   live slots; mult 0 slots are skipped, their dx, dq and dlog are exactly
//   0 in the TPU kernel too). Per live slot it loads the row of cat, lanes
//   m < M hold the logits and compute s by warp shuffles, dx[ch] is formed
//   per lane, and the M dot products dq are reduced across the warp by a
//   transposing butterfly (V values in V-1 + log2(32/V) shuffles instead of
//   5 per value). The self slot's row goes to dcat[i]; a neighbour slot's
//   row goes, coalesced, to dg[(k-1)*N + i] (scratch [K'*N, C+M]). dux[i]
//   is accumulated in registers.
// - Pass B, source-centric: one warp per node j walks j's transpose map
//   adj_t_sm[j] (one-indexed flat slots k*N + i, 0 = pad) and adds those rows
//   of dg to dcat[j], in the map's order. A slot is read only when pass A
//   wrote it (mult != 0 and adj_sm at that slot names j), so dg needs no
//   clearing and a bad table cannot read unwritten memory.
// dg at dconv1 is 86 MB and outlives L2 (50 MB); reading dz from the source
// side instead would read it about K' times.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarps = 8;

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

// Warp sums of V values per lane (V a power of two, <= 32). Each split round
// halves the values a lane holds: a lane keeps one half, sends the other to
// its partner across lane bit OFF and adds what the partner sent of its own
// half. After log2(V) such rounds lane l holds a partial of value
// l / (32 / V); plain rounds over the remaining lane bits finish the sums.
// The rounds are template recursion so that every index is a constant and
// the values stay in registers.
template <int V, int HALF, int OFF>
struct SplitRounds {
  static __device__ __forceinline__ void run(float (&v)[V], int lane) {
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = upper ? v[i] : v[i + HALF];
      const float keep = upper ? v[i + HALF] : v[i];
      v[i] = keep + __shfl_xor_sync(kFullMask, send, OFF);
    }
    SplitRounds<V, HALF / 2, OFF / 2>::run(v, lane);
  }
};

template <int V, int OFF>
struct SplitRounds<V, 0, OFF> {
  static __device__ __forceinline__ void run(float (&)[V], int) {}
};

// Returns the sum over the warp of value l / (32 / V) on lane l.
template <int V>
__device__ __forceinline__ float transpose_reduce(float (&v)[V], int lane) {
  SplitRounds<V, V / 2, 16>::run(v, lane);
  float r = v[0];
#pragma unroll
  for (int off = 16 / V; off > 0; off >>= 1) r += __shfl_xor_sync(kFullMask, r, off);
  return r;
}

template <int CC, int MM, int V>
__global__ void __launch_bounds__(kWarps * 32)
slot_cotangents_kernel(const float* __restrict__ cat, const float* __restrict__ ux,
                       const int* __restrict__ adj_sm,
                       const float* __restrict__ mult_rows,
                       const float* __restrict__ cvec, const float* __restrict__ dz,
                       float* __restrict__ dg, float* __restrict__ dcat,
                       float* __restrict__ dux, int n, int k_nbr, int c_in, int m) {
  const int lane = threadIdx.x & 31;
  const int node = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (node >= n) return;  // warp-uniform: the whole warp leaves together
  const int width = c_in + m;
  const bool logit_lane = lane < m;
  const float base =
      logit_lane ? __ldg(ux + (size_t)node * m + lane) + __ldg(cvec + lane) : 0.f;

  // dz[i] in registers: dzr[a][b] = dz[i, a*C + lane + 32*b]
  float dzr[MM][CC];
  const float* dzrow = dz + (size_t)node * m * c_in;
#pragma unroll
  for (int a = 0; a < MM; ++a)
#pragma unroll
    for (int b = 0; b < CC; ++b) {
      const int ch = lane + 32 * b;
      dzr[a][b] = (a < m && ch < c_in) ? __ldg(dzrow + a * c_in + ch) : 0.f;
    }

  float dux_acc = 0.f;
  float* self_row = dcat + (size_t)node * width;
  for (int k0 = 0; k0 <= k_nbr; k0 += 32) {
    const int k = k0 + lane;
    float mult_l = 0.f;
    int j_l = -1;
    if (k <= k_nbr) {
      mult_l = __ldg(mult_rows + (size_t)k * n + node);
      j_l = k == 0 ? node : __ldg(adj_sm + (size_t)(k - 1) * n + node) - 1;
    }
    unsigned live =
        __ballot_sync(kFullMask, mult_l != 0.f && (unsigned)j_l < (unsigned)n);
    if (k0 == 0 && (live & 1u) == 0u) {
      // a dead self slot (padded node) still owns its row of dcat
      for (int ch = lane; ch < width; ch += 32) self_row[ch] = 0.f;
    }
    while (live != 0u) {
      const int s = __ffs(live) - 1;
      live &= live - 1u;
      const float mult = __shfl_sync(kFullMask, mult_l, s);
      const int j = __shfl_sync(kFullMask, j_l, s);
      const float* row = cat + (size_t)j * width;
      const float v = logit_lane ? __ldg(row + c_in + lane) : 0.f;
      float x[CC];
#pragma unroll
      for (int b = 0; b < CC; ++b) {
        const int ch = lane + 32 * b;
        x[b] = ch < c_in ? __ldg(row + ch) : 0.f;
      }

      // softmax over the M logit lanes (0 on the others)
      const float logit = logit_lane ? base + v : -INFINITY;
      const float mx = warp_max(logit);
      const float e = logit_lane ? expf(logit - mx) : 0.f;
      const float sm = e / warp_sum(e);

      float dx[CC];
#pragma unroll
      for (int b = 0; b < CC; ++b) dx[b] = 0.f;
      float part[V];
#pragma unroll
      for (int a = 0; a < V; ++a) part[a] = 0.f;
#pragma unroll
      for (int a = 0; a < MM; ++a) {
        const float wa = __shfl_sync(kFullMask, sm, a) * mult;
#pragma unroll
        for (int b = 0; b < CC; ++b) {
          dx[b] = fmaf(wa, dzr[a][b], dx[b]);
          part[a] = fmaf(x[b], dzr[a][b], part[a]);
        }
      }
      // dq[m] on lane m: value m sits on lane m * (32 / V) after the reduce
      const float red = transpose_reduce<V>(part, lane);
      const float dq = __shfl_sync(kFullMask, red, (lane * (32 / V)) & 31) * mult;
      const float dq_m = logit_lane ? dq : 0.f;
      const float dlog = sm * (dq_m - warp_sum(sm * dq_m));
      dux_acc += dlog;

      const int kk = k0 + s;
      float* out = kk == 0 ? self_row : dg + ((size_t)(kk - 1) * n + node) * width;
#pragma unroll
      for (int b = 0; b < CC; ++b) {
        const int ch = lane + 32 * b;
        if (ch < c_in) out[ch] = dx[b];
      }
      if (logit_lane) out[c_in + lane] = dlog;
    }
  }
  if (logit_lane) dux[(size_t)node * m + lane] = dux_acc;
}

template <int WB>
__global__ void __launch_bounds__(kWarps * 32)
transpose_sum_kernel(const float* __restrict__ dg, const int* __restrict__ adj_t,
                     const int* __restrict__ adj_sm,
                     const float* __restrict__ mult_rows, float* __restrict__ dcat,
                     int n, int k_nbr, int k_t, int width) {
  const int lane = threadIdx.x & 31;
  const int node = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (node >= n) return;
  float* row = dcat + (size_t)node * width;
  float acc[WB];
#pragma unroll
  for (int b = 0; b < WB; ++b) {
    const int ch = lane + 32 * b;
    acc[b] = ch < width ? row[ch] : 0.f;
  }
  const long long total = (long long)k_nbr * n;
  for (int t0 = 0; t0 < k_t; t0 += 32) {
    const int t = t0 + lane;
    int slot = -1;
    if (t < k_t) {
      const int sl = __ldg(adj_t + (size_t)node * k_t + t) - 1;
      // read only a slot that pass A wrote: live, and naming this node
      if (sl >= 0 && sl < total && __ldg(mult_rows + (size_t)n + sl) != 0.f &&
          __ldg(adj_sm + sl) == node + 1)
        slot = sl;
    }
    unsigned live = __ballot_sync(kFullMask, slot >= 0);
    while (live != 0u) {
      const int s = __ffs(live) - 1;
      live &= live - 1u;
      const float* g = dg + (size_t)__shfl_sync(kFullMask, slot, s) * width;
#pragma unroll
      for (int b = 0; b < WB; ++b) {
        const int ch = lane + 32 * b;
        if (ch < width) acc[b] += g[ch];
      }
    }
  }
#pragma unroll
  for (int b = 0; b < WB; ++b) {
    const int ch = lane + 32 * b;
    if (ch < width) row[ch] = acc[b];
  }
}

struct Args {
  const float* cat;
  const float* ux;
  const int* adj_sm;
  const int* adj_t;
  const float* mult_rows;
  const float* c;
  const float* dz;
  float* dg;
  float* dcat;
  float* dux;
  int n, k_nbr, k_t, c_in, m;
  cudaStream_t stream;
};

unsigned blocks(int n) { return (unsigned)((n + kWarps - 1) / kWarps); }

template <int CC, int MM, int V>
int launch_a(const Args& a) {
  slot_cotangents_kernel<CC, MM, V><<<blocks(a.n), kWarps * 32, 0, a.stream>>>(
      a.cat, a.ux, a.adj_sm, a.mult_rows, a.c, a.dz, a.dg, a.dcat, a.dux, a.n,
      a.k_nbr, a.c_in, a.m);
  return (int)cudaGetLastError();
}

template <int MM, int V>
int dispatch_c(const Args& a) {
  switch ((a.c_in + 31) / 32) {
    case 1: return launch_a<1, MM, V>(a);
    case 2: return launch_a<2, MM, V>(a);
    case 3: return launch_a<3, MM, V>(a);
    case 4: return launch_a<4, MM, V>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int WB>
int launch_b(const Args& a) {
  transpose_sum_kernel<WB><<<blocks(a.n), kWarps * 32, 0, a.stream>>>(
      a.dg, a.adj_t, a.adj_sm, a.mult_rows, a.dcat, a.n, a.k_nbr, a.k_t,
      a.c_in + a.m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest channel count and filter count the kernel is instantiated for.
int facet_conv_bwd_max_c(void) { return 128; }
int facet_conv_bwd_max_m(void) { return 16; }

// cat [n, c_in + m], ux [n, m], adj_sm [k_nbr, n] (one-indexed, 0 = pad),
// adj_t [n, k_t] (one-indexed flat slots k*n + i, 0 = pad), mult_rows
// [k_nbr + 1, n], c [m], dz [n, m * c_in] -> dcat [n, c_in + m], dux [n, m],
// with dg [k_nbr * n, c_in + m] as scratch; all f32 but the int32 tables,
// contiguous, on the current device. Launches both passes on `stream` and
// returns cudaGetLastError() after the first that fails (0 when both were
// accepted).
int facet_conv_bwd_f32(const float* cat, const float* ux, const int* adj_sm,
                       const int* adj_t, const float* mult_rows, const float* c,
                       const float* dz, float* dg, float* dcat, float* dux, int n,
                       int k_nbr, int k_t, int c_in, int m, void* stream) {
  if (n <= 0) return 0;
  if (c_in < 1 || m < 1 || k_nbr < 0 || k_t < 0) return (int)cudaErrorInvalidValue;
  const Args a{cat, ux, adj_sm, adj_t, mult_rows, c, dz, dg, dcat, dux,
               n, k_nbr, k_t, c_in, m, (cudaStream_t)stream};
  int err;
  // M = 9 is the model's filter count: its own width keeps registers low
  if (m <= 4) err = dispatch_c<4, 4>(a);
  else if (m <= 8) err = dispatch_c<8, 8>(a);
  else if (m == 9) err = dispatch_c<9, 16>(a);
  else if (m <= 16) err = dispatch_c<16, 16>(a);
  else err = (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  switch ((c_in + m + 31) / 32) {
    case 1: return launch_b<1>(a);
    case 2: return launch_b<2>(a);
    case 3: return launch_b<3>(a);
    case 4: return launch_b<4>(a);
    case 5: return launch_b<5>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
