// The bias add and leaky ReLU after a dense layer or a conv, forward and
// backward, one pass each way.
//
// They replace the elementwise chain that models/unet.py ran after every
// conv but the two up-convs and after the hidden fc layers (fc1, fc_mid,
// fc_coarse): z = y + b (torch's add; no bias after a conv, whose own bias
// is inside it), then
// h = relu(z) - alpha * relu(-z) (ops/normalization.py::lrelu: relu, neg,
// relu, mul, sub, five kernels), and autograd's backward through those
// (threshold, mul, neg and sum kernels). The JAX package leaves the same
// chain to XLA, which fuses it; no Pallas kernel is replaced.
//
// Bit for bit. Each float operation of the chain is done here in its order
// and rounded as torch's CUDA kernels round it, so h and dz carry the
// chain's bits, signed zeros and NaN included: relu is clamp_min (NaN
// passes, else fmaxf(v, 0)), the products and sums are single roundings
// (__fmul_rn, __fadd_rn, __fsub_rn, never contracted into an FMA), and
// alpha, +0 and -0 are kernel arguments, so that no constant folds an add
// of a zero away (an add canonicalises a NaN). The forward writes, when a
// gradient is needed, a 1-byte class code per element, all that the
// backward needs of z:
//   POS (z > 0):  dz = g + (-0)                       relu(z) passes g
//   NEG (z < 0):  dz = (+0) + -((-g) * alpha)          relu(-z) passes it
//   NAN:          dz = g + -((-g) * alpha)             both pass
//   ZERO (+-0):   dz = (+0) + (-0) = +0                neither: gradient 0
// (each the sum that autograd accumulates at z: relu's threshold gives +0
// where its output is <= 0, the neg after it -0). The bias gradient is
// left to torch's sum over the rows, the reduction autograd ran before.
//
// What bounds them on an H100: bytes. At the torus's fine head (1,273,920
// rows of fc1, 1,024 channels, f32) the forward reads y (5.2 GB) and writes
// h (5.2 GB) and the codes (1.3 GB), 11.7 GB, 3.5 ms at 3.35 TB/s; the
// backward reads dh and the codes and writes dz, the same 11.7 GB. The
// chain they replace moved ~13 and ~16 such 5.2 GB passes. A few integer
// and float operations an element are far below the card's rates.
//
// Design: a grid-stride loop over 16-byte quads of the flat [N * C] tensor
// (float4 loads and stores, the codes a uchar4), 8 blocks of 256 threads an
// SM; the elements past the last whole quad, and every element when a
// pointer is not 16-byte aligned, one a thread. The bias columns of a quad
// start at (4q mod C) and advance by (4 * threads mod C) a step, kept
// without a division in the loop; where that advance is 0 (C divides four
// times the grid, as at every width the model uses) the thread's four bias
// values are loaded once into registers. Every element belongs to one
// thread: no atomics, bitwise repeatable. Both kernels launch on the
// caller's stream and allocate nothing, so a CUDA graph captures them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

enum : unsigned char { ZERO = 0, POS = 1, NEG = 2, NAN_CODE = 3 };

// at::clamp_min(v, 0) as torch's CUDA kernel computes it
__device__ __forceinline__ float relu_as_torch(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

__device__ __forceinline__ unsigned char class_code(float z) {
  return z > 0.0f ? POS : z < 0.0f ? NEG : isnan(z) ? NAN_CODE : ZERO;
}

// h of one element; z = y (+ b) as torch's add rounds it
template <bool BIAS>
__device__ __forceinline__ float forward_one(float y, float b, float alpha, unsigned char* code) {
  const float z = BIAS ? __fadd_rn(y, b) : y;
  *code = class_code(z);
  return __fsub_rn(relu_as_torch(z), __fmul_rn(relu_as_torch(-z), alpha));
}

__device__ __forceinline__ float backward_one(float g, unsigned char code, float alpha,
                                              float pzero, float nzero) {
  // -((-g) * alpha): the mul's backward, then the neg's
  const float through_neg = -__fmul_rn(-g, alpha);
  switch (code) {
    case POS: return __fadd_rn(g, nzero);
    case NEG: return __fadd_rn(pzero, through_neg);
    case NAN_CODE: return __fadd_rn(g, through_neg);
    default: return __fadd_rn(pzero, nzero);
  }
}

__device__ __forceinline__ int next_col(int col, int cols) { return col + 1 == cols ? 0 : col + 1; }

template <bool BIAS, bool CODE>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bias_lrelu_fwd_kernel(const float* __restrict__ y, const float* __restrict__ b,
                      float* __restrict__ h, unsigned char* __restrict__ code,
                      long long total, long long quads, int cols, float alpha) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int col_step = BIAS ? (int)((4 * stride) % cols) : 0;
  int col = BIAS ? (int)((4 * first) % cols) : 0;
  float bias[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  auto load_bias = [&]() {
    int c = col;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      bias[k] = __ldg(b + c);
      c = next_col(c, cols);
    }
  };
  if (BIAS && col_step == 0 && first < quads) load_bias();
  for (long long q = first; q < quads; q += stride) {
    if (BIAS && col_step != 0) load_bias();
    const float4 v = __ldg(reinterpret_cast<const float4*>(y) + q);
    unsigned char c[4];
    float4 out;
    out.x = forward_one<BIAS>(v.x, bias[0], alpha, &c[0]);
    out.y = forward_one<BIAS>(v.y, bias[1], alpha, &c[1]);
    out.z = forward_one<BIAS>(v.z, bias[2], alpha, &c[2]);
    out.w = forward_one<BIAS>(v.w, bias[3], alpha, &c[3]);
    reinterpret_cast<float4*>(h)[q] = out;
    if (CODE) reinterpret_cast<uchar4*>(code)[q] = make_uchar4(c[0], c[1], c[2], c[3]);
    if (BIAS) {
      col += col_step;
      if (col >= cols) col -= cols;
    }
  }
  for (long long i = 4 * quads + first; i < total; i += stride) {
    unsigned char c;
    h[i] = forward_one<BIAS>(y[i], BIAS ? __ldg(b + i % cols) : 0.0f, alpha, &c);
    if (CODE) code[i] = c;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bias_lrelu_bwd_kernel(const float* __restrict__ dh, const unsigned char* __restrict__ code,
                      float* __restrict__ dz, long long total, long long quads, float alpha,
                      float pzero, float nzero) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long q = first; q < quads; q += stride) {
    const float4 g = __ldg(reinterpret_cast<const float4*>(dh) + q);
    const uchar4 c = __ldg(reinterpret_cast<const uchar4*>(code) + q);
    float4 out;
    out.x = backward_one(g.x, c.x, alpha, pzero, nzero);
    out.y = backward_one(g.y, c.y, alpha, pzero, nzero);
    out.z = backward_one(g.z, c.z, alpha, pzero, nzero);
    out.w = backward_one(g.w, c.w, alpha, pzero, nzero);
    reinterpret_cast<float4*>(dz)[q] = out;
  }
  for (long long i = 4 * quads + first; i < total; i += stride)
    dz[i] = backward_one(dh[i], code[i], alpha, pzero, nzero);
}

bool aligned(const void* p, uintptr_t bytes) { return ((uintptr_t)p % bytes) == 0; }

// 8 blocks an SM, fewer when the tensor has fewer quads (or elements)
int blocks_for(long long work, int sms) {
  const long long want = (work + kThreads - 1) / kThreads;
  const long long most = (long long)(sms > 0 ? sms : 1) * kBlocksPerSm;
  return (int)(want < most ? (want > 0 ? want : 1) : most);
}

}  // namespace

extern "C" {

// y [rows, cols] f32 contiguous, b [cols] f32 or null, h [rows, cols] f32,
// code [rows, cols] uint8 or null (no code: no gradient to take), on the
// current device; rows >= 1, cols >= 1. `sms`: the device's SM count.
// Launches on `stream` and returns cudaGetLastError() after the launch.
int bias_lrelu_fwd_f32(const float* y, const float* b, float* h, unsigned char* code,
                       long long rows, int cols, float alpha, int sms, void* stream) {
  const long long total = rows * cols;
  const bool vec = aligned(y, 16) && aligned(h, 16) && (code == nullptr || aligned(code, 4));
  const long long quads = vec ? total / 4 : 0;
  const int blocks = blocks_for(vec ? quads : total, sms);
  cudaStream_t s = (cudaStream_t)stream;
  if (b != nullptr && code != nullptr)
    bias_lrelu_fwd_kernel<true, true><<<blocks, kThreads, 0, s>>>(y, b, h, code, total, quads,
                                                                 cols, alpha);
  else if (b != nullptr)
    bias_lrelu_fwd_kernel<true, false><<<blocks, kThreads, 0, s>>>(y, b, h, code, total, quads,
                                                                  cols, alpha);
  else if (code != nullptr)
    bias_lrelu_fwd_kernel<false, true><<<blocks, kThreads, 0, s>>>(y, b, h, code, total, quads,
                                                                  cols, alpha);
  else
    bias_lrelu_fwd_kernel<false, false><<<blocks, kThreads, 0, s>>>(y, b, h, code, total,
                                                                   quads, cols, alpha);
  return (int)cudaGetLastError();
}

// dh [count] f32 and code [count] uint8 (the forward's) -> dz [count] f32,
// contiguous, on the current device; count >= 1. Launches on `stream` and
// returns cudaGetLastError() after the launch.
int bias_lrelu_bwd_f32(const float* dh, const unsigned char* code, float* dz, long long count,
                       float alpha, int sms, void* stream) {
  const bool vec = aligned(dh, 16) && aligned(dz, 16) && aligned(code, 4);
  const long long quads = vec ? count / 4 : 0;
  const int blocks = blocks_for(vec ? quads : count, sms);
  bias_lrelu_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      dh, code, dz, count, quads, alpha, 0.0f, -0.0f);
  return (int)cudaGetLastError();
}

}  // extern "C"
