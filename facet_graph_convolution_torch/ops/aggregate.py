"""K3: the weighted neighbour aggregation of the rotation-invariant conv.

:func:`weighted_aggregate` launches the hand-written CUDA kernel
``csrc/weighted_aggregate.cu`` on CUDA tensors; it replaces
``facet_graph_convolution_tpu/ops/pallas_kernels.py::_aggregate_kernel``
(launched by ``weighted_aggregate``). The source's head note says what bounds
it on an H100 (bytes) and how its design answers that.
:func:`weighted_aggregate_plain` is the same function in plain PyTorch: the
wrapper takes it for CPU tensors, and the tests and ``chip_smoke.py`` hold
the kernel against it.

In the port's slot-major layout, for ``q`` [S, N, M] and ``x_slots``
[S, N, C] (S slots, slot 0 the node's own row):

    z[n, m·C + c] = Σ_s q[s, n, m] · x_slots[s, n, c]

``z`` [N, M·C], m-major: the JAX package's [N, M, C] with its last two
axes flattened, the column order the conv multiplies by ``W_flat``.

The kernel takes float32 or bfloat16 ``q`` and ``x_slots`` (one dtype for
both): in bfloat16 it upcasts each load, sums in f32 and writes z in
bfloat16, rounded once, which the conv's bf16 product reads as it is (the
Pallas kernel writes f32 and the JAX conv rounds it to bf16 before its
product: the same values). The plain version keeps that contract. The
wrapper counts its launches (``.launches``) and, among them, its bfloat16
ones (``.launches_bf16``).

:class:`WeightedAggregate` is the ``torch.autograd.Function`` through which
the rotation-invariant conv reaches K3: forward K3, backward in PyTorch
tensor ops (``dq = Σ_c dz·x``, ``dx = Σ_m dz·q``, each only when asked
for). The JAX package has no backward kernel for K3 to port: XLA
differentiates ``_aggregate_nminor`` (``ops/conv.py:361-382``).
"""

from __future__ import annotations

import ctypes

import torch

from facet_graph_convolution_torch.ops import cuda_library
from facet_graph_convolution_torch.ops.facet_conv_kernel import ENTRY_SUFFIX, upcast_bf16

_INT32_MAX = 2**31 - 1


def weighted_aggregate_plain(q: torch.Tensor, x_slots: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K3: one einsum, flattened m-major to [N, M·C]; in f32
    on bfloat16 inputs (upcast), z rounded to q's dtype once."""
    _, n, m = q.shape
    z = torch.einsum("snm,snc->nmc", upcast_bf16(q), upcast_bf16(x_slots))
    return z.reshape(n, m * x_slots.shape[2]).to(q.dtype)


def _library() -> ctypes.CDLL:
    lib = cuda_library.load("weighted_aggregate")
    if lib.weighted_aggregate_f32.argtypes is None:
        # c_void_p for the pointers and the stream: without argtypes ctypes
        # would pass the Python ints as 32-bit C ints and cut the addresses
        p, i = ctypes.c_void_p, ctypes.c_int
        for suffix in ENTRY_SUFFIX.values():
            entry = getattr(lib, "weighted_aggregate" + suffix)
            entry.argtypes = [p, p, p, i, i, i, i, p]
            entry.restype = ctypes.c_int
        lib.weighted_aggregate_max_c.restype = ctypes.c_int
        lib.weighted_aggregate_max_m.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, x_slots: torch.Tensor):
    if q.dim() != 3 or x_slots.dim() != 3:
        raise ValueError(f"weighted_aggregate: q {tuple(q.shape)} and x_slots "
                         f"{tuple(x_slots.shape)} need [S, N, M] and [S, N, C]")
    if q.shape[:2] != x_slots.shape[:2]:
        raise ValueError(f"weighted_aggregate: q {tuple(q.shape)} and x_slots "
                         f"{tuple(x_slots.shape)} differ in S or N")
    if x_slots.device != q.device:
        raise ValueError(f"weighted_aggregate: x_slots on {x_slots.device}, q on {q.device}")
    if x_slots.dtype != q.dtype:
        raise TypeError(f"weighted_aggregate: x_slots is {x_slots.dtype} but q is {q.dtype}; "
                        "they must share one compute dtype")


def weighted_aggregate(q: torch.Tensor, x_slots: torch.Tensor) -> torch.Tensor:
    """K3 on ``q``'s device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; z in q's dtype (float32 or bfloat16 on the
    card). Raises on any other device, on a mix of dtypes, and on dtypes,
    shapes, layouts or sizes the kernel does not take (M or C beyond its
    limits, element counts beyond int32)."""
    _check(q, x_slots)
    if q.device.type == "cpu":
        return weighted_aggregate_plain(q, x_slots)
    if q.device.type != "cuda":
        raise ValueError(f"weighted_aggregate: no kernel for device {q.device}")
    if q.dtype not in ENTRY_SUFFIX:
        raise TypeError(f"weighted_aggregate: q is {q.dtype}, needs one of "
                        f"{sorted(str(d) for d in ENTRY_SUFFIX)}")
    for name, t in (("q", q), ("x_slots", x_slots)):
        if not t.is_contiguous():
            raise ValueError(f"weighted_aggregate: {name} is not contiguous")
    s, n, m = q.shape
    c = x_slots.shape[2]
    lib = _library()
    max_m, max_c = lib.weighted_aggregate_max_m(), lib.weighted_aggregate_max_c()
    if not (1 <= m <= max_m and 1 <= c <= max_c):
        raise ValueError(f"weighted_aggregate: M={m}, C={c} exceed the kernel's "
                         f"1<=M<={max_m}, 1<=C<={max_c}")
    if max(s * n * max(m, c), n * m * c) > _INT32_MAX:
        raise ValueError(f"weighted_aggregate: S={s}, N={n}, M={m}, C={c} overflow the "
                         "kernel's int32 sizes")
    z = torch.empty((n, m * c), device=q.device, dtype=q.dtype)
    if n == 0:
        return z
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, "weighted_aggregate" + ENTRY_SUFFIX[q.dtype])(
            q.data_ptr(), x_slots.data_ptr(), z.data_ptr(), s, n, m, c, stream)
    if err != 0:
        raise RuntimeError(f"weighted_aggregate: kernel launch failed (cudaError {err})")
    weighted_aggregate.launches += 1
    if q.dtype == torch.bfloat16:
        weighted_aggregate.launches_bf16 += 1
    return z


weighted_aggregate.launches = 0
weighted_aggregate.launches_bf16 = 0


class WeightedAggregate(torch.autograd.Function):
    """``z = K3(q, x_slots)``; the backward is plain PyTorch, on every
    device: ``dq[s,n,m] = Σ_c dz[n,m,c]·x[s,n,c]`` and ``dx[s,n,c] =
    Σ_m dz[n,m,c]·q[s,n,m]``, each computed only when autograd needs it,
    in the inputs' dtype (bfloat16 grads under bfloat16 compute)."""

    @staticmethod
    def forward(ctx, q, x_slots):
        ctx.save_for_backward(q, x_slots)
        return weighted_aggregate(q, x_slots)

    @staticmethod
    def backward(ctx, dz):
        q, x_slots = ctx.saved_tensors
        _, n, m = q.shape
        dz3 = dz.reshape(n, m, x_slots.shape[2])
        dq = torch.einsum("nmc,snc->snm", dz3, x_slots) if ctx.needs_input_grad[0] else None
        dx = torch.einsum("nmc,snm->snc", dz3, q) if ctx.needs_input_grad[1] else None
        return dq, dx
