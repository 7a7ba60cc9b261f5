"""K3: the assignment and slot sums of the rotation-invariant conv, forward
and backward.

:func:`weighted_aggregate` launches the hand-written CUDA kernel
``csrc/weighted_aggregate.cu`` on CUDA tensors. It replaces
``facet_graph_convolution_tpu/ops/pallas_kernels.py::_aggregate_kernel``
(launched by ``weighted_aggregate``) with the softmax·mult before it fused
in. :func:`weighted_aggregate_bwd` launches its backward kernel, which
replaces no Pallas kernel: XLA differentiates ``_aggregate_nminor``
(``ops/conv.py:361-382``) and the softmax. The source's head note says
what bounds them on an H100 (bytes) and how their design answers that.
:func:`weighted_aggregate_plain` and :func:`weighted_aggregate_bwd_plain`
are the same functions in plain PyTorch: the wrappers take them for CPU
tensors, and the tests and ``chip_smoke.py`` hold the kernels against them.

In the port's slot-major layout, for ``logits`` [S, N, M], the slots'
multipliers ``rows`` [S, N] and ``x_slots`` [S, N, C] (S slots, slot 0 the
node's own row):

    q[s, n, m]      = softmax_M(logits)[s, n, m] · rows[s, n]
    z[n, m·C + c]   = Σ_s q[s, n, m] · x_slots[s, n, c]

``z`` [N, M·C], m-major: the JAX package's [N, M, C] with its last two
axes flattened, the column order the conv multiplies by ``W_flat``. The
backward, for ``dz`` [N, M·C] and p the softmax before ``rows``:

    dq[s, n, m]      = Σ_c dz[n, m·C + c] · x_slots[s, n, c]
    dlogits[s, n, m] = rows[s, n] · p[s, n, m] · (dq[s, n, m] − Σ_m' p·dq)
    dx_slots[s, n, c] = Σ_m dz[n, m·C + c] · q[s, n, m]   (when asked for)

``logits`` and ``rows`` are float32 on the card (the JAX conv takes the
softmax of ``logits.astype(f32)``); ``x_slots`` float32 or bfloat16. In
bfloat16 q is rounded to bfloat16 before the sums, as the JAX conv and the
unfused port round it, the sums are f32, and z, dz and dx_slots are
bfloat16 (z and dx_slots rounded once); ``dlogits`` is f32. The plain
versions keep that contract, and on the CPU also take float64 throughout.
The wrappers count their launches (``.launches``) and, among them, their
bfloat16 ones (``.launches_bf16``).

:class:`WeightedAggregate` is the ``torch.autograd.Function``
``(logits, rows, x_slots) → z`` through which the rotation-invariant conv
reaches K3: forward the fused kernel, backward its backward kernel, which
returns ``dlogits`` (and ``dx_slots`` where autograd asks for it); the
``rows`` are tables and get no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from facet_graph_convolution_torch.ops import cuda_library
from facet_graph_convolution_torch.ops.facet_conv_kernel import ENTRY_SUFFIX, upcast_bf16

_INT32_MAX = 2**31 - 1


def _assignment(logits: torch.Tensor, rows: torch.Tensor, dtype: torch.dtype):
    """(p, q): the softmax over M and q = p·rows in ``dtype`` (rounded to
    bfloat16 in bfloat16)."""
    p = torch.softmax(logits, dim=-1)
    return p, (p * rows[..., None]).to(dtype)


def weighted_aggregate_plain(logits: torch.Tensor, rows: torch.Tensor,
                             x_slots: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K3: the softmax, the multiply and one einsum, flattened
    m-major to [N, M·C]; in f32 on bfloat16 slots (upcast), z rounded to
    x_slots' dtype once."""
    _, n, m = logits.shape
    _, q = _assignment(logits, rows, x_slots.dtype)
    z = torch.einsum("snm,snc->nmc", upcast_bf16(q), upcast_bf16(x_slots))
    return z.reshape(n, m * x_slots.shape[2]).to(x_slots.dtype)


def weighted_aggregate_bwd_plain(logits: torch.Tensor, rows: torch.Tensor,
                                 x_slots: torch.Tensor, dz: torch.Tensor, need_dx: bool = True):
    """Plain PyTorch backward of K3: ``(dlogits, dx_slots or None)``, the
    softmax recomputed, dq and dx_slots by einsums in f32 on bfloat16
    operands, dlogits in logits' dtype, dx_slots rounded to x_slots' dtype
    once."""
    _, n, m = logits.shape
    c = x_slots.shape[2]
    p, q = _assignment(logits, rows, x_slots.dtype)
    dz3 = upcast_bf16(dz).reshape(n, m, c)
    dq = torch.einsum("nmc,snc->snm", dz3, upcast_bf16(x_slots)).to(p.dtype)
    dlogits = rows[..., None] * p * (dq - (p * dq).sum(dim=-1, keepdim=True))
    dx = (torch.einsum("nmc,snm->snc", dz3, upcast_bf16(q)).to(x_slots.dtype) if need_dx
          else None)
    return dlogits.to(logits.dtype), dx


def _library() -> ctypes.CDLL:
    lib = cuda_library.load("weighted_aggregate")
    if lib.weighted_aggregate_f32.argtypes is None:
        # c_void_p for the pointers and the stream: without argtypes ctypes
        # would pass the Python ints as 32-bit C ints and cut the addresses
        p, i = ctypes.c_void_p, ctypes.c_int
        for suffix in ENTRY_SUFFIX.values():
            fwd = getattr(lib, "weighted_aggregate" + suffix)
            fwd.argtypes = [p] * 4 + [i] * 4 + [p]
            bwd = getattr(lib, "weighted_aggregate_bwd" + suffix)
            bwd.argtypes = [p] * 6 + [i] * 4 + [p]
            fwd.restype = bwd.restype = ctypes.c_int
        lib.weighted_aggregate_smem.argtypes = [i] * 4
        lib.weighted_aggregate_smem.restype = ctypes.c_int
    return lib


def _check(kernel: str, logits: torch.Tensor, rows: torch.Tensor, x_slots: torch.Tensor,
           dz=None):
    """Refuse, on every device, shapes, devices and dtypes that do not go
    together; returns (S, N, M, C)."""
    if logits.dim() != 3 or rows.dim() != 2 or x_slots.dim() != 3:
        raise ValueError(f"{kernel}: logits {tuple(logits.shape)}, rows {tuple(rows.shape)} and "
                         f"x_slots {tuple(x_slots.shape)} need [S, N, M], [S, N] and [S, N, C]")
    s, n, m = logits.shape
    c = x_slots.shape[2]
    if x_slots.shape[:2] != logits.shape[:2] or tuple(rows.shape) != (s, n):
        raise ValueError(f"{kernel}: logits {tuple(logits.shape)}, rows {tuple(rows.shape)} and "
                         f"x_slots {tuple(x_slots.shape)} differ in S or N")
    if dz is not None and tuple(dz.shape) != (n, m * c):
        raise ValueError(f"{kernel}: dz is {tuple(dz.shape)}, z is {(n, m * c)}")
    for name, t in (("rows", rows), ("x_slots", x_slots), ("dz", dz)):
        if t is not None and t.device != logits.device:
            raise ValueError(f"{kernel}: {name} on {t.device}, logits on {logits.device}")
    want = torch.float32 if x_slots.dtype == torch.bfloat16 else x_slots.dtype
    if logits.dtype != want:
        raise TypeError(f"{kernel}: x_slots is {x_slots.dtype} but logits is {logits.dtype}; "
                        f"logits must be {want}")
    if dz is not None and dz.dtype != x_slots.dtype:
        raise TypeError(f"{kernel}: dz is {dz.dtype}, z (x_slots) is {x_slots.dtype}")
    return s, n, m, c


def _card_check(kernel: str, lib, tensors, s, n, m, c, bwd: bool):
    """Refuse what the kernel does not take on the card."""
    x_slots = tensors[2]
    if x_slots.dtype not in ENTRY_SUFFIX or tensors[1].dtype != torch.float32:
        raise TypeError(f"{kernel}: x_slots {x_slots.dtype} and rows {tensors[1].dtype}; the "
                        f"kernel takes x_slots in one of {sorted(str(d) for d in ENTRY_SUFFIX)}, "
                        "float32 logits and rows")
    for name, t in zip(("logits", "rows", "x_slots", "dz"), tensors):
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
    if s < 1 or m < 1 or c < 1:
        raise ValueError(f"{kernel}: S={s}, M={m}, C={c}; the kernel needs each >= 1")
    if max(s * n * max(m, c), n * m * c) > _INT32_MAX:
        raise ValueError(f"{kernel}: S={s}, N={n}, M={m}, C={c} overflow the kernel's int32 "
                         "sizes")
    if lib.weighted_aggregate_smem(s, m, c, int(bwd)) < 0:
        raise ValueError(f"{kernel}: S={s}, M={m}, C={c}: a one-node tile needs more than the "
                         "227 KB of shared memory a block can use")


def weighted_aggregate(logits: torch.Tensor, rows: torch.Tensor,
                       x_slots: torch.Tensor) -> torch.Tensor:
    """K3 on the inputs' device: z [N, M·C] in x_slots' dtype; the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. Raises on
    any other device and on shapes, dtypes, layouts or sizes the kernel
    does not take."""
    s, n, m, c = _check("weighted_aggregate", logits, rows, x_slots)
    if logits.device.type == "cpu":
        return weighted_aggregate_plain(logits, rows, x_slots)
    if logits.device.type != "cuda":
        raise ValueError(f"weighted_aggregate: no kernel for device {logits.device}")
    lib = _library()
    _card_check("weighted_aggregate", lib, (logits, rows, x_slots), s, n, m, c, bwd=False)
    z = torch.empty((n, m * c), device=x_slots.device, dtype=x_slots.dtype)
    if n == 0:
        return z
    with torch.cuda.device(x_slots.device):
        stream = torch.cuda.current_stream(x_slots.device).cuda_stream
        err = getattr(lib, "weighted_aggregate" + ENTRY_SUFFIX[x_slots.dtype])(
            logits.data_ptr(), rows.data_ptr(), x_slots.data_ptr(), z.data_ptr(), s, n, m, c,
            stream)
    if err != 0:
        raise RuntimeError(f"weighted_aggregate: kernel launch failed (cudaError {err})")
    weighted_aggregate.launches += 1
    if x_slots.dtype == torch.bfloat16:
        weighted_aggregate.launches_bf16 += 1
    return z


weighted_aggregate.launches = 0
weighted_aggregate.launches_bf16 = 0


def weighted_aggregate_bwd(logits: torch.Tensor, rows: torch.Tensor, x_slots: torch.Tensor,
                           dz: torch.Tensor, need_dx: bool = True):
    """K3's backward on the inputs' device: ``(dlogits, dx_slots)``,
    dlogits in logits' dtype, dx_slots in x_slots' dtype or None when
    ``need_dx`` is false; the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Raises as :func:`weighted_aggregate` does, and
    on a ``dz`` of another shape or dtype than z's."""
    s, n, m, c = _check("weighted_aggregate_bwd", logits, rows, x_slots, dz)
    if logits.device.type == "cpu":
        return weighted_aggregate_bwd_plain(logits, rows, x_slots, dz, need_dx)
    if logits.device.type != "cuda":
        raise ValueError(f"weighted_aggregate_bwd: no kernel for device {logits.device}")
    lib = _library()
    _card_check("weighted_aggregate_bwd", lib, (logits, rows, x_slots, dz), s, n, m, c,
                bwd=True)
    dlogits = torch.empty_like(logits)
    dx = torch.empty_like(x_slots) if need_dx else None
    if n == 0:
        return dlogits, dx
    with torch.cuda.device(x_slots.device):
        stream = torch.cuda.current_stream(x_slots.device).cuda_stream
        err = getattr(lib, "weighted_aggregate_bwd" + ENTRY_SUFFIX[x_slots.dtype])(
            logits.data_ptr(), rows.data_ptr(), x_slots.data_ptr(), dz.data_ptr(),
            dlogits.data_ptr(), None if dx is None else dx.data_ptr(), s, n, m, c, stream)
    if err != 0:
        raise RuntimeError(f"weighted_aggregate_bwd: kernel launch failed (cudaError {err})")
    weighted_aggregate_bwd.launches += 1
    if x_slots.dtype == torch.bfloat16:
        weighted_aggregate_bwd.launches_bf16 += 1
    return dlogits, dx


weighted_aggregate_bwd.launches = 0
weighted_aggregate_bwd.launches_bf16 = 0


class WeightedAggregate(torch.autograd.Function):
    """``z = K3(logits, rows, x_slots)``; the backward is K3's backward on
    the same device, ``dlogits`` always (in logits' dtype) and ``dx_slots``
    only when autograd asks for it; ``rows`` get no gradient."""

    @staticmethod
    def forward(ctx, logits, rows, x_slots):
        ctx.save_for_backward(logits, rows, x_slots)
        return weighted_aggregate(logits, rows, x_slots)

    @staticmethod
    def backward(ctx, dz):
        logits, rows, x_slots = ctx.saved_tensors
        need_logits, _, need_dx = ctx.needs_input_grad
        if not (need_logits or need_dx):
            return None, None, None
        dlogits, dx = weighted_aggregate_bwd(logits, rows, x_slots, dz.contiguous(), need_dx)
        return (dlogits if need_logits else None), None, dx
