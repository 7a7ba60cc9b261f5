"""The bias add and leaky ReLU after a dense layer or a conv, forward and
backward, as one hand-written kernel each way.

The U-Net (``models/unet.py``) applies ``lrelu`` after every conv but the
two up-convs and after the hidden fc layers (``fc1``, ``fc_mid``,
``fc_coarse``), whose bias comes just before it:

    z = y + b                     (no b after a conv: its bias is inside)
    h = relu(z) − α·relu(−z)      (ops/normalization.py::lrelu)

:func:`bias_lrelu` is that, chosen by device: on CPU tensors the chain
itself, :func:`bias_lrelu_plain`; on CUDA tensors ``csrc/bias_lrelu.cu``:
:func:`bias_lrelu_fwd` writes h in one pass, with a 1-byte class code per
element when a gradient is to be taken, and :func:`bias_lrelu_bwd` takes dz
from dh and the codes in one more. The launchers take any float32 layout
(made contiguous, the last axis the channels) and raise on another dtype
or device: on the card there is no second path.

The kernels give the chain's bits, signed zeros and NaN included (the
source's head note says how): h as ``lrelu(y + b)`` on the card, and dz as
autograd through it, class by class of z:

    z > 0:   dz = g + (−0)
    z < 0:   dz = (+0) + −((−g)·α)
    NaN:     dz = g + −((−g)·α)
    ±0:      dz = +0               (no gradient at 0, as the chain gives)

The bias gradient is ``dz`` summed over the rows, the reduction autograd
ran before.

:class:`BiasLrelu` is the kernels' ``torch.autograd.Function``
``(y, b, α) → h``: it keeps only the codes for its backward (not z, not the
relus' outputs). The forward without codes is also the operator
``torch.ops.facet_graph_convolution.bias_lrelu`` (registered when this
module is imported, with a fake that gives h's shape), so that
``torch.export`` keeps it opaque in the programs it writes: an exported
forward launches the kernel on the card and runs the chain on the CPU.
:func:`bias_lrelu` calls the operator where no gradient is taken.
``bias_lrelu_fwd.launches`` and ``bias_lrelu_bwd.launches`` count the
kernels' launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from facet_graph_convolution_torch.ops import cuda_library
from facet_graph_convolution_torch.ops.normalization import lrelu


def bias_lrelu_plain(y: torch.Tensor, b: Optional[torch.Tensor],
                     alpha: float = 0.1) -> torch.Tensor:
    """The chain ``lrelu(y + b)`` (``lrelu(y)`` without b), on any device."""
    return lrelu(y if b is None else y + b, alpha)


def _on_card(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, not {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")


def _library() -> ctypes.CDLL:
    lib = cuda_library.load("bias_lrelu")
    if lib.bias_lrelu_fwd_f32.argtypes is None:
        # c_void_p for the pointers and the stream: without argtypes ctypes
        # would pass the Python ints as 32-bit C ints and cut the addresses
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.bias_lrelu_fwd_f32.argtypes = [p] * 4 + [ll, i, f, i, p]
        lib.bias_lrelu_bwd_f32.argtypes = [p] * 3 + [ll, f, i, p]
        lib.bias_lrelu_fwd_f32.restype = lib.bias_lrelu_bwd_f32.restype = ctypes.c_int
    return lib


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def bias_lrelu_fwd(y: torch.Tensor, b: Optional[torch.Tensor], alpha: float = 0.1,
                   need_code: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(h, code or None)`` of ``lrelu(y + b)`` by the forward kernel: ``y``
    [..., C] float32 on a CUDA device (made contiguous), ``b`` [C] or None;
    h and the uint8 codes in y's shape. Raises on another dtype or device."""
    _on_card("bias_lrelu_fwd", y)
    c = y.shape[-1]
    if b is not None:
        _on_card("bias_lrelu_fwd", b)
        if b.device != y.device or tuple(b.shape) != (c,):
            raise ValueError(f"bias_lrelu_fwd: b {tuple(b.shape)} on {b.device} is not one "
                             f"value a channel of y {tuple(y.shape)} on {y.device}")
        b = b.contiguous()
    y = y.contiguous()
    h = torch.empty_like(y)
    code = torch.empty_like(y, dtype=torch.uint8) if need_code else None
    if h.numel() == 0:
        return h, code
    lib = _library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.bias_lrelu_fwd_f32(y.data_ptr(), None if b is None else b.data_ptr(),
                                     h.data_ptr(), None if code is None else code.data_ptr(),
                                     y.numel() // c, c, alpha, _sms(y.device), stream)
    if err != 0:
        raise RuntimeError(f"bias_lrelu_fwd: kernel launch failed (cudaError {err})")
    bias_lrelu_fwd.launches += 1
    return h, code


bias_lrelu_fwd.launches = 0


def bias_lrelu_bwd(dh: torch.Tensor, code: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    """dz from dh and the forward's codes by the backward kernel: ``dh``
    float32 on a CUDA device (made contiguous), in the codes' shape. Raises
    on another shape, dtype or device."""
    if tuple(dh.shape) != tuple(code.shape) or code.dtype != torch.uint8:
        raise ValueError(f"bias_lrelu_bwd: dh {tuple(dh.shape)} and code {tuple(code.shape)} "
                         f"({code.dtype}) need one shape and uint8 codes")
    _on_card("bias_lrelu_bwd", dh)
    if code.device != dh.device or not code.is_contiguous():
        raise ValueError("bias_lrelu_bwd: the codes need to be the forward's, on dh's device")
    dh = dh.contiguous()
    dz = torch.empty_like(dh)
    if dz.numel() == 0:
        return dz
    lib = _library()
    with torch.cuda.device(dh.device):
        stream = torch.cuda.current_stream(dh.device).cuda_stream
        err = lib.bias_lrelu_bwd_f32(dh.data_ptr(), code.data_ptr(), dz.data_ptr(), dz.numel(),
                                     alpha, _sms(dh.device), stream)
    if err != 0:
        raise RuntimeError(f"bias_lrelu_bwd: kernel launch failed (cudaError {err})")
    bias_lrelu_bwd.launches += 1
    return dz


bias_lrelu_bwd.launches = 0


BIAS_LRELU_OP = "facet_graph_convolution::bias_lrelu"
# torch.library's define/impl rather than custom_op, as K1's operator
torch.library.define(BIAS_LRELU_OP, "(Tensor y, Tensor? b, float alpha) -> Tensor")


@torch.library.impl(BIAS_LRELU_OP, ("cpu", "cuda"))
def _bias_lrelu_impl(y, b, alpha):
    if y.device.type == "cpu":
        return bias_lrelu_plain(y, b, alpha)
    return bias_lrelu_fwd(y, b, alpha)[0]


@torch.library.register_fake(BIAS_LRELU_OP)
def _bias_lrelu_fake(y, b, alpha):
    return torch.empty_like(y)


# the forward without codes as an operator, with no autograd formula
# (BiasLrelu holds the backward)
bias_lrelu_op = torch.ops.facet_graph_convolution.bias_lrelu


class BiasLrelu(torch.autograd.Function):
    """``h = lrelu(y + b)`` (``b`` may be None) by the kernels, on the card;
    the backward takes dz from the class codes alone, and db sums dz over
    the rows."""

    @staticmethod
    def forward(ctx, y, b, alpha):
        h, code = bias_lrelu_fwd(y, b, alpha, need_code=True)
        ctx.save_for_backward(code)
        ctx.alpha = alpha
        return h

    @staticmethod
    def backward(ctx, dh):
        (code,) = ctx.saved_tensors
        need_y, need_b, _ = ctx.needs_input_grad
        if not (need_y or need_b):
            return None, None, None
        dz = bias_lrelu_bwd(dh, code, ctx.alpha)
        db = dz.reshape(-1, dz.shape[-1]).sum(0) if need_b else None
        return (dz if need_y else None), db, None


def bias_lrelu(y: torch.Tensor, b: Optional[torch.Tensor], alpha: float = 0.1) -> torch.Tensor:
    """``lrelu(y + b)`` (``lrelu(y)`` when b is None). Where autograd records,
    the chain on CPU tensors and :class:`BiasLrelu` on CUDA ones; where it
    does not (``torch.no_grad``, an exported program), the operator."""
    recording = torch.is_grad_enabled() and (
        y.requires_grad or (b is not None and b.requires_grad))
    if not recording:
        return bias_lrelu_op(y, b, alpha)
    if y.device.type == "cpu":
        return bias_lrelu_plain(y, b, alpha)
    return BiasLrelu.apply(y, b, alpha)
