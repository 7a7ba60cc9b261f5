"""K4: the zero-ignoring binary-tree pool.

:func:`tree_pool_ignore_zeros` launches the hand-written CUDA kernel
``csrc/tree_pool_iz.cu`` on CUDA tensors; it replaces
``facet_graph_convolution_tpu/ops/pallas_kernels.py::_pool_iz_kernel``
(launched by ``tree_pool_ignore_zeros``, two fused rounds), with the number
of rounds as an argument. The source's head note says what bounds it on an
H100 (launch latency, at the solver's C = 3) and how its design answers
that. :func:`tree_pool_ignore_zeros_plain` is the same function in plain
PyTorch: the wrapper takes it for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernel against it, bit for bit.

For ``x`` [N, C] and ``steps`` rounds, each round pairs consecutive rows
(a, b); a row whose every channel is 0 (-0.0 included) is replaced by its
partner, then ``(a + b) * 0.5``: [N, C] → [N / 2^steps, C]
(reference ``custom_binary_tree_pooling``, model.py:792-814).
"""

from __future__ import annotations

import ctypes

import torch

from facet_graph_convolution_torch.ops import cuda_library


def tree_pool_ignore_zeros_plain(x: torch.Tensor, steps: int = 2) -> torch.Tensor:
    """Plain PyTorch K4: ``steps`` rounds of zero-ignoring pairwise mean."""
    px = x
    for _ in range(steps):
        pair = px.reshape(-1, 2, px.shape[-1])
        a, b = pair[:, 0], pair[:, 1]
        a_zero = (a == 0).all(dim=-1, keepdim=True)
        b_zero = (b == 0).all(dim=-1, keepdim=True)
        px = (torch.where(a_zero, b, a) + torch.where(b_zero, a, b)) * 0.5
    return px


def _library() -> ctypes.CDLL:
    lib = cuda_library.load("tree_pool_iz")
    if lib.tree_pool_iz_f32.argtypes is None:
        # c_void_p for the pointers and the stream: without argtypes ctypes
        # would pass the Python ints as 32-bit C ints and cut the addresses
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tree_pool_iz_f32.argtypes = [p, p, i, i, i, p]
        lib.tree_pool_iz_f32.restype = ctypes.c_int
        lib.tree_pool_iz_max_stack_floats.restype = ctypes.c_int
    return lib


def tree_pool_ignore_zeros(x: torch.Tensor, steps: int = 2) -> torch.Tensor:
    """K4 on ``x``'s device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Raises on any other device, on shapes, dtypes
    or layouts the kernel does not take, and on a CUDA tensor that needs a
    gradient under grad mode (the kernel has no backward)."""
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"tree_pool_ignore_zeros: x has shape {tuple(x.shape)}, needs [N, C>=1]")
    if not 0 <= steps <= 30:
        raise ValueError(f"tree_pool_ignore_zeros: steps={steps}, needs 0..30")
    n, c = x.shape
    if n % (1 << steps):
        raise ValueError(f"tree_pool_ignore_zeros: N={n} is not a multiple of 2^{steps}")
    if x.device.type == "cpu":
        return tree_pool_ignore_zeros_plain(x, steps)
    if x.device.type != "cuda":
        raise ValueError(f"tree_pool_ignore_zeros: no kernel for device {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            "tree_pool_ignore_zeros: the CUDA kernel has no backward; call it under "
            "torch.no_grad() or on a tensor that needs no gradient")
    if x.dtype != torch.float32:
        raise TypeError(f"tree_pool_ignore_zeros: x is {x.dtype}, needs torch.float32")
    if not x.is_contiguous():
        raise ValueError("tree_pool_ignore_zeros: x is not contiguous")
    groups = n >> steps
    if groups >= 2**31:
        raise ValueError(f"tree_pool_ignore_zeros: {groups} groups overflow the kernel's int32")
    lib = _library()
    if (steps + 1) * c > lib.tree_pool_iz_max_stack_floats():
        raise ValueError(f"tree_pool_ignore_zeros: (steps + 1)·C = {(steps + 1) * c} exceeds "
                         f"the kernel's {lib.tree_pool_iz_max_stack_floats()}")
    out = torch.empty((groups, c), device=x.device, dtype=torch.float32)
    if groups == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tree_pool_iz_f32(x.data_ptr(), out.data_ptr(), groups, c, steps, stream)
    if err != 0:
        raise RuntimeError(f"tree_pool_ignore_zeros: kernel launch failed (cudaError {err})")
    tree_pool_ignore_zeros.launches += 1
    return out


tree_pool_ignore_zeros.launches = 0
