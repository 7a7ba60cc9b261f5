"""K4: the zero-ignoring binary-tree pool.

:func:`tree_pool_ignore_zeros` launches the hand-written CUDA kernel
``csrc/tree_pool_iz.cu`` on CUDA tensors; it replaces
``facet_graph_convolution_tpu/ops/pallas_kernels.py::_pool_iz_kernel``
(launched by ``tree_pool_ignore_zeros``, two fused rounds), with the number
of rounds as an argument. The source's head note says what bounds it on an
H100 (bytes, at the sharded naive solver's C = 3 and up to 1.27M rows) and
how its design answers that: a lane a leaf row and the rounds by warp
shuffles for C <= 8 and up to 5 rounds, a team a group past those.
:func:`tree_pool_ignore_zeros_plain` is the same function in plain
PyTorch: the wrapper takes it for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernel against it, bit for bit.

Under autograd, :class:`TreePoolIgnoreZeros` is the pool with a backward:
the forward kernel, then ``tree_pool_iz_bwd`` (the same source), which
routes each cotangent by the plain version's ``where`` rule (a zero
sibling's share goes to its partner; -0.0 counts as zero). The JAX package
has no backward kernel for K4 (``jax.grad`` differentiates its plain
``tree_pool``); the port's sharded naive solver pools with K4 every
iteration, and a plain backward of 4 rounds is some 30 small launches an
iteration where the kernel is one. :func:`tree_pool_ignore_zeros_bwd_plain`
is autograd through the plain version: the CPU path and the reference.

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
        lib.tree_pool_iz_bwd_f32.argtypes = [p, p, p, i, i, i, p]
        lib.tree_pool_iz_bwd_f32.restype = ctypes.c_int
        lib.tree_pool_iz_max_stack_floats.restype = ctypes.c_int
        lib.tree_pool_iz_bwd_max_steps.restype = ctypes.c_int
    return lib


def tree_pool_ignore_zeros_bwd_plain(x: torch.Tensor, dy: torch.Tensor, steps: int = 2) -> torch.Tensor:
    """The pool's backward in plain PyTorch: autograd through
    :func:`tree_pool_ignore_zeros_plain` at ``x`` with cotangent ``dy``."""
    with torch.enable_grad():
        leaf = x.detach().requires_grad_()
        (dx,) = torch.autograd.grad(tree_pool_ignore_zeros_plain(leaf, steps), leaf, dy)
    return dx


def _check(x: torch.Tensor, steps: int, who: str) -> None:
    """The shapes, rounds and device every entry takes (both kernels')."""
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"{who}: x has shape {tuple(x.shape)}, needs [N, C>=1]")
    if not 0 <= steps <= 30:
        raise ValueError(f"{who}: steps={steps}, needs 0..30")
    if x.shape[0] % (1 << steps):
        raise ValueError(f"{who}: N={x.shape[0]} is not a multiple of 2^{steps}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: no kernel for device {x.device}")


def _check_card(t: torch.Tensor, name: str, who: str) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{who}: {name} is {t.dtype}, needs torch.float32")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} is not contiguous")


def _forward(x: torch.Tensor, steps: int) -> torch.Tensor:
    """The forward on ``x``'s device: the kernel on a CUDA tensor, the plain
    version on a CPU one (:func:`_check` done)."""
    if x.device.type == "cpu":
        return tree_pool_ignore_zeros_plain(x, steps)
    who = "tree_pool_ignore_zeros"
    _check_card(x, "x", who)
    n, c = x.shape
    groups = n >> steps
    if groups >= 2**31:
        raise ValueError(f"{who}: {groups} groups overflow the kernel's int32")
    lib = _library()
    if (steps + 1) * c > lib.tree_pool_iz_max_stack_floats():
        raise ValueError(f"{who}: (steps + 1)·C = {(steps + 1) * c} exceeds "
                         f"the kernel's {lib.tree_pool_iz_max_stack_floats()}")
    out = torch.empty((groups, c), device=x.device, dtype=torch.float32)
    if groups == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tree_pool_iz_f32(x.data_ptr(), out.data_ptr(), groups, c, steps, stream)
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed (cudaError {err})")
    tree_pool_ignore_zeros.launches += 1
    return out


def tree_pool_ignore_zeros_bwd(x: torch.Tensor, dy: torch.Tensor, steps: int = 2) -> torch.Tensor:
    """The pool's backward, ``dx`` [N, C] from the forward's input ``x`` and
    the cotangent ``dy`` [N / 2^steps, C]: the ``tree_pool_iz_bwd`` kernel
    on CUDA tensors, :func:`tree_pool_ignore_zeros_bwd_plain` on CPU ones.
    Raises on what the kernel does not take (more than its
    ``tree_pool_iz_bwd_max_steps()`` rounds among it)."""
    who = "tree_pool_ignore_zeros_bwd"
    _check(x, steps, who)
    n, c = x.shape
    if tuple(dy.shape) != (n >> steps, c) or dy.device != x.device:
        raise ValueError(f"{who}: dy {tuple(dy.shape)} on {dy.device}, needs "
                         f"{(n >> steps, c)} on {x.device}")
    if x.device.type == "cpu":
        return tree_pool_ignore_zeros_bwd_plain(x, dy, steps)
    _check_card(x, "x", who)
    _check_card(dy, "dy", who)
    lib = _library()
    if steps > lib.tree_pool_iz_bwd_max_steps():
        raise ValueError(f"{who}: steps={steps} exceeds the kernel's "
                         f"{lib.tree_pool_iz_bwd_max_steps()}")
    if (steps + 1) * c > lib.tree_pool_iz_max_stack_floats():
        raise ValueError(f"{who}: (steps + 1)·C = {(steps + 1) * c} exceeds "
                         f"the kernel's {lib.tree_pool_iz_max_stack_floats()}")
    dx = torch.empty_like(x)
    groups = n >> steps
    if groups == 0:
        return dx
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tree_pool_iz_bwd_f32(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), groups, c,
                                       steps, stream)
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed (cudaError {err})")
    tree_pool_ignore_zeros_bwd.launches += 1
    return dx


class TreePoolIgnoreZeros(torch.autograd.Function):
    """K4 with its backward: the forward kernel, and ``tree_pool_iz_bwd`` on
    the saved input (:func:`tree_pool_ignore_zeros_bwd`); on CPU tensors
    the plain forward and the plain backward."""

    @staticmethod
    def forward(ctx, x, steps: int):
        _check(x, steps, "tree_pool_ignore_zeros")
        ctx.steps = steps
        ctx.save_for_backward(x)
        return _forward(x, steps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return tree_pool_ignore_zeros_bwd(x, dy.contiguous(), ctx.steps), None


def tree_pool_ignore_zeros(x: torch.Tensor, steps: int = 2) -> torch.Tensor:
    """K4 on ``x``'s device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. On a CUDA tensor that needs a gradient under
    grad mode it runs :class:`TreePoolIgnoreZeros` (the backward kernel in
    the backward). Raises on any other device, and on shapes, dtypes or
    layouts the kernel does not take."""
    _check(x, steps, "tree_pool_ignore_zeros")
    if x.device.type == "cuda" and torch.is_grad_enabled() and x.requires_grad:
        return TreePoolIgnoreZeros.apply(x, steps)
    return _forward(x, steps)


tree_pool_ignore_zeros.launches = 0
tree_pool_ignore_zeros_bwd.launches = 0
