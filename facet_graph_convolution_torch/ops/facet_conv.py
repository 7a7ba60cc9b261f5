"""K1: the facet-conv forward epilogue, gather fused in.

:func:`facet_conv_fwd` launches the hand-written CUDA kernel
``csrc/facet_conv_fwd.cu`` on CUDA tensors; it replaces
``facet_graph_convolution_tpu/ops/pallas_conv.py::_epilogue_fwd_kernel``
(launched by ``_conv_epilogue_fwd``). The source's head note says what bounds
it on an H100 (writing ``z``: it is memory-bound) and how its design, one warp
per node with the gather in the kernel, answers that.
:func:`facet_conv_fwd_plain` is the same function in plain PyTorch: the
wrapper takes it for CPU tensors, and the tests and ``chip_smoke.py`` hold the
kernel against it.

For node i and slot k = 0..K' (slot 0 = self; else j = ``adj_sm[k-1, i]-1``,
index 0 a pad):

    logits = ux[i] + vx[j] + c;  q = softmax_M(logits) · mult_rows[k, i]
    z[i, m·C + ch] = Σ_k q[m] · x[j, ch]

with ``cat = [x | vx]`` [N, C+M], ``ux`` [N, M], ``adj_sm`` [K', N] int32,
``mult_rows`` [K'+1, N] f32, ``c`` [M] → ``z`` [N, M·C] f32.
"""

from __future__ import annotations

import ctypes

import torch

from facet_graph_convolution_torch.ops import cuda_library


def facet_conv_fwd_plain(cat, ux, adj_sm, mult_rows, c):
    """Plain PyTorch K1: gather, softmax, multiply by mult, then einsum."""
    k_nbr, n = adj_sm.shape
    m = ux.shape[1]
    c_in = cat.shape[1] - m
    padded = torch.cat([cat.new_zeros(1, cat.shape[1]), cat], dim=0)
    gathered = padded.index_select(0, adj_sm.reshape(-1).long()).reshape(k_nbr, n, -1)
    slots = torch.cat([cat[None], gathered], dim=0)               # [K'+1, N, C+M]
    q = torch.softmax(ux[None] + slots[..., c_in:] + c, dim=-1)
    q = q * mult_rows[..., None]                                  # [K'+1, N, M]
    z = torch.einsum("knm,knc->nmc", q, slots[..., :c_in])
    return z.reshape(n, m * c_in)


def _library() -> ctypes.CDLL:
    lib = cuda_library.load("facet_conv_fwd")
    if lib.facet_conv_fwd_f32.argtypes is None:
        # c_void_p for every pointer: without argtypes ctypes would pass the
        # Python ints as 32-bit C ints and cut the addresses
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.facet_conv_fwd_f32.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.facet_conv_fwd_f32.restype = ctypes.c_int
        lib.facet_conv_fwd_max_c.restype = ctypes.c_int
        lib.facet_conv_fwd_max_m.restype = ctypes.c_int
    return lib


def _check(cat, ux, adj_sm, mult_rows, c):
    k_nbr, n = adj_sm.shape
    m = ux.shape[1]
    expect = {
        "cat": (cat, torch.float32, (n, cat.shape[1])),
        "ux": (ux, torch.float32, (n, m)),
        "adj_sm": (adj_sm, torch.int32, (k_nbr, n)),
        "mult_rows": (mult_rows, torch.float32, (k_nbr + 1, n)),
        "c": (c, torch.float32, (m,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != cat.device:
            raise ValueError(f"facet_conv_fwd: {name} on {t.device}, cat on {cat.device}")
        if t.dtype != dtype:
            raise TypeError(f"facet_conv_fwd: {name} is {t.dtype}, needs {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"facet_conv_fwd: {name} has shape {tuple(t.shape)}, needs {shape}")
        if not t.is_contiguous():
            raise ValueError(f"facet_conv_fwd: {name} is not contiguous")
    if cat.shape[1] <= m:
        raise ValueError(f"facet_conv_fwd: cat width {cat.shape[1]} leaves no channels for M={m}")
    if n >= 2**31:
        raise ValueError(f"facet_conv_fwd: N={n} overflows the kernel's int32 node index")


def facet_conv_fwd(cat, ux, adj_sm, mult_rows, c):
    """K1 on ``cat``'s device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Raises on any other device, and on shapes,
    dtypes or layouts the kernel does not take."""
    if cat.device.type == "cpu":
        return facet_conv_fwd_plain(cat, ux, adj_sm, mult_rows, c)
    if cat.device.type != "cuda":
        raise ValueError(f"facet_conv_fwd: no kernel for device {cat.device}")
    _check(cat, ux, adj_sm, mult_rows, c)
    k_nbr, n = adj_sm.shape
    m = ux.shape[1]
    c_in = cat.shape[1] - m
    lib = _library()
    if c_in > lib.facet_conv_fwd_max_c() or m > lib.facet_conv_fwd_max_m():
        raise ValueError(
            f"facet_conv_fwd: C={c_in}, M={m} exceed the kernel's "
            f"C<={lib.facet_conv_fwd_max_c()}, M<={lib.facet_conv_fwd_max_m()}")
    z = torch.empty((n, m * c_in), device=cat.device, dtype=torch.float32)
    with torch.cuda.device(cat.device):
        stream = torch.cuda.current_stream(cat.device).cuda_stream
        err = lib.facet_conv_fwd_f32(
            cat.data_ptr(), ux.data_ptr(), adj_sm.data_ptr(), mult_rows.data_ptr(),
            c.data_ptr(), z.data_ptr(), n, k_nbr, c_in, m, stream)
    if err != 0:
        raise RuntimeError(f"facet_conv_fwd: kernel launch failed (cudaError {err})")
    facet_conv_fwd.launches += 1
    return z


facet_conv_fwd.launches = 0
