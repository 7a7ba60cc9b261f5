"""K4 redesigned: one scale of the naive multi-scale solver in one kernel.

:func:`naive_scale` runs every iteration of one scale of
:func:`~facet_graph_convolution_torch.ops.vertex_update.update_positions_multiscale`
in one cooperative launch of the hand-written CUDA kernel
``csrc/ms_solver_naive.cu`` on CUDA tensors, with the zero-ignoring tree
pool (K4, ``facet_graph_convolution_tpu/ops/pallas_kernels.py::
_pool_iz_kernel``) inside it. The source's head note says what bounds it on
an H100 (barriers and dependent loads) and how its design answers that.
:func:`naive_scale_plain` is the same loop in plain PyTorch, through
``face_centers_pyramid`` and ``tree_pool``: the wrapper takes it for CPU
tensors, and the tests and ``chip_smoke.py`` hold the kernel against it.

:func:`scale_centers` is the kernel's first phase alone (the level-s face
centres); only the checks use it, to hold the kernel's pool bit for bit
against :func:`tree_pool_ignore_zeros_plain` of its own level-0 centres.

One iteration at scale s, with ``shift = coarsening_steps·s`` (fine face f
lies in level-s node ``f >> shift``; a −1 pad stays negative):

    c_f = the zero-ignoring pool of shift rounds over the centroids of f's
          2^shift fine faces;  t_f = ⟨n_f, c_f⟩
    x_v += 1/|v_faces[v]| · Σ_k (t_{f_k} − ⟨n_{f_k}, x_v⟩) · n_{f_k}
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from facet_graph_convolution_torch.ops import cuda_library
from facet_graph_convolution_torch.ops.normalization import dot_last
from facet_graph_convolution_torch.ops.tree_pool_kernel import tree_pool_ignore_zeros_plain

_MAX_SHIFT = 30
_INT32_MAX = 2**31 - 1


def naive_scale_plain(x: torch.Tensor, faces: torch.Tensor, v_faces: torch.Tensor,
                      fn_s: torch.Tensor, scale: int, coarsening_steps: int,
                      iters: int) -> torch.Tensor:
    """Plain PyTorch: ``iters`` iterations of scale ``scale``; returns the
    new x. Face centres come from ``face_centers_pyramid`` (``scale``
    chained pools of ``coarsening_steps`` rounds)."""
    from facet_graph_convolution_torch.ops.vertex_update import (
        _solver_step_sizes,
        face_centers_pyramid,
    )

    lmbd = _solver_step_sizes(v_faces, x.dtype)[:, None]
    fn = fn_s.reshape(-1, 3)
    fn_pad = torch.cat([fn.new_zeros(1, 3), fn], dim=0)
    vf = torch.div(v_faces.long(), (2 ** coarsening_steps) ** scale, rounding_mode="floor") + 1
    v_fn = fn_pad[vf]                                              # [V, K, 3]
    for _ in range(int(iters)):
        fpos = face_centers_pyramid(x, faces, coarsening_steps, scale + 1)[scale]
        t_pad = torch.cat([fn.new_zeros(1), torch.sum(fn * fpos, dim=-1)])
        n_w = t_pad[vf] - dot_last(v_fn, x[:, None, :])           # [V, K]
        x = x + lmbd * torch.sum(n_w[..., None] * v_fn, dim=1)
    return x


def scale_centers_plain(x: torch.Tensor, faces: torch.Tensor, shift: int) -> torch.Tensor:
    """Plain PyTorch: the centroids of the fine faces (a −1 corner reads a
    zero vertex), pooled by ``shift`` zero-ignoring rounds: [F0 >> shift, 3]."""
    v_pad = torch.cat([x.new_zeros(1, 3), x], dim=0)
    return tree_pool_ignore_zeros_plain(v_pad[faces.long() + 1].mean(dim=1), shift)


def _library() -> ctypes.CDLL:
    lib = cuda_library.load("ms_solver_naive")
    if lib.ms_solver_naive_f32.argtypes is None:
        # c_void_p for the pointers and the stream: without argtypes ctypes
        # would pass the Python ints as 32-bit C ints and cut the addresses
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ms_solver_naive_f32.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.ms_solver_naive_f32.restype = ctypes.c_int
        lib.ms_solver_centers_f32.argtypes = [p, p, p, i, i, p]
        lib.ms_solver_centers_f32.restype = ctypes.c_int
        lib.ms_solver_naive_blocks_per_sm.argtypes = []
        lib.ms_solver_naive_blocks_per_sm.restype = ctypes.c_int
        lib.ms_solver_naive_grid.argtypes = [i, i, i]
        lib.ms_solver_naive_grid.restype = ctypes.c_int
    return lib


def _check_device(name: str, tensors, grad_tensors) -> bool:
    """True for CPU tensors (the plain version runs); raises on mixed or
    other devices and on a CUDA tensor that needs a gradient under grad."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in grad_tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; call it under "
            "torch.no_grad() or on tensors that need no gradient")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: an input is not contiguous")
    return False


def _check_x_faces(name: str, x: torch.Tensor, faces: torch.Tensor, shift: int):
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}, needs [V, 3]")
    if faces.dim() != 2 or faces.shape[1] != 3:
        raise ValueError(f"{name}: faces has shape {tuple(faces.shape)}, needs [F0, 3]")
    if not 0 <= shift <= _MAX_SHIFT:
        raise ValueError(f"{name}: shift={shift}, needs 0..{_MAX_SHIFT}")
    if faces.shape[0] % (1 << shift):
        raise ValueError(f"{name}: F0={faces.shape[0]} is not a multiple of 2^{shift}")
    if max(faces.shape[0], x.shape[0]) > _INT32_MAX // 3:
        raise ValueError(f"{name}: {faces.shape[0]} faces or {x.shape[0]} vertices overflow "
                         "the kernel's int32")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: x is {x.dtype}, needs torch.float32")
    if faces.dtype != torch.int32:
        raise TypeError(f"{name}: faces is {faces.dtype}, needs torch.int32")


def max_grid(device: torch.device) -> int:
    """The most blocks the solver kernel's cooperative launch takes on
    ``device``: all of them resident at once."""
    with torch.cuda.device(device):
        per_sm = _library().ms_solver_naive_blocks_per_sm()
        if per_sm < 1:
            raise RuntimeError(f"ms_solver_naive: occupancy query failed (cudaError {-per_sm})")
        return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def default_grid(device: torch.device, num_vertices: int, nodes: int, shift: int) -> int:
    """The blocks the work fills, one an SM at most (the kernel's own rule,
    from its source)."""
    with torch.cuda.device(device):
        grid = _library().ms_solver_naive_grid(num_vertices, nodes, shift)
    if grid < 1:
        raise RuntimeError(f"ms_solver_naive: grid query failed (cudaError {-grid})")
    return grid


def naive_scale(x: torch.Tensor, faces: torch.Tensor, v_faces: torch.Tensor,
                fn_s: torch.Tensor, scale: int, coarsening_steps: int, iters: int, *,
                grid: Optional[int] = None) -> torch.Tensor:
    """``iters`` iterations of scale ``scale`` on ``x``'s device: one launch
    of the CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    returns the new x (``x`` itself is not written). ``x`` [V, 3] and
    ``fn_s`` [F_s, 3] float32, ``faces`` [F_s·2^shift, 3] and ``v_faces``
    [V, K] int32, ``shift = coarsening_steps·scale``. ``grid`` overrides
    :func:`default_grid` (a measurement knob); a grid the card cannot hold
    resident raises. Raises on any other device, on shapes, dtypes or
    layouts the kernel does not take, and on a CUDA tensor that needs a
    gradient under grad mode (the kernel has no backward)."""
    name = "naive_scale"
    shift = coarsening_steps * scale
    _check_x_faces(name, x, faces, shift)
    if v_faces.dim() != 2 or v_faces.shape[0] != x.shape[0]:
        raise ValueError(f"{name}: v_faces has shape {tuple(v_faces.shape)}, needs "
                         f"[{x.shape[0]}, K]")
    nodes = faces.shape[0] >> shift
    if fn_s.dim() != 2 or tuple(fn_s.shape) != (nodes, 3):
        raise ValueError(f"{name}: fn_s has shape {tuple(fn_s.shape)}, needs "
                         f"[F0 / 2^{shift} = {nodes}, 3]")
    if iters < 0:
        raise ValueError(f"{name}: iters={iters}, needs >= 0")
    if v_faces.shape[0] * v_faces.shape[1] > _INT32_MAX:
        raise ValueError(f"{name}: v_faces {tuple(v_faces.shape)} overflows the kernel's int32")
    if fn_s.dtype != torch.float32:
        raise TypeError(f"{name}: fn_s is {fn_s.dtype}, needs torch.float32")
    if v_faces.dtype != torch.int32:
        raise TypeError(f"{name}: v_faces is {v_faces.dtype}, needs torch.int32")
    if _check_device(name, (x, faces, v_faces, fn_s), (x, fn_s)):
        return naive_scale_plain(x, faces, v_faces, fn_s, scale, coarsening_steps, iters)
    out = x.clone()
    if iters == 0 or x.shape[0] == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        if grid is None:
            grid = default_grid(x.device, x.shape[0], nodes, shift)
        t = torch.empty((nodes,), device=x.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ms_solver_naive_f32(out.data_ptr(), faces.data_ptr(), v_faces.data_ptr(),
                                      fn_s.data_ptr(), t.data_ptr(), x.shape[0],
                                      v_faces.shape[1], nodes, shift, int(iters), int(grid),
                                      stream)
    if err != 0:
        raise RuntimeError(f"naive_scale: cooperative launch of {grid} blocks failed "
                           f"(cudaError {err})")
    naive_scale.launches += 1
    return out


naive_scale.launches = 0


def scale_centers(x: torch.Tensor, faces: torch.Tensor, shift: int) -> torch.Tensor:
    """The kernel's phase A alone: the level-``shift`` face centres
    [F0 >> shift, 3] (shift 0: the fine centroids); the plain version for
    CPU tensors. For checks; the solver does not call it."""
    name = "scale_centers"
    _check_x_faces(name, x, faces, shift)
    if _check_device(name, (x, faces), (x,)):
        return scale_centers_plain(x, faces, shift)
    nodes = faces.shape[0] >> shift
    out = torch.empty((nodes, 3), device=x.device, dtype=torch.float32)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ms_solver_centers_f32(x.data_ptr(), faces.data_ptr(), out.data_ptr(), nodes,
                                        shift, stream)
    if err != 0:
        raise RuntimeError(f"scale_centers: kernel launch failed (cudaError {err})")
    return out
