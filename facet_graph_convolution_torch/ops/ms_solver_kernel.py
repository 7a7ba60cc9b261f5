"""K4 redesigned: one scale of the naive multi-scale solver in one kernel,
and its adjoint in another.

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

Under autograd :func:`naive_scale` goes through :class:`NaiveScale`: its
forward also stores the iterates, and its backward is
:func:`naive_scale_backward`, one cooperative launch of the adjoint kernel
``csrc/ms_solver_naive_bwd.cu`` on CUDA tensors (the JAX package leaves
this backward to XLA's differentiation of its ``fori_loop``), or
:func:`naive_scale_backward_plain`, the same reverse loop in plain PyTorch,
on CPU tensors.

:func:`scale_centers` is the kernel's first phase alone (the level-s face
centres); only the checks use it, to hold the kernel's pool bit for bit
against :func:`tree_pool_ignore_zeros_plain` of its own level-0 centres.

One iteration at scale s, with ``shift = coarsening_steps·s`` (fine face f
lies in level-s node ``f >> shift``; a −1 pad stays negative):

    c_f = the zero-ignoring pool of shift rounds over the centroids of f's
          2^shift fine faces;  t_f = ⟨n_f, c_f⟩
    x_v += λ_v · Σ_k (t_{f_k} − ⟨n_{f_k}, x_v⟩) · n_{f_k},  λ_v = 1/|v_faces[v]|

and its adjoint, from the cotangent g of the new x (a_vk = λ_v⟨n_{f_k}, g_v⟩):

    g t_f   = Σ_{slots (v, k) of f} a_vk
    g n_f  += g t_f · c_f + Σ_{slots of f} [λ_v (t_f − ⟨n_f, x_v⟩) g_v − a_vk x_v]
    g c_f   = g t_f · n_f, down the pool by the rule of ``jnp.where``'s
              gradient, then a third to each corner of each fine face
    g x_v   = g_v − Σ_k a_vk n_{f_k} + Σ_{corners of v} g leaf
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from facet_graph_convolution_torch.ops import cuda_library
from facet_graph_convolution_torch.ops.normalization import dot_last
from facet_graph_convolution_torch.ops.tree_pool_kernel import tree_pool_ignore_zeros_plain

_MAX_SHIFT = 30
_INT32_MAX = 2**31 - 1


def naive_scale_plain(x: torch.Tensor, faces: torch.Tensor, v_faces: torch.Tensor,
                      fn_s: torch.Tensor, scale: int, coarsening_steps: int,
                      iters: int, store: bool = False) -> torch.Tensor:
    """Plain PyTorch: ``iters`` iterations of scale ``scale``; returns the
    new x, or with ``store`` the iterates [iters + 1, V, 3] (x before each
    iteration, then the new x). Face centres come from
    ``face_centers_pyramid`` (``scale`` chained pools of
    ``coarsening_steps`` rounds)."""
    from facet_graph_convolution_torch.ops.vertex_update import (
        _solver_step_sizes,
        face_centers_pyramid,
    )

    lmbd = _solver_step_sizes(v_faces, x.dtype)[:, None]
    fn = fn_s.reshape(-1, 3)
    fn_pad = torch.cat([fn.new_zeros(1, 3), fn], dim=0)
    vf = torch.div(v_faces.long(), (2 ** coarsening_steps) ** scale, rounding_mode="floor") + 1
    v_fn = fn_pad[vf]                                              # [V, K, 3]
    xs = [x]
    for _ in range(int(iters)):
        fpos = face_centers_pyramid(x, faces, coarsening_steps, scale + 1)[scale]
        t_pad = torch.cat([fn.new_zeros(1), torch.sum(fn * fpos, dim=-1)])
        n_w = t_pad[vf] - dot_last(v_fn, x[:, None, :])           # [V, K]
        x = x + lmbd * torch.sum(n_w[..., None] * v_fn, dim=1)
        xs.append(x)
    return torch.stack(xs) if store else x


def pool_with_flags(c: torch.Tensor, rounds: int):
    """K4's plain rounds on [N, C], also returning each round's ``(a_zero,
    b_zero)`` flags [N_r / 2, 1], for :func:`pool_adjoint_plain`."""
    flags = []
    for _ in range(rounds):
        pair = c.reshape(-1, 2, c.shape[-1])
        a, b = pair[:, 0], pair[:, 1]
        a_zero = (a == 0).all(dim=-1, keepdim=True)
        b_zero = (b == 0).all(dim=-1, keepdim=True)
        c = (torch.where(a_zero, b, a) + torch.where(b_zero, a, b)) * 0.5
        flags.append((a_zero, b_zero))
    return c, flags


def pool_adjoint_plain(flags, g: torch.Tensor) -> torch.Tensor:
    """The cotangent of the pool's input from that of its output ``g``, by
    the gradient of ``jnp.where`` (``ops/pooling.py:33-40`` of the JAX
    package): beside a live row an all-zero one takes none of the
    cotangent and the live one all of it; two live or two zero rows take
    half each."""
    for a_zero, b_zero in reversed(flags):
        half = g * 0.5
        g_a = torch.where(a_zero, 0.0, half) + torch.where(b_zero, half, 0.0)
        g_b = torch.where(a_zero, half, 0.0) + torch.where(b_zero, 0.0, half)
        g = torch.stack([g_a, g_b], dim=1).reshape(-1, g.shape[-1])
    return g


def naive_scale_backward_plain(xs: torch.Tensor, faces: torch.Tensor, v_faces: torch.Tensor,
                               fn_s: torch.Tensor, scale: int, coarsening_steps: int,
                               g_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch: the adjoint of :func:`naive_scale_plain` from its
    iterates ``xs`` [iters + 1, V, 3] and the cotangent ``g_out`` [V, 3] of
    its result, the iterations in reverse; returns ``(g x, g fn_s)``. The
    transposes are ``index_add`` over every slot and corner, pads and −1
    corners adding zeros (no maps, no host synchronisation: a CUDA graph
    can capture it); the pool's adjoint is :func:`pool_adjoint_plain`."""
    from facet_graph_convolution_torch.ops.vertex_update import _solver_step_sizes

    shift = coarsening_steps * scale
    fn = fn_s.reshape(-1, 3)
    lmbd = _solver_step_sizes(v_faces, xs.dtype)[:, None]        # [V, 1]
    real = (v_faces >= 0).to(fn.dtype)                            # [V, K]
    node = torch.where(v_faces >= 0, v_faces.long() >> shift, 0)  # [V, K], pads at node 0
    v_fn = fn[node] * real[..., None]                             # [V, K, 3], 0 at pads
    slot_node = node.reshape(-1)
    faces_l = faces.long()
    corner = (faces_l >= 0).to(fn.dtype)[..., None]               # [F0, 3, 1]
    corner_v = faces_l.clamp(min=0).reshape(-1)
    g_x = g_out.clone()
    g_fn = torch.zeros_like(fn)
    for i in reversed(range(xs.shape[0] - 1)):
        x = xs[i]
        v_pad = torch.cat([x.new_zeros(1, 3), x], dim=0)
        c, flags = pool_with_flags(v_pad[faces_l + 1].mean(dim=1), shift)
        t = torch.sum(fn * c, dim=-1)                                 # [F_s]
        gl = lmbd * g_x                                               # λ_v g_v
        a = dot_last(v_fn, gl[:, None, :])                            # [V, K], 0 at pads
        g_t = torch.zeros_like(t).index_add_(0, slot_node, a.reshape(-1))
        n_w = (t[node] - dot_last(v_fn, x[:, None, :])) * real        # [V, K], 0 at pads
        g_vfn = n_w[..., None] * gl[:, None, :] - a[..., None] * x[:, None, :]
        g_fn = g_fn.index_add(0, slot_node, g_vfn.reshape(-1, 3))
        g_fn = g_fn + g_t[:, None] * c
        g_c = pool_adjoint_plain(flags, g_t[:, None] * fn)            # [F0, 3]
        g_leaf = (g_c / 3.0)[:, None, :] * corner                     # [F0, 3 corners, 3]
        g_x = g_x - torch.sum(a[..., None] * v_fn, dim=1)
        g_x = g_x.index_add(0, corner_v, g_leaf.reshape(-1, 3))
    return g_x, g_fn


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
        lib.ms_solver_naive_f32.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.ms_solver_naive_f32.restype = ctypes.c_int
        lib.ms_solver_centers_f32.argtypes = [p, p, p, i, i, p]
        lib.ms_solver_centers_f32.restype = ctypes.c_int
        lib.ms_solver_naive_blocks_per_sm.argtypes = []
        lib.ms_solver_naive_blocks_per_sm.restype = ctypes.c_int
        lib.ms_solver_naive_grid.argtypes = [i, i, i]
        lib.ms_solver_naive_grid.restype = ctypes.c_int
    return lib


def _adjoint_library() -> ctypes.CDLL:
    lib = cuda_library.load("ms_solver_naive_bwd")
    if lib.ms_solver_adjoint_f32.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ms_solver_adjoint_f32.argtypes = [p] * 12 + [i] * 6 + [p]
        lib.ms_solver_adjoint_f32.restype = ctypes.c_int
        lib.ms_solver_adjoint_grid.argtypes = [i, i, i]
        lib.ms_solver_adjoint_grid.restype = ctypes.c_int
    return lib


def _check_device(name: str, tensors) -> bool:
    """True for CPU tensors (the plain version runs); raises on mixed or
    other devices and, for CUDA tensors, on a non-contiguous one."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
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


def _check_scale(name, x, faces, v_faces, fn_s, scale, coarsening_steps, iters) -> int:
    """Raises on what the kernels do not take; returns the level-s nodes."""
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
    return nodes


def _check_maps(name, face_slots, corners, nodes: int, num_vertices: int, device):
    """Raises unless the maps are int32 CSR tables of ``nodes`` and
    ``num_vertices`` rows on ``device``, contiguous."""
    if face_slots is None or corners is None:
        raise ValueError(f"{name}: the backward kernel reads the face→slot and vertex→corner "
                         "maps: pass face_slots and corners (ops/vertex_update.py::"
                         "build_naive_maps, built once a patch)")
    for label, (offsets, ids), rows in (("face_slots", face_slots, nodes),
                                        ("corners", corners, num_vertices)):
        if offsets.shape != (rows + 1,) or ids.dim() != 1:
            raise ValueError(f"{name}: {label} has offsets {tuple(offsets.shape)}, needs "
                             f"[{rows + 1}], and ids {tuple(ids.shape)}, needs [nnz]")
        for t in (offsets, ids):
            if t.dtype != torch.int32 or t.device != device or not t.is_contiguous():
                raise ValueError(f"{name}: {label} needs contiguous int32 tensors on {device}")


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


def _kernel_forward(x, faces, v_faces, fn_s, nodes, shift, iters, grid, store: bool):
    """One launch of the scale kernel; returns the new x and, with
    ``store``, the iterates [iters + 1, V, 3] (else None)."""
    out = x.clone()
    xs = torch.empty((iters + 1, *x.shape), device=x.device, dtype=x.dtype) if store else None
    if store:
        xs[0].copy_(x)
    if iters == 0 or x.shape[0] == 0:
        return out, xs
    lib = _library()
    with torch.cuda.device(x.device):
        if grid is None:
            grid = default_grid(x.device, x.shape[0], nodes, shift)
        t = torch.empty((nodes,), device=x.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ms_solver_naive_f32(out.data_ptr(), faces.data_ptr(), v_faces.data_ptr(),
                                      fn_s.data_ptr(), t.data_ptr(),
                                      xs.data_ptr() if store else None, x.shape[0],
                                      v_faces.shape[1], nodes, shift, int(iters), int(grid),
                                      stream)
    if err != 0:
        raise RuntimeError(f"naive_scale: cooperative launch of {grid} blocks failed "
                           f"(cudaError {err})")
    naive_scale.launches += 1
    return out, xs


def _forward(x, faces, v_faces, fn_s, scale, coarsening_steps, iters, grid, store, on_cpu):
    """The scale on x's device: (new x, iterates or None)."""
    if on_cpu:
        out = naive_scale_plain(x, faces, v_faces, fn_s, scale, coarsening_steps, iters,
                                store=store)
        return (out[-1].clone(), out) if store else (out, None)
    return _kernel_forward(x, faces, v_faces, fn_s, faces.shape[0] >> (coarsening_steps * scale),
                           coarsening_steps * scale, iters, grid, store)


class NaiveScale(torch.autograd.Function):
    """:func:`naive_scale` under autograd. The forward runs the scale
    storing its iterates (the scale kernel with its store on the card, the
    plain loop on the CPU); the backward is :func:`naive_scale_backward`
    from them. With ``checkpoint`` (``cfg.eval.solver_remat``) the forward
    keeps only its start point and the backward reruns it with the store:
    the same iterates, so the same gradients bit for bit."""

    @staticmethod
    def forward(ctx, x, fn_s, faces, v_faces, slot_off, slot_ids, corner_off, corner_ids,
                scale, coarsening_steps, iters, grid, checkpoint):
        on_cpu = x.device.type == "cpu"
        out, xs = _forward(x, faces, v_faces, fn_s, scale, coarsening_steps, iters, grid,
                           not checkpoint, on_cpu)
        ctx.save_for_backward(x if checkpoint else xs, fn_s, faces, v_faces, slot_off,
                              slot_ids, corner_off, corner_ids)
        ctx.args = (scale, coarsening_steps, iters, grid, checkpoint, on_cpu)
        return out

    @staticmethod
    def backward(ctx, g_out):
        saved, fn_s, faces, v_faces, slot_off, slot_ids, corner_off, corner_ids = (
            ctx.saved_tensors)
        scale, coarsening_steps, iters, grid, checkpoint, on_cpu = ctx.args
        xs = saved
        if checkpoint:
            xs = _forward(saved, faces, v_faces, fn_s, scale, coarsening_steps, iters, grid,
                          True, on_cpu)[1]
        maps = {} if on_cpu else dict(face_slots=(slot_off, slot_ids),
                                      corners=(corner_off, corner_ids))
        # the adjoint takes its own grid (adjoint_grid), not the forward's
        g_x, g_fn = naive_scale_backward(xs, faces, v_faces, fn_s, scale, coarsening_steps,
                                         g_out.contiguous(), **maps)
        return (g_x, g_fn) + (None,) * 11


def naive_scale(x: torch.Tensor, faces: torch.Tensor, v_faces: torch.Tensor,
                fn_s: torch.Tensor, scale: int, coarsening_steps: int, iters: int, *,
                grid: Optional[int] = None, face_slots=None, corners=None,
                checkpoint: bool = False) -> torch.Tensor:
    """``iters`` iterations of scale ``scale`` on ``x``'s device: one launch
    of the CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    returns the new x (``x`` itself is not written). ``x`` [V, 3] and
    ``fn_s`` [F_s, 3] float32, ``faces`` [F_s·2^shift, 3] and ``v_faces``
    [V, K] int32, ``shift = coarsening_steps·scale``. ``grid`` overrides
    :func:`default_grid` (a measurement knob); a grid the card cannot hold
    resident raises. Raises on any other device, and on shapes, dtypes or
    layouts the kernel does not take.

    Where ``x`` or ``fn_s`` needs a gradient under grad mode it runs
    :class:`NaiveScale`, whose backward on the card is the adjoint kernel:
    it reads this scale's face→slot map ``face_slots`` and the
    vertex→corner map ``corners`` (``(offsets, ids)`` each, from
    ``ops/vertex_update.py::build_naive_maps``), and raises without them.
    ``checkpoint`` reruns the forward in the backward instead of keeping
    the iterates."""
    name = "naive_scale"
    nodes = _check_scale(name, x, faces, v_faces, fn_s, scale, coarsening_steps, iters)
    on_cpu = _check_device(name, (x, faces, v_faces, fn_s))
    if not (torch.is_grad_enabled() and (x.requires_grad or fn_s.requires_grad)):
        return _forward(x, faces, v_faces, fn_s, scale, coarsening_steps, iters, grid, False,
                        on_cpu)[0]
    if not on_cpu:
        _check_maps(name, face_slots, corners, nodes, x.shape[0], x.device)
    return NaiveScale.apply(x, fn_s, faces, v_faces, *(face_slots or (None, None)),
                            *(corners or (None, None)), scale, coarsening_steps, int(iters), grid,
                            bool(checkpoint))


naive_scale.launches = 0


def adjoint_grid(device: torch.device, num_vertices: int, nodes: int, shift: int) -> int:
    """The adjoint kernel's grid: the blocks its work fills, one an SM at
    most (its source's rule)."""
    with torch.cuda.device(device):
        grid = _adjoint_library().ms_solver_adjoint_grid(num_vertices, nodes, shift)
    if grid < 1:
        raise RuntimeError(f"ms_solver_naive_bwd: grid query failed (cudaError {-grid})")
    return grid


def naive_scale_backward(xs: torch.Tensor, faces: torch.Tensor, v_faces: torch.Tensor,
                         fn_s: torch.Tensor, scale: int, coarsening_steps: int,
                         g_out: torch.Tensor, *, face_slots=None, corners=None,
                         grid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The adjoint of one scale from its iterates ``xs`` [iters + 1, V, 3]
    (as :class:`NaiveScale`'s forward stores them) and the cotangent
    ``g_out`` [V, 3] of its result: ``(g x [V, 3], g fn_s [F_s, 3])``. One
    cooperative launch of the adjoint kernel for CUDA tensors, which reads
    the maps of :func:`naive_scale`; :func:`naive_scale_backward_plain`
    for CPU tensors. ``grid`` overrides :func:`adjoint_grid`."""
    name = "naive_scale_backward"
    if xs.dim() != 3 or xs.shape[0] < 1:
        raise ValueError(f"{name}: xs has shape {tuple(xs.shape)}, needs [iters + 1, V, 3]")
    iters = xs.shape[0] - 1
    nodes = _check_scale(name, xs[0], faces, v_faces, fn_s, scale, coarsening_steps, iters)
    if g_out.shape != xs.shape[1:] or g_out.dtype != torch.float32:
        raise ValueError(f"{name}: g_out is {g_out.dtype} {tuple(g_out.shape)}, needs float32 "
                         f"{tuple(xs.shape[1:])}")
    if _check_device(name, (xs, faces, v_faces, fn_s, g_out)):
        return naive_scale_backward_plain(xs, faces, v_faces, fn_s, scale, coarsening_steps,
                                          g_out)
    _check_maps(name, face_slots, corners, nodes, xs.shape[1], xs.device)
    from facet_graph_convolution_torch.ops.vertex_update import _solver_step_sizes

    g_x = g_out.clone()
    g_fn = torch.zeros_like(fn_s)
    num_vertices, shift = xs.shape[1], coarsening_steps * scale
    if iters == 0 or num_vertices == 0:
        return g_x, g_fn
    lib = _adjoint_library()
    with torch.cuda.device(xs.device):
        if grid is None:
            grid = adjoint_grid(xs.device, num_vertices, nodes, shift)
        lmbd = _solver_step_sizes(v_faces, torch.float32)
        g_leaf = torch.empty_like(faces, dtype=torch.float32)          # [F0, 3]
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        ptrs = [t.data_ptr() for t in (xs, faces, v_faces, fn_s, lmbd, *face_slots, *corners,
                                       g_x, g_fn, g_leaf)]
        err = lib.ms_solver_adjoint_f32(*ptrs, num_vertices, v_faces.shape[1], nodes, shift,
                                        iters, int(grid), stream)
    if err != 0:
        raise RuntimeError(f"naive_scale_backward: cooperative launch of {grid} blocks failed "
                           f"(cudaError {err})")
    naive_scale_backward.launches += 1
    return g_x, g_fn


naive_scale_backward.launches = 0


def scale_centers(x: torch.Tensor, faces: torch.Tensor, shift: int) -> torch.Tensor:
    """The kernel's phase A alone: the level-``shift`` face centres
    [F0 >> shift, 3] (shift 0: the fine centroids); the plain version for
    CPU tensors. For checks; the solver does not call it."""
    name = "scale_centers"
    _check_x_faces(name, x, faces, shift)
    if _check_device(name, (x, faces)):
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
