"""K5: the whole facet conv of an HBM-scale level in one pass, forward and
backward, over the windowed slab tables (the port's counterpart of
``facet_graph_convolution_tpu/ops/windowed_conv.py``).

A level of about a million rows ordered by RCM (``TrainingSet``'s default
``reorder="rcm"``) keeps every row's neighbours in a narrow band of
indices; :func:`..graph.convert.windowed_lane_tables` cuts the output rows
into slabs, each reading one window of source rows. Over those tables K5
computes the conv's whole epilogue for a row: the gather, the softmax
assignment, the multiplicity and degree weights, the slot sum into the
aggregate ``z`` [M·C], and the transform ``y = W_flat · z``. So ``z`` never
reaches device memory, nor does its cotangent ``dz`` in the backward; the
flat path (K1, then a GEMM) writes ``z`` and reads it back, and keeps it for
the backward.

In the port's row-major layout, with ``cat = [x | x·vᵀ]`` [N_src, C+M] (in
the compute dtype; N_src > N on a shard with halo rows after its own),
``ux = x·uᵀ`` [N, M], ``wf`` [out, M·C] (``w.permute(1, 0, 2).reshape``),
``c`` [M] and ``mult_rows`` [K'+1, N] f32 (slot 0 the row itself), for row i
and slot k with source row j:

    logits = (ux[i] + cat[j, C:]) + c;  s = softmax_M(logits)
    q = s · mult_rows[k, i];  z[i, m·C + ch] = Σ_k q[m] · cat[j, ch]
    y[i] = wf · z[i]                   (f32, the bias not added)

In bfloat16 the casts are the JAX package's (``windowed_conv.py:96-98,
120-127``): the logits are summed in bfloat16, the softmax is f32, ``q`` is
rounded to bfloat16, each product ``q · x`` is rounded before the f32 slot
sum, ``z`` and ``wf`` are rounded before their f32 product; in the backward
``dz = wf_bf16ᵀ · gy`` is f32, the slots' cotangents are rounded, and
``dcat`` is their f32 sum rounded once (JAX sums it in bfloat16: the one
difference kept). ``ux`` and ``wf`` come in f32; their cotangents and
``dc`` are f32.

:func:`windowed_conv_fwd` launches ``csrc/windowed_conv_fwd.cu`` and
:func:`windowed_conv_bwd` ``csrc/windowed_conv_bwd.cu`` on CUDA tensors (the
products ``z · wfᵀ``, ``gy · wf`` and ``gyᵀ · z`` on the tensor cores: 3xTF32
in float32, bf16 ``mma`` forward and 2xTF32 backward in bfloat16; any M and
any width, refused only where a block's shared memory cannot hold the
smallest tile); on
CPU tensors they run :func:`windowed_fused_conv_fwd_plain` and
:func:`windowed_fused_conv_bwd_plain`, the JAX package's slab recursion in
PyTorch ops with its cast points, which the tests and ``chip_smoke.py`` hold
the kernels against. Each wrapper counts its launches (``.launches``) and,
among them, its bfloat16 ones (``.launches_bf16``). The JAX package has no
Pallas kernel here: its counterpart is an XLA scan over the slabs.
:func:`make_windowed_fused_conv` is the conv as a
``torch.autograd.Function`` (JAX's ``custom_vjp``).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from facet_graph_convolution_torch.ops import cuda_library
from facet_graph_convolution_torch.ops.facet_conv_kernel import ENTRY_SUFFIX

def _geometry(geometry) -> Tuple[int, int, int, int, int]:
    block, window, bwd_window, num_sources, num_out = map(int, geometry)
    return block, window, bwd_window, num_sources, num_out


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' f32 (float64 when the inputs are float64)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _rows(t: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    """Rows ``idx`` (any shape) of the 2-d ``t``, as ``shape + [width]``."""
    return t.index_select(0, idx.reshape(-1).long()).reshape(*shape, t.shape[1])


def _tail_pad(cat: torch.Tensor, num_out: int) -> torch.Tensor:
    """The halo rows after a zero row: ``tailT`` is one-indexed into them."""
    return torch.cat([cat.new_zeros(1, cat.shape[1]), cat[num_out:]], dim=0)


def _slab_sources(cat, tail_pad, tabs, b, geometry):
    """[K, block, C+M]: slab ``b``'s gathered neighbour rows (the JAX gather
    of ``make_windowed_lane_gather``: pad slots read a clamped row of the
    window, halo slots the halo rows)."""
    block, window, _, num_sources, num_out = geometry
    relT = tabs[2]
    ws = int(tabs[1][b])
    k = relT.shape[1]
    g = _rows(cat[ws:ws + window], relT[b], (k, block))
    if num_sources > num_out:
        not_tail, tailT = tabs[7], tabs[8]
        g = g * not_tail[b].to(cat.dtype)[..., None] + _rows(tail_pad, tailT[b], (k, block))
    return g


def _slab_forward(cat, tail_pad, ux, c, mult_rows, tabs, b, geometry, in_ch):
    """JAX ``_slab_forward`` for slab ``b``, row-major: ``(nbr [K+1, block,
    C+M], mr [K+1, block], q_raw, q [K+1, block, M], x_nbr, z [block, M,
    C] f32)`` with the casts of ``cat``'s dtype."""
    block = geometry[0]
    dtype, acc = cat.dtype, _acc(cat.dtype)
    os_ = int(tabs[0][b])
    g = _slab_sources(cat, tail_pad, tabs, b, geometry)
    nbr = torch.cat([cat[os_:os_ + block][None], g], dim=0)
    mr = mult_rows[:, os_:os_ + block]
    logits = ux[os_:os_ + block].to(dtype)[None] + nbr[..., in_ch:] + c.to(dtype)
    q_raw = torch.softmax(logits.to(acc), dim=-1)
    q = (q_raw * mr[..., None]).to(dtype)
    x_nbr = nbr[..., :in_ch]
    # the products in the compute dtype, summed in f32 (JAX's sum(q·x))
    z = (q[..., :, None] * x_nbr[..., None, :]).sum(dim=0, dtype=acc)
    return nbr, mr, q_raw, q, x_nbr, z


def windowed_fused_conv_fwd_plain(geometry, cat, ux, wf, c, mult_rows, tabs) -> torch.Tensor:
    """Plain PyTorch K5: JAX's forward scan over the slabs in slab order
    (the last slab's rows overwrite the overlap), ``y`` [N, out] f32."""
    geometry = _geometry(geometry)
    block, _, _, num_sources, num_out = geometry
    dtype, acc = cat.dtype, _acc(cat.dtype)
    m = ux.shape[1]
    in_ch = cat.shape[1] - m
    tail_pad = _tail_pad(cat, num_out) if num_sources > num_out else None
    wf_t = wf.to(dtype).to(acc).t()
    y = torch.zeros((num_out, wf.shape[0]), dtype=acc, device=cat.device)
    for b in range(tabs[0].shape[0]):
        z = _slab_forward(cat, tail_pad, ux, c, mult_rows, tabs, b, geometry, in_ch)[-1]
        os_ = int(tabs[0][b])
        y[os_:os_ + block] = z.reshape(block, m * in_ch).to(dtype).to(acc) @ wf_t
    return y


def windowed_fused_conv_bwd_plain(geometry, cat, ux, wf, c, mult_rows, tabs, gy):
    """Plain PyTorch K5 backward (JAX ``_bwd`` of ``make_windowed_fused_conv``):
    ``(dcat [N_src, C+M] in cat's dtype, dux [N, M] f32, dwf [out, M·C] f32,
    dc [M] f32)`` for the cotangent ``gy`` [N, out] f32.

    Each slab recomputes its forward; ``dz = gy · wf``, and per slot ``dq``,
    ``dx``, ``dlog`` give its cotangent row ``[dx | dlog]`` (in cat's
    dtype), the self slot's into ``dcat_self`` and the others' into ``dG``
    [K, N, C+M]; ``dwf`` and ``dc`` count each row once (the last slab's
    rows that its predecessor covered are masked, JAX's ``fresh_off``).
    Then each source row sums its slots' rows through ``relS`` / ``validS``
    (and the halo rows through ``tailS`` / ``tailV``) in f32, with its self
    row, rounded once."""
    geometry = _geometry(geometry)
    block, _, bwd_window, num_sources, num_out = geometry
    dtype, acc = cat.dtype, _acc(cat.dtype)
    out_starts, bwd_starts, relS, validS = tabs[0], tabs[4], tabs[5], tabs[6]
    cm = cat.shape[1]
    m = ux.shape[1]
    in_ch = cm - m
    k = tabs[2].shape[1]
    dev = cat.device
    prev_end = torch.cat([out_starts.new_zeros(1), out_starts[:-1] + block])
    fresh_off = torch.clamp(prev_end - out_starts, min=0)
    tail_pad = _tail_pad(cat, num_out) if num_sources > num_out else None
    wf_f = wf.to(dtype).to(acc)
    dG = torch.zeros((k, num_out, cm), dtype=dtype, device=dev)
    dcat_self = torch.zeros((num_out, cm), dtype=dtype, device=dev)
    dux = torch.zeros((num_out, m), dtype=acc, device=dev)
    dw = torch.zeros(wf.shape, dtype=acc, device=dev)
    dc = torch.zeros((m,), dtype=acc, device=dev)
    for b in range(out_starts.shape[0]):
        os_ = int(out_starts[b])
        _, mr, q_raw, q, x_nbr, z = _slab_forward(cat, tail_pad, ux, c, mult_rows, tabs, b,
                                                  geometry, in_ch)
        gy_s = gy[os_:os_ + block]
        fresh = (torch.arange(block, device=dev) >= fresh_off[b]).to(acc)[:, None]
        z_dt = z.reshape(block, m * in_ch).to(dtype)
        dz = (gy_s @ wf_f).reshape(block, m, in_ch)
        dw += (gy_s * fresh).t() @ z_dt.to(acc)
        dq = (dz[None] * x_nbr[:, :, None, :].to(acc)).sum(dim=-1)        # [K+1, block, M]
        dx_nbr = (dz[None] * q[..., None].to(acc)).sum(dim=2).to(dtype)    # [K+1, block, C]
        dq_raw = dq * mr[..., None]
        dlog = q_raw * (dq_raw - (q_raw * dq_raw).sum(dim=-1, keepdim=True))
        dc += (dlog * fresh[None]).sum(dim=(0, 1))
        dux[os_:os_ + block] = dlog.sum(dim=0)
        dnbr = torch.cat([dx_nbr, dlog.to(dtype)], dim=-1)                 # [K+1, block, CM]
        dcat_self[os_:os_ + block] = dnbr[0]
        dG[:, os_:os_ + block] = dnbr[1:]

    dcat = torch.zeros((num_out, cm), dtype=acc, device=dev)
    s = relS.shape[1]
    for b in range(out_starts.shape[0]):
        os_, bs = int(out_starts[b]), int(bwd_starts[b])
        gwin = dG[:, bs:bs + bwd_window].reshape(k * bwd_window, cm)
        d = _rows(gwin, relS[b], (s, block)).to(acc) * validS[b][..., None]
        dcat[os_:os_ + block] = d.sum(dim=0)
    dcat = (dcat + dcat_self.to(acc)).to(dtype)
    if num_sources > num_out:
        tailS, tailV = tabs[9], tabs[10]
        dt = _rows(dG.reshape(k * num_out, cm), tailS, tailS.shape).to(acc) * tailV[..., None]
        dcat = torch.cat([dcat, dt.sum(dim=0).to(dtype)], dim=0)
    return dcat, dux, dw, dc


def _library(name: str) -> ctypes.CDLL:
    lib = cuda_library.load(name)
    entry = getattr(lib, name + "_f32")
    if entry.argtypes is None:
        # c_void_p for the pointers and the stream: without argtypes ctypes
        # would pass the Python ints as 32-bit C ints and cut the addresses
        p, i = ctypes.c_void_p, ctypes.c_int
        args = ([p] * 11 + [i] * 8 + [p] if name == "windowed_conv_fwd"
                else [p] * 24 + [i] * 13 + [p])
        for sfx in ENTRY_SUFFIX.values():
            getattr(lib, name + sfx).argtypes = args
            getattr(lib, name + sfx).restype = ctypes.c_int
        if name == "windowed_conv_bwd":
            lib.windowed_conv_bwd_partials.argtypes = [i] * 5 + [p]
            lib.windowed_conv_bwd_partials.restype = None
        nbytes = getattr(lib, name + "_bytes")
        nbytes.argtypes = [i] * (9 if name == "windowed_conv_fwd" else 11)
        nbytes.restype = ctypes.c_double
    return lib


def _sizes(geometry, cat, ux, wf, tabs):
    """The C entries' sizes after the pointers: N, N_src, C, M, out, K',
    block, slabs."""
    block, _, _, num_sources, num_out = geometry
    m = ux.shape[1]
    return (num_out, num_sources, cat.shape[1] - m, m, wf.shape[0], tabs[2].shape[1], block,
            tabs[0].shape[0])


def device_bytes(geometry, cat, ux, wf, tabs):
    """The device-memory bytes of one launch of K5's forward and of its
    backward on these inputs, as the C entries count them under the
    kernels' plans (card only: builds the libraries): ``{"fwd": bytes,
    "bwd": bytes}``."""
    geometry = _geometry(geometry)
    sizes = _sizes(geometry, cat, ux, wf, tabs)
    bf16 = int(cat.dtype == torch.bfloat16)
    s_tail = tabs[9].shape[0] if geometry[3] > geometry[4] else 0
    return {"fwd": _library("windowed_conv_fwd").windowed_conv_fwd_bytes(*sizes, bf16),
            "bwd": _library("windowed_conv_bwd").windowed_conv_bwd_bytes(
                *sizes, tabs[5].shape[1], s_tail, bf16)}


def _too_big(kernel, m, in_ch, out, k):
    return ValueError(f"{kernel}: M={m}, C={in_ch}, out={out}, K'={k}: the smallest tile "
                      "(16 rows: their softmax rows and, in the backward, dz's M·C and gy's "
                      "out floats a row) needs more than the 227 KB of shared memory a block "
                      "can use")


def _check(kernel, geometry, cat, ux, wf, c, mult_rows, tabs, **extra):
    """Refuse what the kernels do not take: on every device the shapes and
    dtypes, on the card also the layouts and the limits."""
    block, window, bwd_window, num_sources, num_out = geometry
    if cat.dtype not in ENTRY_SUFFIX:
        raise TypeError(f"{kernel}: cat is {cat.dtype}; the kernel takes "
                        f"{sorted(str(d) for d in ENTRY_SUFFIX)}")
    has_tail = num_sources > num_out
    if len(tabs) != (11 if has_tail else 7):
        raise ValueError(f"{kernel}: {len(tabs)} window tables for a geometry "
                         f"{'with' if has_tail else 'without'} halo rows")
    m = ux.shape[1]
    in_ch = cat.shape[1] - m
    nblk, k = tabs[2].shape[:2]
    s = tabs[5].shape[1]
    expect = {
        "cat": (cat, cat.dtype, (num_sources, cat.shape[1])),
        "ux": (ux, ux.dtype, (num_out, m)),
        "wf": (wf, wf.dtype, (wf.shape[0], m * in_ch)),
        "c": (c, torch.float32, (m,)),
        "mult_rows": (mult_rows, torch.float32, (k + 1, num_out)),
        "out_starts": (tabs[0], torch.int32, (nblk,)),
        "win_starts": (tabs[1], torch.int32, (nblk,)),
        "relT": (tabs[2], torch.int32, (nblk, k, block)),
        "bwd_starts": (tabs[4], torch.int32, (nblk,)),
        "relS": (tabs[5], torch.int32, (nblk, s, block)),
        "validS": (tabs[6], torch.bool, (nblk, s, block)),
        **extra,
    }
    if has_tail:
        h = num_sources - num_out
        expect.update(not_tail=(tabs[7], torch.bool, (nblk, k, block)),
                      tailT=(tabs[8], torch.int32, (nblk, k, block)),
                      tailS=(tabs[9], torch.int32, (tabs[9].shape[0], h)),
                      tailV=(tabs[10], torch.bool, (tabs[9].shape[0], h)))
    for name, (t, dtype, shape) in expect.items():
        if t.device != cat.device:
            raise ValueError(f"{kernel}: {name} on {t.device}, cat on {cat.device}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, needs {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, needs {shape}")
        if cat.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
    if ux.dtype not in (torch.float32, cat.dtype) or wf.dtype not in (torch.float32, cat.dtype):
        raise TypeError(f"{kernel}: ux {ux.dtype} and wf {wf.dtype} must be float32 or "
                        f"cat's {cat.dtype}")
    if in_ch < 1:
        raise ValueError(f"{kernel}: cat width {cat.shape[1]} leaves no channels for M={m}")
    if cat.device.type == "cuda":
        if (k + 1) * num_out >= 2**31 or num_sources >= 2**31 // max(cat.shape[1], 1):
            raise ValueError(f"{kernel}: N={num_out}, K'={k} overflow the kernel's int32 rows")


def _tables_args(tabs, has_tail):
    """The table pointers in the C entries' order (null for the halo pack
    at a geometry without halo rows)."""
    ptr = [t.data_ptr() for t in tabs]
    tail = ptr[7:11] if has_tail else [None] * 4
    return ptr[0:3] + tail[0:2], [ptr[0], ptr[4], ptr[5], ptr[6]] + tail[2:4]


def windowed_conv_fwd(geometry, cat, ux, wf, c, mult_rows, tabs) -> torch.Tensor:
    """K5 on ``cat``'s device: ``y`` [N, out] f32 from the CUDA kernel for
    CUDA tensors, from :func:`windowed_fused_conv_fwd_plain` for CPU
    tensors. ``ux`` and ``wf`` may be f32 (rounded to cat's dtype here, as
    JAX casts them) or in cat's dtype. Raises on any other device and on
    what the kernel does not take."""
    geometry = _geometry(geometry)
    _check("windowed_conv_fwd", geometry, cat, ux, wf, c, mult_rows, tabs)
    if cat.device.type == "cpu":
        return windowed_fused_conv_fwd_plain(geometry, cat, ux, wf, c, mult_rows, tabs)
    if cat.device.type != "cuda":
        raise ValueError(f"windowed_conv_fwd: no kernel for device {cat.device}")
    num_sources, num_out = geometry[3:5]
    # the kernel reads wf transposed, [M·C, out], its rows padded with zeros
    # to 16 bytes (the 16-byte cp.async copies)
    out = wf.shape[0]
    wft = torch.zeros((wf.shape[1], out + -out % (16 // cat.element_size())),
                      dtype=cat.dtype, device=cat.device)
    wft[:, :out] = wf.t()
    ux = ux.to(cat.dtype).contiguous()
    lib = _library("windowed_conv_fwd")
    fwd_tabs, _ = _tables_args(tabs, num_sources > num_out)
    sizes = _sizes(geometry, cat, ux, wf, tabs)
    in_ch, m, _, k = sizes[2:6]
    if lib.windowed_conv_fwd_bytes(*sizes, int(cat.dtype == torch.bfloat16)) < 0:
        raise _too_big("windowed_conv_fwd", m, in_ch, out, k)
    y = torch.empty((num_out, out), dtype=torch.float32, device=cat.device)
    with torch.cuda.device(cat.device):
        stream = torch.cuda.current_stream(cat.device).cuda_stream
        err = getattr(lib, "windowed_conv_fwd" + ENTRY_SUFFIX[cat.dtype])(
            cat.data_ptr(), ux.data_ptr(), wft.data_ptr(), c.data_ptr(), mult_rows.data_ptr(),
            *fwd_tabs, y.data_ptr(), *sizes, stream)
    if err != 0:
        raise RuntimeError(f"windowed_conv_fwd: kernel launch failed (cudaError {err})")
    windowed_conv_fwd.launches += 1
    if cat.dtype == torch.bfloat16:
        windowed_conv_fwd.launches_bf16 += 1
    return y


windowed_conv_fwd.launches = 0
windowed_conv_fwd.launches_bf16 = 0


def windowed_conv_bwd(geometry, cat, ux, wf, c, mult_rows, tabs, gy):
    """K5's backward on ``cat``'s device: ``(dcat [N_src, C+M] in cat's
    dtype, dux [N, M] f32, dwf [out, M·C] f32, dc [M] f32)`` from the CUDA
    kernels for CUDA tensors (one launch of the entry: its passes, then the
    fixed-order sums of the per-block dwf and dc partials; no atomics), from
    :func:`windowed_fused_conv_bwd_plain` for CPU tensors."""
    geometry = _geometry(geometry)
    block, _, bwd_window, num_sources, num_out = geometry
    _check("windowed_conv_bwd", geometry, cat, ux, wf, c, mult_rows, tabs,
           gy=(gy, torch.float32, (num_out, wf.shape[0])))
    if cat.device.type == "cpu":
        return windowed_fused_conv_bwd_plain(geometry, cat, ux, wf, c, mult_rows, tabs, gy)
    if cat.device.type != "cuda":
        raise ValueError(f"windowed_conv_bwd: no kernel for device {cat.device}")
    ux, wf_dt = ux.to(cat.dtype).contiguous(), wf.to(cat.dtype).contiguous()
    lib = _library("windowed_conv_bwd")
    fwd_tabs, bwd_tabs = _tables_args(tabs, num_sources > num_out)
    m = ux.shape[1]
    cm = cat.shape[1]
    k = tabs[2].shape[1]
    out = wf.shape[0]
    dev = cat.device
    sizes = (ctypes.c_int * 2)()
    lib.windowed_conv_bwd_partials(num_out, cm - m, m, out, k, sizes)
    if min(sizes) < 0:
        raise _too_big("windowed_conv_bwd", m, cm - m, out, k)
    # the slots' cotangent rows (self rows first, slot k at rows k·N + i),
    # the per-block dc and dwf partials, then the outputs
    dG = torch.empty(((k + 1) * num_out, cm), dtype=cat.dtype, device=dev)
    dc_part = torch.empty((sizes[0], m), dtype=torch.float32, device=dev)
    dw_part = torch.empty((sizes[1], out * m * (cm - m)), dtype=torch.float32, device=dev)
    dcat = torch.empty((num_sources, cm), dtype=cat.dtype, device=dev)
    dux = torch.empty((num_out, m), dtype=torch.float32, device=dev)
    dwf = torch.empty((out, m * (cm - m)), dtype=torch.float32, device=dev)
    dc = torch.empty((m,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, "windowed_conv_bwd" + ENTRY_SUFFIX[cat.dtype])(
            cat.data_ptr(), ux.data_ptr(), wf_dt.data_ptr(), c.data_ptr(),
            mult_rows.data_ptr(), gy.data_ptr(), *fwd_tabs, *bwd_tabs, dG.data_ptr(),
            dc_part.data_ptr(), dw_part.data_ptr(), dcat.data_ptr(), dux.data_ptr(),
            dwf.data_ptr(), dc.data_ptr(), num_out, num_sources, cm - m, m, out, k, block,
            tabs[0].shape[0], bwd_window, tabs[5].shape[1],
            tabs[9].shape[0] if num_sources > num_out else 0, sizes[0], sizes[1], stream)
    if err != 0:
        raise RuntimeError(f"windowed_conv_bwd: kernel launch failed (cudaError {err})")
    windowed_conv_bwd.launches += 1
    if cat.dtype == torch.bfloat16:
        windowed_conv_bwd.launches_bf16 += 1
    return dcat, dux, dwf, dc


windowed_conv_bwd.launches = 0
windowed_conv_bwd.launches_bf16 = 0


class WindowedFusedConv(torch.autograd.Function):
    """``y = K5(cat, ux, wf, c)`` over ``mult_rows`` and the window tables
    (which get no gradient); the backward is K5's. Both directions dispatch
    on the device. The cotangents of ``ux``, ``wf`` and ``c`` are f32,
    cast to their dtypes; ``dcat`` is in cat's dtype."""

    @staticmethod
    def forward(ctx, geometry, cat, ux, wf, c, mult_rows, *tabs):
        ctx.geometry = geometry
        ctx.save_for_backward(cat, ux, wf, c, mult_rows, *tabs)
        return windowed_conv_fwd(geometry, cat, ux, wf, c, mult_rows, tabs)

    @staticmethod
    def backward(ctx, gy):
        cat, ux, wf, c, mult_rows, *tabs = ctx.saved_tensors
        dcat, dux, dwf, dc = windowed_conv_bwd(ctx.geometry, cat, ux, wf, c, mult_rows, tabs,
                                               gy.contiguous())
        return ((None, dcat, dux.to(ux.dtype), dwf.to(wf.dtype), dc.to(c.dtype), None)
                + (None,) * len(tabs))


def make_windowed_fused_conv(geometry):
    """The fused conv of one level's window ``geometry``
    (``WindowedLaneTables.geometry``: block, window, bwd_window,
    num_sources, num_out), as JAX's ``make_windowed_fused_conv``:
    ``f(cat, ux, wf, c, mult_rows, *win_arrays) -> y [N, out]`` f32, the
    bias not applied, with K5 forward and backward on the card.

    - ``cat`` [N_src, C+M]: ``[x | x·projᵀ]`` in the compute dtype,
      halo-extended where the geometry has halo rows;
    - ``ux`` [N, M]: ``x·uᵀ`` (f32, or the compute dtype);
    - ``wf`` [out, M·C]: ``w.permute(1, 0, 2).reshape(out, M·C)``;
    - ``c`` [M] f32; ``mult_rows`` [K'+1, N] f32, slot 0 the row itself;
    - ``win_arrays``: the level's window tables as tensors, in
      ``WindowedLaneTables.arrays`` order (7, or 11 with the halo pack)."""
    geometry = _geometry(geometry)

    def fused(cat, ux, wf, c, mult_rows, *tabs):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (cat, ux, wf, c)):
            return WindowedFusedConv.apply(geometry, cat, ux, wf, c, mult_rows, *tabs)
        return windowed_conv_fwd(geometry, cat, ux, wf, c, mult_rows, tabs)

    return fused


def window_tensors(arrays: Sequence, device) -> Tuple[torch.Tensor, ...]:
    """A ``WindowedLaneTables.arrays`` pack as contiguous tensors on
    ``device`` (int32 and bool, as built)."""
    return tuple(torch.as_tensor(a).contiguous().to(device) for a in arrays)
