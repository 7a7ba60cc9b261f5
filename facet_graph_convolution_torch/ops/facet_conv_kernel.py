"""K1 and K2: the facet-conv epilogue, forward and backward, gather fused in.

:func:`facet_conv_fwd` launches the hand-written CUDA kernel
``csrc/facet_conv_fwd.cu`` on CUDA tensors; it replaces
``facet_graph_convolution_tpu/ops/pallas_conv.py::_epilogue_fwd_kernel``
(launched by ``_conv_epilogue_fwd``). :func:`facet_conv_bwd` launches
``csrc/facet_conv_bwd.cu``; it replaces ``_epilogue_bwd_kernel`` (launched by
``_conv_epilogue_bwd``) together with the gather's transpose ``_gsm_bwd``.
Each source's head note says what bounds it on an H100 (bytes, for both) and
how its design answers that. Both take any channel count C and any M whose
softmax rows fit a block's shared memory (thousands; :func:`_check` names
the limit): K2 walks wide rows inside the kernel, and :func:`facet_conv_fwd`
runs a conv wider than one K1 launch takes (1024 channels) as channel chunks
(:func:`fwd_in_chunks`).
:func:`facet_conv_fwd_plain` and
:func:`facet_conv_bwd_plain` are the same functions in plain PyTorch: the
wrappers take them for CPU tensors, and the tests and ``chip_smoke.py`` hold
the kernels against them.

For node i and slot k = 0..K' (slot 0 = self; else j = ``adj_sm[k-1, i]-1``,
index 0 a pad):

    logits = ux[i] + vx[j] + c;  s = softmax_M(logits);  q = s · mult_rows[k, i]
    z[i, m·C + ch] = Σ_k q[m] · x[j, ch]

with ``cat = [x | vx]`` [N_src, C+M], ``ux`` [N, M], ``adj_sm`` [K', N] int32,
``mult_rows`` [K'+1, N] f32, ``c`` [M] f32 → ``z`` [N, M·C]. ``cat`` may hold
more rows than the N outputs (N_src ≥ N): a shard of a partitioned graph
(:mod:`..parallel.halo`) appends the halo rows that other shards own after
its own, its neighbour slots index into all N_src rows, and the self slot
is row i < N. K2's ``dcat`` then has N_src rows, and its transpose map
``adj_t_sm`` lists the slots that read each of them.

Both kernels take float32 or bfloat16 ``cat`` and ``ux`` (one dtype for
both, and for ``dz``: the conv's compute dtype). In bfloat16 they upcast
each load, compute in f32 and round once: z when it is written, dcat after
its transpose-map sum; dux stays f32, and :class:`FacetConvEpilogue` takes
``dc`` from it before it casts ux's cotangent to bfloat16 (the JAX
package's ``_conv_epilogue_fwd`` / ``_conv_epilogue_bwd`` under
``compute_dtype=bfloat16``). The plain versions keep the same contract.
Each wrapper counts its launches (``.launches``) and, among them, its
bfloat16 ones (``.launches_bf16``).

:class:`FacetConvEpilogue` is the ``torch.autograd.Function`` over the pair
(``jax.custom_vjp`` of ``conv_epilogue`` in the JAX package): forward K1,
backward K2, on every device. It saves the inputs and recomputes the softmax
in the backward, as the TPU kernel does.

K1 is also the operator ``torch.ops.facet_graph_convolution.facet_conv_fwd``
(:func:`facet_conv_fwd_op`, registered when this module is imported, with a
fake that gives z's shape), so that ``torch.export`` traces the forward
through it; :func:`facet_conv_epilogue` calls the operator where no
gradient is taken and :class:`FacetConvEpilogue` where one is. Both run
whatever :func:`facet_conv_fwd` the module holds at the call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from facet_graph_convolution_torch.ops import cuda_library
from facet_graph_convolution_torch.ops.gather import gather_neighbors


def upcast_bf16(t):
    """A bfloat16 tensor as f32 for the plain versions' arithmetic (K1-K3);
    any other dtype as it is (float64 runs the plain versions in float64)."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _slots(cat, adj_sm):
    """[K'+1, N, C+M]: each node's own row (the first N of ``cat``'s N_src),
    then its gathered neighbour rows (zero rows for pads)."""
    return torch.cat([cat[None, :adj_sm.shape[1]], gather_neighbors(cat, adj_sm)], dim=0)


def facet_conv_fwd_plain(cat, ux, adj_sm, mult_rows, c):
    """Plain PyTorch K1: gather, softmax, multiply by mult, then einsum; in
    f32 on bfloat16 inputs (upcast), z rounded to cat's dtype once."""
    dtype = cat.dtype
    cat, ux = upcast_bf16(cat), upcast_bf16(ux)
    n = adj_sm.shape[1]
    m = ux.shape[1]
    c_in = cat.shape[1] - m
    slots = _slots(cat, adj_sm)                                   # [K'+1, N, C+M]
    q = torch.softmax(ux[None] + slots[..., c_in:] + c, dim=-1)
    q = q * mult_rows[..., None]                                  # [K'+1, N, M]
    z = torch.einsum("knm,knc->nmc", q, slots[..., :c_in])
    return z.reshape(n, m * c_in).to(dtype)


def facet_conv_bwd_plain(cat, ux, adj_sm, adj_t_sm, mult_rows, c, dz):
    """Plain PyTorch K2, written out (no autograd): ``(dcat, dux)`` for the
    cotangent ``dz`` [N, M·C] of :func:`facet_conv_fwd_plain`.

    Per slot, with s the recomputed softmax and w = mult:
    ``dx = Σ_m w·s[m]·dz_m``, ``dq[m] = w·⟨x_j, dz_m⟩``,
    ``dlog = s ⊙ (dq − ⟨s, dq⟩)``; ``dux = Σ_k dlog``. The self slot's
    ``[dx | dlog]`` is node i's own row of ``dcat``; a neighbour slot's row
    goes to its source j through the transpose map ``adj_t_sm`` [N_src, K_t],
    which lists the one-indexed flat slots ``k·N + i`` that read j (0 = pad):
    a gather-sum, no scatter; only the first N source rows have a self row.
    On bfloat16 inputs it computes in f32 (upcast)
    and rounds dcat to cat's dtype once; dux is f32 (K2's contract)."""
    dtype = cat.dtype
    cat, ux, dz = upcast_bf16(cat), upcast_bf16(ux), upcast_bf16(dz)
    n = adj_sm.shape[1]
    m = ux.shape[1]
    c_in = cat.shape[1] - m
    slots = _slots(cat, adj_sm)
    s = torch.softmax(ux[None] + slots[..., c_in:] + c, dim=-1)  # [K'+1, N, M]
    w = mult_rows[..., None]
    dz3 = dz.reshape(n, m, c_in)
    dx = torch.einsum("knm,nmc->knc", s * w, dz3)
    dq = torch.einsum("knc,nmc->knm", slots[..., :c_in], dz3) * w
    dlog = s * (dq - (dq * s).sum(dim=-1, keepdim=True))
    dsrc = torch.cat([dx, dlog], dim=-1)                          # [K'+1, N, C+M]
    dg = torch.cat([dsrc.new_zeros(1, dsrc.shape[-1]), dsrc[1:].reshape(-1, dsrc.shape[-1])])
    n_src = adj_t_sm.shape[0]
    dcat = torch.nn.functional.pad(dsrc[0], (0, 0, 0, n_src - n)) + dg.index_select(
        0, adj_t_sm.reshape(-1).long()).reshape(n_src, adj_t_sm.shape[1], -1).sum(dim=1)
    return dcat.to(dtype), dlog.sum(dim=0)


# the C entry of each storage dtype the kernels take (K1-K3)
ENTRY_SUFFIX = {torch.float32: "_f32", torch.bfloat16: "_bf16"}


def _library(name: str, dtype: torch.dtype = torch.float32) -> ctypes.CDLL:
    """The library of ``name`` holding its ``dtype`` entry: K2's bfloat16
    entry is a library of its own (``csrc/facet_conv_bwd_bf16.cu``)."""
    lib_name = name + ("_bf16" if name == "facet_conv_bwd" and dtype == torch.bfloat16 else "")
    lib = cuda_library.load(lib_name)
    entries = [e for e in (getattr(lib, name + sfx, None) for sfx in ENTRY_SUFFIX.values()) if e]
    if entries[0].argtypes is None:
        # c_void_p for every pointer: without argtypes ctypes would pass the
        # Python ints as 32-bit C ints and cut the addresses
        p, i = ctypes.c_void_p, ctypes.c_int
        for entry in entries:
            entry.argtypes = ([p] * 6 + [i] * 5 + [p] if name == "facet_conv_fwd"
                              else [p] * 10 + [i] * 6 + [p])
            entry.restype = ctypes.c_int
        if name == "facet_conv_fwd":
            lib.facet_conv_fwd_max_c.restype = i
            lib.facet_conv_fwd_max_m.argtypes = [i, i]
        getattr(lib, name + "_max_m").restype = i
    return lib


def _max_m(kernel, lib, k_nbr, c_in):
    """The largest M one launch of ``kernel`` takes: K1's q tile of a node's
    K'+1 slots (and, at C <= 16, its staged z row) must fit a block's shared
    memory, for every channel chunk; K2 past M = 32 keeps 3·M floats a warp
    there. Both kernels keep these in f32 under either storage dtype, so
    the limits are the same for bfloat16."""
    if kernel == "facet_conv_bwd":
        return lib.facet_conv_bwd_max_m()
    max_c = lib.facet_conv_fwd_max_c()
    widths = {min(c_in, max_c), c_in % max_c or max_c}
    return min(lib.facet_conv_fwd_max_m(k_nbr, w) for w in widths)


def _same_dtype(kernel, cat, **others):
    """Refuse a mix of storage dtypes, on every device: ``cat``, ``ux`` (and
    ``dz``) share the conv's compute dtype."""
    for name, t in others.items():
        if t.dtype != cat.dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype} but cat is {cat.dtype}; "
                            "they must share one compute dtype")


def _check(kernel, cat, ux, adj_sm, mult_rows, c, **extra):
    k_nbr, n = adj_sm.shape
    m = ux.shape[1]
    if cat.dtype not in ENTRY_SUFFIX:
        raise TypeError(f"{kernel}: cat is {cat.dtype}; the kernel takes "
                        f"{sorted(str(d) for d in ENTRY_SUFFIX)}")
    n_src = cat.shape[0]
    if n_src < n:
        raise ValueError(f"{kernel}: cat has {n_src} rows, fewer than the N={n} outputs")
    expect = {
        "cat": (cat, cat.dtype, (n_src, cat.shape[1])),
        "ux": (ux, cat.dtype, (n, m)),
        "adj_sm": (adj_sm, torch.int32, (k_nbr, n)),
        "mult_rows": (mult_rows, torch.float32, (k_nbr + 1, n)),
        "c": (c, torch.float32, (m,)),
        **extra,
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != cat.device:
            raise ValueError(f"{kernel}: {name} on {t.device}, cat on {cat.device}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, needs {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, needs {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
    if cat.shape[1] <= m:
        raise ValueError(f"{kernel}: cat width {cat.shape[1]} leaves no channels for M={m}")
    if n * max(k_nbr, 1) >= 2**31:
        raise ValueError(f"{kernel}: N={n}, K'={k_nbr} overflow the kernel's int32 slot index")
    if n_src > 2**26:
        raise ValueError(f"{kernel}: N_src={n_src} source rows overflow K2's int32 thread index")
    lib = _library(kernel, cat.dtype)
    max_m = _max_m(kernel, lib, k_nbr, cat.shape[1] - m)
    if m > max_m:
        raise ValueError(f"{kernel}: M={m} filters need more shared memory for their softmax "
                         f"rows than the 227 KB a block can use; at most M={max_m} fit here")
    return lib


def fwd_in_chunks(fwd, cat, ux, adj_sm, mult_rows, c, max_c):
    """K1 through ``fwd`` on channel chunks of at most ``max_c``. The softmax
    reads only the ``vx`` columns of ``cat``, so the chunk
    ``[x[:, c0:c1] | vx]`` gives z's channels c0..c1 for every m; they
    interleave back into z's m-major layout [N, M, C]. One call of ``fwd``
    when C <= ``max_c``."""
    n, m = ux.shape
    c_in = cat.shape[1] - m
    if c_in <= max_c:
        return fwd(cat, ux, adj_sm, mult_rows, c)
    vx = cat[:, c_in:]
    z = cat.new_empty((n, m, c_in))
    for c0 in range(0, c_in, max_c):
        c1 = min(c0 + max_c, c_in)
        part = fwd(torch.cat([cat[:, c0:c1], vx], dim=1), ux, adj_sm, mult_rows, c)
        z[:, :, c0:c1] = part.view(n, m, c1 - c0)
    return z.view(n, m * c_in)


def _launch_fwd(lib, cat, ux, adj_sm, mult_rows, c):
    """One K1 launch on inputs that :func:`_check` has passed."""
    k_nbr, n = adj_sm.shape
    m = ux.shape[1]
    c_in = cat.shape[1] - m
    z = torch.empty((n, m * c_in), device=cat.device, dtype=cat.dtype)
    with torch.cuda.device(cat.device):
        stream = torch.cuda.current_stream(cat.device).cuda_stream
        err = getattr(lib, "facet_conv_fwd" + ENTRY_SUFFIX[cat.dtype])(
            cat.data_ptr(), ux.data_ptr(), adj_sm.data_ptr(), mult_rows.data_ptr(),
            c.data_ptr(), z.data_ptr(), n, cat.shape[0], k_nbr, c_in, m, stream)
    if err != 0:
        raise RuntimeError(f"facet_conv_fwd: kernel launch failed (cudaError {err})")
    facet_conv_fwd.launches += 1
    if cat.dtype == torch.bfloat16:
        facet_conv_fwd.launches_bf16 += 1
    return z


def facet_conv_fwd(cat, ux, adj_sm, mult_rows, c):
    """K1 on ``cat``'s device: the CUDA kernel for CUDA tensors (one launch
    per channel chunk of at most 1024: one launch a conv at any width the
    model uses), the plain version for CPU tensors; z in cat's dtype
    (float32 or bfloat16 on the card). Raises on any other device, on a mix
    of dtypes, and on shapes, dtypes or layouts the kernel does not take."""
    _same_dtype("facet_conv_fwd", cat, ux=ux)
    if cat.device.type == "cpu":
        return facet_conv_fwd_plain(cat, ux, adj_sm, mult_rows, c)
    if cat.device.type != "cuda":
        raise ValueError(f"facet_conv_fwd: no kernel for device {cat.device}")
    lib = _check("facet_conv_fwd", cat, ux, adj_sm, mult_rows, c)
    return fwd_in_chunks(functools.partial(_launch_fwd, lib), cat, ux, adj_sm, mult_rows, c,
                         lib.facet_conv_fwd_max_c())


facet_conv_fwd.launches = 0
facet_conv_fwd.launches_bf16 = 0


K1_OP = "facet_graph_convolution::facet_conv_fwd"
# defined with torch.library's define/impl rather than custom_op, whose
# kernels import torch._dynamo (seconds) at a process's first call
torch.library.define(K1_OP, "(Tensor cat, Tensor ux, Tensor adj_sm, Tensor mult_rows, "
                            "Tensor c) -> Tensor")


@torch.library.impl(K1_OP, ("cpu", "cuda"))
def _facet_conv_fwd_impl(cat, ux, adj_sm, mult_rows, c):
    # the module attribute, looked up at each call: a swap for the plain
    # version is what runs
    return facet_conv_fwd(cat, ux, adj_sm, mult_rows, c)


@torch.library.register_fake(K1_OP)
def _facet_conv_fwd_fake(cat, ux, adj_sm, mult_rows, c):
    n, m = ux.shape
    return cat.new_empty((n, m * (cat.shape[1] - m)))


# K1 as an operator, with no autograd formula (FacetConvEpilogue holds the
# backward); torch.export keeps it opaque in the programs it writes
facet_conv_fwd_op = torch.ops.facet_graph_convolution.facet_conv_fwd


def facet_conv_epilogue(cat, ux, c, adj_sm, adj_t_sm, mult_rows):
    """``z`` of K1: through :class:`FacetConvEpilogue` (K2 its backward)
    where autograd records, else the operator alone (no autograd there, as
    under ``torch.no_grad`` and in an exported program)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (cat, ux, c)):
        return FacetConvEpilogue.apply(cat, ux, c, adj_sm, adj_t_sm, mult_rows)
    return facet_conv_fwd_op(cat, ux, adj_sm, mult_rows, c)


def facet_conv_bwd(cat, ux, adj_sm, adj_t_sm, mult_rows, c, dz):
    """K2 on ``cat``'s device: ``(dcat, dux)`` from the CUDA kernel for CUDA
    tensors, from the plain version for CPU tensors; dcat in cat's dtype,
    dux f32. Raises on any other device, on a mix of dtypes, and on shapes,
    dtypes or layouts the kernel does not take."""
    _same_dtype("facet_conv_bwd", cat, ux=ux, dz=dz)
    if cat.device.type == "cpu":
        return facet_conv_bwd_plain(cat, ux, adj_sm, adj_t_sm, mult_rows, c, dz)
    if cat.device.type != "cuda":
        raise ValueError(f"facet_conv_bwd: no kernel for device {cat.device}")
    k_nbr, n = adj_sm.shape
    m = ux.shape[1]
    width = cat.shape[1]
    c_in = width - m
    if adj_t_sm.dim() != 2:
        raise ValueError(f"facet_conv_bwd: adj_t_sm has {adj_t_sm.dim()} dims, needs 2")
    k_t = adj_t_sm.shape[1]
    n_src = cat.shape[0]
    lib = _check("facet_conv_bwd", cat, ux, adj_sm, mult_rows, c,
                 adj_t_sm=(adj_t_sm, torch.int32, (n_src, k_t)),
                 dz=(dz, cat.dtype, (n, m * c_in)))
    # dg holds every live slot's row [dx | dlog] between the kernel's two
    # passes (row k*N + i, the self slots first), padded to 8 floats so that
    # the kernel writes whole 32-byte sectors; the rows of dead slots are
    # never written nor read. It stays f32 under bfloat16 too: dcat is
    # rounded once, after the sum of its slots' rows
    dg = torch.empty(((k_nbr + 1) * n, -(-width // 8) * 8), device=cat.device,
                     dtype=torch.float32)
    dcat = torch.empty((n_src, width), device=cat.device, dtype=cat.dtype)
    dux = torch.empty((n, m), device=cat.device, dtype=torch.float32)
    with torch.cuda.device(cat.device):
        stream = torch.cuda.current_stream(cat.device).cuda_stream
        err = getattr(lib, "facet_conv_bwd" + ENTRY_SUFFIX[cat.dtype])(
            cat.data_ptr(), ux.data_ptr(), adj_sm.data_ptr(), adj_t_sm.data_ptr(),
            mult_rows.data_ptr(), c.data_ptr(), dz.data_ptr(), dg.data_ptr(),
            dcat.data_ptr(), dux.data_ptr(), n, n_src, k_nbr, k_t, c_in, m, stream)
    if err != 0:
        raise RuntimeError(f"facet_conv_bwd: kernel launch failed (cudaError {err})")
    facet_conv_bwd.launches += 1
    if cat.dtype == torch.bfloat16:
        facet_conv_bwd.launches_bf16 += 1
    return dcat, dux


facet_conv_bwd.launches = 0
facet_conv_bwd.launches_bf16 = 0


class FacetConvEpilogue(torch.autograd.Function):
    """``z = K1(cat, ux, c)`` over the tables ``adj_sm``, ``adj_t_sm`` (the
    backward's transpose map; may be None when no gradient is taken) and
    ``mult_rows``; the backward is K2, with ``dc = Σ_n dux``. The tables
    get no gradient. Both directions dispatch on the device, so the same
    graph is differentiated on the CPU and on the card. Under bfloat16 the
    cotangent of ``ux`` is K2's f32 dux rounded to bfloat16, and ``dc`` its
    f32 sum (``pallas_conv.py:234``)."""

    @staticmethod
    def forward(ctx, cat, ux, c, adj_sm, adj_t_sm, mult_rows):
        ctx.save_for_backward(cat, ux, c, adj_sm, adj_t_sm, mult_rows)
        return facet_conv_fwd_op(cat, ux, adj_sm, mult_rows, c)

    @staticmethod
    def backward(ctx, dz):
        cat, ux, c, adj_sm, adj_t_sm, mult_rows = ctx.saved_tensors
        if adj_t_sm is None:
            raise RuntimeError(
                "facet_conv: the backward needs the transpose map adj_t_sm "
                "(models.unet.train_graph_tensors builds it)")
        dcat, dux = facet_conv_bwd(cat, ux, adj_sm, adj_t_sm, mult_rows, c,
                                   dz.contiguous())
        return dcat, dux.to(ux.dtype), dux.sum(dim=0), None, None, None
