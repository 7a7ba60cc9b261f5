"""The naive solver's adjoint wrapper on the CPU
(``ops/ms_solver_kernel.py::naive_scale_backward`` and ``NaiveScale``),
and ``tools/adjoint_cluster_probe.py``'s hold on its CUDA source.

The adjoint kernel takes its own grid (``adjoint_grid``): ``NaiveScale``
hands the forward's ``grid`` override to the scale kernel only, so the
gradients do not change with it (bit for bit). The wrapper refuses shapes
and dtypes the kernel does not take. The probe cuts phases out of its
kernel by replacing source lines; each must stand in the source as written.
Inputs from a numpy seed: a subdivision-1 icosphere with random unit
normals. The kernels themselves run on the card
(``tests/test_torch_cuda.py``).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from facet_graph_convolution_torch.data.synthetic import icosphere
from facet_graph_convolution_torch.geometry.mesh_math import vertex_faces
from facet_graph_convolution_torch.ops import ms_solver_kernel as ms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scale():
    """One scale-0 case on the CPU: x [V, 3], faces, v_faces [V, 8], unit fn."""
    rng = np.random.default_rng(3)
    v, f = icosphere(1)
    fn = rng.normal(size=(f.shape[0], 3)).astype(np.float32)
    return (torch.as_tensor(v.astype(np.float32)), torch.as_tensor(f.astype(np.int32)),
            torch.as_tensor(vertex_faces(f, 8, v.shape[0]).astype(np.int32)),
            torch.as_tensor(fn / np.linalg.norm(fn, axis=1, keepdims=True)))


def _grads(x, faces, v_f, fn, **kwargs):
    xl, fl = x.clone().requires_grad_(), fn.clone().requires_grad_()
    out = ms.naive_scale(xl, faces, v_f, fl, 0, 2, 3, **kwargs)
    (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
    return xl.grad, fl.grad


@pytest.mark.parametrize("checkpoint", [False, True])
def test_naive_scale_leaves_the_adjoint_its_own_grid(monkeypatch, checkpoint):
    x, faces, v_f, fn = _scale()
    want = _grads(x, faces, v_f, fn, checkpoint=checkpoint)
    seen = []
    adjoint = ms.naive_scale_backward

    def recorded(*args, **kwargs):
        seen.append(kwargs)
        return adjoint(*args, **kwargs)

    monkeypatch.setattr(ms, "naive_scale_backward", recorded)
    got = _grads(x, faces, v_f, fn, grid=7, checkpoint=checkpoint)
    assert len(seen) == 1 and "grid" not in seen[0]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("what", ["xs_2d", "xs_empty", "g_shape", "g_dtype"])
def test_backward_refuses_what_the_kernel_does_not_take(what):
    x, faces, v_f, fn = _scale()
    xs = ms.naive_scale_plain(x, faces, v_f, fn, 0, 2, 3, store=True)
    g = torch.ones_like(x)
    match = "needs float32"
    if what == "xs_2d":
        xs, match = xs[0], r"needs \[iters \+ 1, V, 3\]"
    elif what == "xs_empty":
        xs, match = xs[:0], r"needs \[iters \+ 1, V, 3\]"
    elif what == "g_shape":
        g = g[1:]
    else:
        g = g.double()
    with pytest.raises(ValueError, match=match):
        ms.naive_scale_backward(xs, faces, v_f, fn, 0, 2, g)


def _probe():
    path = os.path.join(REPO, "tools", "adjoint_cluster_probe.py")
    spec = importlib.util.spec_from_file_location("adjoint_cluster_probe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("variant", ["ra", "rb", "copy", "ra_centers", "ra_slots", "rb_slots",
                                     "rb_corners"])
def test_cluster_probe_cuts_lines_that_stand_in_its_source(variant):
    probe = _probe()
    with open(probe.SOURCE) as fh:
        src = fh.read()
    for old, new in probe.SUBS[variant]:
        assert src.count(old) == 1 and new not in src
    assert all(set(drops) <= set(probe.SUBS) for drops in probe.VARIANTS.values())
