"""The naive multi-scale solver's scale (``ops/ms_solver_kernel.py``) on the
CPU, against the JAX package: its plain version chained over the three
scales against ``update_positions_multiscale(checkpoint=False)``, the pool
identity the card's kernel relies on (one pool of 2s rounds is s chained
pools of 2 rounds), the ``f >> shift`` level map, and the wrapper's
refusals. The kernel itself runs on the card (``tests/test_torch_cuda.py``).

Inputs from numpy seeds. Tolerances: the solvers ``SOLVER_TOL`` (atol 2e-5
+ rtol 1e-4, the bar of tests/test_ops.py: 80 iterations of float32 sums in
another order); pools and level maps bit for bit; the port's solver against
its own chained plain scales bit for bit (the same operations); face
centres against the JAX pyramid atol 1e-6 (a mean of three in another
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facet_graph_convolution_tpu.geometry.mesh_math import compute_face_normals
from facet_graph_convolution_tpu.ops.pooling import tree_pool as jax_tree_pool
from facet_graph_convolution_tpu.ops.vertex_update import (
    face_centers_pyramid as jax_face_centers_pyramid,
)
from facet_graph_convolution_tpu.ops.vertex_update import (
    update_positions_multiscale as jax_update_positions_multiscale,
)
from facet_graph_convolution_torch.data.dataset import InferenceMesh
from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere
from facet_graph_convolution_torch.ops import cuda_library
from facet_graph_convolution_torch.ops import ms_solver_kernel as ms
from facet_graph_convolution_torch.ops.tree_pool_kernel import tree_pool_ignore_zeros_plain
from facet_graph_convolution_torch.ops.vertex_update import update_positions_multiscale
from tests.test_torch_vertex import SOLVER_TOL, _cube_solver_case, _pool_input

SCHEDULE = (40, 20, 20)


def _patch_solver_case():
    """The largest patch of a noisy subdivision-3 icosphere cut into ~300-face
    patches: fake faces (padding to a multiple of 16), −1 pads in every
    v_faces row. Noisy normals with zero rows at the fake faces, their pooled
    mid and coarse levels."""
    v, f = icosphere(3)
    mesh = InferenceMesh(max_patch_size=300, coarsening_steps=2, coarsening_levels=3,
                         k_faces=23, k_vertices=25, seed=0)
    mesh.add_mesh_with_vertices(add_vertex_noise(v, f, 0.2, np.random.default_rng(3)), f)
    p = max(mesh.patches, key=lambda q: q.num_nodes)
    fake = p.faces[:, 0] < 0
    assert fake.any() and (p.v_faces < 0).any()
    rng = np.random.default_rng(4)
    n0 = np.zeros((p.faces.shape[0], 3), np.float32)
    n0[~fake] = compute_face_normals(p.vertices, p.faces[~fake])
    n0[~fake] += rng.normal(scale=0.05, size=(int((~fake).sum()), 3)).astype(np.float32)
    n1 = np.array(jax_tree_pool(jnp.asarray(n0), 2, "avg_ignore_zeros"))
    n2 = np.array(jax_tree_pool(jnp.asarray(n1), 2, "avg_ignore_zeros"))
    return p.vertices, [n0, n1, n2], p.faces.astype(np.int32), p.v_faces


CASES = {"cube": _cube_solver_case, "patch": lambda _rng: _patch_solver_case()}


def _chained_plain(case, schedule):
    """naive_scale_plain over the scales, coarse first: (x, [dx per scale])."""
    x0, normals, faces, v_f = case
    x = torch.as_tensor(x0)
    faces_t, vf_t = torch.as_tensor(faces), torch.as_tensor(v_f)
    dx = []
    for s, iters in zip((2, 1, 0), schedule):
        x_init = x
        x = ms.naive_scale_plain(x, faces_t, vf_t, torch.as_tensor(normals[s]), s, 2, iters)
        dx.append(x - x_init)
    return x, dx


@pytest.mark.parametrize("name", ["cube", "patch"])
def test_naive_scale_plain_chained_matches_jax(rng, name):
    case = CASES[name](rng)
    x, dx = _chained_plain(case, SCHEDULE)
    ref, ref_dx = jax_update_positions_multiscale(
        jnp.asarray(case[0]), [jnp.asarray(n) for n in case[1]], jnp.asarray(case[2]),
        jnp.asarray(case[3]), coarsening_steps=2, iter_nums=SCHEDULE, checkpoint=False)
    assert np.abs(x.numpy() - case[0]).max() > 1e-3          # the solver moved
    np.testing.assert_allclose(x.numpy(), np.asarray(ref), **SOLVER_TOL)
    for a, b in zip(dx, ref_dx):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SOLVER_TOL)


@pytest.mark.parametrize("name", ["cube", "patch"])
def test_solver_on_cpu_is_the_chained_plain_scales(rng, name):
    """update_positions_multiscale on CPU tensors calls naive_scale once a
    scale, which takes the plain version: the same bits."""
    case = CASES[name](rng)
    x, dx = _chained_plain(case, SCHEDULE)
    out, out_dx = update_positions_multiscale(
        torch.as_tensor(case[0]), [torch.as_tensor(n) for n in case[1]],
        torch.as_tensor(case[2]).long(), torch.as_tensor(case[3]).long(), 2, SCHEDULE)
    assert torch.equal(out, x)
    assert len(out_dx) == 3 and all(torch.equal(a, b) for a, b in zip(out_dx, dx))


def _zero_group_input(rng):
    """K4's edge rows, plus all-zero groups of 4 and 16 and −0.0 rows inside
    otherwise live groups."""
    x = _pool_input(rng, 16 * 37, 3)
    x[32:48] = 0.0                           # an all-zero group of 16
    x[48:52] = -0.0                          # an all-zero group of 4, −0.0 only
    x[64:80] = 0.0
    x[70] = (0.0, -0.0, 1.5)                 # one live row in a zero group
    return x


@pytest.mark.parametrize("s", [1, 2])
def test_pool_of_2s_rounds_equals_s_chained_jax_pools(rng, s):
    x = _zero_group_input(rng)
    out = tree_pool_ignore_zeros_plain(torch.as_tensor(x), 2 * s).numpy()
    ref = jnp.asarray(x)
    for _ in range(s):
        ref = jax_tree_pool(ref, 2, "avg_ignore_zeros")
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (x.shape[0] >> (2 * s), 3)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(np.signbit(out), np.signbit(ref))


@pytest.mark.parametrize("s", [0, 1, 2])
def test_scale_centers_match_jax_pyramid(rng, s):
    """The kernel's phase A on the CPU (its plain version): the fine
    centroids pooled by 2s rounds, against the JAX pyramid's level s."""
    x0, _, faces, _ = _patch_solver_case()
    ours = ms.scale_centers(torch.as_tensor(x0), torch.as_tensor(faces), 2 * s).numpy()
    ref = np.asarray(jax_face_centers_pyramid(jnp.asarray(x0), jnp.asarray(faces), 2, 3)[s])
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    np.testing.assert_array_equal(ours == 0, ref == 0)            # fake subtrees stay zero


@pytest.mark.parametrize("s", [0, 1, 2])
def test_level_map_shift_equals_jax_floor_division(s):
    """The kernel maps fine face f to level-s node f >> (2s): for −1 pads it
    stays −1 (an arithmetic shift) and for real ids it is the JAX solver's
    floor division by (2^2)^s."""
    rng = np.random.default_rng(s)
    v_f = rng.integers(0, 2**30, size=(64, 25)).astype(np.int32)
    v_f[:, 20:] = -1
    v_f[3] = -1
    v_f[5, :4] = (0, 1, 15, 16)
    ours = torch.bitwise_right_shift(torch.as_tensor(v_f), 2 * s).numpy()
    ref = np.asarray(jnp.asarray(v_f) // (2 ** 2) ** s)
    np.testing.assert_array_equal(ours, ref)
    assert (ours[v_f < 0] == -1).all() and (ours[v_f >= 0] >= 0).all()


def test_solver_on_cpu_loads_no_cuda_library(rng, monkeypatch):
    def refuse(name):
        raise AssertionError(f"loaded the CUDA library {name} for CPU tensors")

    monkeypatch.setattr(cuda_library, "load", refuse)
    before = ms.naive_scale.launches
    x0, normals, faces, v_f = _cube_solver_case(rng)
    out, _ = update_positions_multiscale(torch.as_tensor(x0),
                                         [torch.as_tensor(n) for n in normals],
                                         torch.as_tensor(faces), torch.as_tensor(v_f), 2,
                                         (3, 2, 2))
    assert torch.isfinite(out).all() and ms.naive_scale.launches == before
    assert ms.scale_centers(torch.as_tensor(x0), torch.as_tensor(faces), 4).shape == (1, 3)


def _refusal_inputs():
    x = torch.zeros(8, 3)
    faces = torch.zeros(16, 3, dtype=torch.int32)
    v_faces = torch.full((8, 25), -1, dtype=torch.int32)
    fn = torch.zeros(4, 3)
    return x, faces, v_faces, fn


REFUSALS = {
    "x_shape": (lambda x, f, v, n: (x[:, :2], f, v, n), ValueError, "x has shape"),
    "faces_shape": (lambda x, f, v, n: (x, f[:, :2], v, n), ValueError, "faces has shape"),
    "faces_not_multiple": (lambda x, f, v, n: (x, f[:14], v, n), ValueError, "multiple"),
    "v_faces_rows": (lambda x, f, v, n: (x, f, v[:7], n), ValueError, "v_faces has shape"),
    "fn_s_rows": (lambda x, f, v, n: (x, f, v, n[:3]), ValueError, "fn_s has shape"),
    "x_dtype": (lambda x, f, v, n: (x.double(), f, v, n), TypeError, "float32"),
    "fn_s_dtype": (lambda x, f, v, n: (x, f, v, n.double()), TypeError, "float32"),
    "faces_dtype": (lambda x, f, v, n: (x, f.long(), v, n), TypeError, "int32"),
    "v_faces_dtype": (lambda x, f, v, n: (x, f, v.long(), n), TypeError, "int32"),
    "meta_device": (lambda x, f, v, n: tuple(t.to("meta") for t in (x, f, v, n)), ValueError,
                    "no kernel for device"),
    "mixed_devices": (lambda x, f, v, n: (x, f, v, n.to("meta")), ValueError,
                      "several devices"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_naive_scale_refuses_what_the_kernel_does_not_take(case):
    change, error, match = REFUSALS[case]
    with pytest.raises(error, match=match):
        ms.naive_scale(*change(*_refusal_inputs()), 1, 2, 3)


def test_naive_scale_refuses_a_bad_shift_or_iters():
    x, faces, v_faces, fn = _refusal_inputs()
    with pytest.raises(ValueError, match="shift"):
        ms.naive_scale(x, faces, v_faces, fn, 16, 2, 3)
    with pytest.raises(ValueError, match="iters"):
        ms.naive_scale(x, faces, v_faces, fn, 1, 2, -1)
    with pytest.raises(ValueError, match="no kernel for device"):
        ms.scale_centers(x.to("meta"), faces.to("meta"), 2)
