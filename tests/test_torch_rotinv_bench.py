"""The benchmark's plain reference of the rotation-invariant network
(``fgc_bench/reference/rotinv.py``) against the port, and its cell at a
size a CPU run holds; on the card, the marks around the port's
rotation-invariant conv.

- The reference's rotation-invariant conv equals the port's
  ``facet_conv(..., ROTATION_INVARIANT)`` in float64 on seeded random
  weights over a random graph, values and gradients (atol 1e-10: the same
  arithmetic in another order).
- Under one rotation of the inputs (normals and positions) each face's
  features turn only about +z, by an angle of the face's own (the Rodrigues
  frame fixes the normal, not the tangents), so the reference's conv1
  assignment q is unchanged where it weighs the z parts alone, and not
  without the per-face rotation (the ``no_rotation`` fault); atol 1e-12 in
  float64.
- R = I for a zero normal and for ±z; R·n = +z for unit normals.
- A tiny rotation-invariant cell runs end to end through the harness on
  the CPU and is ``correct``; the ``no_rotation`` fault, and a program whose
  conv1 leaves out the rotation, read above its limits.
- On the card: the four marks of the rotation-invariant conv, once each a
  step, eager and in a graph replay, in order; none in a default step.
"""

import numpy as np
import pytest
import torch

from facet_graph_convolution_torch.graph.convert import (
    dedupe_klist,
    slot_major_arrays,
    split_self_klist,
)
from facet_graph_convolution_torch.ops import conv as port_conv
from facet_graph_convolution_torch.ops.conv import FacetConvVariant, facet_conv
from fgc_bench.core.runner import run
from fgc_bench.reference import rotinv
from fgc_bench.reference.train import compare, run_steps
from fgc_bench.tests.tiny import LIMITS, TINY_CONFIG, write_tiny

SEED = 20240607
RI_MARKS = ["rotinv_begin", "rotinv_end", "rotinv_bwd_begin", "rotinv_bwd_end"]


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _graph(rng, n=40, k=9):
    """A random one-indexed K-list (slot 0 the node, distinct neighbours,
    0 = pad) and the reference's slot table of it (N for an empty slot)."""
    adj = np.zeros((n, k), np.int32)
    adj[:, 0] = np.arange(n) + 1
    for i in range(n):
        others = np.delete(np.arange(n), i)
        deg = int(rng.integers(0, k))
        adj[i, 1:1 + deg] = rng.choice(others, size=deg, replace=False) + 1
    nbr = np.where(adj > 0, adj - 1, n).astype(np.int64)
    return adj, nbr


def _inputs(rng, n):
    return np.concatenate([_unit(rng.standard_normal((n, 3))),
                           rng.uniform(-0.5, 0.5, (n, 3))], axis=1)


def _conv_params(rng, out=5, m=4, dtype=torch.float64):
    def draw(*shape, std=0.5):
        return torch.tensor(rng.standard_normal(shape) * std, dtype=dtype, requires_grad=True)
    return {"w": draw(m, out, 6), "b": draw(out, std=0.1), "u": draw(m, 6, std=2.0),
            "c": draw(m, std=0.5)}


def test_reference_conv_equals_the_ports_in_values_and_gradients():
    rng = np.random.default_rng(3)
    adj, nbr = _graph(rng)
    x_np = _inputs(rng, adj.shape[0])
    params = _conv_params(rng)
    a_u, mult = dedupe_klist(adj)
    adj_sm, adj_t_sm, rows = slot_major_arrays(*split_self_klist(a_u, mult))

    x_ref = torch.tensor(x_np, requires_grad=True)
    x_port = torch.tensor(x_np, requires_grad=True)
    dy = torch.tensor(rng.standard_normal((adj.shape[0], 5)))
    ref = rotinv.conv_rotinv(params, x_ref, torch.as_tensor(nbr))
    live = (torch.as_tensor(rows) > 0).double()       # 1/|N(i)| in float64, not float32's
    rows = live / live.sum(dim=0, keepdim=True).clamp_min(1)
    got = facet_conv(params, x_port, torch.as_tensor(adj_sm), rows,
                     FacetConvVariant.ROTATION_INVARIANT, adj_t_sm=torch.as_tensor(adj_t_sm))
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-10)
    leaves = [params[k] for k in ("w", "b", "u", "c")]
    g_ref = torch.autograd.grad(ref, leaves + [x_ref], dy)
    g_port = torch.autograd.grad(got, leaves + [x_port], dy)
    for name, a, b in zip(("w", "b", "u", "c", "x"), g_port, g_ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10, msg=name)


def _features(x, nbr, rotate=True):
    return rotinv.rotinv_features(x, torch.cat([x, x.new_zeros(1, 6)])[nbr], rotate)


def test_conv1_assignment_under_a_global_rotation():
    """Turning the inputs (normals and positions) by one rotation Q turns each
    face's frame R_i·Q⁻¹ only up to a twist about +z (the Rodrigues frame
    fixes the normal, not the tangents): every feature of face i turns by
    one R_z(φ_i), z parts unchanged. So q is unchanged for an assignment
    that weighs the z parts alone, which without the per-face rotation it
    is not."""
    rng = np.random.default_rng(5)
    _, nbr = _graph(rng)
    nbr = torch.as_tensor(nbr)
    x = torch.tensor(_inputs(rng, nbr.shape[0]))
    q_mat, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    turn = torch.tensor(q_mat * np.sign(np.linalg.det(q_mat)))         # a proper rotation
    turned = (x.reshape(-1, 2, 3) @ turn.T).reshape(-1, 6)
    f0, f1 = _features(x, nbr), _features(turned, nbr)
    torch.testing.assert_close(f1[..., 2::3], f0[..., 2::3], rtol=0, atol=1e-12)
    a = torch.cat([f0[..., 0:2], f0[..., 3:5]], dim=1)                   # [N, 2K, 2]
    b = torch.cat([f1[..., 0:2], f1[..., 3:5]], dim=1)
    phi = torch.atan2((a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]).sum(1),
                      (a * b).sum((1, 2)))[:, None]
    twisted = torch.stack([torch.cos(phi) * a[..., 0] - torch.sin(phi) * a[..., 1],
                           torch.sin(phi) * a[..., 0] + torch.cos(phi) * a[..., 1]], dim=-1)
    torch.testing.assert_close(twisted, b, rtol=0, atol=1e-12)
    assert float(phi.abs().max()) > 1e-2                 # the frames do twist

    params = {k: t.detach() for k, t in _conv_params(rng).items()}
    u = params["u"].clone()
    u[:, [0, 1, 3, 4]] = 0.0

    def q(inputs, rotate=True):
        return torch.softmax(_features(inputs, nbr, rotate) @ u.T + params["c"], -1)

    torch.testing.assert_close(q(turned), q(x), rtol=0, atol=1e-12)
    assert float((q(turned, False) - q(x, False)).abs().max()) > 1e-2


def test_rotation_is_the_identity_at_zero_and_axis_normals():
    flat = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    assert torch.equal(rotinv.rotation_to_axis(flat), torch.eye(3).expand(3, 3, 3))
    n = torch.tensor(_unit(np.random.default_rng(2).standard_normal((64, 3))))
    rot = rotinv.rotation_to_axis(n)
    torch.testing.assert_close(torch.einsum("nab,nb->na", rot, n),
                               torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype).expand(64, 3),
                               rtol=0, atol=1e-12)
    torch.testing.assert_close(rot @ rot.transpose(1, 2), torch.eye(3, dtype=n.dtype).expand(64, 3, 3),
                               rtol=0, atol=1e-12)


def _tiny_cell(tmp_path):
    config = dict(TINY_CONFIG, name="tinyri", rotation_invariance=True)
    return write_tiny(str(tmp_path), driver="rotinv_chunks", config=config)


def _run(tmp_path, monkeypatch):
    from fgc_bench.core import runner

    # the test process imported JAX for other tests: the run must add none
    loaded, every = set(runner.forbidden_modules()), runner.forbidden_modules
    monkeypatch.setattr(runner, "forbidden_modules",
                        lambda: [m for m in every() if m not in loaded])
    manifest = _tiny_cell(tmp_path)
    code, out = run("tiny.cell", SEED, 0.5, False, manifest_path=manifest, root=str(tmp_path),
                    require_card=False, device="cpu")
    assert code == 0
    return out


def test_tiny_rotinv_cell_is_correct_on_the_cpu(tmp_path, monkeypatch):
    out = _run(tmp_path, monkeypatch)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0


def test_no_rotation_fault_reads_above_the_limits(tmp_path):
    from fgc_bench.core import manifest

    cell = manifest.load_cell("tiny.cell", _tiny_cell(tmp_path), str(tmp_path))
    session = manifest.driver(cell).Session(cell, SEED, "cpu")
    assert "v" not in session.host_params0["conv1"] and "v" in session.host_params0["conv2"]
    prog = session.first_steps()
    session.release()
    lr = cell.config["learning_rate"]
    sound = compare(prog, run_steps(session.host_params0, session.reference_losses("cpu"), lr,
                                    "cpu"))
    fault = compare(prog, run_steps(session.host_params0,
                                    session.reference_losses("cpu", "no_rotation"), lr, "cpu"))
    assert all(sound[k] <= LIMITS[k] for k in LIMITS), sound
    assert any(fault[k] > LIMITS[k] for k in LIMITS), fault
    with pytest.raises(ValueError, match="no fault"):
        session.reference_losses("cpu", "nowhere")


def test_a_program_without_the_rotation_is_caught(tmp_path, monkeypatch):
    monkeypatch.setattr(port_conv, "rotation_to_axis",
                        lambda n: torch.eye(3, dtype=n.dtype).expand(*n.shape[:-1], 3, 3))
    out = _run(tmp_path, monkeypatch)
    assert not out["correct"]
    assert any(v["value"] > v["limit"] for k, v in out["checks"].items() if k in LIMITS)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the marks are kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_case(rotation_invariance):
    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.data.dataset import TrainingSet
    from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere

    v, f = icosphere(3)
    ds = TrainingSet(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                     k_faces=23, seed=0)
    ds.add_mesh(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f, gt_vertices=v)
    cfg = default_config().replace(
        model={"channels": (8, 16, 32), "num_filters": 4, "fc_channels": 32,
               "rotation_invariance": rotation_invariance},
        train={"loss_samples": 512})
    return ds.patches[0], cfg


def _device_marks(run_steps_fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_steps_fn()
        torch.cuda.synchronize()
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    return [e.name[len("fgc_mark_"):] for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and e.name.startswith("fgc_mark_")]


@pytest.mark.cuda
@pytest.mark.parametrize("rotation_invariance", [True, False])
def test_rotinv_marks_once_a_step_eager_and_replayed(cuda, rotation_invariance):
    from facet_graph_convolution_torch.training.trainer import (
        create_train_state,
        make_normals_train_step,
        make_scanned_train_step,
        normals_draws,
        patch_tensors,
        stack_patch_tensors,
    )

    patch, cfg = _card_case(rotation_invariance)
    ri = RI_MARKS if rotation_invariance else []
    state = create_train_state(cfg, device=str(cuda))
    tensors = patch_tensors(patch, str(cuda))
    step = make_normals_train_step(cfg, generator=torch.Generator().manual_seed(7))
    # the first step builds and loads the kernels, outside the profiler: a
    # library loaded while a profiler records was seen to cost every later
    # profiled session in the process its first kernel
    step(state, *tensors)
    assert _device_marks(lambda: step(state, *tensors)) == ri

    state = create_train_state(cfg, device=str(cuda))
    scanned = make_scanned_train_step(state, cfg, stack_patch_tensors([patch], str(cuda)), 3)
    gen = torch.Generator().manual_seed(7)
    calls = [normals_draws(cfg, gen, [0] * 3, patch.num_nodes) for _ in range(2)]
    scanned(state, calls[0])[1].numpy()             # the warm-up step and the capture
    marks = _device_marks(lambda: scanned(state, calls[1])[1].numpy())
    one = ["step_begin", *ri[:2], "fwd_end", *ri[2:], "bwd_end", "opt_end"]
    assert marks == one * 3
