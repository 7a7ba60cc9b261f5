"""The harness's run, the look for a card skipped, at a size a CPU test
holds, with the timed path broken underneath: ``correct`` comes out false
for each fault a training cell can have (a step that returns its state
unchanged; half of the batch left out, the mean taken over the rest), and
true where nothing is broken."""

import pytest
import torch

from fgc_bench.core.runner import run
from fgc_bench.tests.tiny import TINY_CONFIG, TINY_TRAFFIC, write_tiny

CELLS = {
    "patch": dict(driver="patch_chunks"),
    "vertex": dict(driver="vertex_chunks", config=dict(TINY_CONFIG, name="tinyv",
                                                       include_vertices=True),
                   limits={"loss1_gap": 1e-4, "grad_gap": 1e-3, "grad_median_gap": 1e-3}),
    "whole": dict(driver="sharded_mesh", traffic=dict(
        TINY_TRAFFIC, meshes=[{"shape": "torus", "args": {"nu": 32, "nv": 16}}],
        max_patch_size=10**9)),
}


# the number that catches each fault: the vertex cell compares the first
# step's loss and gradient (PERF.md: its later steps follow near ties)
UNCHANGED = {"patch": "change_gap", "vertex": "grad_gap", "whole": "change_gap"}
HALF = {"patch": "loss_gap", "vertex": "loss1_gap", "whole": "loss_gap"}


def _run(tmp_path, kind, seed=20240607):
    manifest = write_tiny(str(tmp_path), **CELLS[kind])
    code, out = run("tiny.cell", seed, 0.5, False, manifest_path=manifest, root=str(tmp_path),
                    require_card=False, device="cpu")
    assert code == 0
    return out


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_sound_run_is_correct(tmp_path, kind):
    out = _run(tmp_path, kind)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_state_left_unchanged_is_caught(tmp_path, kind, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    out = _run(tmp_path, kind)
    assert not out["correct"]
    assert out["checks"][UNCHANGED[kind]]["value"] == pytest.approx(1.0)


def _half(fn, *positions):
    def broken(*args, **kwargs):
        args = list(args)
        for i in positions:
            args[i] = args[i][:len(args[i]) // 2]
        return fn(*args, **kwargs)
    return broken


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_half_the_batch_left_out_is_caught(tmp_path, kind, monkeypatch):
    from facet_graph_convolution_torch.models import losses
    from facet_graph_convolution_torch.parallel import halo
    from facet_graph_convolution_torch.training import trainer

    monkeypatch.setattr(trainer, "face_normals_loss", _half(losses.face_normals_loss, 0, 1))
    monkeypatch.setattr(trainer, "full_chamfer_loss", _half(losses.full_chamfer_loss, 2, 3))

    def half_mask(indices, num_nodes, group):
        return sample_mask_from(indices[:len(indices) // 2], num_nodes, group)

    sample_mask_from = halo.sample_mask_from
    monkeypatch.setattr(halo, "sample_mask_from", half_mask)
    out = _run(tmp_path, kind)
    assert not out["correct"]
    check = out["checks"][HALF[kind]]
    assert check["value"] > check["limit"]
