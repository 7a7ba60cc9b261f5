"""The port's Wang-dataset runner (``cli/wang.py``) on the CPU: stage →
preprocess → train → infer → metrics → summary on a small synthetic tree laid
out as the Wang et al. dataset (``tests/test_wang_runner.py`` builds the
same layout for the JAX runner), at the full width of the default config.
The run is short (3 steps), so only the artifacts, their shapes and ranges
are held, not the accuracy."""

import numpy as np
import pytest
import torch

from facet_graph_convolution_torch.cli import wang
from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere
from facet_graph_convolution_torch.geometry.obj_io import write_obj


@pytest.fixture
def data_root(tmp_path):
    """train/{noisy,original} + test/{noisy,original} with _n1/_n2 names."""
    root = tmp_path / "wang_data"
    rng = np.random.default_rng(0)
    v, f = icosphere(2)
    for split in ("train", "test"):
        (root / split / "noisy").mkdir(parents=True)
        (root / split / "original").mkdir(parents=True)
        write_obj(v, f, str(root / split / "original" / "sphere.obj"))
        for i, level in enumerate(("_n1", "_n2"), start=1):
            write_obj(add_vertex_noise(v, f, 0.1 * i, rng), f,
                      str(root / split / "noisy" / f"sphere{level}.obj"))
    return root


def test_wang_runner_end_to_end_on_cpu(data_root, tmp_path, capsys):
    base = tmp_path / "run"
    argv = ["--data_root", str(data_root), "--base_path", str(base), "--device", "cpu"]
    assert wang.main(argv + ["--num_iterations", "3"]) == 0
    out = capsys.readouterr().out

    assert (base / "Preprocessed_Data" / "trainingSet.npz").exists()
    assert (base / "Networks" / "wang" / "params.pt").exists()
    history = np.loadtxt(base / "Networks" / "wang.csv", delimiter=",", ndmin=2)
    assert np.isfinite(history[:, 0]).all()
    results = base / "Results"
    assert sorted(p.name for p in results.glob("*_denoised.obj")) == [
        "sphere_n1_denoised.obj", "sphere_n2_denoised.obj"]
    assert sorted(p.name for p in results.glob("*_heatmap.obj")) == [
        "sphere_n1_heatmap.obj", "sphere_n2_heatmap.obj"]
    assert (results / "angDiffFinal.mat").exists()
    rows = (results / "results_heat.csv").read_text().strip().splitlines()
    assert len(rows) == 2
    for row in rows:
        assert 0.0 < float(row.split()[3]) < 90.0
    assert "mean angular error" in out and "[wang] seconds: preprocess" in out

    # resumable: preprocessing, inference and metrics skip what exists
    assert wang.main(argv + ["--skip_train"]) == 0
    out = capsys.readouterr().out
    assert "exists — skipping" in out and "skipping sphere_n1.obj: result exists" in out
    assert len((results / "results_heat.csv").read_text().strip().splitlines()) == 2


def test_wang_runner_runs_the_last_partial_call(data_root, tmp_path):
    base = tmp_path / "run"
    res = wang.run(["--data_root", str(data_root), "--base_path", str(base), "--device", "cpu",
                    "--num_iterations", "3", "--steps_per_call", "2"])
    assert set(res["seconds"]) == {"preprocess", "train", "infer", "metrics"}
    assert [r["name"] for r in res["records"]] == ["sphere_n1", "sphere_n2"]
    # a history row a call: one of 2 steps, then the remainder of 1
    history = np.loadtxt(base / "Networks" / "wang.csv", delimiter=",", ndmin=2)
    assert history.shape == (2, 2) and np.isfinite(history[:, 0]).all()
    assert sorted(p.name for p in (base / "Networks" / "wang").glob("step_*.pt")) == [
        "step_3.pt"]


def test_wang_runner_needs_a_card_unless_cpu(data_root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wang.main(["--data_root", str(data_root), "--base_path", str(tmp_path / "run"),
                   "--num_iterations", "1"])


def test_wang_runner_refuses_a_bad_layout(tmp_path):
    (tmp_path / "data" / "train" / "noisy").mkdir(parents=True)
    with pytest.raises(SystemExit, match="missing 'train/original'"):
        wang.main(["--data_root", str(tmp_path / "data"), "--base_path", str(tmp_path / "run"),
                   "--device", "cpu"])


def test_summarize_groups_by_noise_level(tmp_path, capsys):
    (tmp_path / "results_heat.csv").write_text(
        "a_n1_denoised.obj 0.1 0.01 4.0 1.0 320 0 0 0 0 \n"
        "b_n1_denoised.obj 0.1 0.01 6.0 1.0 320 0 0 0 0 \n"
        "a_n2_denoised.obj 0.1 0.01 9.0 1.0 320 0 0 0 0 \n")
    wang._summarize(str(tmp_path))
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-3].split() == ["_n1", "2", "5.000"]
    assert lines[-2].split() == ["_n2", "1", "9.000"]
    assert lines[-1].split() == ["all", "3", "6.333"]
