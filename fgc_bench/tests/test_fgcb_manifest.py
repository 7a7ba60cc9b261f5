"""``BENCHMARK.json`` against the benchmark's contract, and every cell,
configuration and metric found by name in its own file."""

import json
import os
import re

import pytest

from fgc_bench.core import manifest
from fgc_bench.core.runner import result_line
from fgc_bench.tests.tiny import write_tiny

with open(os.path.join(manifest.REPO_ROOT, "BENCHMARK.json")) as fh:
    BENCH = json.load(fh)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "fgc_bench/run.py"]
    assert BENCH["paths"] == ["fgc_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(manifest.REPO_ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_entries():
    names = [e["name"] for part in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[part]]
    for part in ("configs", "workloads"):
        seen = [e["name"] for e in BENCH[part]]
        assert len(seen) == len(set(seen))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and NAME.match(w["traffic"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    c = manifest.load_cell(cell)
    assert c.config["name"] == c.workload["config"]
    assert manifest.driver(c).Session
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    limits = c.workload["limits"]
    assert limits and set(limits) <= {"loss_gap", "loss1_gap", "grad_gap", "grad_median_gap",
                                   "change_gap", "change_median_gap"}
    assert all(isinstance(v, float) and v > 0 for v in limits.values())


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    path = os.path.join(manifest.REPO_ROOT, config["file"])
    assert config["file"].startswith("fgc_bench/configs/")
    with open(path) as fh:
        data = json.load(fh)
    assert data["name"] == config["name"]
    assert set(config["reduced"]) == set(data["reduced"])
    assert config["name"] in [w["config"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_by_name(metric):
    assert callable(manifest.metric_reader(metric))


def test_throwaway_cell_loads_from_its_own_files(tmp_path):
    path = write_tiny(str(tmp_path), name="throwaway.cell")
    cell = manifest.load_cell("throwaway.cell", path, str(tmp_path))
    assert cell.config["name"] == "tiny" and cell.workload["driver"] == "patch_chunks"
    assert [m["name"] for m in cell.per_layer] == ["step_mfu_pct"]


def test_last_line_has_the_contract_keys():
    checks = {"loss_gap": {"value": 1e-7, "limit": 1e-5}}
    line = result_line(True, 100, 0, {"setup_s": {"value": 12.5, "unit": "s"}},
                       {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                        "memory_peak_bytes": 123}, None, "card", checks)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "card", "checks"]
    traced = result_line(True, 1, 0, {}, {}, {"device_ops": [], "idle_gaps": []}, "card", checks)
    assert list(traced)[-1] == "checks" and "breakdown" in traced
    assert json.loads(json.dumps(line)) == line

