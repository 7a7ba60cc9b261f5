"""Find a cell's files by name.

``BENCHMARK.json`` (at the root of the checkout) lists the cells, the
configurations and the metrics. Each has its own files under the
benchmark's directory, found by name and never listed in code:

- ``workloads/<cell>.json``: the cell's configuration, driver, traffic
  parameters, chips, ``why`` and the limits of its comparison;
- ``configs/<config>.json``: a configuration's sizes and precision;
- ``drivers/<driver>.py``: one kind of measured window;
- ``metrics/<metric>.py``: one per-layer metric's reader.

A later cell, configuration or metric is new files and new entries, and no
edit of a file here.
"""

from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    workload: Dict            # the cell's file
    config: Dict              # its configuration's file
    end_to_end: List[Dict]    # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: List[Dict]     # ... and per-layer metrics

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    @property
    def traffic(self) -> Dict:
        return self.workload["traffic"]


def _read(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: Optional[str] = None, root: Optional[str] = None) -> Cell:
    """The cell ``name`` of ``manifest`` (default ``BENCHMARK.json`` at the
    root of the checkout), its files read from ``root`` (default this
    benchmark's directory)."""
    manifest = manifest or os.path.join(REPO_ROOT, "BENCHMARK.json")
    root = root or BENCH_DIR
    bench = _read(manifest)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {manifest}")
    workload = _read(os.path.join(root, "workloads", name + ".json"))
    if workload["config"] != entry["config"] or int(workload["chips"]) != int(entry["chips"]):
        raise ValueError(f"{name}: the workload file's config / chips differ from {manifest}")
    config = _read(os.path.join(root, "configs", entry["config"] + ".json"))
    return Cell(name, workload, config,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def driver(cell: Cell):
    """The module ``drivers/<driver>.py`` of the cell."""
    return importlib.import_module(f"fgc_bench.drivers.{cell.workload['driver']}")


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return importlib.import_module(f"fgc_bench.metrics.{name}").read
