"""The control of each cell's comparison on the card, at the cell's own
size: the plain reference with its products in TF32 (the nearest precision
below the configurations' float32) and with half of each step's batch left
out, put in the program's place, must each fail one of the cell's limits,
while the program's own first steps pass them. Needs a card; run with

    python -m pytest fgc_bench/tests/test_fgcb_control.py -q -m cuda
"""

import json
import os

import pytest

from fgc_bench.core.manifest import REPO_ROOT, load_cell

with open(os.path.join(REPO_ROOT, "BENCHMARK.json")) as fh:
    CELLS = [w["name"] for w in json.load(fh)["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size on the card")
    return "cuda"


def _fails(numbers, limits):
    return any(numbers[k] > limits[k] for k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_half_batch_fail_the_limits(card, cell):
    from fgc_bench.control import readings

    limits = load_cell(cell).workload["limits"]
    r = readings(cell, 7_000_000_011, card)
    assert not _fails(r["sound"], limits), r["sound"]
    assert _fails(r["control"], limits), r["control"]
    assert _fails(r["half_batch"], limits), r["half_batch"]
