"""Near-tied chamfer terms: the reference finds them, and the comparison of
the first gradient takes the resolution of them nearest the program's."""

import pytest
import torch

from fgc_bench.reference.network import chamfer_loss
from fgc_bench.reference.train import compare, run_steps

# one sampled point of p0 with two points of p1, in directions at a right
# angle, 1e-6 apart in distance from it; every other nearest point is clear
P1 = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0 + 1e-6, 0.0], [0.0, 5.0, 0.0]])
P0 = torch.tensor([[0.0, 0.0, 0.0], [0.0, 4.9, 0.0]])


@pytest.mark.parametrize("tolerance, count", [(0.0, 0), (1e-7, 0), (1e-5, 1)])
def test_near_ties_are_found_within_the_tolerance(tolerance, count):
    _, ties, margins = chamfer_loss(P0, P1, torch.tensor([0]), torch.tensor([2]),
                                    tolerance=tolerance)
    assert ties.numel() == margins.numel() == count


def test_a_tie_gives_the_loss_of_the_other_choice():
    loss, ties, margins = chamfer_loss(P0, P1, torch.tensor([0]), torch.tensor([2]),
                                       tolerance=1e-5)
    assert margins[0] == pytest.approx(1e-6, rel=0.2)
    # precision: the sampled point's second-nearest is 1 + 1e-6 away
    other = 1000.0 * ((1.0 + 1e-6) + 0.1)
    assert float(loss + ties[0]) == pytest.approx(other, rel=1e-6)


def _closure(resolve_other):
    def loss(params):
        p0 = P0 + params["shift"]["x"]
        total, ties, margins = chamfer_loss(p0, P1, torch.tensor([0]), torch.tensor([2]),
                                            tolerance=1e-5)
        if resolve_other:
            return total + ties.sum()
        return total, ties, margins
    return loss


def test_the_first_gradient_is_held_to_the_nearest_resolution():
    params0 = {"shift": {"x": torch.zeros(3)}}
    ref = run_steps(params0, [_closure(False)], 1e-3, "cpu")
    other = run_steps(params0, [_closure(True)], 1e-3, "cpu")
    assert ref.tie_margins.size == 1
    # the other resolution turns the point's gradient by a right angle
    assert not torch.allclose(ref.first_grads[("shift", "x")], other.first_grads[("shift", "x")])
    assert compare(other, ref, tie_tolerance=1e-5)["grad_gap"] == pytest.approx(0.0, abs=1e-9)
    assert compare(other, ref, tie_tolerance=0.0)["grad_gap"] > 0.1
    assert compare(ref, ref, tie_tolerance=1e-5)["grad_gap"] == 0.0
