"""The rotation-invariant network's training loop over patches: the
program's ``train_normals(steps_per_call=N)`` chunk loop with
``rotation_invariance`` on, so conv1 runs the rotation-invariant conv (its
rotation features, its logits and K3, forward and backward) and the other
seven convs K1/K2.

Everything but the weights and the reference is :mod:`patch_chunks`'s: the
same patches, draws and calls through ``make_scanned_train_step``. The
weights are that driver's draw at the same seed with conv1's ``v`` left
out (the rotation-invariant assignment has none), so every other leaf
equals the normals cell's. The reference is
:mod:`fgc_bench.reference.rotinv`.
"""

from __future__ import annotations

from typing import List

from fgc_bench.drivers import patch_chunks
from fgc_bench.drivers.common import ReferencePatch
from fgc_bench.reference import network as ref_net
from fgc_bench.reference import rotinv as ref_rot

FAULTS = ("", "half_batch", "no_rotation")


class Session(patch_chunks.Session):
    def __init__(self, cell, seed: int, device: str):
        from facet_graph_convolution_torch.training.graph_step import GraphStep
        from facet_graph_convolution_torch.training.trainer import create_train_state

        super().__init__(cell, seed, device)
        # the state and the graph step again over the weights without conv1's v,
        # before the first call captures anything; the step's loss (and the
        # patches it holds on the card) is the one make_scanned_train_step built
        for weights in (self.params0, self.host_params0):
            del weights["conv1"]["v"]
        self.state = create_train_state(self.cfg, device=device, params=self.params0)
        self.scanned = GraphStep(self.state, self.scanned.loss_fn, self.steps_per_call)

    def reference_losses(self, device: str, fault: str = ""):
        """The loss closures of the first steps, for the plain reference;
        ``fault`` plants one for the limits' derivation: ``half_batch``
        takes each step's loss over half its sampled faces, ``no_rotation``
        leaves conv1's rotation out (R = I)."""
        if fault not in FAULTS:
            raise ValueError(f"rotinv_chunks: no fault {fault!r}; the faults are {FAULTS[1:]}")
        closures, cache = [], {}
        for draws in self.first_draws:
            for j in range(len(draws["idx"])):
                i = int(draws["idx"][j, 0])
                if i not in cache:
                    cache[i] = self.reference_patch(i).to(device)
                idx = draws["sample_idx"][j]
                if fault == "half_batch":
                    idx = idx[:len(idx) // 2]
                closures.append(_rotinv_loss(cache[i], draws["rot"][j].to(device), idx.to(device),
                                             rotate=fault != "no_rotation"))
        return closures

    def kernel_convs(self, kernel: str) -> List[str]:
        """The convs whose work ``kernel`` does a step: K3 conv1's, K1 and
        K2 the other seven."""
        if kernel == "k3":
            return ["conv1"]
        if kernel in ("k1", "k2"):
            return [name for name, _ in ref_net.CONVS if name != "conv1"]
        return []


def _rotinv_loss(patch: ReferencePatch, rot, sample_idx, rotate: bool = True):
    def loss(params):
        x = (patch.x.reshape(-1, 2, 3) @ rot.T).reshape(-1, 6)
        gt = patch.gt @ rot.T
        y = ref_net.normalize(ref_rot.unet(params, x, patch.nbrs, fan=patch.fan,
                                           rotate=rotate)[0])
        return ref_net.angular_loss(y[sample_idx], gt[sample_idx])
    return loss
