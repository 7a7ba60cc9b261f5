"""Training checkpoints (the port's counterpart of
``facet_graph_convolution_tpu/training/checkpoint.py``, which uses Orbax).

Reference flow: a checkpoint every ``save_every`` iterations plus a final
save (train.py:551-552,626), and resume from the latest step
(train.py:528-534). Here a checkpoint is ``torch.save`` of ``{params,
optimizer state, step}`` as ``<network_path>/<net_name>/step_<step>.pt``;
the last ``max_to_keep`` are kept. It is read onto the CPU and loaded into
the template's optimizer in that optimizer's form, so a checkpoint of the
card's capturable Adam (its update counts on the device) resumes on the card
and loads on the CPU, and the other way round. Every save also writes the parameters to
``params.pt`` in the same directory (:func:`..params.save`), the file that
``cli.infer`` reads, so the newest net is the one served.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch

from facet_graph_convolution_torch import params as params_io

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _load_optimizer(optimizer: torch.optim.Optimizer, saved: dict) -> None:
    """Load a saved Adam state (moments and update counts) into
    ``optimizer``, which keeps its own group settings: capturable with a
    tensor learning rate on the card, plain on the CPU. A checkpoint written
    on either device thus resumes on either: the update counts (``step``) go
    to the parameters' device under a capturable Adam and to the CPU
    otherwise."""
    kept = [{k: v for k, v in g.items() if k != "params"} for g in optimizer.param_groups]
    optimizer.load_state_dict(saved)
    for group, own in zip(optimizer.param_groups, kept):
        group.update(own)
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state:
                state["step"] = state["step"].to(p.device if own["capturable"] else "cpu")


class CheckpointManager:
    def __init__(self, directory: str, net_name: str = "net", max_to_keep: int = 3):
        self.directory = os.path.abspath(os.path.join(directory, net_name))
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self):
        """The saved steps, oldest first."""
        found = (_STEP_FILE.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> None:
        """Write ``state`` (a :class:`..trainer.TrainState`) as checkpoint
        ``step``, drop the oldest beyond ``max_to_keep``, and write
        ``params.pt``."""
        tree = {
            "params": {layer: {name: t.detach().cpu() for name, t in leaves.items()}
                       for layer, leaves in state.params.items()},
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
        }
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        params_io.save(state.params, os.path.join(self.directory, params_io.CHECKPOINT_FILE))

    def restore(self, state_template, step: Optional[int] = None) -> Tuple[object, int]:
        """Load checkpoint ``step`` (default: the latest) into the template's
        tensors and optimizer; returns ``(state, step)``, or
        ``(template, 0)`` when no checkpoint exists (the reference trains
        from scratch then, train.py:528-534)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return state_template, 0
        # weights_only: nested dicts of tensors and numbers, nothing that
        # unpickling could execute
        tree = torch.load(self._path(step), map_location="cpu", weights_only=True)
        with torch.no_grad():
            for layer, leaves in state_template.params.items():
                for name, t in leaves.items():
                    t.copy_(tree["params"][layer][name])
        _load_optimizer(state_template.optimizer, tree["optimizer"])
        state_template.step = int(tree["step"])
        return state_template, int(step)

    def close(self) -> None:
        """Nothing is held open between saves (Orbax's manager needs this)."""
