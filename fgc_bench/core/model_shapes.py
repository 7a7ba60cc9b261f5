"""The U-Net's layers as the yardstick counts them: each conv's level,
input and output channels, and the dense layers of the heads. Counts are
of the work the model needs on the real nodes of each level (a level-l
node is real when it holds a face of the mesh), whatever the program pads."""

from __future__ import annotations

from typing import Dict, List, Tuple


def convs(config: Dict) -> List[Tuple[str, int, int, int]]:
    """``(name, level, in, out)`` of the eight convs."""
    c0, c1, c2 = config["channels"]
    return [("conv1", 0, config["in_channels"], c0), ("conv2", 1, c0, c1), ("conv3", 2, c1, c2),
            ("dconv3", 2, c2, c2), ("upconv2", 1, c2, c1), ("dconv2", 1, 2 * c1, c1),
            ("upconv1", 0, c1, c0), ("dconv1", 0, 2 * c0, c0)]


def dense(config: Dict, heads: int) -> List[Tuple[str, int, int, int]]:
    """``(name, level, in, out)`` of the dense layers."""
    c0, c1, c2 = config["channels"]
    fc, out = config["fc_channels"], config["out_channels"]
    layers = [("fc1", 0, c0, fc), ("out0", 0, fc, out)]
    if heads == 3:
        layers += [("fc_mid", 1, c1, fc), ("out1", 1, fc, out),
                   ("fc_coarse", 2, c2, fc), ("out2", 2, fc, out)]
    return layers


def storage_bytes(config: Dict) -> int:
    return 2 if config["compute_dtype"] == "bfloat16" else 4
