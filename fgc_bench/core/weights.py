"""The U-Net's weights, made on the device from the run's seed: one
``torch.Generator`` on the device, one normal draw for every leaf at once,
then each leaf scaled by its standard deviation (the paper's N(0, 0.05)
for weights, N(0, 0.01) for biases). The program and the plain reference
start from these same numbers."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def unet_shapes(config: Dict, heads: int) -> List[Tuple[str, str, Tuple[int, ...]]]:
    """``(layer, leaf, shape)`` of every leaf: a conv has ``w`` [M, out, in],
    ``b`` [out], ``u`` and ``v`` [M, in], ``c`` [M]; a dense layer ``w``
    [in, out] and ``b`` [out]."""
    c0, c1, c2 = config["channels"]
    m, fc, out, cin = (config["num_filters"], config["fc_channels"], config["out_channels"],
                       config["in_channels"])
    convs = [("conv1", cin, c0), ("conv2", c0, c1), ("conv3", c1, c2), ("dconv3", c2, c2),
             ("upconv2", c2, c1), ("dconv2", 2 * c1, c1), ("upconv1", c1, c0),
             ("dconv1", 2 * c0, c0)]
    dense = [("fc1", c0, fc), ("out0", fc, out)]
    if heads == 3:
        dense += [("fc_mid", c1, fc), ("out1", fc, out), ("fc_coarse", c2, fc), ("out2", fc, out)]
    shapes = []
    for name, i, o in convs:
        shapes += [(name, "w", (m, o, i)), (name, "b", (o,)), (name, "u", (m, i)),
                   (name, "c", (m,)), (name, "v", (m, i))]
    for name, i, o in dense:
        shapes += [(name, "w", (i, o)), (name, "b", (o,))]
    return shapes


def make_weights(config: Dict, heads: int, seed: int, device: str) -> Dict[str, Dict[str, torch.Tensor]]:
    shapes = unet_shapes(config, heads)
    sizes = [int(torch.Size(s).numel()) for _, _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for (layer, leaf, shape), part in zip(shapes, torch.split(flat, sizes)):
        std = config["std_dev_bias"] if leaf == "b" else config["std_dev"]
        out.setdefault(layer, {})[leaf] = (part * std).reshape(shape)
    return out
