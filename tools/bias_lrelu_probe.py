"""Time the bias + lrelu kernels (``csrc/bias_lrelu.cu``) beside the
elementwise chain they replace, at the U-Net's shapes (card only).

For each shape: the forward kernel with its codes, the backward kernel, and
the whole layer's forward and backward (``bias_lrelu`` and the bias
gradient's sum) against autograd through ``lrelu(y + b)``, in device ms by
CUDA events over repeated launches (warm L2 only where the tensors fit it),
each kernel's bytes bound at 3.35 TB/s and the layer's peak memory above
its inputs. Checks the bits against the chain first.

    python tools/bias_lrelu_probe.py [--reps N] [--out chiprun_out/bias_lrelu_probe.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from facet_graph_convolution_torch.ops import bias_lrelu_kernel as bl  # noqa: E402
from facet_graph_convolution_torch.ops import cuda_library  # noqa: E402
from facet_graph_convolution_torch.ops.normalization import lrelu  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
# (name, rows, channels, bias): fc1 and conv1 at the torus's level 0, fc1 of
# a 25,600-node patch
SHAPES = [("torus_fc1", 1273920, 1024, True), ("torus_conv1", 1273920, 32, False),
          ("patch_fc1", 25600, 1024, True)]


def device_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def peak_above(fn) -> float:
    """GiB allocated above what was live when ``fn`` started, at its peak."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def probe(name, n, c, bias, reps):
    gen = torch.Generator(device="cuda").manual_seed(0)
    y = torch.randn(n, c, device="cuda", generator=gen)
    b = torch.randn(c, device="cuda", generator=gen) * 0.1 if bias else None
    dh = torch.randn(n, c, device="cuda", generator=gen)
    elems = n * c

    def chain_layer():
        yg = y.detach().requires_grad_()
        bg = None if b is None else b.detach().requires_grad_()
        h = lrelu(yg if bg is None else yg + bg, 0.1)
        return torch.autograd.grad(h, [yg] + ([] if bg is None else [bg]), dh)

    def kernel_layer():
        yg = y.detach().requires_grad_()
        bg = None if b is None else b.detach().requires_grad_()
        h = bl.bias_lrelu(yg, bg, 0.1)
        return torch.autograd.grad(h, [yg] + ([] if bg is None else [bg]), dh)

    got, want = kernel_layer(), chain_layer()
    same = all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want))
    del got, want
    h, code = bl.bias_lrelu_fwd(y, b, 0.1, need_code=True)
    out = {
        "shape": name, "rows": n, "channels": c, "bias": bias, "bits_equal_chain": same,
        "fwd_ms": device_ms(lambda: bl.bias_lrelu_fwd(y, b, 0.1, need_code=True), reps),
        "fwd_no_code_ms": device_ms(lambda: bl.bias_lrelu_fwd(y, b, 0.1), reps),
        "bwd_ms": device_ms(lambda: bl.bias_lrelu_bwd(dh, code, 0.1), reps),
        "fwd_bound_ms": elems * 9 / HBM_BYTES_PER_S * 1e3,
        "bwd_bound_ms": elems * 9 / HBM_BYTES_PER_S * 1e3,
        "layer_ms": device_ms(kernel_layer, reps),
        "chain_layer_ms": device_ms(chain_layer, reps),
        "db_sum_ms": device_ms(lambda: dh.sum(0), reps) if bias else None,
        "layer_peak_gib": peak_above(kernel_layer),
        "chain_layer_peak_gib": peak_above(chain_layer),
    }
    out["fwd_bound_share"] = out["fwd_bound_ms"] / out["fwd_ms"]
    out["bwd_bound_share"] = out["bwd_bound_ms"] / out["bwd_ms"]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/bias_lrelu_probe.json")
    args = ap.parse_args()
    cuda_library.build(["bias_lrelu"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    with open(os.path.join(cuda_library.BUILD_DIR, "bias_lrelu.log")) as fh:
        ptxas = [line.strip() for line in fh if "registers" in line or "spill" in line]
    rows = [{"card": card, "ptxas": ptxas}]
    for shape in SHAPES:
        rows.append(probe(*shape, args.reps))
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(rows, fh, indent=1)
    print(json.dumps(rows[0]))


if __name__ == "__main__":
    main()
