"""Profile the normals train step on one card, kernel by kernel.

    python tools/k3_step_probe.py [--conv1_only] [--out FILE]

At ``chip_smoke.py``'s training set (the whole subdivision-5 icosphere, one
patch bucket-padded to 25,600 nodes, full width), for the default and the
rotation-invariant network in float32 and in bfloat16 compute: the eager
step's median host ms (10 steps after 3, each ending in its loss read) and
one profiled eager step; the step through its CUDA graph (10 steps a call,
median of 5 calls) and one profiled call. Each profile prints the device
busy ms, the busy share of the unprofiled wall time, the device activities
a step and every kernel's device ms and launches a step. Then, for each
dtype and form, the kernels whose time or count differs between the two
networks: the rotation-invariant conv1's chain (its softmax, multiply,
casts, K3 and the backward around K3) against the default conv1's K1/K2.

Then conv1 alone at the step's inputs (the patch's 6 input channels, the
level-0 tables, full-width random parameters): the rotation-invariant
conv's forward and its backward to the parameters (the input is data, as
in the step), and, apart, the logits' product ``feats @ u.T + c`` and its
backward at conv1's shapes, each profiled eagerly (kernels and launches);
so that each kernel of the step's difference is placed in its op.

Uses only the trainer's and the conv's public API, so it runs on any
version of the port since the graph step (e.g. an earlier commit unpacked into a
gitignored directory such as ``bench_trees/``, run from there). Builds the
CUDA kernels first. Card only, ~2 min.
"""

import argparse
import os
import sys
import time

import numpy as np

GRAPH_STEPS = 10


def bench_patch(dev):
    """The whole subdivision-5 icosphere as ``bench.py`` and
    ``chip_smoke.py`` build it (noise 0.01, bucket-padded to a multiple of
    1024 nodes)."""
    from facet_graph_convolution_torch.data.dataset import TrainingSet, bucket_size, pad_patch_to
    from facet_graph_convolution_torch.data.synthetic import icosphere
    from facet_graph_convolution_torch.training.trainer import patch_tensors

    v, f = icosphere(5)
    ds = TrainingSet(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3,
                     k_faces=23, seed=0)
    noisy = (v + np.random.default_rng(0).normal(scale=0.01, size=v.shape)).astype(np.float32)
    ds.add_mesh(noisy, f, gt_vertices=v)
    patch = pad_patch_to(ds.patches[0], bucket_size(ds.patches[0].num_nodes, 1024))
    return patch, patch_tensors(patch, str(dev))


def kernels_of(fn, steps):
    """(busy ms, activities, {kernel: (ms, launches)}) a step of one call of
    ``fn`` (``steps`` steps), traced from a warm-up call on."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    by_name, busy, count = {}, 0.0, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        ms = e.time_range.elapsed_us() / 1e3
        busy += ms
        count += 1
        t, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + ms, k + 1)
    return busy / steps, count / steps, {k: (t / steps, n / steps) for k, (t, n) in
                                          by_name.items()}


def wall_ms(fn):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def measure(cfg, patch, tensors, dev, out):
    import torch

    from facet_graph_convolution_torch.training.trainer import (
        create_train_state,
        make_normals_train_step,
        make_scanned_train_step,
        normals_draws,
        stack_patch_tensors,
    )

    res = {}
    state = create_train_state(cfg, num_steps=100, device=str(dev))
    step = make_normals_train_step(cfg)
    times = []
    for i in range(13):
        t0 = time.perf_counter()
        state, loss = step(state, *tensors)
        float(loss)
        if i >= 3:
            times.append(1e3 * (time.perf_counter() - t0))
    times.sort()

    def eager():
        float(step(state, *tensors)[1])

    res["eager"] = (times[len(times) // 2], wall_ms(eager), *kernels_of(eager, 1))

    gstate = create_train_state(cfg, num_steps=100, device=str(dev))
    scanned = make_scanned_train_step(gstate, cfg, stack_patch_tensors([patch], str(dev)),
                                      GRAPH_STEPS)
    gen = torch.Generator().manual_seed(11)

    def graph():
        scanned(gstate, normals_draws(cfg, gen, [0] * GRAPH_STEPS, patch.num_nodes))[1].numpy()

    graph()
    per_call = []
    for _ in range(5):
        t0 = time.perf_counter()
        graph()
        per_call.append(1e3 * (time.perf_counter() - t0) / GRAPH_STEPS)
    per_call.sort()
    res["graph"] = (per_call[len(per_call) // 2], wall_ms(graph) / GRAPH_STEPS,
                    *kernels_of(graph, GRAPH_STEPS))
    for form, (median, wall, busy, acts, kernels) in res.items():
        out(f"  {form}: step median {median:.3f} ms; profiled: wall {wall:.3f} ms a step, "
            f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%), {acts:.1f} activities a "
            "step")
        for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
            out(f"    {ms:9.5f} ms {n:5.1f}x  {name[:150]}")
    return res


def conv1_chain(tensors, dev, out):
    """Profile conv1 of the rotation-invariant network alone, forward and
    backward to its parameters, f32 and bf16 compute; and the logits'
    product at conv1's shapes."""
    import torch

    from facet_graph_convolution_torch.models.unet import init_unet
    from facet_graph_convolution_torch.ops.conv import FacetConvVariant, facet_conv

    ri = FacetConvVariant.ROTATION_INVARIANT
    x, adjs, adj_ts, mult_rows = tensors[:4]
    n = x.shape[0]
    params = {k: t.requires_grad_() for k, t in
              init_unet(0, x.shape[1], variant=ri, device=str(dev))["conv1"].items()}
    names = sorted(params)
    dy = torch.randn(n, params["b"].shape[0], device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    for dtype in (None, torch.bfloat16):
        def run(dtype=dtype):
            y = facet_conv(params, x, adjs[0], mult_rows[0], variant=ri, adj_t_sm=adj_ts[0],
                           compute_dtype=dtype)
            torch.autograd.grad(y, [params[k] for k in names], dy)

        busy, acts, kernels = kernels_of(run, 1)
        out(f"conv1 alone ({'bf16' if dtype else 'f32'}), forward and backward: device busy "
            f"{busy:.5f} ms, {acts:.0f} activities")
        for name, (ms, k) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
            out(f"    {ms:9.5f} ms {k:5.1f}x  {name[:150]}")
    slots = mult_rows[0].shape[0]
    feats = torch.randn(slots, n, x.shape[1], device=dev)
    u, c = params["u"], params["c"]

    def logits_only():
        logits = feats @ u.T + c
        torch.autograd.grad(logits, [u, c], torch.ones_like(logits))

    busy, acts, kernels = kernels_of(logits_only, 1)
    out(f"the logits' product alone (feats [{slots}, {n}, {x.shape[1]}] @ u.T + c), forward "
        f"and backward to u and c: device busy {busy:.5f} ms, {acts:.0f} activities")
    for name, (ms, k) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
        out(f"    {ms:9.5f} ms {k:5.1f}x  {name[:150]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the report to this file")
    ap.add_argument("--conv1_only", action="store_true", help="profile conv1 alone, no steps")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("k3_step_probe: no CUDA device", file=sys.stderr)
        return 2
    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.ops import cuda_library

    lines = []

    def out(text):
        print(text, flush=True)
        lines.append(text)

    import subprocess

    out(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60).stdout.strip())
    out(f"k3_step_probe from {os.getcwd()}")
    t0 = time.perf_counter()
    out(f"build: {cuda_library.build()} in {time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    patch, tensors = bench_patch(dev)
    conv1_chain(tensors, dev, out)
    results = {}
    for dtype in () if args.conv1_only else ("float32", "bfloat16"):
        for rotinv in (False, True):
            cfg = default_config().replace(model={"rotation_invariance": rotinv,
                                                  "compute_dtype": dtype})
            label = ("rotation-invariant" if rotinv else "default") + f" {dtype}"
            out(f"{label} step, {patch.num_nodes}-node patch:")
            results[label] = measure(cfg, patch, tensors, dev, out)
    for dtype in () if args.conv1_only else ("float32", "bfloat16"):
        for form in ("eager", "graph"):
            base = results[f"default {dtype}"][form][4]
            rot = results[f"rotation-invariant {dtype}"][form][4]
            out(f"rotation-invariant minus default, {dtype}, {form} (ms a step, launches a "
                "step):")
            total = 0.0
            for name in sorted(set(base) | set(rot),
                               key=lambda k: -abs(rot.get(k, (0, 0))[0] - base.get(k, (0, 0))[0])):
                (tr, nr), (tb, nb) = rot.get(name, (0.0, 0.0)), base.get(name, (0.0, 0.0))
                if abs(tr - tb) < 1e-3 and nr == nb:
                    continue
                total += tr - tb
                out(f"    {tr - tb:+9.5f} ms ({tr:.5f} vs {tb:.5f}) {nr:4.1f}x vs {nb:4.1f}x  "
                    f"{name[:130]}")
            out(f"    total {total:+.5f} ms of kernel time a step")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
