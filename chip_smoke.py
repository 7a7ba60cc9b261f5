"""Drive the PyTorch port on one NVIDIA GPU (H100) and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile every CUDA kernel of the port from ``csrc/`` (one ``nvcc``
   per source, in parallel);
2. kernel: the facet-conv forward kernel (K1) against its plain PyTorch
   version on the card, at the 8 conv shapes of the largest patch of a
   noisy subdivision-5 icosphere (20,480 faces, two patches), on the real
   slot tables (pad slots, padded nodes, zero fake rows); prints each
   launch's error, kernel and plain times and bound;
3. serving: ``infer_directory`` answers 3 requests (subdivision-5 icosphere,
   torus, chamfered box, with noise) at the full model width (channels
   32/64/128, M = 9, fc 1024, random weights from a seed); checks the written
   meshes, that K1 ran 8 times per patch, and that each patch's forward
   through the kernel matches the same forward through the plain version.

Then it prints the kernels' JSON line, the card's ``nvidia-smi`` name and
power limit, and as its last line ``{"ok": true, "device": {...}}``. It exits
non-zero, printing no result, without a CUDA device or outside the repo.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12      # HBM3, SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores
KERNEL_ATOL = KERNEL_RTOL = 1e-5
FORWARD_ATOL = 1e-4
CONVS = (  # name, level, input channels (out channels follow the model)
    ("conv1", 0, 6), ("conv2", 1, 32), ("conv3", 2, 64), ("dconv3", 2, 128),
    ("upconv2", 1, 128), ("dconv2", 1, 128), ("upconv1", 0, 64), ("dconv1", 0, 64),
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Per call: (device ms, wall ms). Device time is the sum of the device
    activities (kernels, copies) that torch.profiler records over ``reps``
    calls; wall time spans the calls with CUDA events, so for a kernel
    shorter than its host-side launch it is the launch rate. Device time is
    None when the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    device_ms = device_us / 1e3 / reps if device_us > 0 else None
    return device_ms, start.elapsed_time(end) / reps


def bound_ms(cat, ux, adj_sm, rows, c, z):
    """Least time for K1's work on this card: each input read once and z
    written once at the HBM rate, against the operations this data needs
    (per slot with mult > 0: M·(2C) aggregation FMAs as 2 ops, ~6·M softmax
    ops) at the f32 rate; the larger of the two."""
    import torch

    n = adj_sm.shape[1]
    m = ux.shape[1]
    c_in = cat.shape[1] - m
    nbytes = sum(t.numel() * t.element_size() for t in (cat, ux, adj_sm, rows, c, z))
    live = rows != 0
    live[1:] &= (adj_sm > 0) & (adj_sm <= n)
    slots = int(torch.count_nonzero(live))
    ops = slots * m * (2 * c_in + 6)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(dev):
    import torch

    from facet_graph_convolution_torch.data.dataset import InferenceMesh
    from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere
    from facet_graph_convolution_torch.models.unet import graph_tensors
    from facet_graph_convolution_torch.ops import facet_conv as k1

    v, f = icosphere(5)
    mesh = InferenceMesh(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                         k_faces=23, seed=0)
    mesh.add_mesh(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f)
    patch = max(mesh.patches, key=lambda p: p.num_nodes)
    adjs, mult_rows = graph_tensors(patch.adjs, dev)
    fake0 = ~np.any(patch.inputs != 0, axis=1)          # level-0 fake nodes
    rng = np.random.default_rng(1)
    m = 9
    bound_kinds, worst = set(), 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    print("kernel phase: K1 vs plain, atol=rtol=%g, patch levels %s" % (
        KERNEL_ATOL, [a.shape[0] for a in patch.adjs]))
    print("  device ms from torch.profiler, wall ms from CUDA events over back-to-back calls")
    print("  %-8s %6s %4s %3s %3s %10s %9s %9s %9s %9s %s" % (
        "conv", "N'", "C", "M", "K'", "max_err", "ms", "wall_ms", "plain_ms", "bound_ms",
        "bound_by"))
    for name, level, c_in in CONVS:
        adj_sm, rows = adjs[level], mult_rows[level][:, :, 0].contiguous()
        k_nbr, n_pad = adj_sm.shape
        n_real = patch.adjs[level].shape[0]
        cat = rng.normal(size=(n_pad, c_in + m)).astype(np.float32)
        cat[n_real:] = 0.0                               # padded nodes
        if level == 0:
            cat[:n_real][fake0] = 0.0                    # fake nodes' zero signal
        cat = torch.as_tensor(cat, device=dev)
        ux = torch.as_tensor(rng.normal(size=(n_pad, m)).astype(np.float32), device=dev)
        c = torch.as_tensor(rng.normal(size=(m,)).astype(np.float32), device=dev)
        args = (cat, ux, adj_sm, rows, c)
        z = k1.facet_conv_fwd(*args)
        torch.cuda.synchronize()
        z_ref = k1.facet_conv_fwd_plain(*args)
        err = float((z - z_ref).abs().max())
        if not torch.allclose(z, z_ref, atol=KERNEL_ATOL, rtol=KERNEL_RTOL):
            raise AssertionError(f"K1 disagrees with its plain version at {name}: {err}")
        ms, wall_ms = cuda_ms(lambda: k1.facet_conv_fwd(*args), 50)
        plain_ms, _ = cuda_ms(lambda: k1.facet_conv_fwd_plain(*args), 10)
        if ms is None or plain_ms is None:
            raise AssertionError("torch.profiler recorded no device time")
        b_ms, b_by = bound_ms(cat, ux, adj_sm, rows, c, z)
        worst = max(worst, err)
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["bound_ms"] += b_ms
        bound_kinds.add(b_by)
        print("  %-8s %6d %4d %3d %3d %10.3e %9.5f %9.5f %9.5f %9.5f %s" % (
            name, n_pad, c_in, m, k_nbr, err, ms, wall_ms, plain_ms, b_ms, b_by))
    return worst, totals, ("bytes" if bound_kinds == {"bytes"} else "operations")


def profile_forward(params, patch, cfg, dev):
    """Where one full-width patch forward spends its time: device time by
    kernel (torch.profiler), and the device's busy share of the forward's
    wall time (host table building included, as on the serving path)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from facet_graph_convolution_torch.inference.driver import forward_patch

    with torch.no_grad():
        forward_patch(params, patch, cfg, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward_patch(params, patch, cfg, dev)
        torch.cuda.synchronize()
        bare_ms = 1e3 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            forward_patch(params, patch, cfg, dev)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    print(f"profile: one forward of a {patch.num_nodes}-node patch: wall {bare_ms:.3f} ms "
          f"({wall_ms:.3f} ms under the profiler), device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / bare_ms:.1f}% of the unprofiled wall time)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:9.4f} ms  {name[:100]}")


def serving_phase(dev, workdir):
    import torch

    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.data.synthetic import (
        add_vertex_noise,
        chamfered_box,
        icosphere,
        torus,
    )
    from facet_graph_convolution_torch.geometry.obj_io import load_obj, write_obj
    from facet_graph_convolution_torch.inference.driver import forward_patch, infer_directory
    from facet_graph_convolution_torch.models.unet import init_unet
    from facet_graph_convolution_torch.ops import facet_conv as k1

    in_dir = os.path.join(workdir, "requests")
    os.makedirs(in_dir)
    rng = np.random.default_rng(0)
    shapes = {"icosphere5": icosphere(5), "torus": torus(nu=128, nv=64),
              "chamfered_box": chamfered_box(24)}
    for name, (v, f) in shapes.items():
        write_obj(add_vertex_noise(v, f, 0.2, rng), f, os.path.join(in_dir, name + ".obj"))
    cfg = default_config(workdir).replace(
        eval={"results_path": os.path.join(workdir, "results") + "/"})
    params = init_unet(seed=0, device=str(dev))     # full width: 32/64/128, M=9, fc 1024

    k1.facet_conv_fwd.launches = 0
    records = infer_directory(in_dir, cfg, params=params, device=str(dev))
    launches = k1.facet_conv_fwd.launches

    if len(records) != 3:
        raise AssertionError(f"served {len(records)} of 3 requests")
    patches = sum(r["patches"] for r in records)
    if launches != 8 * patches:
        raise AssertionError(f"K1 launched {launches} times for {patches} patches (want 8 each)")
    print(f"serving phase: 3 requests, {patches} patches, K1 launches {launches}")
    for r in records:
        out_v, out_f, _ = load_obj(r["path"])
        v, f = shapes[r["name"]]
        if out_v.shape != v.shape or not np.isfinite(out_v).all():
            raise AssertionError(f"{r['name']}: bad denoised vertices {out_v.shape}")
        if not np.array_equal(out_f.astype(np.int64), f.astype(np.int64)):
            raise AssertionError(f"{r['name']}: denoised faces differ from the input's")
        print("  request %-14s faces %6d patches %d  preprocess %.3f s  forward %.3f s  "
              "solver %.3f s (%d iterations)" % (
                  r["name"], r["faces"], r["patches"], r["preprocess_s"], r["forward_s"],
                  r["solver_s"], r["solver_iterations"]))

    # each served patch again, through the kernel and through the plain K1
    worst = 0.0
    kernel = k1.facet_conv_fwd
    with torch.no_grad():
        for r in records:
            for patch in r["mesh"].patches:
                y = forward_patch(params, patch, cfg, dev)
                try:
                    k1.facet_conv_fwd = k1.facet_conv_fwd_plain
                    y_ref = forward_patch(params, patch, cfg, dev)
                finally:
                    k1.facet_conv_fwd = kernel
                if y.shape != (patch.num_nodes, 3) or not torch.isfinite(y).all():
                    raise AssertionError(f"{r['name']}: bad forward output {tuple(y.shape)}")
                worst = max(worst, float((y - y_ref).abs().max()))
    if worst > FORWARD_ATOL:
        raise AssertionError(f"kernel forward differs from the plain forward by {worst}")
    print(f"  forward through K1 vs through plain K1: max abs err {worst:.3e} "
          f"(atol {FORWARD_ATOL})")
    largest = max((p for r in records for p in r["mesh"].patches), key=lambda p: p.num_nodes)
    profile_forward(params, largest, cfg, dev)
    return launches, records


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # fails outside the repo, before anything is printed
    from facet_graph_convolution_torch.ops import cuda_library

    card = card_line()
    print(card)

    t0 = time.perf_counter()
    built = cuda_library.build()
    print(f"build: {built} in {time.perf_counter() - t0:.1f} s")
    for name in built:
        with open(os.path.join(cuda_library.BUILD_DIR, name + ".log")) as fh:
            print(fh.read().strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    err, totals, bound_by = kernel_phase(dev)
    with tempfile.TemporaryDirectory() as workdir:
        launches, _ = serving_phase(dev, workdir)

    print(json.dumps({"kernels": [{
        "name": "facet_conv_fwd",
        "route": "cuda",
        "source": "facet_graph_convolution_torch/csrc/facet_conv_fwd.cu",
        "replaces": "facet_graph_convolution_tpu/ops/pallas_conv.py:92",
        "launches": launches,
        "max_abs_err": err,
        # per patch forward: the sum over the 8 conv launches of the largest
        # subdivision-5 patch
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
