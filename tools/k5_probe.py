"""K5 (``csrc/windowed_conv_fwd.cu``, ``csrc/windowed_conv_bwd.cu``) on
synthetic banded K-lists: builds both kernels, prints each kernel's
registers and spills (``-Xptxas -v``) and its tensor-core (HMMA) and
cp.async (LDGSTS) instructions in the SASS (``cuobjdump -sass``), holds
them against their plain versions (``ops/windowed_conv.py``) in float32
and bfloat16, with and without halo rows, checks that a second launch
gives the same bits, and prints each case's device ms a launch (CUDA
events, warm L2) beside the plain version's. Card only:

    python3 tools/k5_probe.py [--n 4096] [--block 512] [--shapes 6:32,64:32,128:64]
    python3 tools/k5_probe.py --torus [--dtype bfloat16]

Each shape is ``C:out`` at M = 9; the K-list has K' = 12 neighbour slots
within ±96 rows, a fifth of them pads (``tests/test_windowed_gather.py``'s
banded lists). Exits 1 on a disagreement: f32 within 1e-5 × max|plain|,
bf16 within 2^-8 × max|plain|. ``--torus`` instead builds
``chip_smoke.py``'s 1,048,576-face torus at one rank and, at each of its
6 windowed convs, prints the device ms of every kernel that K5's forward
and backward launch (torch.profiler over 3 calls) and each call's ms by
CUDA events.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

F32_TOL, BF16_TOL = 1e-5, 2.0 ** -8


def banded_klist(n, k, band, pad_frac=0.2, seed=0):
    rng = np.random.default_rng(seed)
    adj = np.clip(np.arange(n)[:, None] + rng.integers(-band, band + 1, size=(n, k)), 0,
                  n - 1) + 1
    adj[rng.random((n, k)) < pad_frac] = 0
    return adj.astype(np.int32)


def klist(n, k, halo, seed):
    """A banded K-list of n rows; with ``halo`` rows after the n, a tenth of
    its live slots read them instead."""
    adj = banded_klist(n, k, 96, seed=seed)
    rng = np.random.default_rng(seed + 1)
    if halo:
        to_tail = (rng.random(adj.shape) < 0.1) & (adj > 0)
        adj = np.where(to_tail, rng.integers(n + 1, n + halo + 1, size=adj.shape),
                       adj).astype(np.int32)
    return adj, n + halo, rng


def case(args, c_in, out, halo, dtype):
    import torch

    from facet_graph_convolution_torch.graph.convert import windowed_lane_tables
    from facet_graph_convolution_torch.ops import windowed_conv as k5

    dev = torch.device("cuda")
    n, k, m = args.n, 12, 9
    adj, ext, rng = klist(n, k, halo, 3)
    wt = windowed_lane_tables(adj, num_sources=ext, block=args.block, align=64)
    tabs = k5.window_tensors(wt.arrays, dev)
    mult = np.where(adj.T > 0, rng.uniform(0.5, 2.0, size=(k, n)), 0.0)
    rows = np.concatenate([np.ones((1, n)), mult], axis=0) / (1.0 + mult.sum(0))

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev).to(dt)

    cat = t(rng.normal(size=(ext, c_in + m)), dtype)
    ux = t(rng.normal(size=(n, m)))
    wf = t(rng.normal(size=(out, m * c_in)) * 0.1)
    c = t(rng.normal(size=(m,)) * 0.1)
    mr = t(rows)
    gy = t(rng.normal(size=(n, out)))
    g = wt.geometry
    fargs = (g, cat, ux, wf, c, mr, tabs)
    y, y2 = k5.windowed_conv_fwd(*fargs), k5.windowed_conv_fwd(*fargs)
    d, d2 = k5.windowed_conv_bwd(*fargs, gy), k5.windowed_conv_bwd(*fargs, gy)
    torch.cuda.synchronize()
    same = torch.equal(y, y2) and all(torch.equal(a, b) for a, b in zip(d, d2))
    y_ref = k5.windowed_fused_conv_fwd_plain(*fargs)
    d_ref = k5.windowed_fused_conv_bwd_plain(*fargs, gy)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    errs = {}
    for name, a, b in [("y", y, y_ref)] + list(zip(("dcat", "dux", "dwf", "dc"), d, d_ref)):
        scale = float(b.float().abs().max()) or 1.0
        errs[name] = float((a.float() - b.float()).abs().max()) / scale

    def ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    row = {"C": c_in, "out": out, "halo": halo, "dtype": str(dtype).split(".")[-1],
           "repeatable": same, "rel_err": errs, "fwd_ms": ms(lambda: k5.windowed_conv_fwd(*fargs)),
           "bwd_ms": ms(lambda: k5.windowed_conv_bwd(*fargs, gy)),
           "plain_fwd_ms": ms(lambda: k5.windowed_fused_conv_fwd_plain(*fargs), 3),
           "plain_bwd_ms": ms(lambda: k5.windowed_fused_conv_bwd_plain(*fargs, gy), 3)}
    row["ok"] = same and all(e <= tol for e in errs.values())
    return row


def sass_counts(lib):
    """{kernel: (HMMA, LDGSTS)} instructions in a library's SASS, each kernel
    by its demangled name and template arguments."""
    from facet_graph_convolution_torch.ops import cuda_library

    tool = os.path.join(os.path.dirname(cuda_library._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = subprocess.run(["c++filt", m.group(1)], capture_output=True,
                                  text=True).stdout.strip() or m.group(1)
            name = name.replace("(anonymous namespace)::", "").split("(")[0]
            counts[name] = [0, 0]
        elif name is not None:
            counts[name][0] += "HMMA" in line
            counts[name][1] += "LDGSTS" in line
    return counts


def kernel_name(name):
    """A profiled kernel's short name: the word that holds ``windowed``, or
    the name cut to 40 characters."""
    words = [w for w in re.split(r"[^A-Za-z0-9_]", name) if "windowed" in w]
    return words[0] if words else name[:40]


def torus_profile(dtype):
    """K5's kernels at the torus's windowed convs, device ms by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.data.dataset import TrainingSet
    from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, torus
    from facet_graph_convolution_torch.ops import windowed_conv as k5
    from facet_graph_convolution_torch.parallel import halo
    from facet_graph_convolution_torch.parallel.mesh import GraphGroup

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    v, f = torus(nu=chip_smoke.HALO_TORUS[0], nv=chip_smoke.HALO_TORUS[1])
    ds = TrainingSet(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3,
                     k_faces=23, seed=0)
    ds.add_mesh(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f, gt_vertices=v)
    group = GraphGroup(0, 1, dev)
    part = halo._prepare_sharded_mesh_arrays(default_config(), ds.patches[0], group)[0]
    tables = halo.partition_operands(part, 0, dev, halo.build_level_windows(part))
    print(f"torus tables in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(31)
    for name, level, c_in, out in chip_smoke.WINDOWED_CONVS:
        args, gy = chip_smoke.k5_inputs(tables[level], c_in, out, rng, dev, dtype)
        for label, fn in (("fwd", lambda: k5.windowed_conv_fwd(*args)),
                          ("bwd", lambda: k5.windowed_conv_bwd(*args, gy))):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
            by = {}
            for name_, us in chip_smoke.device_events(prof):
                by[name_] = by.get(name_, 0.0) + us / 3e3
            print(f"{name} {label} ({args[0][4]} rows, C {c_in}, out {out}): "
                  f"{chip_smoke.event_ms(fn):.4f} ms; "
                  + "; ".join(f"{kernel_name(k)} {v:.4f}" for k, v in
                              sorted(by.items(), key=lambda kv: -kv[1])))


def main() -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--block", type=int, default=512)
    p.add_argument("--shapes", default="6:32,64:32,128:64")
    p.add_argument("--torus", action="store_true")
    p.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("k5_probe: no CUDA device", file=sys.stderr)
        return 1
    from facet_graph_convolution_torch.ops import cuda_library

    t0 = time.perf_counter()
    cuda_library.build(["windowed_conv_fwd", "windowed_conv_bwd"])
    print(f"built in {time.perf_counter() - t0:.1f} s")
    for name in ("windowed_conv_fwd", "windowed_conv_bwd"):
        with open(os.path.join(cuda_library.BUILD_DIR, name + ".log")) as fh:
            print("".join(ln for ln in fh if "registers" in ln or "spill" in ln
                          or "Compiling entry" in ln), end="")
        lib = os.path.join(cuda_library.BUILD_DIR, f"lib{name}.so")
        for kernel, (hmma, ldgsts) in sass_counts(lib).items():
            print(f"SASS {kernel}: HMMA {hmma}, LDGSTS {ldgsts}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print("card:", card.strip())
    if args.torus:
        torus_profile(getattr(torch, args.dtype))
        return 0
    ok = True
    for shape in args.shapes.split(","):
        c_in, out = map(int, shape.split(":"))
        for halo in (0, 160):
            for dtype in (torch.float32, torch.bfloat16):
                row = case(args, c_in, out, halo, dtype)
                ok &= row["ok"]
                print(json.dumps(row))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
