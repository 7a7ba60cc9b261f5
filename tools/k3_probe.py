"""Time K3 and its backward (``csrc/weighted_aggregate.cu``) at the
rotation-invariant conv1's shapes, beside another version of the source.

    python tools/k3_probe.py [--source DIR ...] [--nodes 25600]

The repo's source (``current``) and, with ``--source``, the
``weighted_aggregate.cu`` of each DIR (another version, e.g. one unpacked
into a gitignored directory such as ``bench_trees/``, beside its
``storage.cuh``; named by the directory's name) are built by ``nvcc`` into
libraries of their own under ``csrc/build/k3_probe/``, all at once, and
called through the C
entries of ``ops/aggregate.py``. At S = 13 slots, M = 9, C = 6 (conv1 of
the whole subdivision-5 icosphere; random logits, multipliers with a fifth
zeros, slots and dz from a seed), f32 and bf16: each version's forward and
backward (without dx, as the train step runs it, and with) against the
plain versions (f32 within 1e-5 × max|plain|, bf16 within 2^-8), then its
device ms by CUDA-graph replay of 50 calls, in turns (each version in
order, then in reverse), beside the bytes bound. Card only, ~1 min.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build(sources):
    """{name: loaded library} of each ``weighted_aggregate.cu`` in
    ``sources`` ({name: directory})."""
    from facet_graph_convolution_torch.ops import cuda_library

    out_dir = os.path.join(cuda_library.BUILD_DIR, "k3_probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for v, directory in sources.items():
        lib = os.path.join(out_dir, f"libk3_{v}.so")
        procs[v] = (lib, subprocess.Popen(
            [cuda_library._nvcc(), *cuda_library.NVCC_FLAGS, "-o", lib,
             os.path.join(directory, "weighted_aggregate.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {v}:\n{log}")
        regs = [line.strip() for line in log.splitlines() if "registers" in line]
        print(f"  {v}: {' | '.join(r.split(':', 1)[1].strip() for r in regs)}")
        libs[v] = ctypes.CDLL(lib)
        p, i = ctypes.c_void_p, ctypes.c_int
        for sfx in ("_f32", "_bf16"):
            getattr(libs[v], "weighted_aggregate" + sfx).argtypes = [p] * 4 + [i] * 4 + [p]
            getattr(libs[v], "weighted_aggregate_bwd" + sfx).argtypes = [p] * 6 + [i] * 4 + [p]
    return libs


def graph_ms(fn, reps=50):
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=25600)
    ap.add_argument("--source", action="append", default=[], help="a directory with "
                    "another weighted_aggregate.cu (and its storage.cuh) to time beside")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k3_probe: no CUDA device", file=sys.stderr)
        return 2
    from facet_graph_convolution_torch.ops import aggregate as k3
    from facet_graph_convolution_torch.ops import cuda_library

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    sources = {"current": cuda_library.CSRC}
    sources.update({os.path.basename(os.path.normpath(d)): d for d in args.source})
    variants = list(sources)
    libs = build(sources)
    s, n, m, c = 13, args.nodes, 9, 6
    rng = np.random.default_rng(0)
    rows = rng.uniform(size=(s, n)).astype(np.float32)
    rows[rng.uniform(size=(s, n)) < 0.2] = 0.0
    base = [torch.as_tensor(a, device="cuda") for a in (
        (2 * rng.normal(size=(s, n, m))).astype(np.float32), rows,
        rng.normal(size=(s, n, c)).astype(np.float32),
        rng.normal(size=(n, m * c)).astype(np.float32))]
    for dtype, sfx in ((torch.float32, "_f32"), (torch.bfloat16, "_bf16")):
        logits, rows_t, x, dz = base[0], base[1], base[2].to(dtype), base[3].to(dtype)
        es = x.element_size()
        # z is dz's shape and dtype
        fwd_bytes = logits.numel() * 4 + rows_t.numel() * 4 + x.numel() * es + dz.numel() * es
        bwd_bytes = 2 * logits.numel() * 4 + rows_t.numel() * 4 + (x.numel() + dz.numel()) * es
        z = torch.empty(n, m * c, device="cuda", dtype=dtype)
        dl = torch.empty_like(logits)
        dx = torch.empty_like(x)
        z_ref = k3.weighted_aggregate_plain(logits, rows_t, x)
        dl_ref, dx_ref = k3.weighted_aggregate_bwd_plain(logits, rows_t, x, dz)
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8

        def calls(lib):
            def fwd():
                getattr(lib, "weighted_aggregate" + sfx)(
                    logits.data_ptr(), rows_t.data_ptr(), x.data_ptr(), z.data_ptr(), s, n, m,
                    c, torch.cuda.current_stream().cuda_stream)

            def bwd(with_dx=False):
                getattr(lib, "weighted_aggregate_bwd" + sfx)(
                    logits.data_ptr(), rows_t.data_ptr(), x.data_ptr(), dz.data_ptr(),
                    dl.data_ptr(), dx.data_ptr() if with_dx else None, s, n, m, c,
                    torch.cuda.current_stream().cuda_stream)
            return fwd, bwd

        print(f"{dtype}: S {s}, N {n}, M {m}, C {c}; bounds (bytes at 3.35 TB/s) fwd "
              f"{1e3 * fwd_bytes / 3.35e12:.5f} ms, bwd {1e3 * bwd_bytes / 3.35e12:.5f} ms")
        for v in variants:
            fwd, bwd = calls(libs[v])
            fwd()
            bwd(True)
            torch.cuda.synchronize()
            for got, ref, what in ((z, z_ref, "z"), (dl, dl_ref, "dlogits"), (dx, dx_ref, "dx")):
                err = float((got.float() - ref.float()).abs().max())
                bound = (1e-5 if what == "dlogits" else tol) * float(ref.float().abs().max())
                if not err <= bound:
                    raise AssertionError(f"{v} {dtype} {what}: {err} > {bound}")
        times = {v: [] for v in variants}
        for v in variants + variants[::-1]:
            fwd, bwd = calls(libs[v])
            times[v].append((graph_ms(fwd), graph_ms(bwd), graph_ms(lambda: bwd(True))))
        for v in variants:
            t = np.mean(times[v], axis=0)
            print(f"  {v:>8}: fwd {t[0]:.5f} ms, bwd {t[1]:.5f}, bwd with dx {t[2]:.5f} "
                  f"(runs {[tuple(round(x, 5) for x in r) for r in times[v]]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
