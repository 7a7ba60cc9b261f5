"""K4 and its backward against an earlier version of their source, on one card.

    python3 tools/k4_lane_probe.py --source DIR_OR_FILE

Needs an NVIDIA GPU and ``nvcc``. It builds ``tree_pool_iz.cu`` from
``--source`` (a file, or a directory holding it, such as an earlier commit's
``csrc/`` unpacked into a git-ignored directory like ``bench_trees/``) into
``csrc/build/k4_probe/`` of the port's package (listed in ``.gitignore``),
beside the port's own ``csrc/tree_pool_iz.cu``. On random face-centre-like
rows (C = 3, 1% zero rows, a zero group, -0.0 rows) at the sharded naive
solver's two sizes (the 1,048,576-face torus's 1,273,920 centres and the
102,400-face training torus's 126,256) and its two round counts (4 and 2),
it checks that both versions give the same bits as the plain pool (the
backward: equal to autograd through it), then times each kernel in turns,
earlier, current, current, earlier: warm L2 by CUDA-graph replay of 20
launches and cold L2 by ``chip_smoke.cold_ms`` (median of 20 after a 64 MiB
write), beside the bytes bound. At each size it also times the current
forward at 0 rounds (a pass that reads x and writes it back, the lane
kernels' loads and stores with no rounds) and ``x.clone()``, the same bytes
through PyTorch's copy. With ``cuobjdump`` beside ``nvcc`` it also counts the
SASS instructions (and the shuffles among them) of the current lane kernels
at C = 3 and 4 and 2 rounds. It prints the card's
``nvidia-smi`` name and power limit and one JSON line of the numbers.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from facet_graph_convolution_torch.ops import cuda_library as cl  # noqa: E402
from facet_graph_convolution_torch.ops import tree_pool_kernel as k4  # noqa: E402

OUT = os.path.join(cl.BUILD_DIR, "k4_probe")
SIZES = (1_273_920, 126_256)
STEPS = (4, 2)


def build_earlier(source):
    path = os.path.join(source, "tree_pool_iz.cu") if os.path.isdir(source) else source
    os.makedirs(OUT, exist_ok=True)
    lib_path = os.path.join(OUT, "libtree_pool_iz_earlier.so")
    proc = subprocess.run([cl._nvcc(), *cl.NVCC_FLAGS, "-o", lib_path, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"k4_lane_probe: nvcc failed for {path}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tree_pool_iz_f32.argtypes = [p, p, i, i, i, p]
    lib.tree_pool_iz_bwd_f32.argtypes = [p, p, p, i, i, i, p]
    return lib


def earlier_fns(lib, x, dy, steps):
    """The earlier forward and backward on x (and dy), into fresh outputs."""
    groups, c = x.shape[0] >> steps, x.shape[1]

    def fwd():
        out = torch.empty(groups, c, device=x.device)
        err = lib.tree_pool_iz_f32(x.data_ptr(), out.data_ptr(), groups, c, steps,
                                   torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"k4_lane_probe: earlier forward refused (cudaError {err})")
        return out

    def bwd():
        dx = torch.empty_like(x)
        err = lib.tree_pool_iz_bwd_f32(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), groups, c,
                                       steps, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"k4_lane_probe: earlier backward refused (cudaError {err})")
        return dx

    return fwd, bwd


def sass_counts():
    """{"kernel<3, steps>": (instructions, shuffles)} of the current
    library's lane kernels at C = 3 and 4 and 2 rounds, from ``cuobjdump
    -sass``; empty without cuobjdump."""
    tool = os.path.join(os.path.dirname(cl._nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    text = subprocess.run([tool, "-sass", os.path.join(cl.BUILD_DIR, "libtree_pool_iz.so")],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        found = re.search(r"Function : \S*(tree_pool_iz_lane_(?:bwd_)?kernel)ILi3ELi([24])E",
                          line)
        if "Function :" in line:
            name = f"{found.group(1)}<3, {found.group(2)}>" if found else None
            if name:
                counts[name] = [0, 0]
        elif name and re.search(r"/\*[0-9a-f]{4}\*/\s+\S", line) and "NOP" not in line:
            counts[name][0] += 1
            counts[name][1] += "SHFL" in line
    return {k: tuple(v) for k, v in counts.items()}


def rows(rng, n, dev):
    x = rng.normal(size=(n, 3)).astype(np.float32)
    x[rng.random(n) < 0.01] = 0.0
    x[64:128] = 0.0
    x[1] = -0.0
    return torch.as_tensor(x, device=dev)


def same_bits(a, b):
    return torch.equal(a, b) and torch.equal(torch.signbit(a), torch.signbit(b))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", required=True)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k4_lane_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    lib = build_earlier(args.source)
    cl.build(["tree_pool_iz"])
    rng = np.random.default_rng(19)
    results = []
    print(cs.card_line())
    print("K4 probe: ms a launch, warm L2 (graph replay) / cold L2 (median of "
          f"{cs.COLD_REPS}), earlier then current, each timed twice in turns")
    for n in SIZES:
        x = rows(rng, n, dev)
        for steps in STEPS:
            dy = torch.as_tensor(rng.normal(size=(n >> steps, 3)).astype(np.float32), device=dev)
            old_fwd, old_bwd = earlier_fns(lib, x, dy, steps)
            new_fwd = lambda: k4.tree_pool_ignore_zeros(x, steps)  # noqa: E731
            new_bwd = lambda: k4.tree_pool_ignore_zeros_bwd(x, dy, steps)  # noqa: E731
            ref = k4.tree_pool_ignore_zeros_plain(x, steps)
            dref = k4.tree_pool_ignore_zeros_bwd_plain(x, dy, steps)
            checks = {"earlier fwd": same_bits(old_fwd(), ref), "current fwd": same_bits(
                new_fwd(), ref), "earlier bwd": torch.equal(old_bwd(), dref),
                "current bwd": torch.equal(new_bwd(), dref)}
            if not all(checks.values()):
                raise AssertionError(f"k4_lane_probe: n={n} steps={steps}: {checks}")
            bounds = {"fwd": cs.pool_bound_ms(x, ref, steps)[0],
                      "bwd": cs.pool_bwd_bound_ms(x, dy)}
            for kind, old, new in (("fwd", old_fwd, new_fwd), ("bwd", old_bwd, new_bwd)):
                times = {"earlier": [], "current": []}
                for who, fn in (("earlier", old), ("current", new), ("current", new),
                                ("earlier", old)):
                    times[who].append((cs.cuda_ms(fn, 20)[0], cs.cold_ms(fn)))
                row = {"n": n, "steps": steps, "kernel": kind, "bound_ms": bounds[kind]}
                for who, pairs in times.items():
                    row[f"{who}_ms"] = [p[0] for p in pairs]
                    row[f"{who}_cold_ms"] = [p[1] for p in pairs]
                results.append(row)
                print("  n %9d  %d rounds  %s  earlier %s  current %s  bound %.5f  "
                      "bound / ms current %.3f (cold %.3f)" % (
                          n, steps, kind,
                          " ".join("%.5f/%.5f" % p for p in times["earlier"]),
                          " ".join("%.5f/%.5f" % p for p in times["current"]),
                          bounds[kind], bounds[kind] / min(row["current_ms"]),
                          bounds[kind] / min(row["current_cold_ms"])))
        copy = {"n": n, "kernel": "pass",
                "lanes_0_rounds_ms": cs.cuda_ms(lambda: k4.tree_pool_ignore_zeros(x, 0), 20)[0],
                "lanes_0_rounds_cold_ms": cs.cold_ms(lambda: k4.tree_pool_ignore_zeros(x, 0)),
                "clone_ms": cs.cuda_ms(lambda: x.clone(), 20)[0],
                "clone_cold_ms": cs.cold_ms(lambda: x.clone()),
                "bound_ms": 1e3 * 2 * x.numel() * 4 / cs.H100_BYTES_PER_S}
        results.append(copy)
        print("  n %9d  a pass over x (read, write back): lanes at 0 rounds %.5f/%.5f, "
              "x.clone() %.5f/%.5f, bound %.5f" % (
                  n, copy["lanes_0_rounds_ms"], copy["lanes_0_rounds_cold_ms"],
                  copy["clone_ms"], copy["clone_cold_ms"], copy["bound_ms"]))
    sass = sass_counts()
    for name, (count, shuffles) in sass.items():
        print(f"  SASS of {name}: {count} instructions, {shuffles} of them SHFL")
    print(json.dumps({"card": cs.card_line(), "k4_lane_probe": results, "sass_c3": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
