"""Where K1 spends its time: the forward kernel with phases removed.

    python3 tools/k1_phase_probe.py [--source PATH] [--variants full,no_x,...]

Needs an NVIDIA GPU and ``nvcc``. It compiles variants of a K1 source
(default: ``facet_graph_convolution_torch/csrc/facet_conv_fwd.cu``; ``--source``
takes another version of the file, such as an earlier commit's, unpacked
elsewhere), each with some phases cut out by replacing source lines (so the
variants compute wrong results and are only timed), into
``csrc/build/k1_probe/`` of the port's package (listed in ``.gitignore``), and
times each at the 8 conv shapes of ``chip_smoke.py`` (the served
subdivision-5 icosphere patch, M = 9) by CUDA-graph replay of 50 launches. It
prints µs per variant and conv. Two designs are known by their lines:

- ``block_tiles`` (the current kernel: a thread a slot for its index,
  logits and softmax, then aggregation by channel teams): ``full``;
  ``no_x`` (x's channels read as constants); ``no_softmax`` (no logits
  loaded, no softmax); ``no_store`` (z not written); ``no_aggregate`` (no
  slot walk: no x, q or FMAs); ``table_only`` (the slot indices and the
  barrier);
- ``warp_per_node`` (the earlier design: a warp a node, the softmax by
  shuffles): ``full``; ``no_x``; ``no_reduce`` (the softmax's max and sum
  shuffles cut); ``no_bcast`` (q's broadcast shuffles cut); ``no_store``.

A variant that cuts a phase keeps the code it feeds (its condition tests a
runtime value), so the compiler does not drop more than the phase. The
replaced lines are matched exactly; the script stops when one is missing (the
kernel changed), naming it.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from facet_graph_convolution_torch.models.unet import graph_tensors  # noqa: E402
from facet_graph_convolution_torch.ops import cuda_library as cl  # noqa: E402

OUT = os.path.join(cl.BUILD_DIR, "k1_probe")
X_NEW = "          x[u][b] = js[u] >= 0 && ch < c_in ? load_f32(xrow + ch) : 0.f;"
STORE_NEW = "        if (ch >= c_in) continue;"
DESIGNS = {
    "block_tiles": {
        "marker": "// 2. aggregation",
        "subs": {
            "x": [(X_NEW, X_NEW.replace("load_f32(xrow + ch)", "1.f"))],
            "softmax": [("    if (!live) continue;", "    if (!live || n > 0) continue;")],
            "store": [(STORE_NEW, STORE_NEW.replace("ch >= c_in", "ch >= c_in || n > 0")),
                      ("  if (!stage) return;", "  if (!stage || n > 0) return;")],
            "walk": [("    for (int k0 = 0; k0 < ks; k0 += kInFlight) {",
                      "    for (int k0 = 0; k0 < (n < 0 ? ks : 0); k0 += kInFlight) {")],
        },
        "variants": {"full": [], "no_x": ["x"], "no_softmax": ["softmax"],
                     "no_store": ["store"], "no_aggregate": ["walk"],
                     "table_only": ["softmax", "walk", "store"]},
    },
    "warp_per_node": {
        "marker": "accumulate<CC, MM>",
        "subs": {
            "x": [("    x[b] = ch < c_in ? __ldg(row + ch) : 0.f;",
                   "    x[b] = ch < c_in ? 1.f : 0.f;")],
            "reduce": [("    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));",
                        "    mx = fmaxf(mx, (float)off);"),
                       ("    sum += __shfl_xor_sync(kFullMask, sum, off);",
                        "    sum += (float)off;")],
            "bcast": [("    const float qa = __shfl_sync(kFullMask, q, a);",
                       "    const float qa = q + (float)a;")],
            "store": [("      if (ch < c_in) zrow[a * c_in + ch] = acc[a][b];",
                       "      if (ch < c_in && n < 0) zrow[a * c_in + ch] = acc[a][b];")],
        },
        "variants": {"full": [], "no_x": ["x"], "no_reduce": ["reduce"],
                     "no_bcast": ["bcast"], "no_store": ["store"]},
    },
}


def build(source, only=None):
    src = open(source).read()
    design = next((d for d, spec in DESIGNS.items() if spec["marker"] in src), None)
    if design is None:
        raise SystemExit(f"k1_phase_probe: {source} is neither known K1 design")
    spec = DESIGNS[design]
    os.makedirs(OUT, exist_ok=True)
    variants = {k: v for k, v in spec["variants"].items() if only is None or k in only}
    procs = {}
    for name, drops in variants.items():
        text = src
        for drop in drops:
            for old, new in spec["subs"][drop]:
                if old not in text:
                    raise SystemExit(f"k1_phase_probe: line not found for {drop!r}: {old!r}")
                text = text.replace(old, new)
        path = os.path.join(OUT, f"{design}_{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [cl._nvcc(), *cl.NVCC_FLAGS, "-I", cl.CSRC, "-o",
             os.path.join(OUT, f"lib{design}_{name}.so"), path],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"k1_phase_probe: nvcc failed for {design} {name}")
    libs = {}
    for name in variants:
        lib = ctypes.CDLL(os.path.join(OUT, f"lib{design}_{name}.so"))
        lib.facet_conv_fwd_f32.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        libs[name] = lib
    return design, libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", default=os.path.join(cl.CSRC, "facet_conv_fwd.cu"))
    parser.add_argument("--variants", help="comma-separated variants to time (default: all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k1_phase_probe: no CUDA device", file=sys.stderr)
        return 2
    design, libs = build(args.source, args.variants and args.variants.split(","))
    dev = torch.device("cuda", 0)
    patch = cs.phase_patch()
    adjs, mult_rows = graph_tensors(patch.adjs, dev)
    rng = np.random.default_rng(1)
    m = 9
    rows_out = {name: [] for name in libs}
    for _, level, c_in in cs.CONVS:
        adj_sm, rows = adjs[level], mult_rows[level][:, :, 0].contiguous()
        k_nbr, n = adj_sm.shape
        cat, ux, c = cs.conv_inputs(patch, level, c_in, m, n, rng, dev)
        z = torch.empty(n, m * c_in, device=dev)
        for name, lib in libs.items():
            def launch(lib=lib):
                err = lib.facet_conv_fwd_f32(
                    cat.data_ptr(), ux.data_ptr(), adj_sm.data_ptr(), rows.data_ptr(),
                    c.data_ptr(), z.data_ptr(), n, k_nbr, c_in, m,
                    torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"k1_phase_probe: launch failed (cudaError {err})")
            rows_out[name].append(cs.cuda_ms(launch, 50)[0])
    print(cs.card_line())
    print(f"K1 phase probe, design {design} ({args.source}): µs a launch by CUDA-graph replay")
    print("%-13s " % "variant" + " ".join("%8s" % name for name, _, _ in cs.CONVS) + "      sum")
    for name, vals in rows_out.items():
        print("%-13s " % name + " ".join("%8.2f" % (1e3 * v) for v in vals)
              + " %8.2f" % (1e3 * sum(vals)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
