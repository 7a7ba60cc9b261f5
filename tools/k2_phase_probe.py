"""Where K2's pass A spends its time: the kernel with phases removed.

    python3 tools/k2_phase_probe.py

Needs an NVIDIA GPU and ``nvcc``. It compiles variants of
``facet_graph_convolution_torch/csrc/facet_conv_bwd.cu``, each with some
phases of pass A cut out by replacing source lines (so the variants compute
wrong results and are only timed), into ``csrc/build/k2_probe/`` of the
port's package (listed in ``.gitignore``), and times each at the 8 conv
shapes of ``chip_smoke.py`` (the served subdivision-5 icosphere patch,
M = 9) by CUDA-graph replay of 50 launches. It prints, per variant and conv, ``ms/A_us``: both passes in ms
and pass A alone in µs (torch.profiler). The variants:

- ``full``: the kernel as it is;
- ``no_x``: x's channels read as constants (no gathered row loads);
- ``no_tile``: the dz tile not copied (no dz loads);
- ``no_store``: no row of dg written;
- ``no_chan``: the channel walk skipped (no x, dz or dx work);
- ``compute_only``: no x, no dz tile, no stores;
- ``skeleton``: no channel walk, no tile, no stores: indices, logits,
  softmax, dq reduction, barriers and dux.

The replaced lines are matched exactly; the script stops when one is missing
(the kernel changed), naming it.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from facet_graph_convolution_torch.models.unet import train_graph_tensors  # noqa: E402
from facet_graph_convolution_torch.ops import cuda_library as cl  # noqa: E402

OUT = os.path.join(cl.BUILD_DIR, "k2_probe")
SUBS = {
    "x": [("      x.x = ch < c_in ? load_f32(xrow + ch) : 0.f;",
           "      x.x = ch < c_in ? 1.f : 0.f;"),
          ("      x.y = ch + 1 < c_in ? load_f32(xrow + ch + 1) : 0.f;",
           "      x.y = ch + 1 < c_in ? 1.f : 0.f;"),
          ("      x.z = ch + 2 < c_in ? load_f32(xrow + ch + 2) : 0.f;",
           "      x.z = ch + 2 < c_in ? 1.f : 0.f;"),
          ("      x.w = ch + 3 < c_in ? load_f32(xrow + ch + 3) : 0.f;",
           "      x.w = ch + 3 < c_in ? 1.f : 0.f;"),
          ("      xp[st][e] = j >= 0 && ch < c_in ? load_f32(xrow + ch) : 0.f;",
           "      xp[st][e] = j >= 0 && ch < c_in ? 1.f : 0.f;")],
    "tile": [("    vec_put(tile + nl * ns", "    if (n < 0) vec_put(tile + nl * ns"),
             ("    tile_put(tile + nl * ns + a * tc + col,",
              "    if (n < 0) tile_put(tile + nl * ns + a * tc + col,")],
    "store": [("      *reinterpret_cast<float4*>(out + ch) = d;",
               "      if (c_in < 0) *reinterpret_cast<float4*>(out + ch) = d;"),
              ("    *reinterpret_cast<float4*>(out + 4 * v) = make_float4(o[0], o[1], o[2], o[3]);",
               "    if (c_in < 0) *reinterpret_cast<float4*>(out + 4 * v) = "
               "make_float4(o[0], o[1], o[2], o[3]);")],
    "chan": [("    if (live)\n      slot_channels<MM, T>(tile + node_l * ns, tc, 0, tc,",
              "    if (live && n < 0)\n      slot_channels<MM, T>(tile + node_l * ns, tc, 0, tc,")],
}
VARIANTS = {"full": [], "no_x": ["x"], "no_tile": ["tile"], "no_store": ["store"],
            "no_chan": ["chan"], "compute_only": ["x", "tile", "store"],
            "skeleton": ["chan", "tile", "store"]}


def build():
    src = open(os.path.join(cl.CSRC, "facet_conv_bwd.cu")).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, drops in VARIANTS.items():
        text = src
        for drop in drops:
            for old, new in SUBS[drop]:
                if old not in text:
                    raise SystemExit(f"k2_phase_probe: line not found for {drop!r}: {old!r}")
                text = text.replace(old, new)
        path = os.path.join(OUT, name + ".cu")
        with open(path, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [cl._nvcc(), *cl.NVCC_FLAGS, "-I", cl.CSRC, "-o", os.path.join(OUT, f"lib{name}.so"),
             path],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"k2_phase_probe: nvcc failed for {name}")
    libs = {}
    for name in VARIANTS:
        lib = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
        lib.facet_conv_bwd_f32.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_phase_probe: no CUDA device", file=sys.stderr)
        return 2
    libs = build()
    dev = torch.device("cuda", 0)
    patch = cs.phase_patch()
    adjs, adj_ts, mult_rows = train_graph_tensors(patch.adjs, dev)
    rng = np.random.default_rng(2)
    m = 9
    rows_out = {name: [] for name in VARIANTS}
    for _, level, c_in in cs.CONVS:
        adj_sm, adj_t_sm = adjs[level], adj_ts[level]
        rows = mult_rows[level][:, :, 0].contiguous()
        k_nbr, n = adj_sm.shape
        cat, ux, c = cs.conv_inputs(patch, level, c_in, m, n, rng, dev)
        dz = torch.randn(n, m * c_in, device=dev)
        dg = torch.empty((k_nbr + 1) * n, -(-(c_in + m) // 8) * 8, device=dev)
        dcat = torch.empty(n, c_in + m, device=dev)
        dux = torch.empty(n, m, device=dev)
        for name, lib in libs.items():
            def launch(lib=lib):
                err = lib.facet_conv_bwd_f32(
                    cat.data_ptr(), ux.data_ptr(), adj_sm.data_ptr(), adj_t_sm.data_ptr(),
                    rows.data_ptr(), c.data_ptr(), dz.data_ptr(), dg.data_ptr(),
                    dcat.data_ptr(), dux.data_ptr(), n, n, k_nbr, adj_t_sm.shape[1], c_in, m,
                    torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"k2_phase_probe: launch failed (cudaError {err})")
            ms, _, by_kernel = cs.cuda_ms(launch, 50)
            a_ms = sum(t for k, (t, _) in by_kernel.items() if "slot_cotangents" in k)
            rows_out[name].append((ms, a_ms))
    print(cs.card_line())
    print("variant       " + " ".join("%12s" % name for name, _, _ in cs.CONVS))
    for name, vals in rows_out.items():
        print("%-13s " % name + " ".join("%6.4f/%5.1f" % (ms, 1e3 * a) for ms, a in vals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
