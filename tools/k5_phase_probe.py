"""K5's kernels with phases cut out, at the 1,048,576-face torus's upconv1
(level 0, 1,273,920 rows, C = 64, out = 32, M = 9): where a launch's time
goes. Card only (~2 minutes with the torus's tables):

    python3 tools/k5_phase_probe.py [--conv upconv1] [--dtype float32]

Each variant is a copy of ``csrc/windowed_conv_{fwd,bwd}.cu`` (and the
shared header) with one or more source lines replaced, built with the
port's ``nvcc`` flags into a temporary directory and launched through the
same C entry on the same inputs (the variants built in parallel); its
device ms (CUDA events over 5 calls, warm L2) is printed beside the full
kernel's. The variants compute wrong
results: they time, they do not check. The probe stops when a replaced line
no longer matches the source.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (file, variant, [(old, new), ...])
VARIANTS = [
    ("windowed_conv_fwd", "full", []),
    ("windowed_conv_fwd", "no transform", [
        ("      for (int k0 = 0; k0 < p.kp; k0 += KS) {", "      for (int k0 = 0; k0 < 0; k0 += KS) {")]),
    ("windowed_conv_fwd", "no slot sums", [
        ("    slot_sums<T, MM>(cat, src, q, p.nb, k1, cm, m, ci * p.cw, p.cw, in_ch, z, p.zld);\n",
         "")]),
    ("windowed_conv_fwd", "slot phase only", [
        ("    slot_sums<T, MM>(cat, src, q, p.nb, k1, cm, m, ci * p.cw, p.cw, in_ch, z, p.zld);\n",
         ""),
        ("      for (int k0 = 0; k0 < p.kp; k0 += KS) {", "      for (int k0 = 0; k0 < 0; k0 += KS) {")]),
    ("windowed_conv_bwd", "full", []),
    ("windowed_conv_bwd", "no slot teams", [
        ("  for (int p0 = warp_team0; p0 < nb * k1; p0 += teams) {",
         "  for (int p0 = warp_team0; p0 < 0; p0 += teams) {")]),
    ("windowed_conv_bwd", "no dz", [
        ("    const int items = warp < ntn ? (ntn - warp + 7) / 8 * nkc : 0;",
         "    const int items = 0;")]),
    ("windowed_conv_bwd", "no dwf products", [
        ("    for (int k0 = 0; k0 < nbw; k0 += 8) {", "    for (int k0 = 0; k0 < 0; k0 += 8) {")]),
    ("windowed_conv_bwd", "no dcat pass", [
        ("  if (row >= n_src) return;  // a warp a row: uniform",
         "  if (row >= 0) return;")]),
    ("windowed_conv_bwd", "no dwf slot sums", [
        ("    slot_sums<T, MM>(cat, src, q, nb, k1, cm, m, c0, pw.cw, in_ch, z, zld);\n", "")]),
]


def build(name, edits, workdir, tag):
    from facet_graph_convolution_torch.ops import cuda_library

    src_dir = os.path.join(workdir, tag)
    os.makedirs(src_dir, exist_ok=True)
    for fn in os.listdir(cuda_library.CSRC):
        if fn.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(cuda_library.CSRC, fn), src_dir)
    path = os.path.join(src_dir, name + ".cu")
    text = open(path).read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{tag}: the line {old!r} is no longer in {name}.cu")
        text = text.replace(old, new)
    open(path, "w").write(text)
    lib = os.path.join(src_dir, f"lib{name}.so")
    subprocess.run([cuda_library._nvcc(), *cuda_library.NVCC_FLAGS, "-o", lib, path],
                   check=True, capture_output=True)
    return lib


def main() -> int:
    import torch

    import chip_smoke
    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.data.dataset import TrainingSet
    from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, torus
    from facet_graph_convolution_torch.ops import windowed_conv as k5
    from facet_graph_convolution_torch.parallel import halo
    from facet_graph_convolution_torch.parallel.mesh import GraphGroup

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--conv", default="upconv1",
                   choices=[c[0] for c in chip_smoke.WINDOWED_CONVS])
    p.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("k5_phase_probe: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line())
    dev = torch.device("cuda")
    v, f = torus(nu=chip_smoke.HALO_TORUS[0], nv=chip_smoke.HALO_TORUS[1])
    ds = TrainingSet(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3,
                     k_faces=23, seed=0)
    ds.add_mesh(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f, gt_vertices=v)
    part = halo._prepare_sharded_mesh_arrays(default_config(), ds.patches[0],
                                             GraphGroup(0, 1, dev))[0]
    tables = halo.partition_operands(part, 0, dev, halo.build_level_windows(part))
    name, level, c_in, out = [c for c in chip_smoke.WINDOWED_CONVS if c[0] == args.conv][0]
    fargs, gy = chip_smoke.k5_inputs(tables[level], c_in, out, np.random.default_rng(31), dev,
                                     getattr(torch, args.dtype))
    print(f"{name}: {fargs[0][4]} rows, C {c_in}, out {out}, {args.dtype}")
    originals = dict(k5.cuda_library._LIBS)
    with tempfile.TemporaryDirectory() as workdir:
        # one nvcc a variant, all at once
        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            libs = list(pool.map(lambda iv: build(iv[1][0], iv[1][2], workdir, f"v{iv[0]}"),
                                 enumerate(VARIANTS)))
        for (kernel, label, edits), path in zip(VARIANTS, libs):
            lib = ctypes.CDLL(path)
            k5.cuda_library._LIBS[kernel] = lib
            fn = ((lambda: k5.windowed_conv_fwd(*fargs)) if kernel.endswith("fwd")
                  else (lambda: k5.windowed_conv_bwd(*fargs, gy)))
            ms = [chip_smoke.event_ms(fn) for _ in range(5)]
            print(f"  {kernel} {label}: {np.median(ms):.4f} ms (min {min(ms):.4f})")
            k5.cuda_library._LIBS.pop(kernel)
    k5.cuda_library._LIBS.update(originals)
    return 0


if __name__ == "__main__":
    sys.exit(main())
