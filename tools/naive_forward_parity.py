"""The naive solver's scale kernel against another version of its source, bit
for bit.

    python3 tools/naive_forward_parity.py --source DIR

Needs an NVIDIA GPU and ``nvcc``. Compiles ``DIR/ms_solver_naive.cu`` (with
the headers beside it: another version of the port's ``csrc/``, such as an
earlier commit's unpacked elsewhere) into ``csrc/build/naive_parity/`` of the
port's package (listed in ``.gitignore``), then runs one naive solve at the
largest patch of ``chip_smoke.py``'s request shapes, without noise (its
vertices, random unit normals at each level from a seed, schedule (80, 20,
20))
through three launches a scale: that build, the current one as serving
launches it (no store), and the current one with the iterate store that
training uses. It prints, a scale, whether the three gave the same bits,
and exits 1 when one did not.
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
from facet_graph_convolution_torch.data.dataset import InferenceMesh  # noqa: E402
from facet_graph_convolution_torch.ops import cuda_library as cl  # noqa: E402
from facet_graph_convolution_torch.ops import ms_solver_kernel as ms  # noqa: E402

OUT = os.path.join(cl.BUILD_DIR, "naive_parity")


def build_other(source_dir: str) -> ctypes.CDLL:
    src = os.path.join(source_dir, "ms_solver_naive.cu")
    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, "libms_solver_naive_other.so")
    subprocess.run([cl._nvcc(), *cl.NVCC_FLAGS, "-o", lib, src], check=True,
                   stdout=subprocess.DEVNULL)
    other = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    with open(src) as fh:
        stores = "float* store" in fh.read()
    other.ms_solver_naive_f32.argtypes = [p] * (6 if stores else 5) + [i] * 6 + [p]
    other.ms_solver_naive_f32.restype = ctypes.c_int
    other.stores = stores
    return other


def largest_served_patch():
    patches = []
    for v, f in cs.request_shapes().values():
        mesh = InferenceMesh(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                             k_faces=23, seed=0)
        mesh.add_mesh_with_vertices(v, f)
        patches += mesh.patches
    return max(patches, key=lambda p: p.num_nodes)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", required=True,
                        help="a directory holding another ms_solver_naive.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("naive_forward_parity: no CUDA device", file=sys.stderr)
        return 2
    other = build_other(args.source)
    dev = torch.device("cuda", 0)
    patch = largest_served_patch()
    rng = np.random.default_rng(0)
    x = torch.as_tensor(patch.vertices, device=dev)
    faces = torch.as_tensor(patch.faces.astype(np.int32), device=dev)
    v_faces = torch.as_tensor(patch.v_faces, device=dev)
    print(cs.card_line())
    print(f"naive solve at the {patch.num_nodes}-face patch ({x.shape[0]} vertices): "
          f"{args.source} against the current build, without and with the store")
    same = True
    for scale, iters in zip((2, 1, 0), (80, 20, 20)):
        nodes = faces.shape[0] >> (2 * scale)
        fn = rng.normal(size=(nodes, 3)).astype(np.float32)
        fn = torch.as_tensor(fn / np.linalg.norm(fn, axis=1, keepdims=True), device=dev)
        grid = ms.default_grid(dev, x.shape[0], nodes, 2 * scale)
        with torch.no_grad():
            ours = ms.naive_scale(x, faces, v_faces, fn, scale, 2, iters)
            stored, xs = ms._kernel_forward(x, faces, v_faces, fn, nodes, 2 * scale, iters, grid,
                                            True)
            theirs = x.clone()
            t = torch.empty(nodes, device=dev)
            err = other.ms_solver_naive_f32(
                theirs.data_ptr(), faces.data_ptr(), v_faces.data_ptr(), fn.data_ptr(),
                t.data_ptr(), *([None] if other.stores else []), x.shape[0], v_faces.shape[1],
                nodes, 2 * scale, iters, grid, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"the other build's launch failed (cudaError {err})")
        row = (torch.equal(theirs, ours), torch.equal(stored, ours), torch.equal(xs[-1], ours))
        same = same and all(row)
        print(f"  scale {scale} ({nodes} nodes, {iters} iterations): other == current "
              f"{row[0]}, with the store == without {row[1]}, last stored iterate == result "
              f"{row[2]}")
        x = ours
    print("the same bits" if same else "DIFFERENT BITS")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
