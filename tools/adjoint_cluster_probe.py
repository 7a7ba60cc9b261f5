"""The naive solver's scale adjoint as one thread-block cluster a scale,
against the port's kernel: a measurement of a design that the port does
not run.

    python3 tools/adjoint_cluster_probe.py

Needs an NVIDIA H100 (or another sm_90 card) and ``nvcc``. It compiles
``tools/adjoint_cluster_probe.cu`` (one cluster of up to 16 CTAs, the rows
in distributed shared memory, cluster barriers; see its header) and
variants of it with phases cut out by replacing source lines (those
compute wrong results and are only timed), all at once, into
``csrc/build/adjoint_cluster_probe/`` of the port's package (listed in
``.gitignore``). At the three scales of the largest vertex patch of a noisy
subdivision-5 icosphere under the default config (schedule (80, 20, 20);
the iterates from the scale kernel; random unit normals and cotangent from
a seed) it

- holds the cluster design at 16 and at 8 CTAs to the port's adjoint
  (``ops/ms_solver_kernel.py::naive_scale_backward``, the grid design) bit
  for bit, and to itself (two launches);
- times each by CUDA-graph replay of 20 launches: the port's adjoint, the
  cluster design at 16 and 8 CTAs, and each variant at 16 CTAs; printed as
  ms per scale and per step and µs an iteration;
- times one barrier alone (a kernel of nothing but barriers, 160 against
  none): a cluster of 16 and of 8 CTAs, and a cooperative grid of the
  port's adjoint's largest grid of the three; and the barrier floor a step
  of each design (iterations × 2 barriers).

A cluster that the card cannot schedule, a failed launch or different bits
stop it. The variants:

- ``no_ra`` / ``no_rb``: without phase R-A / R-B;
- ``no_copy``: without the bulk copies of the iterates;
- ``skeleton``: none of those: the barriers and the loop alone;
- ``ra_no_centers``: R-A without the leaf centroids (a constant centre);
- ``ra_no_slots``: R-A without its walk over the node's slots;
- ``rb_no_slots`` / ``rb_no_corners``: R-B without its walk over the
  vertex's slots / corners.

The replaced lines are matched exactly; the script stops when one is
missing (the source changed), naming it.
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
from facet_graph_convolution_torch.config import default_config  # noqa: E402
from facet_graph_convolution_torch.data.dataset import InferenceMesh  # noqa: E402
from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere  # noqa: E402
from facet_graph_convolution_torch.ops import cuda_library as cl  # noqa: E402
from facet_graph_convolution_torch.ops import ms_solver_kernel as ms  # noqa: E402
from facet_graph_convolution_torch.ops.vertex_update import (  # noqa: E402
    _solver_step_sizes, build_naive_maps)

SOURCE = os.path.join(ROOT, "tools", "adjoint_cluster_probe.cu")
OUT = os.path.join(cl.BUILD_DIR, "adjoint_cluster_probe")
CTAS = (16, 8)
SUBS = {
    "ra": [("    adjoint_a(rows, faces, fn, slot_off, slot_ids, n_lo, n_lo + n_cnt,",
            "    if (iters < 0) adjoint_a(rows, faces, fn, slot_off, slot_ids, n_lo, "
            "n_lo + n_cnt,")],
    "rb": [("    adjoint_b(rows, v_faces, fn, corner_off, corner_ids, v_lo, v_lo + v_cnt,",
            "    if (iters < 0) adjoint_b(rows, v_faces, fn, corner_off, corner_ids, v_lo, "
            "v_lo + v_cnt,")],
    "copy": [("    if (it > 0) fetch(it - 1);", "    if (it < 0) fetch(it - 1);"),
             ("    if (it > 0) await();", "    if (it < 0) await();")],
    "ra_centers": [("    if (live) leaf_center_smem(rows, faces, first, c);",
                    "    if (live) c[0] = 1.f;")],
    "ra_slots": [("      for (int base = __ldg(slot_off + f) + sub; base < end;",
                  "      for (int base = __ldg(slot_off + f) + sub; shift < 0 && base < end;")],
    "rb_slots": [("      for (int j = sub; j < len; j += kVertexTeam) {",
                  "      for (int j = sub; shift < 0 && j < len; j += kVertexTeam) {")],
    "rb_corners": [("      for (int j = __ldg(corner_off + v) + sub; j < end; j += kVertexTeam) {",
                    "      for (int j = __ldg(corner_off + v) + sub; shift < 0 && j < end; "
                    "j += kVertexTeam) {")],
}
VARIANTS = {"full": [], "no_ra": ["ra"], "no_rb": ["rb"], "no_copy": ["copy"],
            "skeleton": ["ra", "rb", "copy"], "ra_no_centers": ["ra_centers"],
            "ra_no_slots": ["ra_slots"], "rb_no_slots": ["rb_slots"],
            "rb_no_corners": ["rb_corners"]}


def build():
    """{variant: loaded library}, every variant compiled at once."""
    src = open(SOURCE).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, drops in VARIANTS.items():
        text = src
        for drop in drops:
            for old, new in SUBS[drop]:
                if old not in text:
                    raise SystemExit(f"adjoint_cluster_probe: line not found for {drop!r}: "
                                     f"{old!r}")
                text = text.replace(old, new)
        path = os.path.join(OUT, name + ".cu")
        with open(path, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [cl._nvcc(), *cl.NVCC_FLAGS, "-I", cl.CSRC, "-o",
             os.path.join(OUT, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"adjoint_cluster_probe: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.adjoint_cluster_smem.argtypes = [i, i, i, i]
        lib.adjoint_cluster_smem.restype = q
        lib.adjoint_cluster_max_clusters.argtypes = [i, q]
        lib.adjoint_cluster_max_clusters.restype = i
        lib.adjoint_cluster_f32.argtypes = [p] * 11 + [i] * 8 + [q, p]
        lib.adjoint_cluster_f32.restype = i
        lib.adjoint_barrier_probe.argtypes = [i, i, i, p]
        lib.adjoint_barrier_probe.restype = i
        libs[name] = lib
    return libs


_SCHEDULABLE = {}


def cluster_adjoint(lib, ctas, xs, faces, v_faces, fn, scale, steps, g_out, face_slots,
                    corners):
    """naive_scale_backward's (g x, g fn) by the cluster design in one
    cluster of ``ctas`` CTAs, each owning ceil(V / ctas) vertices and
    ceil(F_s / ctas) nodes."""
    num_vertices, nodes, shift = xs.shape[1], fn.shape[0], steps * scale
    v_chunk, n_chunk = -(-num_vertices // ctas), -(-nodes // ctas)
    smem = lib.adjoint_cluster_smem(num_vertices, v_chunk, n_chunk, shift)
    key = (id(lib), ctas, smem)
    if key not in _SCHEDULABLE:
        _SCHEDULABLE[key] = lib.adjoint_cluster_max_clusters(ctas, smem)
    if _SCHEDULABLE[key] < 1:
        raise SystemExit(f"adjoint_cluster_probe: no cluster of {ctas} CTAs with {smem} bytes "
                         f"of shared memory each can be scheduled ({_SCHEDULABLE[key]})")
    if xs.data_ptr() % 16:
        raise SystemExit("adjoint_cluster_probe: xs is not on a 16-byte boundary")
    g_x, g_fn = g_out.clone(), torch.zeros_like(fn)
    lmbd = _solver_step_sizes(v_faces, torch.float32)
    ptrs = [t.data_ptr() for t in (xs, faces, v_faces, fn, lmbd, *face_slots, *corners, g_x,
                                   g_fn)]
    err = lib.adjoint_cluster_f32(*ptrs, num_vertices, v_faces.shape[1], nodes, shift,
                                  xs.shape[0] - 1, ctas, v_chunk, n_chunk, smem,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise SystemExit(f"adjoint_cluster_probe: cluster launch of {ctas} CTAs failed "
                         f"(cudaError {err})")
    return g_x, g_fn


def barrier_us(lib, cluster, blocks):
    """One barrier alone: 160 against none, by CUDA-graph replay."""
    def run(count):
        err = lib.adjoint_barrier_probe(int(cluster), blocks, count,
                                        torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"adjoint_cluster_probe: barrier probe failed (cudaError {err})")

    return 1e3 * (cs.cuda_ms(lambda: run(160), 20)[0] - cs.cuda_ms(lambda: run(0), 20)[0]) / 160


def scales(dev):
    """The largest vertex patch and [(xs, faces, v_faces, fn, scale, steps,
    g_out, maps)] for its three scales."""
    cfg = default_config()
    steps = cfg.model.coarsening_steps
    mesh = InferenceMesh(max_patch_size=cfg.data.max_patch_size, coarsening_steps=steps,
                         coarsening_levels=3, k_faces=cfg.data.k_faces, seed=0)
    v, f = icosphere(5)
    mesh.add_mesh_with_vertices(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f)
    p = max(mesh.patches, key=lambda q: q.faces.shape[0])
    rng = np.random.default_rng(5)
    x = torch.as_tensor(p.vertices.astype(np.float32), device=dev)
    faces = torch.as_tensor(p.faces.astype(np.int32), device=dev)
    v_faces = torch.as_tensor(p.v_faces.astype(np.int32), device=dev)
    maps = build_naive_maps(p.faces.astype(np.int32), p.v_faces, 3, steps, device=dev)
    out = []
    for scale, iters in zip((2, 1, 0), cfg.eval.ms_solver_iterations):
        shift = steps * scale
        fn = rng.normal(size=(faces.shape[0] >> shift, 3)).astype(np.float32)
        fn = torch.as_tensor(fn / np.linalg.norm(fn, axis=1, keepdims=True), device=dev)
        x, xs = ms._kernel_forward(x, faces, v_faces, fn, fn.shape[0], shift, iters, None, True)
        g = torch.as_tensor(rng.normal(size=tuple(x.shape)).astype(np.float32), device=dev)
        out.append((xs, faces, v_faces, fn, scale, steps, g,
                    dict(face_slots=maps.face_slots[scale], corners=maps.corners)))
    return p, out


def main() -> int:
    if not torch.cuda.is_available():
        print("adjoint_cluster_probe: no CUDA device", file=sys.stderr)
        return 2
    libs = build()
    dev = torch.device("cuda", 0)
    patch, calls = scales(dev)
    for xs, faces, v_faces, fn, scale, steps, g, kw in calls:
        port = ms.naive_scale_backward(xs, faces, v_faces, fn, scale, steps, g, **kw)
        for ctas in CTAS:
            runs = [cluster_adjoint(libs["full"], ctas, xs, faces, v_faces, fn, scale, steps, g,
                                    **kw) for _ in range(2)]
            torch.cuda.synchronize()
            for run in runs:
                if not all(torch.equal(a, b) for a, b in zip(run, port)):
                    raise SystemExit(f"adjoint_cluster_probe: the cluster design at {ctas} CTAs "
                                     f"differs from the port's adjoint at scale {scale}")
    rows = {"grid (the port)": [cs.cuda_ms(lambda: ms.naive_scale_backward(
        xs, faces, v_faces, fn, scale, steps, g, **kw), 20)[0]
        for xs, faces, v_faces, fn, scale, steps, g, kw in calls]}
    for name, lib in libs.items():
        for ctas in (CTAS if name == "full" else CTAS[:1]):
            rows[f"{name}@{ctas}"] = [cs.cuda_ms(lambda: cluster_adjoint(
                lib, ctas, *call[:7], **call[7]), 20)[0] for call in calls]
    iters = [c[0].shape[0] - 1 for c in calls]
    grid = max(ms.adjoint_grid(dev, c[0].shape[1], c[3].shape[0], c[5] * c[4]) for c in calls)
    barriers = {f"cluster of {n} CTAs": barrier_us(libs["full"], True, n) for n in CTAS}
    barriers[f"grid of {grid} blocks"] = barrier_us(libs["full"], False, grid)

    print(cs.card_line())
    sizes = " and ".join(map(str, CTAS))
    print(f"the {patch.faces.shape[0]}-face vertex patch ({patch.vertices.shape[0]} vertices), "
          f"scales 2 / 1 / 0 at {iters} iterations: the cluster design at {sizes} CTAs equals "
          "the port's adjoint bit for bit at every scale, and itself; device ms by CUDA-graph "
          "replay")
    print("%-20s %9s %9s %9s %9s   us an iteration" % ("design / variant@CTAs", "scale 2",
                                                       "scale 1", "scale 0", "step"))
    for label, times in rows.items():
        print("%-20s %9.5f %9.5f %9.5f %9.5f   %s" % (
            label, *times, sum(times), " / ".join("%.2f" % (1e3 * t / n)
                                                   for t, n in zip(times, iters))))
    print(f"one barrier alone, and the floor a step ({sum(iters)} iterations x 2 barriers):")
    for label, us in barriers.items():
        print(f"  {label}: {us:.4f} us, floor {2 * sum(iters) * us / 1e3:.5f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
