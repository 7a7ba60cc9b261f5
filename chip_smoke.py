"""Drive the PyTorch port on one NVIDIA GPU (H100) and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile every CUDA kernel of the port from ``csrc/`` (one ``nvcc``
   per source, in parallel) and, beside them, the C++ host library
   ``csrc/graphlib.cpp`` (``g++``; the phase fails if it does not load);
2. kernel: the facet-conv forward kernel (K1) against its plain PyTorch
   version on the card, at the 8 conv shapes of the largest patch of a
   noisy subdivision-5 icosphere (20,480 faces, two patches), on the real
   slot tables (pad slots, padded nodes, zero fake rows), and two launches
   on the same inputs giving the same bits; prints each launch's error,
   kernel and plain times and bound (its phase split comes from
   ``tools/k1_phase_probe.py``); then, untimed, at widths beyond the
   model's (``WIDE``: C = 256 at M = 9, and M = 32, 33, 64 and 100);
3. backward kernel: the same for the facet-conv backward kernel (K2), on the
   same shapes with the transpose maps, with its two passes' times and the
   floor of its two-pass design (the bound plus the scratch's round trip);
   also checks that two launches on the same inputs give the same bits (no
   atomics), and the same wide shapes;
4. serving: ``infer_directory`` answers 3 requests (subdivision-5 icosphere,
   torus, chamfered box, with noise) at the full model width (channels
   32/64/128, M = 9, fc 1024, random weights from a seed); checks the written
   meshes, that K1 ran 8 times per patch, and that each patch's forward
   through the kernel matches the same forward through the plain version;
5. batched serving: the same 3 requests through one ``InferenceServer``
   (``inference/serving.py``) with the C++ host library in use
   (``graph.native.available()``): each request's preprocessing seconds,
   native and under ``FGC_DISABLE_NATIVE=1``; one ``denoise_batch`` of the 4
   patches, K1 8 launches for the call, each mesh's normals and vertices
   within 1e-4 of ``infer_directory``'s with the same coarsening seed; a
   second call that captures no graph and gives the same bits; the graph's
   memory, the busy share of a capturing and of a replaying forward (K1 8
   times in a replay's profile), the largest patch's host tables with and
   without transpose maps, and K1 timed at the batched shapes; then
   ``denoise_batch_with_vertices`` (K1 8, the scale kernel 3 launches a
   patch) within 2e-4 of the naive-solver driver, and ``export_forward`` →
   ``load_forward`` on the card (K1 8 launches) within 1e-5 of the direct
   forward;
6. training: noisy/GT OBJ pairs of the same 3 shapes → ``preprocess_directory``
   → ``train_normals`` at full width for 50 steps with a mid-run and a final
   checkpoint; checks finite, falling losses, that K1 and K2 each ran 8
   times per step, that one step's gradients through the kernels match the
   plain versions', and that the written ``params.pt`` serves a request
   through ``infer_normals``; then times the train step on the whole
   subdivision-5 icosphere (one patch, as ``bench.py`` builds it) and
   profiles one step;
7. rotation-invariant training: ``train_normals`` with
   ``rotation_invariance=True`` on the training phase's set, at full width
   for 50 steps; checks finite, falling losses, that the weighted
   aggregation (K3) ran once a step (conv1) and K1 and K2 7 times a step,
   that the checkpoint's conv1 has no ``v``, and that one step's gradients
   through K3 match the same step through the plain K3; then times and
   profiles the step on the whole subdivision-5 icosphere, as for the
   default step;
8. aggregate kernel: K3 against its plain version, bitwise repeatable, at
   conv1 of that step (the inputs the path gave it) and at the JAX kernel
   test's shape; prints its times, bound and ``torch.einsum``'s time;
8b. bfloat16 (``compute_dtype="bfloat16"``, the JAX package's production
   training configuration): K1 and K2 in bfloat16 against their plain
   bfloat16 versions at the kernel phase's 8 conv shapes, K3 in bfloat16 at
   conv1's inputs, each within 2^-8 of the plain output's largest magnitude
   and bitwise repeatable, with times and bounds at bfloat16 bytes (and
   ``torch.einsum`` in bfloat16 beside K3); ``train_normals`` under
   bfloat16 on the training phase's set for 50 default steps (finite,
   falling losses; K1 and K2 in bfloat16 8 times a step and never in
   float32; one step's gradients within 0.05 of max|g| of the float32
   step's from the same state and draws; a float32 ``params.pt`` that
   serves a request in float32) and 30 rotation-invariant steps (K3 in
   bfloat16 once a step, K1/K2 7 times); then both bfloat16 graph steps
   (10 a call, the whole subdivision-5 icosphere) against their eager
   steps bit for bit, printed at the end beside the float32 graph steps of
   phase 12;
9. vertex serving: ``infer_directory(with_vertices=True)`` answers the same 3
   requests at full width with random multi-scale weights, once under the
   operator solver and once under the naive one; checks the 7 written meshes
   of each request, that K1 ran 8 times per patch, that the naive solver's
   scale kernel (``csrc/ms_solver_naive.cu``, K4 redesigned) ran 3 times per
   patch under the naive solver and never under the operator one, and the
   standalone zero-ignoring tree pool (K4) never; each patch's three heads
   through K1 against the plain K1, each patch's naive solve through the
   scale kernel against the plain solve (atol 1e-5) and against itself (the
   same bits), and the operator points against the naive points on the same
   patches;
10. vertex training: noisy/GT pairs of the same 3 shapes →
   ``preprocess_directory(with_vertices=True)`` → ``train_with_vertices``
   at full width for 30 steps under the operator solver (the default:
   schedule (80, 20, 20), 500 chamfer samples, Adam at 1e-3); checks finite
   losses with the last below 5× the first, that K1 and K2 each ran 8 times
   a step and K3, the standalone K4 and the scale kernel never, the
   checkpoints, that one step's gradients on the largest vertex patch
   through K1/K2 match the plain conv's (as they are where no kink of the
   step lies on another side, and with every kink pinned to the float64
   step's), that ``step.eval`` gives the loss
   the step reports for the same draws; prints the preprocessing seconds,
   the step's median time over 20 steps, one profiled step, and the
   solver's share of its device time;
11. naive training: ``train_with_vertices(vertex_solver="naive")`` on the
   same set for 30 eager steps at full width: finite losses, the
   checkpoints, K1 8, K2 8, the scale kernel 3 and its adjoint
   (``csrc/ms_solver_naive_bwd.cu``) 3 launches a step; the same gradient
   check on the largest vertex patch, through K1/K2 against the plain conv
   (the solver's kernels in both) and against the plain step in float64
   (the plain solver loop under autograd);
12. graph training: ``train_normals`` (default and rotation-invariant) and
   ``train_with_vertices`` (operator and naive) at ``steps_per_call=10``
   for 30 steps each, at full width on the two training sets, each call
   replaying a captured CUDA graph of the step; checks finite losses, the
   update counts, the checkpoints and the wrappers' launch counts (the
   warm-up step and the capture: replays launch from the graph). Then for
   each of the four steps, on the whole subdivision-5 icosphere and the
   largest vertex patch: two calls through the graph (the second under
   torch's sync debug mode set to raise, its only host synchronisation the
   loss read) equal as many eager steps with the same draws bit for bit;
   K1, K2, K3, the scale kernel and its adjoint launch a step from the
   graph counted in profiles (8, 8, 0, 0, 0; 7, 7, 1, 0, 0; 8, 8, 0, 0, 0;
   naive 8, 8, 0, 3, 3; the most of three, each traced from a warm-up
   call on, since the profiler can drop activities); prints the step time through the graph beside the
   eager step's, the device busy share and activities a step of each, the
   capture time and the graph's memory; last ``cli.train`` on the card with
   its default ``--steps_per_call`` (100) for 150 steps;
12b. streaming: the training phase's OBJ tree plus 3 more noisy copies of
   each shape → ``cli.preprocess --shard_size 2`` (at least 8 patches in at
   least 4 shards, 2 shards held at once, so shards load during the run) →
   ``cli.train --stream_dir`` (``training/trainer.py::
   train_normals_streaming``) at full width, 150 steps at
   ``--steps_per_call 10`` and 100 at 1: finite losses falling from the
   first CSV row to the last, the checkpoints, K1/K2 launched by their
   wrappers 8 times a step eagerly and 8 at each warm-up step and capture of
   the windowed run (captures = 1 + width growths), the plain K1/K2 never,
   the windowed run's params.pt serving a request; a profiled windowed run
   past the memo (the shards' patches STREAM_PAST_COPIES times over, more
   than the 64 the trainer keeps, so that evicted patches are prepared and
   uploaded again, and shards leave the cache): the device memory
   allocated at each window after the first epoch within one window's
   uploads of its value at the first, and the uploads' time that overlaps
   kernels; one window of the shards through the graph against eager steps
   bit for bit (:func:`graph_vs_eager`: K1/K2 8 a step in profiles); prints
   the streaming step a step (median of the windows after the first epoch)
   beside the in-memory graph step over the same window buffers timed on
   the streaming loop's clock (each call's losses read after the next call
   is enqueued) and waiting for each call, and the graph phase's default
   step, the eager streaming step beside the eager step, the consumer's
   wait on the loader a window, host preparation a new patch, the uploads'
   bytes and copy ms a window, and the phase's seconds;
13. budget: the naive vertex step through the graph on the vertex set with
   a graph cache held to 1.5 graphs of the largest patch: evictions and
   captures again, and the peak allocated and reserved memory within the
   eager run's plus the budget;
14. solver kernel: the scale kernel against its plain version at the three
   launches of the largest served patch's solve (the inputs the path gave
   it), and its launch with the iterate store (training's) against its
   serving launch, bit for bit, with its times per scale and per patch at the default grid and at
   one block an SM, the plain loop's times (pure PyTorch, and with the
   standalone K4 as before the redesign), the cost of one grid barrier, and
   its bound;
15. adjoint kernel: the scale kernel's adjoint against the plain adjoint
   (float32, and float64 on the same iterates) at the three launches of
   the largest vertex patch's naive solve under autograd, bitwise
   repeatable, with its times per scale and per patch, the plain adjoint's
   and its bound (a barrier's cost alone: ``tools/adjoint_cluster_probe.py``);
16. pool kernel: K4 against its plain version, bit for bit, at the solver's
   two pools of the largest served patch, at C = 3 and N = 1,048,576, on
   rows of zeros, groups of zeros and -0.0 rows, and at steps 1, 2 and 3;
   prints its times and bound; the scale kernel's phase A alone at the
   largest patch's two coarse levels, bit for bit against the plain K4 of
   its own level-0 centroids (those within 1e-6 of the plain gather-mean);
17. parity: ``init_unet`` at seed 0, single- and multi-scale, through
   ``export_unet_to_tf`` (a reference-format TF1 checkpoint) and
   ``load_reference_unet`` onto the card, bit for bit, with the write and
   read seconds; ``capture_activations`` of the single-scale network on the
   largest served patch (the subdivision-5 icosphere's first, as
   ``cli.parity`` takes it) through K1 against the same capture through the
   plain K1, per layer within 1e-4 (each layer's max |Δ| printed); its out0
   against ``unet_apply`` on the same tables within 1e-5; K1 8 launches a
   capture, by its wrapper and in profiles; then ``cli.parity`` in a new
   process against the plain export, which must print PASS;
18. wang: ``cli.wang --device cuda --num_iterations 250`` in-process on a
   synthetic Wang tree (train/ and test/ of the three request shapes, each
   with ``_n1`` and ``_n2`` noise, 0.1 and 0.2 of the mean edge length):
   preprocess, 2 calls of 100 steps and a partial call of 50 through the
   step's CUDA graph, serving and scoring the 6 test meshes; 6 CSV rows
   with angles finite in (0, 90), finite falling losses, the wrappers'
   launches (K1 and K2 8 at the warm-up step and 8 at the capture, K1 8 a
   served patch), at most 256 MiB left allocated on the card after the run,
   and K1/K2 8/8 a step through a graph of the run's training set and K1 8
   a served patch in profiles; prints each stage's seconds, the summary
   table and, a noise level, the noisy input's mean angular error beside
   the denoised one's;
19. halo: the halo-sharded path (``parallel/``) in a one-rank NCCL group:
   K1 and K2 on halo-extended sources (N_src > N: shard 0 of a 4-way
   partition of the 25,600-node subdivision-5 patch, its halo rows
   gathered from the whole graph) at the 8 conv shapes, f32 and bf16,
   against their plain versions and bitwise repeatable; one sharded step
   at one rank against the flat ``make_normals_train_step`` from the same
   state and draws (loss and gradients within 1e-5 relative); the
   1,048,576-face torus (``torus(1024, 512)``, noise 0.2) as one
   whole-mesh patch: ``train_normals_sharded`` 20 steps in f32 and 20 in
   bf16 (finite losses, the last below the first; K1/K2 8 launches a step
   in the run's dtype only, the plain K1/K2 never, 8 of each in a profiled
   step, the most of three profiles), with host seconds a stage, step ms, conv-edges/s and
   peak memory, and K1/K2 ns a row at its level 0 beside the kernel
   phase's 24,832-row level 0; ``infer_normals_sharded`` of the torus
   whole (random weights; finite, K1 8) and of the subdivision-5
   icosphere against ``infer_normals`` of the same one-patch mesh within
   1e-4; then the launcher (``python -m
   facet_graph_convolution_torch.parallel.launch --num_processes 1 ...
   train --iterations 40``) in a subprocess, which must exit 0.

Then it prints the kernels' JSON line, the card's ``nvidia-smi`` name and
power limit, and as its last line ``{"ok": true, "device": {...}}``. It exits
non-zero, printing no result, without a CUDA device or outside the repo.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12      # HBM3, SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores
KERNEL_ATOL = KERNEL_RTOL = 1e-5
FORWARD_ATOL = 1e-4
# the operator and naive solvers on the same patches, in the patches' frame
# (bounding-box diagonal 1): the same sums reassociated over 120 iterations
SOLVER_ATOL = 1e-4
# the naive solve through the scale kernel against the plain solve, patch
# frame: the same operations with the slot sums in another order
NAIVE_ATOL = 1e-5
# the scale kernel's adjoint against the plain adjoint, each gradient scaled
# to max 1: float32 sums in another order over up to 80 iterations (both
# within 8e-6 of the float64 adjoint on a 10k-face patch, H100)
ADJOINT_ATOL = 1e-5
CENTROID_ATOL = 1e-6
SEVEN_FILES = ("_denoised.obj", "_d_mid.obj", "_d_coarse.obj", "_fine_normals_s.obj",
               "_original_normals.obj", "_mid_normals_s.obj", "_coarse_normals_s.obj")
# one step's gradients through the kernels against the plain versions, each
# gradient scaled to max 1: float32 sums in another order through 8 convs
GRAD_ATOL = 1e-4
TRAIN_STEPS = 50
VERTEX_TRAIN_STEPS = 30
# one vertex step through K1/K2 against the plain conv, each gradient scaled
# to max 1, and against the plain step in float64: float32 alone moves the
# gradients by ~5e-4 through the solver's 120 iterations (measured on an
# H100 at the largest vertex patch: plain float32 against float64 4.8e-4,
# K1/K2 against float64 7.6e-4, K1/K2 against plain float32 7.8e-4), so
# GRAD_ATOL's 1e-4 is below float32's own noise here
VERTEX_GRAD_ATOL = 2e-3
# the chamfer loss (~10², ×1000 of the patch frame), relative
VERTEX_LOSS_RTOL = 1e-5
# (C, M) wider than the model's convs (C <= 128, M = 9), checked untimed at
# level 1 of the served patch; past M = 32 K2 takes its general pass A
WIDE = ((256, 9), (64, 32), (6, 33), (64, 64), (128, 100))
CONVS = (  # name, level, input channels (out channels follow the model)
    ("conv1", 0, 6), ("conv2", 1, 32), ("conv3", 2, 64), ("dconv3", 2, 128),
    ("upconv2", 1, 128), ("dconv2", 1, 128), ("upconv1", 0, 64), ("dconv1", 0, 64),
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_events(prof):
    """(name, µs) of the device activities (kernels, copies) a profile
    recorded; user annotations, which span other activities, are left out."""
    import torch

    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def cuda_ms(fn, reps):
    """Per call: (device ms, wall ms, {kernel: (device ms, launches)}).

    Device time: ``reps`` calls captured in one CUDA graph and replayed
    between two CUDA events, so the device runs them back to back without
    the host's launch gaps. Wall time: ``reps`` eager calls between CUDA
    events; for a kernel shorter than its host-side launch it is the launch
    rate. The split by kernel comes from torch.profiler over the eager
    calls and is informational: the profiler can drop device activities
    from a window, so the launches it saw per call are returned beside each
    kernel's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
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
    device_ms = start.elapsed_time(end) / reps
    del graph

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    by_name = {}
    for name, us in device_events(prof):
        ms, count = by_name.get(name, (0.0, 0.0))
        by_name[name] = (ms + us / 1e3 / reps, count + 1.0 / reps)
    return device_ms, start.elapsed_time(end) / reps, by_name


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


def phase_patch():
    """The larger patch of a noisy subdivision-5 icosphere, as served."""
    from facet_graph_convolution_torch.data.dataset import InferenceMesh
    from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere

    v, f = icosphere(5)
    mesh = InferenceMesh(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                         k_faces=23, seed=0)
    mesh.add_mesh(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f)
    return max(mesh.patches, key=lambda p: p.num_nodes)


def conv_inputs(patch, level, c_in, m, n_pad, rng, dev):
    """Random ``cat`` [N', C+M] with zero rows at the padded nodes and, at
    level 0, at the fake nodes; ``ux`` [N', M]; ``c`` [M]."""
    import torch

    n_real = patch.adjs[level].shape[0]
    cat = rng.normal(size=(n_pad, c_in + m)).astype(np.float32)
    cat[n_real:] = 0.0                                   # padded nodes
    if level == 0:
        cat[:n_real][~np.any(patch.inputs != 0, axis=1)] = 0.0   # fake nodes
    return (torch.as_tensor(cat, device=dev),
            torch.as_tensor(rng.normal(size=(n_pad, m)).astype(np.float32), device=dev),
            torch.as_tensor(rng.normal(size=(m,)).astype(np.float32), device=dev))


def fwd_check(k1, args, label):
    """K1 on ``args`` against its plain version and against itself (two
    launches, the same bits); returns (z, max abs error)."""
    import torch

    z = k1.facet_conv_fwd(*args)
    again = k1.facet_conv_fwd(*args)
    torch.cuda.synchronize()
    if not torch.equal(z, again):
        raise AssertionError(f"K1 gave different bits on the same inputs at {label}")
    z_ref = k1.facet_conv_fwd_plain(*args)
    err = float((z - z_ref).abs().max())
    if not torch.allclose(z, z_ref, atol=KERNEL_ATOL, rtol=KERNEL_RTOL):
        raise AssertionError(f"K1 disagrees with its plain version at {label}: {err}")
    return z, err


def kernel_phase(dev, patch):
    import torch

    from facet_graph_convolution_torch.models.unet import graph_tensors
    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1

    adjs, mult_rows = graph_tensors(patch.adjs, dev)
    rng = np.random.default_rng(1)
    m = 9
    bound_kinds, worst = set(), 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    print("kernel phase: K1 vs plain, atol=rtol=%g, bitwise repeatable, patch levels %s" % (
        KERNEL_ATOL, [a.shape[0] for a in patch.adjs]))
    print("  its phases: python3 tools/k1_phase_probe.py")
    print("  device ms: 50 calls replayed from one CUDA graph; wall ms: 50 eager calls")
    print("  %-8s %6s %4s %3s %3s %10s %9s %9s %9s %9s %s" % (
        "conv", "N'", "C", "M", "K'", "max_err", "ms", "wall_ms", "plain_ms", "bound_ms",
        "bound_by"))
    for name, level, c_in in CONVS:
        adj_sm, rows = adjs[level], mult_rows[level][:, :, 0].contiguous()
        k_nbr, n_pad = adj_sm.shape
        cat, ux, c = conv_inputs(patch, level, c_in, m, n_pad, rng, dev)
        args = (cat, ux, adj_sm, rows, c)
        z, err = fwd_check(k1, args, name)
        ms, wall_ms, _ = cuda_ms(lambda: k1.facet_conv_fwd(*args), 50)
        plain_ms, _, _ = cuda_ms(lambda: k1.facet_conv_fwd_plain(*args), 10)
        b_ms, b_by = bound_ms(cat, ux, adj_sm, rows, c, z)
        worst = max(worst, err)
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["bound_ms"] += b_ms
        bound_kinds.add(b_by)
        print("  %-8s %6d %4d %3d %3d %10.3e %9.5f %9.5f %9.5f %9.5f %s" % (
            name, n_pad, c_in, m, k_nbr, err, ms, wall_ms, plain_ms, b_ms, b_by))
    for c_in, m_wide in WIDE:
        adj_sm, rows = adjs[1], mult_rows[1][:, :, 0].contiguous()
        k_nbr, n_pad = adj_sm.shape
        cat, ux, c = conv_inputs(patch, 1, c_in, m_wide, n_pad, rng, dev)
        err = fwd_check(k1, (cat, ux, adj_sm, rows, c), f"C={c_in}, M={m_wide}")[1]
        worst = max(worst, err)
        print("  %-8s %6d %4d %3d %3d %10.3e (untimed)" % ("wide", n_pad, c_in, m_wide,
                                                         k_nbr, err))
    return worst, totals, ("bytes" if bound_kinds == {"bytes"} else "operations")


def bwd_bound_ms(args, dcat, dux):
    """Least time for K2's work on this card: each input (cat, ux, the
    tables, c, dz) read once and dcat, dux written once at the HBM rate,
    against the operations this data needs (per live slot: M·(2C) FMAs for
    dx and as many for dq as 2 ops each, ~10·M for the softmax and its
    Jacobian; C+M adds per live neighbour slot in the transpose sum) at the
    f32 rate; the larger of the two. The scratch ``dg`` is the kernel's own
    and not counted."""
    import torch

    cat, ux, adj_sm, adj_t_sm, rows, c, dz = args
    n = adj_sm.shape[1]
    m = ux.shape[1]
    width = cat.shape[1]
    c_in = width - m
    nbytes = sum(t.numel() * t.element_size() for t in (*args, dcat, dux))
    live = rows != 0
    live[1:] &= (adj_sm > 0) & (adj_sm <= n)
    slots = int(torch.count_nonzero(live))
    ops = slots * m * (4 * c_in + 10) + int(torch.count_nonzero(live[1:])) * width
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def dg_round_trip_ms(args):
    """Least time for K2's scratch: each live neighbour slot's row of
    C+M floats written by pass A and read by pass B, at the HBM rate. With
    the bound it is the floor of the two-pass design."""
    import torch

    _, ux, adj_sm, _, rows, _, dz = args
    n = adj_sm.shape[1]
    width = dz.shape[1] // ux.shape[1] + ux.shape[1]
    live = (rows[1:] != 0) & (adj_sm > 0) & (adj_sm <= n)
    return 1e3 * 2 * int(torch.count_nonzero(live)) * width * 4 / H100_BYTES_PER_S


def bwd_check(k1, args, label):
    """K2 on ``args`` against its plain version and against itself (two
    launches, the same bits); returns (dcat, dux, max abs error)."""
    import torch

    dcat, dux = k1.facet_conv_bwd(*args)
    again = k1.facet_conv_bwd(*args)
    torch.cuda.synchronize()
    if not (torch.equal(dcat, again[0]) and torch.equal(dux, again[1])):
        raise AssertionError(f"K2 gave different bits on the same inputs at {label}")
    ref = k1.facet_conv_bwd_plain(*args)
    err = max(float((a - b).abs().max()) for a, b in zip((dcat, dux), ref))
    for got, want in zip((dcat, dux), ref):
        if not torch.allclose(got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL):
            raise AssertionError(f"K2 disagrees with its plain version at {label}: {err}")
    return dcat, dux, err


def backward_kernel_phase(dev, patch):
    import torch

    from facet_graph_convolution_torch.models.unet import train_graph_tensors
    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1

    adjs, adj_ts, mult_rows = train_graph_tensors(patch.adjs, dev)
    rng = np.random.default_rng(2)
    m = 9
    bound_kinds, worst = set(), 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "dg_ms": 0.0}
    print("backward kernel phase: K2 vs plain, atol=rtol=%g, bitwise repeatable" % KERNEL_ATOL)
    print("  device ms as in the kernel phase; A_ms, B_ms: its passes by torch.profiler;")
    print("  dg_ms: the scratch's round trip at the HBM rate (bound_ms + dg_ms: the floor "
          "of the two-pass design)")
    print("  %-8s %6s %4s %3s %3s %3s %10s %9s %9s %9s %9s %9s %9s %9s %6s %s" % (
        "conv", "N'", "C", "M", "K'", "K_t", "max_err", "ms", "A_ms", "B_ms", "wall_ms",
        "plain_ms", "bound_ms", "dg_ms", "events", "bound_by"))
    for name, level, c_in in CONVS:
        adj_sm, adj_t_sm = adjs[level], adj_ts[level]
        rows = mult_rows[level][:, :, 0].contiguous()
        k_nbr, n_pad = adj_sm.shape
        cat, ux, c = conv_inputs(patch, level, c_in, m, n_pad, rng, dev)
        dz = torch.as_tensor(rng.normal(size=(n_pad, m * c_in)).astype(np.float32), device=dev)
        args = (cat, ux, adj_sm, adj_t_sm, rows, c, dz)
        dcat, dux, err = bwd_check(k1, args, name)
        ms, wall_ms, by_kernel = cuda_ms(lambda: k1.facet_conv_bwd(*args), 50)
        plain_ms, _, _ = cuda_ms(lambda: k1.facet_conv_bwd_plain(*args), 10)
        # the kernel's two passes as the profiler saw them, and its launches
        # per call (2 when it dropped none)
        pass_ms = [sum(t for n_, (t, _) in by_kernel.items() if tag in n_)
                   for tag in ("slot_cotangents", "transpose_sum")]
        events = sum(c_ for _, c_ in by_kernel.values())
        b_ms, b_by = bwd_bound_ms(args, dcat, dux)
        dg_ms = dg_round_trip_ms(args)
        worst = max(worst, err)
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["bound_ms"] += b_ms
        totals["dg_ms"] += dg_ms
        bound_kinds.add(b_by)
        print("  %-8s %6d %4d %3d %3d %3d %10.3e %9.5f %9.5f %9.5f %9.5f %9.5f %9.5f %9.5f "
              "%6.2f %s" % (name, n_pad, c_in, m, k_nbr, adj_t_sm.shape[1], err, ms,
                            pass_ms[0], pass_ms[1], wall_ms, plain_ms, b_ms, dg_ms, events,
                            b_by))
    print("  %-8s %53.5f %49.5f %9.5f" % ("step", totals["ms"], totals["bound_ms"],
                                          totals["dg_ms"]))
    for c_in, m_wide in WIDE:
        adj_sm, adj_t_sm = adjs[1], adj_ts[1]
        rows = mult_rows[1][:, :, 0].contiguous()
        k_nbr, n_pad = adj_sm.shape
        cat, ux, c = conv_inputs(patch, 1, c_in, m_wide, n_pad, rng, dev)
        dz = torch.as_tensor(rng.normal(size=(n_pad, m_wide * c_in)).astype(np.float32),
                             device=dev)
        args = (cat, ux, adj_sm, adj_t_sm, rows, c, dz)
        err = bwd_check(k1, args, f"C={c_in}, M={m_wide}")[2]
        worst = max(worst, err)
        print("  %-8s %6d %4d %3d %3d %3d %10.3e (untimed)" % (
            "wide", n_pad, c_in, m_wide, k_nbr, adj_t_sm.shape[1], err))
    return worst, totals, ("bytes" if bound_kinds == {"bytes"} else "operations")


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
    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1

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
    with torch.no_grad():
        # host table building included, as on the serving path
        device_profile(lambda: forward_patch(params, largest, cfg, dev),
                       f"one forward of a {largest.num_nodes}-node patch")
    return launches, records


SERVE_ATOL = 1e-4           # batched serving against the per-mesh driver
SERVE_VERTEX_ATOL = 2e-4    # batched vertex serving against the naive-solver driver
EXPORT_ATOL = 1e-5          # the exported program against the direct forward


def host_ms(fn, reps=5):
    """Median host milliseconds of ``reps`` calls of ``fn``."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def batched_serving_phase(dev, workdir, k1_patch_ms, patch_nodes):
    """The serving phase's 3 requests through one ``InferenceServer``: the
    native host library in use, each request's preprocessing native and
    NumPy, one batched forward (K1 8 launches for the 4 patches) against
    ``infer_directory`` with the same coarsening seed, a second call that
    replays the captured graph (the same bits), K1 at the batched shapes,
    the busy share of a capturing and of a replaying forward, the forward's
    tables with and without transpose maps, the vertex pipeline through
    ``denoise_batch_with_vertices`` (the scale kernel 3 launches a patch)
    against the naive-solver driver, and the exported forward on the card
    (K1 8 launches) against the direct forward. ``k1_patch_ms`` is K1's time
    a forward of the kernel phase's patch of ``patch_nodes`` nodes."""
    import types

    import torch

    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.data.dataset import bucket_size, pad_patch_to
    from facet_graph_convolution_torch.geometry.obj_io import load_obj
    from facet_graph_convolution_torch.graph import native
    from facet_graph_convolution_torch.inference.driver import infer_directory, predict_normals
    from facet_graph_convolution_torch.inference.serving import (
        InferenceServer,
        _build_mesh,
        export_forward,
        load_forward,
    )
    from facet_graph_convolution_torch.models.unet import (
        batched_graph_tensors,
        graph_tensors,
        init_unet,
        train_graph_tensors,
        unet_apply,
    )
    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
    from facet_graph_convolution_torch.ops import ms_solver_kernel as ms
    from facet_graph_convolution_torch.ops.normalization import normalize_tensor

    t_phase = time.perf_counter()
    if not native.available():
        raise AssertionError("the C++ host library is not in use: graph.native.available() "
                             "is False")
    in_dir = os.path.join(workdir, "requests")
    names = sorted(f[:-4] for f in os.listdir(in_dir) if f.endswith(".obj"))
    meshes = [load_obj(os.path.join(in_dir, n + ".obj"))[:2] for n in names]
    cfg = default_config(workdir).replace(
        eval={"results_path": os.path.join(workdir, "batched_driver") + "/"})
    params = init_unet(seed=0, device=str(dev))     # the serving phase's weights
    print(f"batched serving phase: {len(names)} requests through one InferenceServer, "
          "full width, the C++ host library in use")

    for name, (v, f) in zip(names, meshes):
        t0 = time.perf_counter()
        mesh = _build_mesh(v, f, cfg)
        t_native = time.perf_counter() - t0
        os.environ["FGC_DISABLE_NATIVE"] = "1"
        try:
            t0 = time.perf_counter()
            _build_mesh(v, f, cfg)
            t_numpy = time.perf_counter() - t0
        finally:
            del os.environ["FGC_DISABLE_NATIVE"]
        print(f"  request {name:<14s} faces {f.shape[0]:6d} patches {len(mesh.patches)}  "
              f"preprocess {t_native:.3f} s native, {t_numpy:.3f} s NumPy")

    # the per-mesh driver on the same files and coarsening seed
    t0 = time.perf_counter()
    records = {r["name"]: r for r in infer_directory(in_dir, cfg, params=params,
                                                     device=str(dev), seed=0)}
    driver_s = time.perf_counter() - t0
    drv_points = {n: load_obj(records[n]["path"])[0] for n in names}
    drv_normals = {n: predict_normals(records[n]["mesh"], cfg, params, dev) for n in names}
    patches = sum(records[n]["patches"] for n in names)

    server = InferenceServer(cfg, params=params, device=str(dev))
    k1.facet_conv_fwd.launches = 0
    t0 = time.perf_counter()
    first = server.denoise_batch(meshes)
    first_s = time.perf_counter() - t0
    launches = k1.facet_conv_fwd.launches
    first_timings = dict(server.timings)
    if launches != 8:
        raise AssertionError(f"K1 launched {launches} times for one batched call of {patches} "
                             "patches (want 8)")
    err_n = err_v = 0.0
    for name, (refined, normals) in zip(names, first):
        if not (np.isfinite(refined).all() and np.isfinite(normals).all()):
            raise AssertionError(f"{name}: non-finite batched output")
        err_n = max(err_n, float(np.abs(normals - drv_normals[name]).max()))
        err_v = max(err_v, float(np.abs(refined - drv_points[name]).max()))
    if max(err_n, err_v) > SERVE_ATOL:
        raise AssertionError(f"batched serving differs from infer_directory: normals {err_n}, "
                             f"vertices {err_v}")
    print(f"  one denoise_batch call, {patches} patches: K1 launches {launches}; against "
          f"infer_directory (seed 0): normals max abs err {err_n:.3e}, vertices {err_v:.3e} "
          f"(atol {SERVE_ATOL})")

    captures = server._cache.captures
    k1.facet_conv_fwd.launches = 0
    t0 = time.perf_counter()
    second = server.denoise_batch(meshes)
    second_s = time.perf_counter() - t0
    if server._cache.captures != captures:
        raise AssertionError("the second call captured a new graph")
    for (a, b), (c, d) in zip(first, second):
        if not (np.array_equal(a, c) and np.array_equal(b, d)):
            raise AssertionError("the replayed call gave other bits than the first")
    entry = next(iter(server._compiled.values()))
    print(f"  second call: no new capture ({captures} captured), the same bits; K1 through "
          f"the wrapper {k1.facet_conv_fwd.launches} (the graph launches it)")
    print(f"  graph: captured in {entry.capture_s:.3f} s, {entry.graph_bytes / 2**20:.1f} MiB "
          f"allocated, {entry.pool_bytes / 2**20:.1f} MiB reserved")
    drv_ms = {n: 1e3 * (records[n]["preprocess_s"] + records[n]["forward_s"]
                        + records[n]["solver_s"]) for n in names}
    print("  wall ms a request: batched %.1f (first call, capture) and %.1f (second call, "
          "replay), per-mesh driver %.1f (its %s; %.1f with its file writes)" % (
              1e3 * first_s / len(names), 1e3 * second_s / len(names),
              sum(drv_ms.values()) / len(names),
              ", ".join(f"{n} {ms_:.1f}" for n, ms_ in drv_ms.items()),
              1e3 * driver_s / len(names)))
    print("  second call's seconds: preprocess %s, tables %.4f, forward %.4f, solver %.4f" % (
        [round(s, 4) for s in server.timings["preprocess_s"]], server.timings["tables_s"],
        server.timings["forward_s"], server.timings["solver_s"]))

    built = [_build_mesh(v, f, cfg) for v, f in meshes]
    padded, x_b, adjs_b = server._stack_batch(built)
    fresh = InferenceServer(cfg, params=params, device=str(dev))
    busy_capture, acts = device_busy(lambda: fresh._forward(x_b, adjs_b))
    print(f"  capturing forward: device busy {busy_capture:.3f} ms in {acts} activities, "
          f"{100 * busy_capture / (1e3 * first_timings['forward_s']):.1f}% of the first call's "
          f"forward ({1e3 * first_timings['forward_s']:.3f} ms wall, tables to host output)")
    del fresh
    wall, busy, _ = device_profile(lambda: server._forward(x_b, adjs_b),
                                   f"one replayed batched forward, {len(padded)} patches of "
                                   f"{x_b.shape[1]} nodes (tables built on the host included)")
    seen = [sum(GRAPH_KERNELS["K1"] in name for name, _ in
                warm_profile(lambda: server._forward(x_b, adjs_b)))
            for _ in range(GRAPH_PROFILES)]
    if max(seen) != 8:
        raise AssertionError(f"a replayed batched forward ran K1 {seen} times in "
                             f"{GRAPH_PROFILES} profiles (want 8)")
    print(f"  a replayed forward runs K1 8 times (the most of {GRAPH_PROFILES} profiles: {seen})")

    largest = max((p for n in names for p in records[n]["mesh"].patches),
                  key=lambda p: p.num_nodes)
    without = host_ms(lambda: graph_tensors(largest.adjs, "cpu"))
    with_t = host_ms(lambda: train_graph_tensors(largest.adjs, "cpu"))
    print(f"  host tables of the largest patch ({largest.num_nodes} nodes): {without:.3f} ms "
          f"without the transpose maps, {with_t:.3f} ms with them (median of 5); the batch's "
          f"block-diagonal tables {1e3 * server.timings['tables_s']:.3f} ms")

    # K1 at the batched forward's shapes
    steps = cfg.model.coarsening_steps
    adjs, mult_rows = batched_graph_tensors(adjs_b, steps, dev)
    flat = types.SimpleNamespace(adjs=[a.reshape(-1, a.shape[-1]) for a in adjs_b],
                                 inputs=x_b.reshape(-1, x_b.shape[-1]))
    rng = np.random.default_rng(2)
    total_ms, worst = 0.0, 0.0
    print("  K1 at the batched forward's shapes (device ms: 50 calls replayed from a graph)")
    for name, level, c_in in CONVS:
        adj_sm, rows = adjs[level], mult_rows[level][:, :, 0].contiguous()
        cat, ux, c = conv_inputs(flat, level, c_in, 9, adj_sm.shape[1], rng, dev)
        args = (cat, ux, adj_sm, rows, c)
        z, err = fwd_check(k1, args, f"batched {name}")
        ms_, _, _ = cuda_ms(lambda: k1.facet_conv_fwd(*args), 50)
        b_ms, b_by = bound_ms(cat, ux, adj_sm, rows, c, z)
        total_ms += ms_
        worst = max(worst, err)
        print("    %-8s N' %6d C %4d K' %3d  err %.3e  %.5f ms  bound %.5f ms (%s)" % (
            name, adj_sm.shape[1], c_in, adj_sm.shape[0], err, ms_, b_ms, b_by))
    print(f"  K1 a batched forward: {total_ms:.5f} ms for {len(padded)} patches of "
          f"{x_b.shape[1]} nodes ({total_ms / 8:.5f} ms a launch), against {k1_patch_ms:.5f} ms "
          f"a forward of the kernel phase's {patch_nodes}-node patch")

    # the vertex pipeline, batched, against the naive-solver driver
    vparams = init_unet(seed=1, multi_scale=True, device=str(dev))
    naive_cfg = cfg.replace(eval={"vertex_solver": "naive", "results_path": os.path.join(
        workdir, "batched_vertex_driver") + "/"})
    vrecords = {r["name"]: r for r in infer_directory(in_dir, naive_cfg, with_vertices=True,
                                                      params=vparams, device=str(dev),
                                                      seed=0)}
    vpatches = sum(vrecords[n]["patches"] for n in names)
    # the server runs the naive solver whatever the config names (cfg: operator)
    vserver = InferenceServer(cfg, params=vparams, include_vertices=True, device=str(dev))
    k1.facet_conv_fwd.launches = 0
    ms.naive_scale.launches = 0
    vout = vserver.denoise_batch(meshes)
    vlaunches = {"K1": k1.facet_conv_fwd.launches, "solver": ms.naive_scale.launches}
    if vlaunches != {"K1": 8, "solver": 3 * vpatches}:
        raise AssertionError(f"batched vertex serving launched {vlaunches} for {vpatches} "
                             f"patches, want K1 8 and the scale kernel {3 * vpatches}")
    err = 0.0
    for name, res in zip(names, vout):
        for key, value in res.items():
            if not np.isfinite(value).all():
                raise AssertionError(f"{name}: non-finite {key}")
            err = max(err, float(np.abs(value - vrecords[name]["outputs"][key]).max()))
    if err > SERVE_VERTEX_ATOL:
        raise AssertionError(f"batched vertex serving differs from the naive driver by {err}")
    print(f"  denoise_batch_with_vertices, {vpatches} patches: launches {vlaunches}; against "
          f"the naive-solver driver: max abs err {err:.3e} (atol {SERVE_VERTEX_ATOL}, "
          f"points and the three normals); wall {1e3 * sum(vserver.timings['preprocess_s']):.1f} "
          f"ms preprocess, {1e3 * vserver.timings['forward_s']:.1f} ms forward, "
          f"{1e3 * vserver.timings['solver_s']:.1f} ms solver")

    # the exported forward, run on the card
    patch = pad_patch_to(largest, bucket_size(largest.num_nodes, server.bucket_align))
    t0 = time.perf_counter()
    data = export_forward(cfg, params, patch.num_nodes, [a.shape[1] for a in patch.adjs])
    export_s = time.perf_counter() - t0
    fn = load_forward(data, device=str(dev))
    k1.facet_conv_fwd.launches = 0
    y = fn(params, patch.inputs[None], *(a[None] for a in patch.adjs))
    torch.cuda.synchronize()
    exp_launches = k1.facet_conv_fwd.launches
    t_adjs, t_rows = graph_tensors(patch.adjs, dev)
    with torch.no_grad():
        y_ref = normalize_tensor(unet_apply(params, torch.as_tensor(patch.inputs, device=dev),
                                            t_adjs, t_rows, coarsening_steps=steps))
    err = float((y[0] - y_ref).abs().max())
    if exp_launches != 8 or err > EXPORT_ATOL:
        raise AssertionError(f"the exported forward: K1 launches {exp_launches} (want 8), "
                             f"max abs err {err} against the direct forward")
    print(f"  exported forward ({len(data)} bytes, {export_s:.1f} s to export) at "
          f"{patch.num_nodes} nodes: K1 launches {exp_launches}, max abs err {err:.3e} against "
          f"the direct forward (atol {EXPORT_ATOL})")
    print(f"  batched serving phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "k1_ms": total_ms, "k1_err": worst}


def device_profile(fn, label):
    """Device time by kernel (torch.profiler) of one call of ``fn``, and the
    device's busy share of its unprofiled wall time; returns (wall ms, busy
    ms, device activities)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    bare_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for name, us in device_events(prof):
        by_name[name] = by_name.get(name, 0.0) + us / 1e3
    busy_ms = sum(by_name.values())
    print(f"profile: {label}: wall {bare_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / bare_ms:.1f}% of the unprofiled wall time), "
          f"{len(device_events(prof))} device activities")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:9.4f} ms  {name[:100]}")
    return bare_ms, busy_ms, len(device_events(prof))


def device_busy(fn):
    """(device busy ms, device activities) of one profiled call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    return sum(us for _, us in events) / 1e3, len(events)


def count_edges(patch) -> int:
    """Conv-edges of one step, as ``bench.py`` counts them: non-zero
    adjacency entries per conv, summed over the 8 convs (3 at level 0, 3 at
    level 1, 2 at level 2)."""
    return sum(int(np.count_nonzero(adj)) * convs
               for adj, convs in zip(patch.adjs, (3, 3, 2)))


def gradient_check(state, cfg, tensors, dev, swaps, label):
    """One step's parameter gradients through the kernels against the same
    step with each ``(module, wrapper name, plain version)`` of ``swaps``
    swapped in (same rotation and samples); fails beyond GRAD_ATOL on a
    gradient scaled to max 1."""
    import torch

    from facet_graph_convolution_torch.training.trainer import normals_loss

    rng = np.random.default_rng(3)
    rot = torch.as_tensor(np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32),
                          device=dev)
    idx = torch.as_tensor(rng.integers(0, tensors[0].shape[0], cfg.train.loss_samples),
                          device=dev)
    leaves = [t for layer in sorted(state.params) for _, t in sorted(state.params[layer].items())]

    def grads():
        loss = normals_loss(state.params, cfg, *tensors, idx, rot)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    kernels = [getattr(module, name) for module, name, _ in swaps]
    loss, g = grads()
    try:
        for module, name, plain in swaps:
            setattr(module, name, plain)
        loss_ref, g_ref = grads()
    finally:
        for (module, name, _), kernel in zip(swaps, kernels):
            setattr(module, name, kernel)
    worst = 0.0
    for a, b in zip(g, g_ref):
        if not torch.isfinite(a).all():
            raise AssertionError("non-finite gradient through the kernels")
        scale = float(b.abs().max()) or 1.0
        worst = max(worst, float((a - b).abs().max()) / scale)
    if worst > GRAD_ATOL or abs(loss - loss_ref) > FORWARD_ATOL:
        raise AssertionError(f"kernel step differs from the plain step: gradient {worst}, "
                             f"loss {loss} vs {loss_ref}")
    print(f"  one step through {label} vs through the plain versions: loss {loss:.6f} vs "
          f"{loss_ref:.6f}, gradient max abs err {worst:.3e} scaled to max 1 "
          f"(atol {GRAD_ATOL})")


def training_phase(dev, workdir):
    import torch

    from facet_graph_convolution_torch import params as params_io
    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.data.dataset import (
        InferenceMesh,
        TrainingSet,
        bucket_size,
        load_dataset,
        pad_patch_to,
    )
    from facet_graph_convolution_torch.data.preprocess import preprocess_directory
    from facet_graph_convolution_torch.data.synthetic import (
        add_vertex_noise,
        chamfered_box,
        icosphere,
        torus,
    )
    from facet_graph_convolution_torch.geometry.obj_io import write_obj
    from facet_graph_convolution_torch.inference.driver import infer_normals
    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
    from facet_graph_convolution_torch.training.trainer import patch_tensors, train_normals

    base = os.path.join(workdir, "train_run")
    cfg = default_config(base).replace(train={
        "network_path": os.path.join(base, "Networks") + "/", "net_name": "smoke",
        "save_every": TRAIN_STEPS // 2, "eval_every": 1, "seed": 0})
    os.makedirs(cfg.data.training_data_path)
    os.makedirs(cfg.data.gt_data_path)
    rng = np.random.default_rng(4)
    shapes = {"icosphere5": icosphere(5), "torus": torus(nu=128, nv=64),
              "chamfered_box": chamfered_box(24)}
    for name, (v, f) in shapes.items():
        write_obj(add_vertex_noise(v, f, 0.2, rng), f,
                  os.path.join(cfg.data.training_data_path, name + "_n1.obj"))
        write_obj(v, f, os.path.join(cfg.data.gt_data_path, name + ".obj"))
    t0 = time.perf_counter()
    preprocess_directory(cfg)
    train_set = load_dataset(os.path.join(cfg.data.binary_dump_path, "trainingSet.npz"))
    print(f"training phase: preprocessed {len(train_set.patches)} patches in "
          f"{time.perf_counter() - t0:.2f} s")

    k1.facet_conv_fwd.launches = 0
    k1.facet_conv_bwd.launches = 0
    t0 = time.perf_counter()
    state, hist = train_normals(cfg, train_set, num_iterations=TRAIN_STEPS, device=str(dev))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"fwd": k1.facet_conv_fwd.launches, "bwd": k1.facet_conv_bwd.launches}

    losses = hist[:, 0]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"bad loss history: {losses}")
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    if not last < first:
        raise AssertionError(f"loss did not fall: first 10 {first}, last 10 {last}")
    if launches != {"fwd": 8 * TRAIN_STEPS, "bwd": 8 * TRAIN_STEPS}:
        raise AssertionError(f"launches {launches} in {TRAIN_STEPS} steps (want 8 each a step)")
    if state.step != TRAIN_STEPS:
        raise AssertionError(f"{state.step} updates in {TRAIN_STEPS} steps")
    net_dir = os.path.join(cfg.train.network_path, cfg.train.net_name)
    saved = sorted(os.listdir(net_dir))
    for want in (f"step_{TRAIN_STEPS // 2}.pt", f"step_{TRAIN_STEPS}.pt", "params.pt"):
        if want not in saved:
            raise AssertionError(f"checkpoint {want} missing: {saved}")
    print(f"  {TRAIN_STEPS} steps over {len(train_set.patches)} patches in {train_s:.2f} s "
          f"(tables, checkpoints and warm-up included): loss {losses[0]:.3f} → "
          f"{losses[-1]:.3f}, mean of the first 10 {first:.3f}, of the last 10 {last:.3f}; "
          f"K1 launches {launches['fwd']}, K2 launches {launches['bwd']}; saved {saved}")

    first_patch = patch_tensors(
        pad_patch_to(train_set.patches[0], bucket_size(train_set.patches[0].num_nodes)),
        str(dev))
    gradient_check(state, cfg, first_patch, dev,
                   [(k1, "facet_conv_fwd", k1.facet_conv_fwd_plain),
                    (k1, "facet_conv_bwd", k1.facet_conv_bwd_plain)], "K1/K2")

    # the written params.pt serves a request
    v, f = shapes["chamfered_box"]
    mesh = InferenceMesh(max_patch_size=cfg.data.max_patch_size,
                         coarsening_steps=cfg.model.coarsening_steps,
                         coarsening_levels=cfg.model.coarsening_levels,
                         k_faces=cfg.data.k_faces, max_edges=cfg.data.max_edges, seed=0)
    mesh.add_mesh(add_vertex_noise(v, f, 0.2, rng), f)
    points, normals = infer_normals(mesh, cfg, device=str(dev))
    if points.shape != v.shape or normals.shape != (f.shape[0], 3) or not (
            np.isfinite(points).all() and np.isfinite(normals).all()):
        raise AssertionError(f"serving the trained net: bad output {points.shape}")
    params_io.load(os.path.join(net_dir, params_io.CHECKPOINT_FILE), device=str(dev))
    print(f"  served chamfered_box ({f.shape[0]} faces) from {net_dir}/params.pt")

    # the train step on the whole subdivision-5 icosphere, one patch, as
    # bench.py builds it (noise 0.01, bucket-padded to a multiple of 1024)
    v, f = icosphere(5)
    ds = TrainingSet(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3,
                     k_faces=23, seed=0)
    noisy = (v + np.random.default_rng(0).normal(scale=0.01, size=v.shape)).astype(np.float32)
    ds.add_mesh(noisy, f, gt_vertices=v)
    patch = pad_patch_to(ds.patches[0], bucket_size(ds.patches[0].num_nodes, 1024))
    edges = count_edges(patch)
    tensors = patch_tensors(patch, str(dev))
    time_train_step(cfg, tensors, dev, patch.num_nodes, edges, "default")
    return launches, {"cfg": cfg, "train_set": train_set, "first_patch": first_patch,
                      "bench_patch": patch, "bench_tensors": tensors,
                      "bench_nodes": patch.num_nodes, "bench_edges": edges}


def time_train_step(cfg, tensors, dev, nodes, edges, label):
    """Median host time of the train step on one patch (20 steps after 5 of
    warm-up, each ending in its loss on the host), then one profiled step."""
    from facet_graph_convolution_torch.training.trainer import (
        create_train_state,
        make_normals_train_step,
    )

    bench = create_train_state(cfg, num_steps=100, device=str(dev))
    step = make_normals_train_step(cfg)
    times = []
    for _ in range(25):
        t0 = time.perf_counter()
        bench, loss = step(bench, *tensors)
        float(loss)                     # waits for the step, as train_normals does
        times.append(time.perf_counter() - t0)
    times = sorted(times[5:])
    median = times[len(times) // 2]
    print(f"  {label} train step, whole subdivision-5 icosphere ({nodes} nodes, {edges} "
          f"conv-edges): median {1e3 * median:.3f} ms over {len(times)} steps "
          f"(min {1e3 * times[0]:.3f}, max {1e3 * times[-1]:.3f}), "
          f"{edges / median:.4e} conv-edges/s")
    device_profile(lambda: float(step(bench, *tensors)[1]),
                   f"one {label} train step of the {nodes}-node patch")
    return bench


def rotinv_training_phase(dev, trained):
    """``train_normals`` with ``rotation_invariance=True`` on the training
    phase's set: conv1 through K3, the other 7 convs through K1/K2. Returns
    (K3 launches, K3's inputs at conv1 of the whole-icosphere step)."""
    import torch

    from facet_graph_convolution_torch import params as params_io
    from facet_graph_convolution_torch.ops import aggregate as k3
    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
    from facet_graph_convolution_torch.training.trainer import normals_loss, train_normals

    cfg = trained["cfg"].replace(model={"rotation_invariance": True},
                                 train={"net_name": "smoke_rotinv"})
    k1.facet_conv_fwd.launches = 0
    k1.facet_conv_bwd.launches = 0
    k3.weighted_aggregate.launches = 0
    t0 = time.perf_counter()
    state, hist = train_normals(cfg, trained["train_set"], num_iterations=TRAIN_STEPS,
                                device=str(dev))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"K1": k1.facet_conv_fwd.launches, "K2": k1.facet_conv_bwd.launches,
                "K3": k3.weighted_aggregate.launches}

    losses = hist[:, 0]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"rotation-invariant training: bad loss history {losses}")
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    if not last < first:
        raise AssertionError(f"rotation-invariant loss did not fall: first 10 {first}, "
                             f"last 10 {last}")
    want = {"K1": 7 * TRAIN_STEPS, "K2": 7 * TRAIN_STEPS, "K3": TRAIN_STEPS}
    if launches != want or state.step != TRAIN_STEPS:
        raise AssertionError(f"rotation-invariant training: launches {launches}, want {want}; "
                             f"{state.step} updates in {TRAIN_STEPS} steps")
    saved = params_io.load(params_io.checkpoint_path(cfg.train.network_path, cfg.train.net_name),
                           device="cpu")
    if "v" in saved["conv1"] or "v" not in saved["conv2"]:
        raise AssertionError("the rotation-invariant params.pt has a v in conv1 or none in conv2")
    print(f"rotation-invariant training phase: {TRAIN_STEPS} steps over "
          f"{len(trained['train_set'].patches)} patches in {train_s:.2f} s: loss "
          f"{losses[0]:.3f} → {losses[-1]:.3f}, mean of the first 10 {first:.3f}, of the last "
          f"10 {last:.3f}; launches {launches}; params.pt without v in conv1")

    gradient_check(state, cfg, trained["first_patch"], dev,
                   [(k3, "weighted_aggregate", k3.weighted_aggregate_plain)], "K3")
    bench = time_train_step(cfg, trained["bench_tensors"], dev, trained["bench_nodes"],
                            trained["bench_edges"], "rotation-invariant")

    # K3's inputs as the path gives them: conv1 of one step on the whole icosphere
    captured, kernel = [], k3.weighted_aggregate

    def record(q, x_slots):
        captured.append((q, x_slots))
        return kernel(q, x_slots)

    record.launches = 0             # the wrapper counts its launch on what stands in its name
    try:
        k3.weighted_aggregate = record
        idx = torch.arange(cfg.train.loss_samples, device=dev)
        with torch.no_grad():
            normals_loss(bench.params, cfg, *trained["bench_tensors"], idx)
    finally:
        k3.weighted_aggregate = kernel
    if len(captured) != 1:
        raise AssertionError(f"one forward called K3 {len(captured)} times")
    return launches["K3"], tuple(t.detach() for t in captured[0])


def aggregate_bound_ms(q, x_slots, z):
    """Least time for K3's work on this card: q and x_slots read once and z
    written once at the HBM rate (at their dtypes' sizes), against its
    2·S·N·M·C operations (a multiply and an add per product; the contraction
    is dense, pad slots included) at the f32 rate (the kernel computes in
    f32 in either dtype); the larger of the two."""
    s, n, m = q.shape
    nbytes = sum(t.numel() * t.element_size() for t in (q, x_slots, z))
    ops = 2 * s * n * m * x_slots.shape[2]
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def aggregate_kernel_phase(dev, path_inputs):
    """K3 against its plain version at conv1 of the whole-icosphere train
    step (its inputs as the path gave them) and at the JAX kernel test's
    shape (N = 512, K = 23, M = 9, C = 64); also bitwise repeatable. Times
    the path's shape beside ``torch.einsum``, the one PyTorch call that
    computes the same function (a yardstick: the port never calls it).
    Returns (worst error, {ms, plain_ms, bound_ms, library_ms}, bound kind)."""
    import torch

    from facet_graph_convolution_torch.ops import aggregate as k3

    rng = np.random.default_rng(7)
    jax_shape = tuple(torch.as_tensor(rng.normal(size=(23, 512, w)).astype(np.float32),
                                      device=dev) for w in (9, 64))
    print("aggregate kernel phase: K3 vs plain, atol=rtol=%g, bitwise repeatable; "
          "library: torch.einsum(\"knm,knc->nmc\")" % KERNEL_ATOL)
    print("  %-22s %3s %6s %3s %4s %10s %9s %9s %9s %10s %9s %s" % (
        "case", "S", "N", "M", "C", "max_err", "ms", "wall_ms", "plain_ms", "library_ms",
        "bound_ms", "bound_by"))
    worst, path = 0.0, None
    for label, (q, x_slots) in (("conv1, train step", path_inputs),
                                ("JAX kernel test shape", jax_shape)):
        z = k3.weighted_aggregate(q, x_slots)
        again = k3.weighted_aggregate(q, x_slots)
        torch.cuda.synchronize()
        ref = k3.weighted_aggregate_plain(q, x_slots)
        err = float((z - ref).abs().max())
        if not torch.allclose(z, ref, atol=KERNEL_ATOL, rtol=KERNEL_RTOL):
            raise AssertionError(f"K3 disagrees with its plain version at {label}: {err}")
        if not torch.equal(z, again):
            raise AssertionError(f"K3 gave different bits on the same inputs at {label}")
        worst = max(worst, err)
        ms, wall_ms, _ = cuda_ms(lambda: k3.weighted_aggregate(q, x_slots), 50)
        plain_ms, _, _ = cuda_ms(lambda: k3.weighted_aggregate_plain(q, x_slots), 50)
        library_ms, _, _ = cuda_ms(lambda: torch.einsum("knm,knc->nmc", q, x_slots), 50)
        b_ms, b_by = aggregate_bound_ms(q, x_slots, z)
        s, n, m = q.shape
        print("  %-22s %3d %6d %3d %4d %10.3e %9.5f %9.5f %9.5f %10.5f %9.5f %s" % (
            label, s, n, m, x_slots.shape[2], err, ms, wall_ms, plain_ms, library_ms, b_ms,
            b_by))
        if path is None:
            path = ({"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "library_ms": library_ms}, b_by)
    return worst, path[0], path[1]


BF16 = "bfloat16"
BF16_KERNEL_TOL = 2.0 ** -8    # × max|plain| per output tensor: one bf16 rounding apart
# × max|g|: bf16 against f32 gradients (the bound of tests/test_variant_matrix.py)
BF16_GRAD_TOL = 0.05
BF16_ROTINV_STEPS = 30


def bf16_close(got, ref, what, label):
    """max |got - ref| within BF16_KERNEL_TOL × max|ref| (same dtype);
    returns the error."""
    if got.dtype != ref.dtype:
        raise AssertionError(f"{what} at {label}: {got.dtype}, its plain version {ref.dtype}")
    err = float((got.float() - ref.float()).abs().max())
    if err > BF16_KERNEL_TOL * float(ref.float().abs().max()):
        raise AssertionError(f"{what} in bfloat16 disagrees with its plain version at {label}: "
                             f"{err} (max |plain| {float(ref.float().abs().max())})")
    return err


def bf16_kernel_checks(dev, patch, k3_inputs):
    """K1 and K2 in bfloat16 against their plain bfloat16 versions at the 8
    conv shapes of the kernel phases' patch (random cat, ux and dz rounded
    to bfloat16), K3 in bfloat16 at conv1's inputs of the rotation-invariant
    step; each bitwise repeatable. Times and bounds as in the float32
    phases, the bounds at the bfloat16 bytes. Returns {kernel: (max err,
    totals, bound kind)}."""
    import torch

    from facet_graph_convolution_torch.models.unet import train_graph_tensors
    from facet_graph_convolution_torch.ops import aggregate as k3
    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1

    adjs, adj_ts, mult_rows = train_graph_tensors(patch.adjs, dev)
    rng = np.random.default_rng(8)
    m = 9
    out = {}
    sums = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0, "by": set()}
            for k in ("K1", "K2")}
    print(f"bfloat16 kernel checks: K1, K2 vs their plain bf16 versions within "
          f"{BF16_KERNEL_TOL:g} × max|plain| per output, bitwise repeatable; device ms by "
          "CUDA-graph replay (50 calls; plain 10), bounds at bf16 bytes")
    print("  %-8s %6s %4s %9s %9s %9s %9s %9s %9s %9s %9s" % (
        "conv", "N'", "C", "K1_err", "K1_ms", "K1_plain", "K1_bound", "K2_err", "K2_ms",
        "K2_plain", "K2_bound"))
    for name, level, c_in in CONVS:
        adj_sm, adj_t_sm = adjs[level], adj_ts[level]
        rows = mult_rows[level][:, :, 0].contiguous()
        n_pad = adj_sm.shape[1]
        cat, ux, c = conv_inputs(patch, level, c_in, m, n_pad, rng, dev)
        cat, ux = cat.to(torch.bfloat16), ux.to(torch.bfloat16)
        dz = torch.as_tensor(rng.normal(size=(n_pad, m * c_in)).astype(np.float32),
                             device=dev).to(torch.bfloat16)
        fargs = (cat, ux, adj_sm, rows, c)
        bargs = (cat, ux, adj_sm, adj_t_sm, rows, c, dz)
        z, again = k1.facet_conv_fwd(*fargs), k1.facet_conv_fwd(*fargs)
        dcat, dux = k1.facet_conv_bwd(*bargs)
        dcat2, dux2 = k1.facet_conv_bwd(*bargs)
        torch.cuda.synchronize()
        if not (torch.equal(z, again) and torch.equal(dcat, dcat2) and torch.equal(dux, dux2)):
            raise AssertionError(f"K1/K2 in bfloat16 gave different bits on the same inputs "
                                 f"at {name}")
        if (z.dtype, dcat.dtype, dux.dtype) != (torch.bfloat16, torch.bfloat16, torch.float32):
            raise AssertionError(f"bf16 K1/K2 output dtypes {z.dtype}, {dcat.dtype}, {dux.dtype}")
        e1 = bf16_close(z, k1.facet_conv_fwd_plain(*fargs), "K1 z", name)
        ref = k1.facet_conv_bwd_plain(*bargs)
        e2 = max(bf16_close(dcat, ref[0], "K2 dcat", name), bf16_close(dux, ref[1], "K2 dux",
                                                                         name))
        row = []
        for key, err, fn, plain, args, bound in (
                ("K1", e1, k1.facet_conv_fwd, k1.facet_conv_fwd_plain, fargs,
                 lambda: bound_ms(*fargs, z)),
                ("K2", e2, k1.facet_conv_bwd, k1.facet_conv_bwd_plain, bargs,
                 lambda: bwd_bound_ms(bargs, dcat, dux))):
            ms = cuda_ms(lambda: fn(*args), 50)[0]
            plain_ms = cuda_ms(lambda: plain(*args), 10)[0]
            b_ms, b_by = bound()
            t = sums[key]
            t["ms"] += ms
            t["plain_ms"] += plain_ms
            t["bound_ms"] += b_ms
            t["err"] = max(t["err"], err)
            t["by"].add(b_by)
            row += [err, ms, plain_ms, b_ms]
        print("  %-8s %6d %4d %9.2e %9.5f %9.5f %9.5f %9.2e %9.5f %9.5f %9.5f" % (
            name, n_pad, c_in, *row))
    for key, t in sums.items():
        print(f"  {key} bf16, the 8 convs: {t['ms']:.5f} ms (plain {t['plain_ms']:.5f}, bound "
              f"{t['bound_ms']:.5f}, {'/'.join(sorted(t['by']))})")
        out[key] = (t["err"], {k: t[k] for k in ("ms", "plain_ms", "bound_ms")},
                    "bytes" if t["by"] == {"bytes"} else "operations")

    q, x_slots = (t.to(torch.bfloat16) for t in k3_inputs)
    z, again = k3.weighted_aggregate(q, x_slots), k3.weighted_aggregate(q, x_slots)
    torch.cuda.synchronize()
    if not torch.equal(z, again) or z.dtype != torch.bfloat16:
        raise AssertionError(f"K3 in bfloat16: repeatable {torch.equal(z, again)}, z {z.dtype}")
    err = bf16_close(z, k3.weighted_aggregate_plain(q, x_slots), "K3 z", "conv1")
    ms = cuda_ms(lambda: k3.weighted_aggregate(q, x_slots), 50)[0]
    plain_ms = cuda_ms(lambda: k3.weighted_aggregate_plain(q, x_slots), 50)[0]
    library_ms = cuda_ms(lambda: torch.einsum("knm,knc->nmc", q, x_slots), 50)[0]
    b_ms, b_by = aggregate_bound_ms(q, x_slots, z)
    s_, n, m3 = q.shape
    print(f"  K3 bf16 at conv1 (S {s_}, N {n}, M {m3}, C {x_slots.shape[2]}): err {err:.2e}, "
          f"{ms:.5f} ms, plain {plain_ms:.5f}, torch.einsum (bf16) {library_ms:.5f}, bound "
          f"{b_ms:.5f} ({b_by})")
    out["K3"] = (err, {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                       "library_ms": library_ms}, b_by)
    return out


def bf16_phase(dev, patch, trained, k3_inputs):
    """``compute_dtype="bfloat16"`` (the JAX package's production training
    configuration): the bf16 kernel checks; ``train_normals`` at full width
    for TRAIN_STEPS default steps on the training phase's set (finite,
    falling losses; K1 and K2 in bfloat16 8 times a step and never in
    float32; one step's gradients within BF16_GRAD_TOL of the float32 step's
    from the same state and draws; a float32 ``params.pt`` that serves a
    request through ``infer_normals``), then BF16_ROTINV_STEPS
    rotation-invariant steps (K3 in bfloat16 once a step, K1/K2 7 times);
    then the bfloat16 graph step of both variants against its eager steps.
    Returns its numbers."""
    import torch

    from facet_graph_convolution_torch import params as params_io
    from facet_graph_convolution_torch.data.dataset import InferenceMesh
    from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, chamfered_box
    from facet_graph_convolution_torch.inference.driver import infer_normals
    from facet_graph_convolution_torch.ops import aggregate as k3
    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
    from facet_graph_convolution_torch.training.trainer import normals_loss, train_normals

    t_phase = time.perf_counter()
    print("bfloat16 phase: compute_dtype=\"bfloat16\"; "
          "torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction} (left at "
          "PyTorch's default; the convs' bf16 products write f32)")
    checks = bf16_kernel_checks(dev, patch, k3_inputs)
    counters = {"K1": k1.facet_conv_fwd, "K2": k1.facet_conv_bwd, "K3": k3.weighted_aggregate}
    cfg = trained["cfg"].replace(model={"compute_dtype": BF16})
    runs, launches = {}, {}
    for label, c, steps, per_step in (
            ("default", cfg.replace(train={"net_name": "smoke_bf16"}), TRAIN_STEPS,
             {"K1": 8, "K2": 8, "K3": 0}),
            ("rotation-invariant", cfg.replace(model={"rotation_invariance": True},
                                               train={"net_name": "smoke_bf16_rotinv"}),
             BF16_ROTINV_STEPS, {"K1": 7, "K2": 7, "K3": 1})):
        for fn in counters.values():
            fn.launches = fn.launches_bf16 = 0
        t0 = time.perf_counter()
        state, hist = train_normals(c, trained["train_set"], num_iterations=steps,
                                    device=str(dev))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        bf16 = {k: fn.launches_bf16 for k, fn in counters.items()}
        f32 = {k: fn.launches - fn.launches_bf16 for k, fn in counters.items()}
        losses = hist[:, 0]
        first, last = float(losses[:10].mean()), float(losses[-10:].mean())
        if len(losses) != steps or not np.isfinite(losses).all() or not last < first:
            raise AssertionError(f"bf16 training, {label}: losses {losses}")
        want = {k: n * steps for k, n in per_step.items()}
        if bf16 != want or any(f32.values()) or state.step != steps:
            raise AssertionError(f"bf16 training, {label}: bf16 launches {bf16} (want {want}), "
                                 f"f32 launches {f32} (want none), {state.step} updates")
        print(f"  bf16 training, {label}: {steps} steps in {train_s:.2f} s: loss {losses[0]:.3f} "
              f"→ {losses[-1]:.3f}, mean of the first 10 {first:.3f}, of the last 10 "
              f"{last:.3f}; bf16 launches {bf16}, f32 launches {f32}")
        runs[label], launches[label] = (c, state), bf16

    # one step's gradients in bf16 against the f32 step's, same state and draws
    c, state = runs["default"]
    tensors = trained["first_patch"]
    rng = np.random.default_rng(9)
    rot = torch.as_tensor(np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32),
                          device=dev)
    idx = torch.as_tensor(rng.integers(0, tensors[0].shape[0], c.train.loss_samples),
                          device=dev)
    leaves = [t for layer in sorted(state.params) for _, t in sorted(state.params[layer].items())]
    got = {}
    for dtype in (torch.bfloat16, torch.float32):
        loss = normals_loss(state.params, c, *tensors, idx, rot, dtype=dtype)
        got[dtype] = (float(loss.detach()), torch.autograd.grad(loss, leaves))
    worst = 0.0
    for a, b in zip(got[torch.bfloat16][1], got[torch.float32][1]):
        if a.dtype != torch.float32 or not torch.isfinite(a).all():
            raise AssertionError(f"bf16 step gradient {a.dtype}, finite {torch.isfinite(a).all()}")
        worst = max(worst, float((a - b).abs().max()) / (float(b.abs().max()) or 1.0))
    if worst > BF16_GRAD_TOL:
        raise AssertionError(f"bf16 step gradients differ from the f32 step's by {worst} "
                             f"(> {BF16_GRAD_TOL} of max|g|)")
    print(f"  one default step in bf16 vs f32 (same state and draws): loss "
          f"{got[torch.bfloat16][0]:.5f} vs {got[torch.float32][0]:.5f}; gradient max abs err "
          f"{worst:.3e} of max|g| (bound {BF16_GRAD_TOL})")

    # the checkpoint is f32 and serves a request
    saved = params_io.load(params_io.checkpoint_path(c.train.network_path, c.train.net_name),
                           device=str(dev))
    dtypes = {t.dtype for leaves in saved.values() for t in leaves.values()}
    if dtypes != {torch.float32}:
        raise AssertionError(f"the bf16-trained params.pt holds {dtypes}")
    v, f = chamfered_box(24)
    mesh = InferenceMesh(max_patch_size=c.data.max_patch_size,
                         coarsening_steps=c.model.coarsening_steps,
                         coarsening_levels=c.model.coarsening_levels, k_faces=c.data.k_faces,
                         max_edges=c.data.max_edges, seed=0)
    mesh.add_mesh(add_vertex_noise(v, f, 0.2, np.random.default_rng(5)), f)
    k1.facet_conv_fwd.launches = k1.facet_conv_fwd.launches_bf16 = 0
    points, normals = infer_normals(mesh, c, device=str(dev))
    if points.shape != v.shape or not (np.isfinite(points).all() and np.isfinite(normals).all()):
        raise AssertionError("serving the bf16-trained net: bad output")
    if k1.facet_conv_fwd.launches_bf16 != 0 or k1.facet_conv_fwd.launches == 0:
        raise AssertionError(f"serving a bf16 config: K1 launches {k1.facet_conv_fwd.launches}, "
                             f"bf16 {k1.facet_conv_fwd.launches_bf16} (serving runs f32)")
    print(f"  params.pt float32; served chamfered_box ({f.shape[0]} faces) in float32 (K1 "
          f"{k1.facet_conv_fwd.launches} f32 launches)")

    # the bf16 graph step on the whole subdivision-5 icosphere
    graphs = {}
    for label, c in (("default", cfg), ("rotation-invariant",
                                        cfg.replace(model={"rotation_invariance": True}))):
        for fn in counters.values():
            fn.launches = fn.launches_bf16 = 0
        graphs[label] = normals_graph_vs_eager(dev, trained, label, c)
        if any(fn.launches != fn.launches_bf16 for fn in counters.values()):
            counts = {k: (fn.launches, fn.launches_bf16) for k, fn in counters.items()}
            raise AssertionError(f"bf16 graph step, {label}: an f32 kernel launched (all, "
                                 f"bf16): {counts}")
    print(f"  bfloat16 phase: {time.perf_counter() - t_phase:.1f} s")
    return {"checks": checks, "launches": launches, "graphs": graphs}


def request_shapes():
    from facet_graph_convolution_torch.data.synthetic import chamfered_box, icosphere, torus

    return {"icosphere5": icosphere(5), "torus": torus(nu=128, nv=64),
            "chamfered_box": chamfered_box(24)}


def plain_solve(fn):
    """``fn()`` with the naive solver's scale kernel and the standalone K4
    both replaced by their plain versions: the solve in plain PyTorch."""
    from facet_graph_convolution_torch.ops import ms_solver_kernel as ms
    from facet_graph_convolution_torch.ops import tree_pool_kernel as k4

    kernels = (ms.naive_scale, k4.tree_pool_ignore_zeros)
    try:
        ms.naive_scale = plain_scale
        k4.tree_pool_ignore_zeros = k4.tree_pool_ignore_zeros_plain
        return fn()
    finally:
        ms.naive_scale, k4.tree_pool_ignore_zeros = kernels


def plain_scale(x, faces, v_faces, fn, scale, steps, iters, **kernel_args):
    """The plain loop in ``naive_scale``'s place (under autograd, autograd
    through it); the kernels' own arguments (grid, maps, checkpoint) are
    not its."""
    from facet_graph_convolution_torch.ops import ms_solver_kernel as ms

    return ms.naive_scale_plain(x, faces, v_faces, fn, scale, steps, iters)


def vertex_serving_phase(dev, workdir):
    """The 3 requests through the vertex pipeline under both solvers;
    returns (the naive run's launches, its records, its config, the
    weights)."""
    import torch

    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.data.synthetic import add_vertex_noise
    from facet_graph_convolution_torch.geometry.obj_io import load_obj, write_obj
    from facet_graph_convolution_torch.inference.driver import (
        forward_patch,
        infer_directory,
        infer_with_vertices,
        solve_patch,
        solver_tables,
    )
    from facet_graph_convolution_torch.models.unet import init_unet
    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
    from facet_graph_convolution_torch.ops import ms_solver_kernel as ms
    from facet_graph_convolution_torch.ops import tree_pool_kernel as k4

    t_phase = time.perf_counter()
    in_dir = os.path.join(workdir, "vertex_requests")
    os.makedirs(in_dir)
    rng = np.random.default_rng(5)
    shapes = request_shapes()
    for name, (v, f) in shapes.items():
        write_obj(add_vertex_noise(v, f, 0.2, rng), f, os.path.join(in_dir, name + ".obj"))
    # full width with the multi-scale heads: 32/64/128, M = 9, fc 1024
    params = init_unet(seed=1, multi_scale=True, device=str(dev))
    print("vertex serving phase: 3 requests, full width, multi-scale heads, random weights")
    runs = {}
    for solver in ("operator", "naive"):
        cfg = default_config(workdir).replace(eval={
            "results_path": os.path.join(workdir, "vertex_results_" + solver) + "/",
            "vertex_solver": solver})
        k1.facet_conv_fwd.launches = 0
        k1.facet_conv_bwd.launches = 0
        k4.tree_pool_ignore_zeros.launches = 0
        ms.naive_scale.launches = 0
        records = infer_directory(in_dir, cfg, with_vertices=True, params=params,
                                  device=str(dev))
        launches = {"K1": k1.facet_conv_fwd.launches, "K2": k1.facet_conv_bwd.launches,
                    "K4": k4.tree_pool_ignore_zeros.launches,
                    "solver": ms.naive_scale.launches}
        if len(records) != 3:
            raise AssertionError(f"{solver}: served {len(records)} of 3 requests")
        patches = sum(r["patches"] for r in records)
        want = {"K1": 8 * patches, "K2": 0, "K4": 0,
                "solver": 3 * patches if solver == "naive" else 0}
        if launches != want:
            raise AssertionError(f"{solver}: launches {launches} for {patches} patches, "
                                 f"want {want}")
        print(f"  {solver} solver: {patches} patches, launches {launches}")
        for r in records:
            v, f = shapes[r["name"]]
            results = cfg.eval.results_path
            for suffix in SEVEN_FILES:
                out_v, out_f, _ = load_obj(os.path.join(results, r["name"] + suffix))
                if not np.isfinite(out_v).all():
                    raise AssertionError(f"{r['name']}{suffix}: non-finite vertices")
                if suffix.startswith("_d") and (
                        out_v.shape != v.shape
                        or not np.array_equal(out_f.astype(np.int64), f.astype(np.int64))):
                    raise AssertionError(f"{r['name']}{suffix}: bad mesh {out_v.shape}")
            print("    request %-14s faces %6d patches %d  preprocess %.3f s  forward %.3f s  "
                  "solver %.3f s (%d iterations a patch)" % (
                      r["name"], r["faces"], r["patches"], r["preprocess_s"], r["forward_s"],
                      r["solver_s"], r["solver_iterations"]))
        runs[solver] = (records, cfg, launches)

    records, cfg, launches = runs["naive"]
    cfg_operator = runs["operator"][1]
    heads_err = solve_err = points_err = 0.0
    identical = True
    kernel = k1.facet_conv_fwd
    for r in records:
        for patch in r["mesh"].patches:
            with torch.no_grad():
                heads = forward_patch(params, patch, cfg, dev, multi_scale=True)
                try:
                    k1.facet_conv_fwd = k1.facet_conv_fwd_plain
                    heads_ref = forward_patch(params, patch, cfg, dev, multi_scale=True)
                finally:
                    k1.facet_conv_fwd = kernel
            for h, h_ref in zip(heads, heads_ref):
                if not torch.isfinite(h).all():
                    raise AssertionError(f"{r['name']}: non-finite head")
                heads_err = max(heads_err, float((h - h_ref).abs().max()))
            solved = solve_patch(patch, cfg, heads, dev)
            again = solve_patch(patch, cfg, heads, dev)
            solved_ref = plain_solve(lambda: solve_patch(patch, cfg, heads, dev))
            for a, b, c in zip([solved[0], *solved[1]], [solved_ref[0], *solved_ref[1]],
                               [again[0], *again[1]]):
                if not torch.isfinite(a).all():
                    raise AssertionError(f"{r['name']}: non-finite naive solve")
                identical = identical and torch.equal(a, c)
                solve_err = max(solve_err, float((a - b).abs().max()))
        # the operator solver on the same patches as the naive run
        out_op = infer_with_vertices(r["mesh"], cfg_operator, params=params, device=str(dev))
        for key in ("points", "points_mid", "points_coarse"):
            points_err = max(points_err, float(np.abs(out_op[key] - r["outputs"][key]).max()))
    if heads_err > FORWARD_ATOL:
        raise AssertionError(f"the heads through K1 differ from the plain K1's by {heads_err}")
    if not identical:
        raise AssertionError("two naive solves through the scale kernel gave different bits")
    if solve_err > NAIVE_ATOL:
        raise AssertionError(f"the naive solve through the scale kernel differs from the plain "
                             f"solve by {solve_err}")
    if points_err > SOLVER_ATOL:
        raise AssertionError(f"operator and naive points differ by {points_err}")
    print(f"  three heads through K1 vs through plain K1: max abs err {heads_err:.3e} "
          f"(atol {FORWARD_ATOL})")
    print(f"  naive solve through the scale kernel vs the plain solve: max abs err "
          f"{solve_err:.3e} (atol {NAIVE_ATOL}, patch frame); two solves, the same bits")
    print(f"  operator vs naive points, same patches: max abs err {points_err:.3e} "
          f"(atol {SOLVER_ATOL}, patch frame)")

    # where a solve's time goes, on the largest patch
    largest = largest_patch(records)
    with torch.no_grad():
        heads = forward_patch(params, largest, cfg, dev, multi_scale=True)
    t0 = time.perf_counter()
    solver_tables(cfg_operator, largest, dev)
    torch.cuda.synchronize()
    print(f"  operator tables of the {largest.num_nodes}-face patch, built on the host: "
          f"{time.perf_counter() - t0:.3f} s")
    for solver, solver_cfg in (("naive", cfg), ("operator", cfg_operator)):
        device_profile(lambda: solve_patch(largest, solver_cfg, heads, dev),
                       f"one {solver} solve of the {largest.num_nodes}-face patch")
    print(f"  vertex serving phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, records, cfg, params


def largest_patch(records):
    return max((p for r in records for p in r["mesh"].patches), key=lambda p: p.num_nodes)


def vertex_gradient_check(state, cfg, tensors, rot, idx0, idx1):
    """One vertex step's parameter gradients through K1/K2 against the same
    step through the plain conv (same draws), each gradient scaled to max 1;
    fails beyond VERTEX_GRAD_ATOL, or on a loss beyond VERTEX_LOSS_RTOL. Both
    are also held against the plain step in float64, which shows how far
    float32 alone moves the gradients through the solver's 120 iterations.

    The step is not smooth everywhere: ``lrelu``'s derivative is 1, α, or 0
    at exactly 0; the max pool's and the chamfer minimum's gradients go to
    the winning entry. Where float32 noise moves an input across such a
    point, the gradient changes discretely (on an H100, one lrelu input and
    one pool winner on other sides through K1 than through the plain conv
    moved fc_mid.b's gradient by 6.1e-3 scaled; pinned, 3.2e-4). So each
    pair of steps is compared as it is where none of those points differ
    between the two, and every step is compared once more with them pinned
    to the float64 step's (the same forward values; each derivative, pool
    winner and nearest point taken from the float64 step), where none can
    differ."""
    import torch

    from facet_graph_convolution_torch.models import losses, unet
    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
    from facet_graph_convolution_torch.ops import ms_solver_kernel as ms
    from facet_graph_convolution_torch.ops import tree_pool_kernel as k4
    from facet_graph_convolution_torch.training import trainer

    names = [(layer, k) for layer in sorted(state.params) for k in sorted(state.params[layer])]
    originals = (unet.lrelu, unet.tree_pool, trainer.full_chamfer_loss)
    lrelu, tree_pool, chamfer = originals
    records = []                      # per step: its kinks, in call order

    def recorded(kind, value):
        seen = records[-1].setdefault(kind, [])
        if len(records) > 3:          # pinned: the float64 step's
            value = records[2][kind][len(seen)]
        seen.append(value)
        return value

    def check_lrelu(x, alpha=0.1):
        # the derivative autograd takes of relu(x) - alpha * relu(-x)
        d = recorded("lrelu", torch.where(x > 0, 1.0, torch.where(x < 0, alpha, 0.0)).float())
        y = lrelu(x, alpha)
        return y if len(records) <= 3 else y.detach() + (x - x.detach()) * d.to(x.dtype)

    def check_pool(x, steps=1, mode="max"):
        groups = x.reshape(-1, 2 ** steps, x.shape[1])
        win = recorded("pool", torch.argmax(groups, dim=1))
        if len(records) <= 3:
            return tree_pool(x, steps, mode)
        return torch.gather(groups, 1, win[:, None, :]).squeeze(1)

    def check_chamfer(p0, p1, i0, i1):
        with torch.no_grad():
            nn0 = recorded("nearest", torch.argmin(losses._pairwise_dist(p0[i0], p1), dim=1))
            nn1 = recorded("nearest", torch.argmin(losses._pairwise_dist(p0, p1[i1]), dim=0))
        if len(records) <= 3:
            return chamfer(p0, p1, i0, i1)
        d0 = torch.sqrt(torch.sum(torch.square(p0[i0] - p1[nn0]), dim=-1) + 1e-20)
        d1 = torch.sqrt(torch.sum(torch.square(p0[nn1] - p1[i1]), dim=-1) + 1e-20)
        return 1000.0 * (torch.mean(losses._threshold(d0, 5000.0))
                         + torch.mean(losses._threshold(d1, 5000.0)))

    def grads(params, t, draws):
        records.append({})
        loss = trainer.vertex_loss(params, cfg, t, *draws)
        g = torch.autograd.grad(loss, [params[a][b] for a, b in names])
        return float(loss.detach()), [x.double() for x in g]

    p64 = {a: {b: t.detach().double().requires_grad_() for b, t in leaves.items()}
           for a, leaves in state.params.items()}
    t64 = tensors._replace(**{f: getattr(tensors, f).double() for f in (
        "x", "vertices", "gt_vertices", "gt_normals")})
    runs = {}
    # the plain step: the plain conv, the solver as in the step; the float64
    # step: the plain conv and, under the naive solver, the plain loop under
    # autograd with the plain K4 (the scale kernel and its adjoint take
    # float32 only)
    kernels = (k1.facet_conv_fwd, k1.facet_conv_bwd, ms.naive_scale, k4.tree_pool_ignore_zeros)
    plain_conv = (k1.facet_conv_fwd_plain, k1.facet_conv_bwd_plain) + kernels[2:]
    plains = plain_conv[:2] + (plain_scale, k4.tree_pool_ignore_zeros_plain)

    def use(fns):
        k1.facet_conv_fwd, k1.facet_conv_bwd, ms.naive_scale, k4.tree_pool_ignore_zeros = fns

    try:
        unet.lrelu, unet.tree_pool, trainer.full_chamfer_loss = (check_lrelu, check_pool,
                                                                  check_chamfer)
        for mode in ("as they are", "pinned to float64's"):
            use(kernels)
            kernel = grads(state.params, tensors, (rot, idx0, idx1))
            use(plain_conv)
            plain = grads(state.params, tensors, (rot, idx0, idx1))
            use(plains)
            runs[mode] = (kernel, plain, grads(p64, t64, (rot.double(), idx0, idx1)))
    finally:
        use(kernels)
        unet.lrelu, unet.tree_pool, trainer.full_chamfer_loss = originals

    def worst(a, b):
        errs = [(float((x - y).abs().max()) / (float(y.abs().max()) or 1.0), f"{n[0]}.{n[1]}")
                for x, y, n in zip(a[1], b[1], names)]
        return max(errs)

    def flips(i, j):
        """Kinks on different sides in steps i and j, by kind."""
        return {kind: sum(int((a != b).sum()) for a, b in zip(records[i][kind], records[j][kind]))
                for kind in records[i]}

    failed = []
    for mode, (kernel, plain, exact) in runs.items():
        for g in kernel[1]:
            if not torch.isfinite(g).all():
                raise AssertionError("non-finite gradient through the kernels")
        err, leaf = worst(kernel, plain)
        err64, leaf64 = worst(kernel, exact)
        if mode == "as they are":
            flipped = {"plain": flips(0, 1), "float64": flips(0, 2)}
            note = f"; kinks on other sides than the plain step's {flipped['plain']}, " \
                   f"than float64's {flipped['float64']}"
        else:
            flipped = {"plain": {}, "float64": {}}
            note = ""
        print(f"  one vertex step through K1/K2 vs through the plain conv, kinks {mode}: loss "
              f"{kernel[0]:.6f} vs {plain[0]:.6f}, gradient max abs err {err:.3e} scaled to max 1 "
              f"({leaf}; atol {VERTEX_GRAD_ATOL}); against the plain step in float64 (loss "
              f"{exact[0]:.6f}): through K1/K2 {err64:.3e} ({leaf64}), plain float32 %.3e (%s)"
              % worst(plain, exact) + note)
        if ((not any(flipped["plain"].values()) and err > VERTEX_GRAD_ATOL)
                or (not any(flipped["float64"].values()) and err64 > VERTEX_GRAD_ATOL)
                or abs(kernel[0] - plain[0]) > VERTEX_LOSS_RTOL * abs(plain[0])):
            failed.append(f"kinks {mode}: gradient {err} ({leaf}), from float64 {err64} "
                          f"({leaf64}), loss {kernel[0]} vs {plain[0]}")
    if failed:
        raise AssertionError("the vertex step through K1/K2 differs from the plain step: "
                             + "; ".join(failed))


def vertex_training_phase(dev, workdir):
    """Vertex training at full width: the 3 shapes' noisy/GT pairs →
    ``preprocess_directory(with_vertices=True)`` → ``train_with_vertices``
    under the operator solver; then its checks and times on the largest
    vertex patch."""
    import torch

    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.data.dataset import load_dataset
    from facet_graph_convolution_torch.data.preprocess import preprocess_directory
    from facet_graph_convolution_torch.data.synthetic import add_vertex_noise
    from facet_graph_convolution_torch.geometry.obj_io import write_obj
    from facet_graph_convolution_torch.models.unet import unet_apply
    from facet_graph_convolution_torch.ops import aggregate as k3
    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
    from facet_graph_convolution_torch.ops import ms_solver_kernel as ms
    from facet_graph_convolution_torch.ops import tree_pool_kernel as k4
    from facet_graph_convolution_torch.ops.normalization import normalize_tensor
    from facet_graph_convolution_torch.ops.vertex_update import (
        update_positions_multiscale_operator,
    )
    from facet_graph_convolution_torch.training.trainer import (
        create_train_state,
        make_vertex_train_step,
        train_with_vertices,
        vertex_loss,
        vertex_patch_tensors,
    )

    t_phase = time.perf_counter()
    base = os.path.join(workdir, "vertex_train_run")
    # full width, schedule (80, 20, 20), 500 chamfer samples, the operator
    # solver, Adam at 1e-3: the config's defaults
    cfg = default_config(base).replace(train={
        "network_path": os.path.join(base, "Networks") + "/", "net_name": "smoke_vertex",
        "save_every": VERTEX_TRAIN_STEPS // 2, "seed": 0})
    os.makedirs(cfg.data.training_data_path)
    os.makedirs(cfg.data.gt_data_path)
    rng = np.random.default_rng(6)
    for name, (v, f) in request_shapes().items():
        write_obj(add_vertex_noise(v, f, 0.2, rng), f,
                  os.path.join(cfg.data.training_data_path, name + "_n1.obj"))
        write_obj(v, f, os.path.join(cfg.data.gt_data_path, name + ".obj"))
    t0 = time.perf_counter()
    preprocess_directory(cfg, with_vertices=True)
    pre_s = time.perf_counter() - t0
    train_set = load_dataset(os.path.join(cfg.data.binary_dump_path,
                                          "trainingSetWithVertices.npz"))
    print(f"vertex training phase: preprocessed {len(train_set.patches)} patches with vertices "
          f"in {pre_s:.2f} s")

    counters = {"K1": k1.facet_conv_fwd, "K2": k1.facet_conv_bwd, "K3": k3.weighted_aggregate,
                "K4": k4.tree_pool_ignore_zeros, "solver": ms.naive_scale,
                "adjoint": ms.naive_scale_backward}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    state, hist = train_with_vertices(cfg, train_set, num_iterations=VERTEX_TRAIN_STEPS,
                                      device=str(dev))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    losses = hist[:, 0]
    if len(losses) != VERTEX_TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"vertex training: bad loss history {losses}")
    if not losses[-1] < 5 * losses[0]:
        raise AssertionError(f"vertex training: loss {losses[0]} → {losses[-1]} (want the last "
                             "below 5× the first)")
    want = {"K1": 8 * VERTEX_TRAIN_STEPS, "K2": 8 * VERTEX_TRAIN_STEPS, "K3": 0, "K4": 0,
            "solver": 0, "adjoint": 0}
    if launches != want or state.step != VERTEX_TRAIN_STEPS:
        raise AssertionError(f"vertex training: launches {launches}, want {want}; "
                             f"{state.step} updates in {VERTEX_TRAIN_STEPS} steps")
    net_dir = os.path.join(cfg.train.network_path, cfg.train.net_name)
    saved = sorted(os.listdir(net_dir))
    for want_file in (f"step_{VERTEX_TRAIN_STEPS // 2}.pt", f"step_{VERTEX_TRAIN_STEPS}.pt",
                      "params.pt"):
        if want_file not in saved:
            raise AssertionError(f"vertex training: checkpoint {want_file} missing: {saved}")
    print(f"  {VERTEX_TRAIN_STEPS} steps over {len(train_set.patches)} patches in "
          f"{train_s:.2f} s (tables, checkpoints and warm-up included): loss {losses[0]:.3f} → "
          f"{losses[-1]:.3f}, min {losses.min():.3f}; launches {launches}; saved {saved}")

    # the largest vertex patch: one step through K1/K2 against the plain
    # conv, step.eval against the step, then its times
    largest = max(train_set.patches, key=lambda p: p.num_nodes)
    tensors = vertex_patch_tensors(cfg, largest, str(dev))
    samples = cfg.train.chamfer_samples
    draw_rng = np.random.default_rng(8)
    rot = torch.as_tensor(np.linalg.qr(draw_rng.normal(size=(3, 3)))[0].astype(np.float32),
                          device=dev)
    idx0 = torch.as_tensor(draw_rng.integers(0, largest.vertices.shape[0], samples), device=dev)
    idx1 = torch.as_tensor(draw_rng.integers(0, largest.gt_vertices.shape[0], samples),
                           device=dev)
    print(f"  largest vertex patch: {largest.num_nodes} faces, {largest.vertices.shape[0]} "
          f"vertices, {largest.gt_vertices.shape[0]} GT vertices")
    vertex_gradient_check(state, cfg, tensors, rot, idx0, idx1)

    bench = create_train_state(cfg, num_steps=100, device=str(dev), params=state.params,
                               multi_scale=True)
    step = make_vertex_train_step(cfg)
    eval_loss = float(step.eval(bench.params, tensors, rot, idx0, idx1))
    bench, step_loss = step(bench, tensors, rot, idx0, idx1)
    step_loss = float(step_loss)
    if abs(eval_loss - step_loss) > VERTEX_LOSS_RTOL * abs(step_loss):
        raise AssertionError(f"step.eval's loss {eval_loss} differs from the step's {step_loss}")
    print(f"  step.eval vs the step, same draws: {eval_loss:.6f} vs {step_loss:.6f} "
          f"({'the same bits' if eval_loss == step_loss else 'rtol %g' % VERTEX_LOSS_RTOL})")

    times = []
    for _ in range(25):
        t0 = time.perf_counter()
        bench, loss = step(bench, tensors)
        float(loss)                     # waits for the step, as train_with_vertices does
        times.append(time.perf_counter() - t0)
    times = sorted(times[5:])
    print(f"  vertex train step, {largest.num_nodes}-face patch: median "
          f"{1e3 * times[len(times) // 2]:.3f} ms over {len(times)} steps "
          f"(min {1e3 * times[0]:.3f}, max {1e3 * times[-1]:.3f})")
    _, step_busy, _ = device_profile(lambda: float(step(bench, tensors)[1]),
                                     f"one vertex train step of the {largest.num_nodes}-face "
                                     "patch")

    # the solver's share of that step's device time: its forward and its
    # backward alone, from the step's normalized heads
    with torch.no_grad():
        heads = [normalize_tensor(h) for h in unet_apply(
            bench.params, tensors.x, tensors.adjs, tensors.rows,
            coarsening_steps=cfg.model.coarsening_steps, multi_scale=True)]
    leaves = [h.clone().requires_grad_() for h in heads]
    cotangent = torch.randn_like(tensors.vertices)
    solved = []

    def solver_forward():
        solved.append(update_positions_multiscale_operator(
            tensors.vertices, leaves, tensors.faces, tensors.v_faces, tensors.tables,
            coarsening_steps=cfg.model.coarsening_steps,
            iter_nums=cfg.eval.ms_solver_iterations)[0])

    fwd_ms, fwd_n = device_busy(solver_forward)
    bwd_ms, bwd_n = device_busy(lambda: solved[-1].backward(cotangent))
    print(f"  the operator solver in that step: forward {fwd_ms:.3f} ms busy ({fwd_n} device "
          f"activities), backward {bwd_ms:.3f} ms ({bwd_n}); together "
          f"{100 * (fwd_ms + bwd_ms) / step_busy:.1f}% of the step's device time")

    print(f"  vertex training phase: {time.perf_counter() - t_phase:.1f} s")
    return {"cfg": cfg, "train_set": train_set, "tensors": tensors, "params": state.params,
            "largest": largest, "draws": (rot, idx0, idx1)}


def naive_training_phase(dev, vertex_trained):
    """Vertex training at full width under the naive solver on the vertex
    training phase's set: ``train_with_vertices`` eager for
    VERTEX_TRAIN_STEPS steps (the scale kernel forward, its adjoint kernel
    backward); then on the largest vertex patch the vertex gradient check
    (through K1/K2 against the plain conv, and against float64). Returns the
    run's launches and its config."""
    import torch

    from facet_graph_convolution_torch.ops import aggregate as k3
    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
    from facet_graph_convolution_torch.ops import ms_solver_kernel as ms
    from facet_graph_convolution_torch.ops import tree_pool_kernel as k4
    from facet_graph_convolution_torch.training.checkpoint import CheckpointManager
    from facet_graph_convolution_torch.training.trainer import (
        train_with_vertices,
        vertex_patch_tensors,
    )

    t_phase = time.perf_counter()
    cfg = vertex_trained["cfg"].replace(eval={"vertex_solver": "naive"},
                                        train={"net_name": "smoke_naive"})
    train_set = vertex_trained["train_set"]
    counters = {"K1": k1.facet_conv_fwd, "K2": k1.facet_conv_bwd, "K3": k3.weighted_aggregate,
                "K4": k4.tree_pool_ignore_zeros, "solver": ms.naive_scale,
                "adjoint": ms.naive_scale_backward}
    print(f"naive training phase: train_with_vertices(vertex_solver='naive'), full width, "
          f"{VERTEX_TRAIN_STEPS} eager steps over {len(train_set.patches)} patches")
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    state, hist = train_with_vertices(cfg, train_set, num_iterations=VERTEX_TRAIN_STEPS,
                                      device=str(dev))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    losses = hist[:, 0]
    if len(losses) != VERTEX_TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"naive training: bad loss history {losses}")
    want = {"K1": 8 * VERTEX_TRAIN_STEPS, "K2": 8 * VERTEX_TRAIN_STEPS, "K3": 0, "K4": 0,
            "solver": 3 * VERTEX_TRAIN_STEPS, "adjoint": 3 * VERTEX_TRAIN_STEPS}
    if launches != want or state.step != VERTEX_TRAIN_STEPS:
        raise AssertionError(f"naive training: launches {launches}, want {want}; "
                             f"{state.step} updates")
    saved = CheckpointManager(cfg.train.network_path, cfg.train.net_name).steps()
    if saved != [VERTEX_TRAIN_STEPS // 2, VERTEX_TRAIN_STEPS]:
        raise AssertionError(f"naive training: checkpoints {saved}")
    print(f"  {VERTEX_TRAIN_STEPS} steps in {train_s:.2f} s (maps, checkpoints and warm-up "
          f"included): loss {losses[0]:.3f} → {losses[-1]:.3f}, min {losses.min():.3f}; launches "
          f"{launches}; saved steps {saved}")

    largest = vertex_trained["largest"]
    tensors = vertex_patch_tensors(cfg, largest, str(dev))
    vertex_gradient_check(state, cfg, tensors, *vertex_trained["draws"])
    print(f"  naive training phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "cfg": cfg}


GRAPH_STEPS = 10            # steps a call in the graph training phase
GRAPH_TRAIN_STEPS = 30      # steps of each trainer run there (3 calls)
# the kernels' names in a profile, counted a step: K2's pass B runs once a launch
GRAPH_KERNELS = {"K1": "facet_conv_fwd_kernel", "K2": "transpose_sum_kernel",
                 "K3": "weighted_aggregate_kernel", "solver": "ms_solver_naive_kernel",
                 "adjoint": "ms_solver_adjoint_kernel"}
# K1, K2, K3, the scale kernel and its adjoint a step of each trainer
PER_STEP = {"default": {"K1": 8, "K2": 8, "K3": 0, "solver": 0, "adjoint": 0},
            "rotation-invariant": {"K1": 7, "K2": 7, "K3": 1, "solver": 0, "adjoint": 0},
            "vertex": {"K1": 8, "K2": 8, "K3": 0, "solver": 0, "adjoint": 0},
            "vertex naive": {"K1": 8, "K2": 8, "K3": 0, "solver": 3, "adjoint": 3}}


GRAPH_PROFILES = 3           # profiled calls a step's launch count is read from


def warm_profile(fn):
    """Device activities of one call of ``fn``, profiled with its tracing
    started one call earlier (a warm-up call whose activities are dropped)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return device_events(prof)


def profiled_launches(fn, steps):
    """Launches a step of each kernel of GRAPH_KERNELS in GRAPH_PROFILES
    warm profiles of ``fn`` (``steps`` steps a call); returns (launches,
    profiles, launches each profile saw). The profiler can drop a call's
    device activities (the same call's count varies by a few; once 8 of a
    2-step call's 16 K1 launches went missing) but never adds one. So each
    kernel's launches is the most that any profile saw: a kernel launched
    more or fewer times than its callers want fails in every profile."""
    profiles = [warm_profile(fn) for _ in range(GRAPH_PROFILES)]
    seen = [{k: sum(kernel in name for name, _ in events) / steps
             for k, kernel in GRAPH_KERNELS.items()} for events in profiles]
    return {k: max(s[k] for s in seen) for k in GRAPH_KERNELS}, profiles, seen


def graph_vs_eager(label, scanned, graph_state, eager_state, eager_step, draw, per_step,
                   profile_steps):
    """One train step through its captured CUDA graph against the eager step:
    two calls of GRAPH_STEPS through ``scanned`` (the first captures, the
    second only replays, under torch's sync debug mode set to raise) against
    as many eager steps with the same draws and the same capturable Adam, bit
    for bit (losses, parameters, Adam state); then the step time through the
    graph (host clock over a call of GRAPH_STEPS, its draws and loss read
    included, / GRAPH_STEPS, median of 6 calls) beside the eager step's
    (median of 10 after 3, each ending in its loss on the host),
    GRAPH_PROFILES profiled calls of ``profile_steps`` (device busy share and
    activities a step from the fullest; launches a step of each kernel of
    GRAPH_KERNELS, the most any profile saw, which must equal ``per_step``)
    and one profiled eager step. Returns the printed numbers, and the
    graph's ``held_bytes``."""
    import torch

    from facet_graph_convolution_torch.training.trainer import _leaves

    calls = [draw(GRAPH_STEPS) for _ in range(2)]
    _, first = scanned(graph_state, calls[0])
    first = first.numpy()
    torch.cuda.set_sync_debug_mode("error")      # a synchronising op in the call raises
    try:
        _, second = scanned(graph_state, calls[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graph_losses = np.concatenate([first, second.numpy()])
    eager_losses = []
    for d in calls:
        for j in range(GRAPH_STEPS):
            eager_state, loss = eager_step(eager_state, d, j)
            eager_losses.append(float(loss))
    eager_losses = np.asarray(eager_losses, np.float32)
    worst = 0.0
    for p, q in zip(_leaves(graph_state.params), _leaves(eager_state.params)):
        sp, sq = graph_state.optimizer.state[p], eager_state.optimizer.state[q]
        for a, b in ((p, q), (sp["exp_avg"], sq["exp_avg"]), (sp["exp_avg_sq"], sq["exp_avg_sq"]),
                     (sp["step"], sq["step"])):
            worst = max(worst, float((a.detach() - b.detach()).abs().max()))
    if worst != 0.0 or not np.array_equal(graph_losses, eager_losses):
        raise AssertionError(f"{label}: {2 * GRAPH_STEPS} steps through the graph differ from "
                             f"the eager steps: losses {graph_losses} vs {eager_losses}, "
                             f"state max abs diff {worst}")
    print(f"  {label}: {2 * GRAPH_STEPS} steps through the graph (2 calls; the second's only "
          "host synchronisation its loss read) equal the eager steps bit for bit; capture "
          f"{scanned.capture_s:.3f} s, graph memory {scanned.graph_bytes / 2**20:.1f} MiB")

    per_call = []
    for _ in range(6):
        t0 = time.perf_counter()
        _, losses = scanned(graph_state, draw(GRAPH_STEPS))
        losses.numpy()
        per_call.append(1e3 * (time.perf_counter() - t0) / GRAPH_STEPS)
    per_call.sort()
    eager_ms = []
    for i in range(13):
        t0 = time.perf_counter()
        eager_state, loss = eager_step(eager_state, None, 0)
        float(loss)
        if i >= 3:
            eager_ms.append(1e3 * (time.perf_counter() - t0))
    eager_ms.sort()

    def one_call():
        scanned(graph_state, draw(profile_steps))[1].numpy()

    one_call()
    t0 = time.perf_counter()
    one_call()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    launches, profiles, seen = profiled_launches(one_call, profile_steps)
    if launches != per_step:
        raise AssertionError(f"{label}: kernel launches a step through the graph {launches} "
                             f"(the most of {GRAPH_PROFILES} profiles: {seen}), want {per_step}")
    events = max(profiles, key=len)
    busy_ms = sum(us for _, us in events) / 1e3
    graph_median = per_call[len(per_call) // 2]
    print(f"  {label}: step through the graph median {graph_median:.3f} ms (min "
          f"{per_call[0]:.3f}, max {per_call[-1]:.3f}; a call of {GRAPH_STEPS}, 6 calls), eager "
          f"median {eager_ms[len(eager_ms) // 2]:.3f} ms (min {eager_ms[0]:.3f}, max "
          f"{eager_ms[-1]:.3f}; 10 steps)")
    print(f"  {label}: one profiled call of {profile_steps} steps through the graph: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of "
          f"the unprofiled wall time), {len(events)} device activities "
          f"({len(events) / profile_steps:.1f} a step; the fullest of {GRAPH_PROFILES} "
          f"profiles, which saw {[len(e) for e in profiles]}); launches a step {launches}")
    eager_wall, eager_busy, eager_n = device_profile(
        lambda: float(eager_step(eager_state, None, 0)[1]), f"{label}: one eager step")
    return {"graph_ms": graph_median, "eager_ms": eager_ms[len(eager_ms) // 2],
            "graph_busy_share": busy_ms / wall_ms, "graph_activities": len(events) / profile_steps,
            "eager_busy_share": eager_busy / eager_wall, "eager_activities": eager_n,
            "capture_s": scanned.capture_s, "graph_mib": scanned.graph_bytes / 2**20,
            "held_bytes": scanned.held_bytes}


def normals_graph_vs_eager(dev, trained, label, cfg):
    """:func:`graph_vs_eager` of the normals step of ``cfg`` on the whole
    subdivision-5 icosphere (``trained["bench_patch"]``), 10 steps a call;
    ``label`` names its launches a step in PER_STEP."""
    import torch

    from facet_graph_convolution_torch.training.trainer import (
        create_train_state,
        make_normals_train_step,
        make_scanned_train_step,
        normals_draws,
        stack_patch_tensors,
    )

    patch = trained["bench_patch"]
    graph_state = create_train_state(cfg, num_steps=100, device=str(dev))
    eager_state = create_train_state(cfg, num_steps=100, device=str(dev))
    scanned = make_scanned_train_step(graph_state, cfg, stack_patch_tensors([patch], str(dev)),
                                      GRAPH_STEPS)
    gen = torch.Generator().manual_seed(11)
    step = make_normals_train_step(cfg)
    tensors = trained["bench_tensors"]

    def eager(state, d, j):
        if d is None:
            return step(state, *tensors)
        return step(state, *tensors, rot=d["rot"][j], sample_idx=d["sample_idx"][j])

    return graph_vs_eager(
        f"{label} step ({cfg.model.compute_dtype}), {patch.num_nodes}-node patch", scanned,
        graph_state, eager_state, eager,
        lambda n: normals_draws(cfg, gen, [0] * n, patch.num_nodes),
        PER_STEP[label], GRAPH_STEPS)


def graph_training_phase(dev, trained, vertex_trained, naive_cfg):
    """Training with steps_per_call > 1 at full width: ``train_normals``
    (default and rotation-invariant) and ``train_with_vertices`` (operator
    and naive solver) at ``steps_per_call=GRAPH_STEPS`` for
    GRAPH_TRAIN_STEPS steps on the training phases' sets, each call
    replaying a captured CUDA graph a step; finite losses, the updates
    counted, and K1/K2/K3 and the scale kernel and its adjoint counted by
    their wrappers at the warm-up step and the capture only (replays launch
    from the graph). Then, for each step, the graph against the eager step
    (:func:`graph_vs_eager`) on the whole subdivision-5 icosphere (normals)
    and the largest vertex patch, and ``cli.train`` on the card with its
    default ``--steps_per_call`` (100). Returns the results by step."""
    import torch

    from facet_graph_convolution_torch.cli import train as cli_train
    from facet_graph_convolution_torch.ops import aggregate as k3
    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
    from facet_graph_convolution_torch.ops import ms_solver_kernel as ms
    from facet_graph_convolution_torch.training.checkpoint import CheckpointManager
    from facet_graph_convolution_torch.training.trainer import (
        create_train_state,
        make_vertex_train_step,
        train_normals,
        train_with_vertices,
        vertex_patch_tensors,
    )

    t_phase = time.perf_counter()
    counters = {"K1": k1.facet_conv_fwd, "K2": k1.facet_conv_bwd, "K3": k3.weighted_aggregate,
                "solver": ms.naive_scale, "adjoint": ms.naive_scale_backward}
    vcfg = vertex_trained["cfg"]
    runs = (
        ("default", trained["cfg"], trained["train_set"], train_normals),
        ("rotation-invariant", trained["cfg"].replace(model={"rotation_invariance": True}),
         trained["train_set"], train_normals),
        ("vertex", vcfg, vertex_trained["train_set"], train_with_vertices),
        ("vertex naive", naive_cfg, vertex_trained["train_set"], train_with_vertices),
    )
    print(f"graph training phase: {GRAPH_TRAIN_STEPS} steps at steps_per_call={GRAPH_STEPS}, "
          "full width, a CUDA graph replayed a step")
    for label, cfg, train_set, train in runs:
        per_step = PER_STEP[label]
        cfg = cfg.replace(train={"net_name": f"graph_{label.replace(' ', '_')}",
                                 "save_every": GRAPH_TRAIN_STEPS})
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        state, hist = train(cfg, train_set, num_iterations=GRAPH_TRAIN_STEPS,
                            steps_per_call=GRAPH_STEPS, device=str(dev))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        # one graph (the normals stack) or one a pinned patch (vertex); each
        # counted its kernels at its warm-up step and its capture
        rng = np.random.default_rng(cfg.train.seed)
        graphs = 1 if train is train_normals else len(
            {int(rng.integers(len(train_set.patches))) for _ in range(3)})
        want = {k: 2 * graphs * n for k, n in per_step.items()}
        losses = hist[:, 0]
        if hist.shape != (GRAPH_TRAIN_STEPS // GRAPH_STEPS, 2) or not np.isfinite(losses).all():
            raise AssertionError(f"graph training, {label}: bad loss history {hist}")
        if state.step != GRAPH_TRAIN_STEPS or launches != want:
            raise AssertionError(f"graph training, {label}: {state.step} updates; wrapper "
                                 f"launches {launches}, want {want} ({graphs} graphs)")
        saved = CheckpointManager(cfg.train.network_path, cfg.train.net_name).steps()
        if saved != [GRAPH_TRAIN_STEPS]:
            raise AssertionError(f"graph training, {label}: checkpoints {saved}")
        print(f"  {label}: {GRAPH_TRAIN_STEPS} steps in {train_s:.2f} s ({graphs} graph(s) "
              f"captured; tables and checkpoint included): chunk losses "
              f"{np.array2string(losses, precision=3)}; wrapper launches {launches} (warm-up "
              f"and capture); saved step {saved}")

    results = {}
    cfg = trained["cfg"]
    for label, model in (("default", {}), ("rotation-invariant", {"rotation_invariance": True})):
        results[label] = normals_graph_vs_eager(dev, trained, label, cfg.replace(model=model))

    params = vertex_trained["params"]
    for label, c in (("vertex", vcfg), ("vertex naive", naive_cfg)):
        tensors = vertex_trained["tensors"] if label == "vertex" else vertex_patch_tensors(
            c, vertex_trained["largest"], str(dev))
        graph_state = create_train_state(c, num_steps=100, device=str(dev), params=params,
                                         multi_scale=True)
        eager_state = create_train_state(c, num_steps=100, device=str(dev), params=params,
                                         multi_scale=True)
        step = make_vertex_train_step(c, generator=torch.Generator().manual_seed(12))

        def vertex_eager(state, d, j, step=step, tensors=tensors):
            if d is None:
                return step(state, tensors)
            return step(state, tensors, d["rot"][j], d["idx0"][j], d["idx1"][j])

        results[label] = graph_vs_eager(
            f"{label} step, {tensors.x.shape[0]}-face patch",
            step.scanned(graph_state, tensors, GRAPH_STEPS), graph_state, eager_state,
            vertex_eager, lambda n, step=step, tensors=tensors: step.draw(tensors, n),
            PER_STEP[label], 2)

    # cli.train on the card with its default --steps_per_call (100): a full
    # call and a remainder of 50, a CSV row each
    net = os.path.join(cfg.data.base_path, "NetworksCli")
    t0 = time.perf_counter()
    cli_train.main(["--base_path", cfg.data.base_path, "--network_path", net, "--net_name", "cli",
                    "--num_iterations", "150"])
    cli_s = time.perf_counter() - t0
    rows = np.loadtxt(os.path.join(net, "cli.csv"), delimiter=",", ndmin=2)
    saved = CheckpointManager(net, "cli").steps()
    if saved != [150] or rows.shape != (2, 2) or not np.isfinite(rows[:, 0]).all():
        raise AssertionError(f"cli.train on the card: checkpoints {saved}, history {rows}")
    print(f"  cli.train, default --steps_per_call (100), 150 steps: {cli_s:.2f} s, losses "
          f"{np.array2string(rows[:, 0], precision=3)}, saved step {saved}")
    print("  graph vs eager (ms a step; device busy share; device activities a step; capture "
          "s; graph MiB):")
    for label, r in results.items():
        print(f"    {label}: graph {r['graph_ms']:.3f} vs eager {r['eager_ms']:.3f}; busy "
              f"{100 * r['graph_busy_share']:.1f}% vs {100 * r['eager_busy_share']:.1f}%; "
              f"activities {r['graph_activities']:.1f} vs {r['eager_activities']}; capture "
              f"{r['capture_s']:.3f}; {r['graph_mib']:.1f}")
    print(f"  graph training phase: {time.perf_counter() - t_phase:.1f} s")
    return results


STREAM_SHARD = 2             # patches a streaming shard (cli.preprocess --shard_size)
STREAM_COPIES = 4            # noisy copies of each training shape in the streaming tree
# cli.train's history has a row every eval_every (50) steps: 150 windowed
# steps (15 windows of GRAPH_STEPS) give 3 rows and 100 eager steps 2, so
# that the losses can be seen to fall
STREAM_STEPS = 150
STREAM_EAGER_STEPS = 100
# the profiled windowed run past the memo: the 16 patches 5 times over (80,
# more than trainer.MAX_PREPARED), 160 steps, 8 windows in the first epoch
# and 8 after it
STREAM_PAST_COPIES = 5
STREAM_PAST_STEPS = 160
ALLOCATOR_SLACK = 2**20      # the allocator's rounding of a window's uploads (512 B a tensor)


class Tee:
    """A stream that writes to two."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)

    def flush(self):
        for s in self.streams:
            s.flush()


def intervals_overlap_us(spans, others):
    """µs of ``spans`` that lie inside the union of ``others`` (both lists
    of (start, end) µs)."""
    import bisect

    merged = []
    for start, end in sorted(others):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    starts = [m[0] for m in merged]
    total = 0.0
    for start, end in spans:
        i = max(bisect.bisect_right(starts, start) - 1, 0)
        while i < len(merged) and merged[i][0] < end:
            total += max(0.0, min(end, merged[i][1]) - max(start, merged[i][0]))
            i += 1
    return total


def streaming_phase(dev, workdir, trained, graphs):
    """Streaming training on the card through the CLIs (``data/stream.py``,
    ``training/trainer.py::train_normals_streaming``): the training phase's
    OBJ tree plus more noisy copies → ``cli.preprocess --shard_size 2`` →
    ``cli.train --stream_dir`` at ``--steps_per_call`` GRAPH_STEPS and 1, at
    full width (the CLI's default config). Checks finite, falling losses,
    K1/K2 launched by their wrappers 8 times a step eagerly and 8 at each
    warm-up step and capture of the windowed run (captures = 1 + width
    growths), the plain versions never, the written params.pt serving a
    request; one window of the shards through the graph against eager steps
    bit for bit (:func:`graph_vs_eager`, with K1/K2 8 a step in profiles);
    prints the streaming step's ms beside the in-memory graph and eager
    steps, the loader wait, host preparation, the uploads and, from a
    profiled run, how much of their time overlaps kernels."""
    import contextlib
    import io
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from facet_graph_convolution_torch.cli import preprocess as cli_preprocess
    from facet_graph_convolution_torch.cli import train as cli_train
    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.data.dataset import InferenceMesh, bucket_size, pad_patch_to
    from facet_graph_convolution_torch.data.stream import ShardedDataset
    from facet_graph_convolution_torch.data.synthetic import add_vertex_noise
    from facet_graph_convolution_torch.geometry.obj_io import load_obj, write_obj
    from facet_graph_convolution_torch.inference.driver import infer_normals
    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
    from facet_graph_convolution_torch.training import trainer
    from facet_graph_convolution_torch.training.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    src = trained["cfg"].data
    base = os.path.join(workdir, "stream_run")
    cfg = default_config(base)
    os.makedirs(cfg.data.training_data_path)
    os.makedirs(cfg.data.gt_data_path)
    rng = np.random.default_rng(16)
    for name in sorted(os.listdir(src.gt_data_path)):
        v, f, _ = load_obj(os.path.join(src.gt_data_path, name))
        write_obj(v, f, os.path.join(cfg.data.gt_data_path, name))
        stem = name[:-len(".obj")]
        shutil.copyfile(os.path.join(src.training_data_path, stem + "_n1.obj"),
                        os.path.join(cfg.data.training_data_path, stem + "_n1.obj"))
        for copy in range(2, STREAM_COPIES + 1):
            write_obj(add_vertex_noise(v, f, 0.2, rng), f,
                      os.path.join(cfg.data.training_data_path, f"{stem}_n{copy}.obj"))
    t0 = time.perf_counter()
    cli_preprocess.main(["--base_path", base, "--shard_size", str(STREAM_SHARD)])
    shards = os.path.join(cfg.data.binary_dump_path, "trainingShards")
    ds = ShardedDataset(shards)
    if len(ds) < 8 or len(ds.index["shards"]) < 4:
        raise AssertionError(f"streaming: {len(ds)} patches in {len(ds.index['shards'])} shards")
    print(f"streaming phase: cli.preprocess --shard_size {STREAM_SHARD}: {len(ds)} patches in "
          f"{len(ds.index['shards'])} shards (largest {ds.max_num_nodes} nodes) in "
          f"{time.perf_counter() - t0:.2f} s")

    plain = {"fwd": 0, "bwd": 0}
    swaps = {"fwd": ("facet_conv_fwd_plain", k1.facet_conv_fwd_plain),
             "bwd": ("facet_conv_bwd_plain", k1.facet_conv_bwd_plain)}

    def counting(key, fn):
        def wrapped(*args):
            plain[key] += 1
            return fn(*args)
        return wrapped

    def run_cli(label, net, steps, steps_per_call, shard_dir=shards):
        """cli.train --stream_dir in this process; returns (summary, CSV
        rows, wrapper launches, seconds)."""
        k1.facet_conv_fwd.launches = k1.facet_conv_bwd.launches = 0
        plain.update(fwd=0, bwd=0)
        for key, (attr, fn) in swaps.items():
            setattr(k1, attr, counting(key, fn))
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(Tee(out, sys.stdout)):
                cli_train.main(["--base_path", base, "--network_path", net, "--net_name",
                                "stream", "--stream_dir", shard_dir, "--steps_per_call",
                                str(steps_per_call), "--num_iterations", str(steps),
                                "--device", str(dev)])
                torch.cuda.synchronize()
        finally:
            for attr, fn in swaps.values():
                setattr(k1, attr, fn)
        seconds = time.perf_counter() - t0
        line = [x for x in out.getvalue().splitlines() if x.startswith("streaming summary: ")]
        summary = json.loads(line[-1].split(": ", 1)[1])
        # a row each eval_every steps
        rows = np.loadtxt(os.path.join(net, "stream.csv"), delimiter=",", ndmin=2) if (
            steps >= cfg.train.eval_every) else np.zeros((0, 2))
        launches = {"fwd": k1.facet_conv_fwd.launches, "bwd": k1.facet_conv_bwd.launches}
        saved = CheckpointManager(net, "stream").steps()
        if saved != [steps] or not np.isfinite(rows[:, 0]).all() or rows.shape != (
                steps // cfg.train.eval_every, 2):
            raise AssertionError(f"streaming, {label}: checkpoints {saved}, history {rows}")
        if plain != {"fwd": 0, "bwd": 0}:
            raise AssertionError(f"streaming, {label}: the plain K1/K2 ran {plain}")
        return summary, rows, launches, seconds

    windowed_net = os.path.join(base, "NetworksWindowed")
    win, rows, win_launches, win_s = run_cli("windowed", windowed_net, STREAM_STEPS, GRAPH_STEPS)
    if win["captures"] != 1 + win["growths"] or win_launches != {
            "fwd": 16 * win["captures"], "bwd": 16 * win["captures"]}:
        raise AssertionError(f"streaming, windowed: {win['captures']} captures, "
                             f"{win['growths']} growths, wrapper launches {win_launches}")
    if not rows[-1, 0] < rows[0, 0]:
        raise AssertionError(f"streaming, windowed: the loss did not fall: {rows[:, 0]}")
    print(f"  cli.train --stream_dir, steps_per_call {GRAPH_STEPS}, {STREAM_STEPS} steps: "
          f"{win_s:.2f} s, losses {np.array2string(rows[:, 0], precision=3)}; {win['growths']} "
          f"width growths, {win['captures']} captures; wrapper launches {win_launches} (warm-up "
          "steps and captures), plain K1/K2 none")
    eager, rows, eager_launches, eager_s = run_cli(
        "eager", os.path.join(base, "NetworksEager"), STREAM_EAGER_STEPS, 1)
    want = {"fwd": 8 * STREAM_EAGER_STEPS, "bwd": 8 * STREAM_EAGER_STEPS}
    if eager_launches != want or not rows[-1, 0] < rows[0, 0]:
        raise AssertionError(f"streaming, eager: wrapper launches {eager_launches} (want {want}), "
                             f"losses {rows[:, 0]}")
    print(f"  cli.train --stream_dir, steps_per_call 1, {STREAM_EAGER_STEPS} steps: {eager_s:.2f} "
          f"s, losses {np.array2string(rows[:, 0], precision=3)}; wrapper launches "
          f"{eager_launches}, plain K1/K2 none")

    # the windowed run's params.pt serves a request
    v, f, _ = load_obj(os.path.join(cfg.data.gt_data_path, "chamfered_box.obj"))
    mesh = InferenceMesh(max_patch_size=cfg.data.max_patch_size,
                         coarsening_steps=cfg.model.coarsening_steps,
                         coarsening_levels=cfg.model.coarsening_levels,
                         k_faces=cfg.data.k_faces, max_edges=cfg.data.max_edges, seed=0)
    mesh.add_mesh(add_vertex_noise(v, f, 0.2, rng), f)
    serve_cfg = cfg.replace(train={"network_path": windowed_net, "net_name": "stream"})
    points, normals = infer_normals(mesh, serve_cfg, device=str(dev))
    if points.shape != v.shape or not (np.isfinite(points).all() and np.isfinite(normals).all()):
        raise AssertionError(f"streaming: serving the streamed net: bad output {points.shape}")
    print(f"  served chamfered_box ({f.shape[0]} faces) from {windowed_net}/stream/params.pt")

    # a profiled windowed run past the memo: the shards' patches
    # STREAM_PAST_COPIES times over (their shard files copied), more patches
    # than the trainer keeps prepared, in shards of 2 (2 held)
    t0 = time.perf_counter()
    past_shards = os.path.join(base, "pastShards")
    os.makedirs(past_shards)
    index = dict(ds.index, shards=[])
    for copy in range(STREAM_PAST_COPIES):
        for shard in ds.index["shards"]:
            name = f"copy{copy}_{shard['file']}"
            shutil.copyfile(os.path.join(shards, shard["file"]), os.path.join(past_shards, name))
            index["shards"].append(dict(shard, file=name))
    index["num_patches"] = STREAM_PAST_COPIES * len(ds)
    with open(os.path.join(past_shards, "index.json"), "w") as fh:
        json.dump(index, fh)
    if not len(ShardedDataset(past_shards)) > trainer.MAX_PREPARED:
        raise AssertionError(f"streaming past the memo: {index['num_patches']} patches")
    copy_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        past, _, past_launches, past_s = run_cli(
            "past the memo", os.path.join(base, "NetworksPast"), STREAM_PAST_STEPS, GRAPH_STEPS,
            past_shards)
    t0 = time.perf_counter()
    # the profiler's raw device activities (its FunctionEvent tree is not
    # needed here, and building it for ~90,000 kernels takes long)
    spans = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA
             and not e.is_user_annotation()]
    h2d = [(a, b) for name, a, b in spans if "HtoD" in name]
    kernels = [(a, b) for name, a, b in spans if not name.startswith(("Memcpy", "Memset"))]
    h2d_us = sum(b - a for a, b in h2d)
    overlap_us = intervals_overlap_us(h2d, kernels)
    read_s = time.perf_counter() - t0
    after = past["after"]
    held = after["allocated"] and after["allocated"][2] - after["allocated"][0]
    if (after["windows"] < 4 or after["h2d_windows"] == 0 or not h2d
            or past["captures"] != 1 + past["growths"]
            or past_launches != {"fwd": 16 * past["captures"], "bwd": 16 * past["captures"]}):
        raise AssertionError(f"streaming past the memo: {after['windows']} windows after the "
                             f"first epoch, {after['h2d_windows']} of them uploading, {len(h2d)} "
                             f"copies in the profile, {past['captures']} captures, "
                             f"{past['growths']} growths, wrapper launches {past_launches}")
    if held is None or held > past["h2d_bytes_max"] + ALLOCATOR_SLACK:
        raise AssertionError(f"streaming past the memo: device memory allocated at the windows "
                             f"after the first epoch (first, last, most) {after['allocated']}: "
                             f"grew more than a window's uploads ({past['h2d_bytes_max']} B)")
    print(f"  cli.train --stream_dir past the memo ({index['num_patches']} patches, the "
          f"shards' {len(ds)} {STREAM_PAST_COPIES} times over in shards of {STREAM_SHARD}, "
          f"more than the {trainer.MAX_PREPARED} kept; the shards copied in {copy_s:.2f} s; "
          f"profiled, its device activities read in {read_s:.2f} s), "
          f"steps_per_call {GRAPH_STEPS}, {STREAM_PAST_STEPS} steps: {past_s:.2f} s; a step "
          f"(median) {past['first_epoch']['step_ms']:.4f} ms in the first epoch, "
          f"{after['step_ms']:.4f} ms after it; {after['h2d_windows']} of the {after['windows']} windows after the first epoch "
          f"uploaded; device memory allocated at those windows (first, last, most) "
          f"{[round(b / 2**20, 1) for b in after['allocated']]} MiB, the most above the first "
          f"{held / 2**20:.1f} MiB against a window's uploads of at most "
          f"{past['h2d_bytes_max'] / 2**20:.1f} MiB; wrapper launches {past_launches}")
    print(f"  past the memo, profiled: {len(h2d)} host-to-device copies, {h2d_us / 1e3:.3f} ms, of "
          f"which {overlap_us / 1e3:.3f} ms ({100 * overlap_us / max(h2d_us, 1e-9):.1f}%) overlap "
          f"kernels ({len(kernels)} kernels)")

    # one window of the shards through the graph against eager steps
    target = bucket_size(ds.max_num_nodes, 1024)
    tensors = [trainer.patch_tensors(pad_patch_to(ds.patch(i), target), str(dev))
               for i in range(GRAPH_STEPS)]
    dims = tuple(tuple(max(w) for w in zip(*lvl))
                 for lvl in zip(*(trainer._slot_dims(t) for t in tensors)))
    tensors = [trainer._pad_to_dims(t, dims) for t in tensors]
    buffers = trainer.WindowBuffers(GRAPH_STEPS)
    buffers.load(tensors)
    graph_state = trainer.create_train_state(cfg, num_steps=100, device=str(dev))
    eager_state = trainer.create_train_state(cfg, num_steps=100, device=str(dev))
    window = trainer.make_scanned_train_step(graph_state, cfg, buffers, GRAPH_STEPS)
    gen = torch.Generator().manual_seed(13)
    step = trainer.make_normals_train_step(cfg)

    def eager_step(state, d, j):
        if d is None:
            return step(state, *tensors[0])
        t = tensors[int(d["idx"][j])]
        return step(state, *t, rot=d["rot"][j], sample_idx=d["sample_idx"][j])

    in_memory = graph_vs_eager(
        f"streaming window ({GRAPH_STEPS} patches of the shards at {target} nodes)", window,
        graph_state, eager_state, eager_step,
        lambda n: trainer.normals_draws(cfg, gen, [j % GRAPH_STEPS for j in range(n)], target),
        PER_STEP["default"], GRAPH_STEPS)

    # the in-memory window on the streaming loop's clock: each call's losses
    # read after the next call is enqueued, ms a step between call starts
    starts, pending = [], None
    for _ in range(8):
        starts.append(time.perf_counter())
        _, losses = window(graph_state, trainer.normals_draws(cfg, gen, range(GRAPH_STEPS),
                                                              target))
        if pending is not None:
            pending.numpy()
        pending = losses
    pending.numpy()
    starts.append(time.perf_counter())
    loop_ms = sorted(1e3 * (b - a) / GRAPH_STEPS for a, b in zip(starts[1:-1], starts[2:]))
    in_memory["loop_ms"] = loop_ms[len(loop_ms) // 2]

    def fmt(x, unit=""):
        return "n/a" if x is None else f"{x:.4f}{unit}"

    print(f"  streaming step through the graph, median of the windows after the first epoch: "
          f"{fmt(win['after']['step_ms'])} ms ({win['after']['windows']} windows; the first "
          f"epoch's {fmt(win['first_epoch']['step_ms'])} ms over {win['first_epoch']['windows']}) "
          f"vs the in-memory graph step over the same window buffers on the same clock (each "
          f"call's losses read after the next call is enqueued, median of 7) "
          f"{in_memory['loop_ms']:.4f} ms, waiting for each call {in_memory['graph_ms']:.4f} "
          f"ms, and the default graph step of the graph phase (whole subdivision-5 icosphere) "
          f"{graphs['default']['graph_ms']:.4f} ms")
    print(f"  eager streaming step after the first epoch {fmt(eager['after']['step_ms'])} ms "
          f"(first epoch {fmt(eager['first_epoch']['step_ms'])}) vs the in-memory eager step "
          f"{in_memory['eager_ms']:.4f} ms (patch 0 of the window, at the dataset's bucket)")
    for label, r in (("windowed", win), ("eager", eager), ("past the memo", past)):
        print(f"  {label}: the consumer's wait on the loader a window: first epoch "
              f"{fmt(r['first_epoch']['loader_wait_s'], ' s')}, after "
              f"{fmt(r['after']['loader_wait_s'], ' s')}; host preparation "
              f"{fmt(r['prepare_s_per_patch'], ' s')} a new patch ({r['patches_prepared']} "
              f"patches); uploads {r['h2d_windows']} windows, "
              f"{fmt(r['h2d_bytes_per_window'] and r['h2d_bytes_per_window'] / 2**20, ' MiB')} "
              f"and {fmt(r['h2d_ms_per_window'], ' ms')} a window")
    print(f"  streaming phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": {k: win_launches[k] + eager_launches[k] + past_launches[k]
                         for k in ("fwd", "bwd")},
            "windowed": win, "eager": eager, "past": past, "in_memory": in_memory,
            "overlap_share": overlap_us / max(h2d_us, 1e-9)}


def solver_bound_ms(calls):
    """Least time for the scale kernel's work on this card, summed over a
    solve's launches: each input read once and x written once at the HBM
    rate, against the operations this data needs at the f32 rate (per
    iteration: a centroid of 9 ops a fine face, 4 ops a pooled value, 5 ops
    for t a node, 12 ops a real slot for the dot, n_w and the sum, 7 a
    vertex for λ and the move); the larger of the two."""
    import torch

    nbytes = ops = 0
    for x, faces, v_faces, fn, scale, steps, iters in calls:
        shift = steps * scale
        nbytes += 4 * (2 * x.numel() + faces.numel() + v_faces.numel() + fn.numel())
        f0 = faces.shape[0]
        pool = sum(4 * 3 * (f0 >> r) for r in range(1, shift + 1))
        slots = int(torch.count_nonzero(v_faces >= 0))
        ops += iters * (9 * f0 + pool + 5 * fn.shape[0] + 12 * slots + 7 * x.shape[0])
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def solver_kernel_phase(dev, records, cfg, params):
    """The scale kernel against its plain version at the three launches of
    the largest served patch's naive solve (their inputs as the path gave
    them); times per scale and per patch, the plain loop's, a grid
    barrier's, and the bound. Returns (worst error, per patch {ms, plain_ms,
    bound_ms}, bound kind)."""
    import torch

    from facet_graph_convolution_torch.inference.driver import forward_patch, solve_patch
    from facet_graph_convolution_torch.ops import ms_solver_kernel as ms

    largest = largest_patch(records)
    calls, kernel = [], ms.naive_scale

    def record(x, faces, v_faces, fn, scale, steps, iters, **kw):
        calls.append((x, faces, v_faces, fn, scale, steps, iters))
        return kernel(x, faces, v_faces, fn, scale, steps, iters, **kw)

    record.launches = 0             # the wrapper counts its launch on what stands in its name
    with torch.no_grad():
        heads = forward_patch(params, largest, cfg, dev, multi_scale=True)
        try:
            ms.naive_scale = record
            solve_patch(largest, cfg, heads, dev)
        finally:
            ms.naive_scale = kernel
    if len(calls) != 3:
        raise AssertionError(f"one naive solve called the scale kernel {len(calls)} times")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    full = ms.max_grid(dev)
    print(f"solver kernel phase: the scale kernel vs plain (atol {NAIVE_ATOL}), bitwise "
          f"repeatable and the same bits with the iterate store, at the {largest.num_nodes}-face "
          f"patch's solve "
          f"({largest.vertices.shape[0]} vertices, K = {largest.v_faces.shape[1]})")
    print(f"  device ms by CUDA-graph replay: ms at the default grid, ms_1/SM at {sms} blocks, "
          f"ms_full at full occupancy ({full} blocks); plain_ms the plain loop in PyTorch, "
          f"plain+K4 the same with the standalone K4 (the naive solver before this kernel)")
    print("  %-5s %6s %5s %5s %10s %9s %9s %9s %9s %9s %9s" % (
        "scale", "nodes", "iters", "grid", "max_err", "ms", "ms_1/SM", "ms_full", "plain_ms",
        "plain+K4", "bound_ms"))
    worst = 0.0
    totals = {"ms": 0.0, "ms_1/SM": 0.0, "ms_full": 0.0, "plain_ms": 0.0, "plain+K4": 0.0}
    with torch.no_grad():
        for x, faces, v_faces, fn, scale, steps, iters in calls:
            args = (x, faces, v_faces, fn, scale, steps, iters)
            out = ms.naive_scale(*args)
            again = ms.naive_scale(*args)
            # training's launch, which also stores the iterates
            stored, xs = ms._kernel_forward(x, faces, v_faces, fn, fn.shape[0], steps * scale,
                                            iters, None, True)
            ref = plain_solve(lambda: ms.naive_scale_plain(*args))
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            if not torch.equal(out, again):
                raise AssertionError(f"the scale kernel gave different bits at scale {scale}")
            if not (torch.equal(stored, out) and torch.equal(xs[-1], out)
                    and torch.equal(xs[0], x)):
                raise AssertionError(f"the scale kernel with its store gave other bits than "
                                     f"without at scale {scale}")
            if err > NAIVE_ATOL:
                raise AssertionError(f"the scale kernel differs from plain at scale {scale}: "
                                     f"{err}")
            worst = max(worst, err)
            grid = ms.default_grid(dev, x.shape[0], fn.shape[0], steps * scale)
            row = {"ms": cuda_ms(lambda: ms.naive_scale(*args), 20)[0],
                   "ms_1/SM": cuda_ms(lambda: ms.naive_scale(*args, grid=sms), 20)[0],
                   "ms_full": cuda_ms(lambda: ms.naive_scale(*args, grid=full), 20)[0],
                   "plain_ms": cuda_ms(lambda: plain_solve(lambda: ms.naive_scale_plain(*args)),
                                       2)[0],
                   "plain+K4": cuda_ms(lambda: ms.naive_scale_plain(*args), 2)[0]}
            for key in totals:
                totals[key] += row[key]
            b_ms = solver_bound_ms([args])[0]
            print("  %-5d %6d %5d %5d %10.3e %9.5f %9.5f %9.5f %9.5f %9.5f %9.6f" % (
                scale, fn.shape[0], iters, grid, err, row["ms"], row["ms_1/SM"],
                row["ms_full"], row["plain_ms"], row["plain+K4"], b_ms))
        b_ms, b_by = solver_bound_ms(calls)
        print("  %-5s %6s %5s %5s %10s %9.5f %9.5f %9.5f %9.5f %9.5f %9.6f %s" % (
            "patch", "", "", "", "", totals["ms"], totals["ms_1/SM"], totals["ms_full"],
            totals["plain_ms"], totals["plain+K4"], b_ms, b_by))
        # one grid barrier: a node of 16 faces on one vertex, 80 iterations
        # against 1 (158 barriers apart), at the largest grid of the solve
        grid = max(ms.default_grid(dev, c[0].shape[0], c[3].shape[0], c[5] * c[4])
                   for c in calls)
        tx = calls[0][0][:1].contiguous()
        tf = torch.zeros((16, 3), dtype=torch.int32, device=dev)
        tv = torch.full((1, 25), -1, dtype=torch.int32, device=dev)
        tv[0, 0] = 0
        tfn = calls[0][3][:1].contiguous()
        for g in sorted({1, grid, sms, full}):
            t80 = cuda_ms(lambda: ms.naive_scale(tx, tf, tv, tfn, 2, 2, 80, grid=g), 20)[0]
            t1 = cuda_ms(lambda: ms.naive_scale(tx, tf, tv, tfn, 2, 2, 1, grid=g), 20)[0]
            print(f"  one grid barrier at {g} blocks: {1e3 * (t80 - t1) / 158:.4f} us "
                  f"(a 1-iteration launch {1e3 * t1:.3f} us)")
    return worst, {k: totals[k] for k in ("ms", "plain_ms")} | {"bound_ms": b_ms}, b_by


def adjoint_bound_ms(calls):
    """Least time for the adjoint kernel's work on this card, summed over a
    solve's launches: the iterates it reads, each table, the normals and the
    cotangent read once and the two cotangents written once at the HBM
    rate, against the operations this data needs at the f32 rate (per
    iteration: the forward's centroids and pool, 5 ops for t a node; a real
    slot 28 in R-A for a, g t, the dot with x and the g n terms, and 12 in
    R-B; a pooled value's share 3 ops a round, 3 for the third a fine face,
    3 a corner; 9 a node and 6 a vertex to finish); the larger of the
    two."""
    import torch

    nbytes = ops = 0
    for xs, faces, v_faces, fn, scale, steps, maps in calls:
        iters, shift = xs.shape[0] - 1, steps * scale
        tables = [faces, v_faces, *maps]
        nbytes += 4 * (iters * xs.shape[1] * 3 + sum(t.numel() for t in tables)
                       + 2 * fn.numel() + 2 * xs.shape[1] * 3 + xs.shape[1])
        f0, nodes, verts = faces.shape[0], fn.shape[0], xs.shape[1]
        slots = int(torch.count_nonzero(v_faces >= 0))
        corners = int(torch.count_nonzero(faces >= 0))
        pool = sum(4 * 3 * (f0 >> r) for r in range(1, shift + 1))
        share = sum(3 * (f0 >> r) for r in range(0, shift))
        ops += iters * (9 * f0 + pool + 5 * nodes + 40 * slots + share + 3 * f0
                        + 3 * corners + 9 * nodes + 6 * verts)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def adjoint_kernel_phase(dev, vertex_trained, naive_cfg):
    """The scale kernel's adjoint against the plain adjoint at the three
    scales of the largest vertex patch's naive solve under autograd (the
    iterates, normals and cotangents the path gave it), in float32 and
    against the plain adjoint in float64 on the same iterates; bitwise
    repeatable; times per scale and per patch by CUDA-graph replay, the
    plain adjoint's, and the bound. Returns (worst error
    against the float32 plain adjoint, per patch {ms, plain_ms, bound_ms},
    bound kind)."""
    import torch

    from facet_graph_convolution_torch.models.unet import unet_apply
    from facet_graph_convolution_torch.ops import ms_solver_kernel as ms
    from facet_graph_convolution_torch.ops.normalization import normalize_tensor
    from facet_graph_convolution_torch.ops.vertex_update import update_positions_multiscale
    from facet_graph_convolution_torch.training.trainer import vertex_patch_tensors

    largest = vertex_trained["largest"]
    t = vertex_patch_tensors(naive_cfg, largest, str(dev))
    with torch.no_grad():
        heads = [normalize_tensor(h) for h in unet_apply(
            vertex_trained["params"], t.x, t.adjs, t.rows,
            coarsening_steps=naive_cfg.model.coarsening_steps, multi_scale=True)]
    # the path's calls: each scale's iterates and the cotangent of its result
    calls, adjoint = [], ms.naive_scale_backward

    def record(xs, faces, v_faces, fn, scale, steps, g_out, **kw):
        calls.append((xs, faces, v_faces, fn, scale, steps, g_out, kw))
        return adjoint(xs, faces, v_faces, fn, scale, steps, g_out, **kw)

    record.launches = 0             # the wrapper counts its launch on what stands in its name

    leaves = [h.clone().requires_grad_() for h in heads]
    out, _ = update_positions_multiscale(
        t.vertices, leaves, t.faces, t.v_faces, coarsening_steps=naive_cfg.model.coarsening_steps,
        iter_nums=naive_cfg.eval.ms_solver_iterations, maps=t.naive_maps)
    try:
        ms.naive_scale_backward = record
        out.backward(torch.randn_like(out))
    finally:
        ms.naive_scale_backward = adjoint
    if len(calls) != 3:
        raise AssertionError(f"one naive solve's backward called the adjoint {len(calls)} times")
    print(f"adjoint kernel phase: the scale kernel's adjoint vs the plain adjoint (atol "
          f"{ADJOINT_ATOL} scaled to max 1), bitwise repeatable, at the {largest.num_nodes}-face "
          f"patch's naive solve ({largest.vertices.shape[0]} vertices)")
    print("  device ms by CUDA-graph replay; err32 / err64: against the plain adjoint in float32 "
          "/ float64 on the same iterates (g x, g fn); plain32 err64: the float32 plain's own")
    print("  %-5s %6s %5s %5s %21s %21s %21s %9s %9s %9s" % (
        "scale", "nodes", "iters", "grid", "err32", "err64", "plain32 err64", "ms", "plain_ms",
        "bound_ms"))

    def err(a, b):
        return float(((a.double() - b.double()) / b.double().abs().max().clamp_min(1e-30))
                     .abs().max())

    worst, totals, bounds = 0.0, {"ms": 0.0, "plain_ms": 0.0}, []
    for xs, faces, v_faces, fn, scale, steps, g_out, kw in calls:
        fn = fn.detach()               # as saved for the backward: a leaf of the step
        args = (xs, faces, v_faces, fn, scale, steps, g_out)
        ours = ms.naive_scale_backward(*args, **kw)
        again = ms.naive_scale_backward(*args, **kw)
        plain = ms.naive_scale_backward_plain(*args)
        exact = ms.naive_scale_backward_plain(xs.double(), faces, v_faces, fn.double(), scale,
                                              steps, g_out.double())
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(ours, again)):
            raise AssertionError(f"the adjoint kernel gave different bits at scale {scale}")
        e32 = [err(a, b) for a, b in zip(ours, plain)]
        e64 = [err(a, b) for a, b in zip(ours, exact)]
        p64 = [err(a, b) for a, b in zip(plain, exact)]
        if max(e32) > ADJOINT_ATOL or max(e64) > ADJOINT_ATOL:
            raise AssertionError(f"the adjoint kernel differs from the plain adjoint at scale "
                                 f"{scale}: {e32} (float32), {e64} (float64)")
        worst = max(worst, *e32)
        row = {"ms": cuda_ms(lambda: ms.naive_scale_backward(*args, **kw), 20)[0],
               "plain_ms": cuda_ms(lambda: ms.naive_scale_backward_plain(*args), 2)[0]}
        for key in totals:
            totals[key] += row[key]
        bounds.append((xs, faces, v_faces, fn, scale, steps,
                       (*kw["face_slots"], *kw["corners"])))
        grid = ms.adjoint_grid(dev, xs.shape[1], fn.shape[0], steps * scale)
        print("  %-5d %6d %5d %5d %10.3e %10.3e %10.3e %10.3e %10.3e %10.3e %9.5f %9.5f %9.6f" % (
            scale, fn.shape[0], xs.shape[0] - 1, grid, *e32, *e64, *p64, row["ms"],
            row["plain_ms"], adjoint_bound_ms(bounds[-1:])[0]))
    b_ms, b_by = adjoint_bound_ms(bounds)
    print("  %-5s %6s %5s %5s %21s %21s %21s %9.5f %9.5f %9.6f %s" % (
        "patch", "", "", "", "", "", "", totals["ms"], totals["plain_ms"], b_ms, b_by))
    return worst, {"ms": totals["ms"], "plain_ms": totals["plain_ms"], "bound_ms": b_ms}, b_by


def budget_phase(dev, vertex_trained, naive_cfg, graph_bytes):
    """``train_with_vertices`` under the naive solver through the graph on
    the vertex training set with a cache budget of 1.5 graphs of the
    largest patch (``graph_bytes``, the graph training phase's), so that a
    new patch's graph evicts the one before: the captures and evictions,
    what the cache held at most, and the card's peak allocated and reserved
    memory against the eager run's on the same set plus the budget."""
    import torch

    from facet_graph_convolution_torch.training.graph_step import GraphCache
    from facet_graph_convolution_torch.training.trainer import train_with_vertices

    train_set = vertex_trained["train_set"]
    steps, per_call = 24, 2

    def run(name, **kw):
        cfg = naive_cfg.replace(train={"net_name": name, "save_every": 1000})
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
        train_with_vertices(cfg, train_set, num_iterations=steps, device=str(dev), **kw)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base[0],
                torch.cuda.max_memory_reserved() - base[1])

    eager = run("budget_eager")
    cache = GraphCache(budget_bytes=graph_bytes * 3 // 2)
    t0 = time.perf_counter()
    graphs = run("budget_graphs", steps_per_call=per_call, graph_cache=cache)
    run_s = time.perf_counter() - t0
    cache.observe()
    rng = np.random.default_rng(naive_cfg.train.seed)
    visited = len({int(rng.integers(len(train_set.patches))) for _ in range(steps // per_call)})
    limit = max(cache.budget_bytes, cache.peak_held)
    print(f"budget phase: {steps} naive vertex steps at {per_call} a call over "
          f"{len(train_set.patches)} patches ({visited} visited), cache budget "
          f"{cache.budget_bytes / 2**20:.1f} MiB (1.5 graphs of the largest patch): "
          f"{cache.captures} captures, {cache.evictions} evictions, at most "
          f"{cache.peak_held / 2**20:.1f} MiB held, {run_s:.2f} s")
    print(f"  peak memory growth, allocated / reserved: through the graphs "
          f"{graphs[0] / 2**20:.1f} / {graphs[1] / 2**20:.1f} MiB, eager {eager[0] / 2**20:.1f} / "
          f"{eager[1] / 2**20:.1f} MiB; limit eager + {limit / 2**20:.1f} MiB")
    if cache.evictions < 1 or cache.captures <= visited:
        raise AssertionError(f"budget phase: {cache.captures} captures and {cache.evictions} "
                             f"evictions for {visited} patches: the budget forced none")
    if graphs[0] > eager[0] + limit or graphs[1] > eager[1] + limit:
        raise AssertionError(f"budget phase: peak memory growth {graphs} past the eager run's "
                             f"{eager} plus {limit}")
    return {"captures": cache.captures, "evictions": cache.evictions}


def pool_bound_ms(x, out, steps):
    """Least time for K4's work on this card: x read once and out written
    once at the HBM rate, against its operations (per pairwise value: two
    zero tests, an add and a multiply) at the f32 rate; the larger."""
    nbytes = (x.numel() + out.numel()) * 4
    ops = sum(4 * (x.shape[0] >> r) * x.shape[1] for r in range(1, steps + 1))
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def pool_kernel_phase(dev, records, schedule):
    """K4 against its plain version, bit for bit; returns (worst error,
    per served patch {ms, plain_ms, bound_ms}, bound kind)."""
    import torch

    from facet_graph_convolution_torch.ops import tree_pool_kernel as k4
    from facet_graph_convolution_torch.ops.ms_solver_kernel import scale_centers
    from facet_graph_convolution_torch.ops.vertex_update import face_centers_pyramid

    largest = largest_patch(records)
    rng = np.random.default_rng(6)
    with torch.no_grad():
        centers = face_centers_pyramid(torch.as_tensor(largest.vertices, device=dev),
                                       torch.as_tensor(largest.faces, device=dev), 2, 1)[0]
    level1 = k4.tree_pool_ignore_zeros_plain(centers, 2).contiguous()
    big = rng.normal(size=(1 << 20, 3)).astype(np.float32)
    big[rng.random(1 << 20) < 0.1] = 0.0
    edge = rng.normal(size=(4096, 3)).astype(np.float32)
    edge[rng.random(4096) < 0.3] = 0.0               # zero rows
    edge[64:128] = 0.0                               # zero groups, at every steps
    edge[3] = -0.0                                   # -0.0 rows
    edge[9, 1] = -0.0
    edge[200] = (0.0, -0.0, 0.0)
    wide = rng.normal(size=(4096, 40)).astype(np.float32)
    wide[rng.random(4096) < 0.3] = 0.0
    wide[5] = -0.0
    cases = [("solver level 0→1", centers, 2, True), ("solver level 1→2", level1, 2, True),
             ("C=3, N=1,048,576", torch.as_tensor(big, device=dev), 2, True)]
    cases += [(f"edge rows, steps {s}", torch.as_tensor(edge, device=dev), s, False)
              for s in (1, 2, 3)]
    cases += [(f"C=40 edge rows, steps {s}", torch.as_tensor(wide, device=dev), s, False)
              for s in (1, 3)]
    print("pool kernel phase: K4 vs plain, bit for bit; largest served patch "
          f"{largest.num_nodes} faces")
    print("  %-22s %8s %3s %5s %10s %9s %9s %9s %9s %s" % (
        "case", "N", "C", "steps", "max_err", "ms", "wall_ms", "plain_ms", "bound_ms",
        "bound_by"))
    worst, timed = 0.0, []
    for label, x, steps, time_it in cases:
        out = k4.tree_pool_ignore_zeros(x, steps)
        torch.cuda.synchronize()
        ref = k4.tree_pool_ignore_zeros_plain(x, steps)
        err = float((out - ref).abs().max())
        if not (torch.equal(out, ref) and torch.equal(torch.signbit(out), torch.signbit(ref))):
            raise AssertionError(f"K4 differs from its plain version at {label}: {err}")
        worst = max(worst, err)
        ms = wall_ms = plain_ms = float("nan")
        if time_it:
            ms, wall_ms, _ = cuda_ms(lambda: k4.tree_pool_ignore_zeros(x, steps), 50)
            plain_ms, _, _ = cuda_ms(lambda: k4.tree_pool_ignore_zeros_plain(x, steps), 10)
        b_ms, b_by = pool_bound_ms(x, out, steps)
        timed.append((ms, plain_ms, b_ms, b_by))
        print("  %-22s %8d %3d %5d %10.3e %9.5f %9.5f %9.5f %9.6f %s" % (
            label, x.shape[0], x.shape[1], steps, err, ms, wall_ms, plain_ms, b_ms, b_by))
    # per served patch of the largest size: the coarse scale pools twice an
    # iteration, the mid scale once (iterations coarse first)
    per_patch = {key: (schedule[0] + schedule[1]) * timed[0][i] + schedule[0] * timed[1][i]
                 for i, key in enumerate(("ms", "plain_ms", "bound_ms"))}
    print("  per served patch (%d + %d launches): K4 %.5f ms, plain %.5f ms, bound %.6f ms" % (
        schedule[0] + schedule[1], schedule[0], per_patch["ms"], per_patch["plain_ms"],
        per_patch["bound_ms"]))
    kinds = {timed[0][3], timed[1][3]}

    # the scale kernel's phase A alone: its pool against the plain K4 of its
    # own level-0 centroids, bit for bit, at the largest patch's two levels
    x = torch.as_tensor(largest.vertices, device=dev)
    faces = torch.as_tensor(largest.faces, device=dev).to(torch.int32)
    level0 = scale_centers(x, faces, 0)
    torch.cuda.synchronize()
    c_err = float((level0 - centers).abs().max())
    if c_err > CENTROID_ATOL:
        raise AssertionError(f"the scale kernel's centroids differ from the plain gather-mean "
                             f"by {c_err}")
    print(f"  scale kernel, phase A alone: level-0 centroids vs the plain gather-mean "
          f"{c_err:.3e} (atol {CENTROID_ATOL})")
    for shift in (2, 4):
        out = scale_centers(x, faces, shift)
        ref = k4.tree_pool_ignore_zeros_plain(level0, shift)
        torch.cuda.synchronize()
        if not (torch.equal(out, ref) and torch.equal(torch.signbit(out), torch.signbit(ref))):
            raise AssertionError(f"the scale kernel's pool differs from the plain K4 at shift "
                                 f"{shift}: {float((out - ref).abs().max())}")
        print(f"  scale kernel, phase A alone: level {shift // 2} ({out.shape[0]} nodes, "
              f"{shift} rounds) vs plain K4 of its level 0: bit for bit")
    return worst, per_patch, ("bytes" if kinds == {"bytes"} else "operations")


PARITY_ATOL = 1e-5          # the capture's out0 against unet_apply on the same tables
WANG_STEPS = 250            # cli.wang: 2 calls of 100 and a last partial call of 50
WANG_NOISE = (("_n1", 0.1), ("_n2", 0.2))    # of the mean edge length


def parity_phase(dev, workdir):
    """The reference-checkpoint parity path at full width: ``init_unet``
    (seed 0, single- and multi-scale) through ``export_unet_to_tf`` and
    ``load_reference_unet`` onto the card, bit for bit; the single-scale
    one's ``capture_activations`` on the largest served patch (the
    subdivision-5 icosphere's first patch, as ``cli.parity`` takes it)
    through K1 and through the plain K1, per layer within FORWARD_ATOL; its
    out0 against ``unet_apply`` within PARITY_ATOL; K1's launches of one
    capture in profiles; then ``cli.parity --reference <the plain export>``
    as a subprocess, which must print PASS. Returns K1's wrapper launches."""
    import torch

    from facet_graph_convolution_torch.cli.parity import parity_patch
    from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere
    from facet_graph_convolution_torch.evaluation.parity import (
        capture_activations,
        compare_activations,
        export_activations,
    )
    from facet_graph_convolution_torch.evaluation.tf_checkpoint import (
        export_unet_to_tf,
        load_reference_unet,
    )
    from facet_graph_convolution_torch.geometry.obj_io import write_obj
    from facet_graph_convolution_torch.models.unet import graph_tensors, init_unet, unet_apply
    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1

    t_phase = time.perf_counter()
    root = os.path.join(workdir, "parity")
    print("parity phase: reference-format TF1 checkpoints, full width")
    for multi in (False, True):
        params = init_unet(seed=0, device=str(dev), multi_scale=multi)
        prefix = os.path.join(root, "multi" if multi else "single", "net-0")
        t0 = time.perf_counter()
        export_unet_to_tf(prefix, params)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, got_multi = load_reference_unet(prefix, device=str(dev))
        read_s = time.perf_counter() - t0
        if got_multi != multi or back.keys() != params.keys():
            raise AssertionError(f"checkpoint round trip: multi-scale {got_multi}, layers "
                                 f"{sorted(back)} vs {sorted(params)}")
        for layer in params:
            for name, t in params[layer].items():
                got = back[layer][name]
                if got.device != t.device or not torch.equal(got, t):
                    raise AssertionError(f"checkpoint round trip: {layer}/{name} differs")
        nbytes = sum(os.path.getsize(prefix + ext) for ext in (".index", ".data-00000-of-00001"))
        print(f"  {'multi' if multi else 'single'}-scale: {len(params)} layers, {nbytes} bytes; "
              f"write {write_s:.3f} s, read onto the card {read_s:.3f} s; bit for bit")
        if not multi:
            single_prefix, single = prefix, back

    mesh = os.path.join(root, "icosphere5_n2.obj")
    v, f = icosphere(5)
    write_obj(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f, mesh)
    patch = parity_patch(mesh)
    ours, plain = os.path.join(root, "k1.npz"), os.path.join(root, "plain.npz")
    k1.facet_conv_fwd.launches = 0
    t0 = time.perf_counter()
    acts = export_activations(ours, single, patch.inputs, patch.adjs, device=str(dev))
    export_s = time.perf_counter() - t0
    launches = k1.facet_conv_fwd.launches
    kernel = k1.facet_conv_fwd
    try:
        k1.facet_conv_fwd = k1.facet_conv_fwd_plain
        export_activations(plain, single, patch.inputs, patch.adjs, device=str(dev))
    finally:
        k1.facet_conv_fwd = kernel
    if launches != 8:
        raise AssertionError(f"the capture launched K1 {launches} times (want 8)")
    report = compare_activations(ours, plain, atol=FORWARD_ATOL)
    print(f"  capture of a {patch.num_nodes}-node patch through K1 ({export_s:.2f} s with its "
          f"npz) vs through the plain K1, max |Δ| a layer (atol {FORWARD_ATOL}):")
    for name, diff in report.items():
        print(f"    {name:10s} {diff:.3e}")
    adjs, rows = graph_tensors(patch.adjs, dev)
    with torch.no_grad():
        y = unet_apply(single, torch.as_tensor(patch.inputs, device=dev), adjs, rows)
    err = float(np.abs(acts["out0"] - y.cpu().numpy()).max())
    if err > PARITY_ATOL:
        raise AssertionError(f"the capture's out0 differs from unet_apply's by {err}")
    seen, _, _ = profiled_launches(
        lambda: capture_activations(single, patch.inputs, patch.adjs, device=str(dev)), 1)
    if seen["K1"] != 8 or seen["K2"] != 0:
        raise AssertionError(f"one capture launched {seen} in profiles (want K1 8, K2 0)")
    print(f"  out0 vs unet_apply on the same tables: max |Δ| {err:.3e} (atol {PARITY_ATOL}); "
          f"K1 launches a capture {launches} (wrapper), {seen['K1']:.0f} (the most of "
          f"{GRAPH_PROFILES} profiles)")

    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "facet_graph_convolution_torch.cli.parity", "--device", "cuda",
         "--checkpoint", single_prefix, "--mesh", mesh, "--out", os.path.join(root, "cli.npz"),
         "--reference", plain], capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines or json.loads(lines[-1]).get("parity") != "PASS":
        raise AssertionError(f"cli.parity failed ({out.returncode}): {out.stdout[-2000:]}"
                             f"{out.stderr[-2000:]}")
    print(f"  cli.parity --reference <plain export>: PASS, max |Δ| "
          f"{json.loads(lines[-1])['max_abs_diff']:.3e}, {time.perf_counter() - t0:.1f} s "
          f"(a new process)")
    print(f"  parity phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def wang_phase(dev, workdir):
    """``cli.wang --device cuda --num_iterations WANG_STEPS`` in-process on
    a synthetic Wang tree of the three request shapes (train/ and test/,
    each GT with its ``_n1`` and ``_n2`` noise): 2 full calls of 100 steps
    and a partial call through the step's CUDA graph, then serving and
    scoring the 6 test meshes. Checks the artifacts (6 CSV rows, angles
    finite in (0, 90)), finite falling chunk losses, the wrappers' launches
    (K1 and K2 8 at the warm-up step and 8 at the capture, K1 8 a served
    patch), the card's memory after the run back to where it was, and K1/K2
    launches a step through a graph on the run's training set and K1's of a
    served patch in profiles. Prints the stage seconds and, a noise level,
    the noisy input's mean angular error beside the denoised one's.
    Returns the wrappers' launches."""
    import torch

    from facet_graph_convolution_torch.cli import wang
    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.data.dataset import bucket_size, load_dataset, pad_patch_to
    from facet_graph_convolution_torch.data.synthetic import (
        add_vertex_noise,
        chamfered_box,
        icosphere,
        torus,
    )
    from facet_graph_convolution_torch.evaluation.metrics import angular_error_stats
    from facet_graph_convolution_torch.geometry.mesh_math import compute_face_normals
    from facet_graph_convolution_torch.geometry.obj_io import load_obj, write_obj
    from facet_graph_convolution_torch.inference.driver import _restore_params, forward_patch
    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
    from facet_graph_convolution_torch.training.trainer import (
        create_train_state,
        make_scanned_train_step,
        normals_draws,
        stack_patch_tensors,
    )

    t_phase = time.perf_counter()
    root, base = os.path.join(workdir, "wang_data"), os.path.join(workdir, "wang_run")
    rng = np.random.default_rng(5)
    shapes = {"icosphere5": icosphere(5), "torus": torus(nu=128, nv=64),
              "chamfered_box": chamfered_box(24)}
    noisy_err = {level: [] for level, _ in WANG_NOISE}
    for split in ("train", "test"):
        os.makedirs(os.path.join(root, split, "noisy"))
        os.makedirs(os.path.join(root, split, "original"))
        for name, (v, f) in shapes.items():
            write_obj(v, f, os.path.join(root, split, "original", name + ".obj"))
            for level, sigma in WANG_NOISE:
                path = os.path.join(root, split, "noisy", name + level + ".obj")
                write_obj(add_vertex_noise(v, f, sigma, rng), f, path)
                if split == "test":
                    noisy = load_obj(path)[0]
                    noisy_err[level].append(angular_error_stats(
                        compute_face_normals(noisy, f), compute_face_normals(v, f))[0])

    k1.facet_conv_fwd.launches = 0
    k1.facet_conv_bwd.launches = 0
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = wang.run(["--data_root", root, "--base_path", base, "--device", "cuda",
                    "--num_iterations", str(WANG_STEPS)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"fwd": k1.facet_conv_fwd.launches, "bwd": k1.facet_conv_bwd.launches}
    held = torch.cuda.memory_allocated() - mem0

    records = res["records"]
    patches = sum(r["patches"] for r in records)
    want = {"fwd": 16 + 8 * patches, "bwd": 16}
    if len(records) != 6 or launches != want:
        raise AssertionError(f"cli.wang served {len(records)} of 6 meshes; wrapper launches "
                             f"{launches}, want {want} ({patches} patches)")
    rows = open(os.path.join(base, "Results", "results_heat.csv")).read().strip().splitlines()
    angles = {r.split()[0]: float(r.split()[3]) for r in rows}
    if len(rows) != 6 or not all(np.isfinite(a) and 0.0 < a < 90.0 for a in angles.values()):
        raise AssertionError(f"cli.wang: bad results_heat.csv {rows}")
    hist = np.loadtxt(os.path.join(base, "Networks", "wang.csv"), delimiter=",", ndmin=2)
    losses = hist[:, 0]
    if hist.shape != (3, 2) or not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"cli.wang: chunk losses {losses} (want 3 finite, falling)")
    if held > 256 * 2**20:
        raise AssertionError(f"cli.wang left {held / 2**20:.1f} MiB allocated on the card")
    secs = res["seconds"]
    print(f"wang phase: cli.wang --device cuda --num_iterations {WANG_STEPS} in {wall_s:.2f} s: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))
    print(f"  chunk losses {np.array2string(losses, precision=3)} (calls of 100, 100, 50); "
          f"wrapper launches K1 {launches['fwd']}, K2 {launches['bwd']} ({patches} served "
          f"patches); {held / 2**20:.1f} MiB allocated on the card after the run than before")
    print("  mean angular error a noise level (degrees; 3 test meshes each): noisy input vs "
          f"denoised after {WANG_STEPS} steps")
    for level, _ in WANG_NOISE:
        denoised = [a for n, a in angles.items() if f"{level}_denoised" in n]
        print(f"    {level}: {np.mean(noisy_err[level]):.3f} vs {np.mean(denoised):.3f} "
              f"(denoised per mesh {[round(a, 3) for a in denoised]})")

    # launches a step through a graph of the run's training set, and a
    # served patch's, in profiles
    cfg = default_config(base + "/").replace(train={
        "network_path": os.path.join(base, "Networks") + "/", "net_name": "wang"})
    params = _restore_params(cfg, dev)
    train_set = load_dataset(os.path.join(base, "Preprocessed_Data", "trainingSet.npz"))
    padded = [pad_patch_to(p, bucket_size(p.num_nodes, 1024)) for p in train_set.patches]
    target = max(p.num_nodes for p in padded)
    state = create_train_state(cfg, num_steps=100, device=str(dev), params=params)
    scanned = make_scanned_train_step(
        state, cfg, stack_patch_tensors([pad_patch_to(p, target) for p in padded], str(dev)),
        GRAPH_STEPS)
    gen = torch.Generator().manual_seed(13)

    def one_call(steps=2):
        idxs = rng.integers(len(padded), size=steps)
        return scanned(state, normals_draws(cfg, gen, idxs, target))[1].numpy()

    one_call()
    step_seen, _, _ = profiled_launches(one_call, 2)
    del scanned, state
    largest = max((p for r in records for p in r["mesh"].patches), key=lambda p: p.num_nodes)
    with torch.no_grad():
        serve_seen, _, _ = profiled_launches(lambda: forward_patch(params, largest, cfg, dev), 1)
    if (step_seen["K1"], step_seen["K2"], serve_seen["K1"], serve_seen["K2"]) != (8, 8, 8, 0):
        raise AssertionError(f"launches in profiles: a graph step {step_seen}, a served patch "
                             f"{serve_seen} (want K1/K2 8/8 and 8/0)")
    print(f"  launches in profiles (the most of {GRAPH_PROFILES}): a step through the graph on "
          f"the run's {len(padded)} patches K1 {step_seen['K1']:.0f}, K2 "
          f"{step_seen['K2']:.0f}; a served {largest.num_nodes}-node patch K1 "
          f"{serve_seen['K1']:.0f}")
    print(f"  wang phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


HALO_TORUS = (1024, 512)     # torus(nu, nv): 2·nu·nv = 1,048,576 faces
HALO_STEPS = 20              # train_normals_sharded steps, f32 then bf16
HALO_TIMED = 10              # timed steps of the sharded step after 3 of warm-up
HALO_SHARDS = 4              # the kernel check's partition of the subdivision-5 patch
# the one-rank sharded step against the flat step on the same state and
# draws: the same kernels on the same tables, the sums reassociated only in
# the normalization's mean and the dense layers' products
HALO_PARITY_RTOL = 1e-5
HALO_SERVE_ATOL = 1e-4       # infer_normals_sharded against infer_normals (JAX's bar)
LEVEL0_CONVS = (("conv1", 6), ("upconv1", 64), ("dconv1", 64))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _extended_inputs(part, level, c_in, m, rng, dev, dtype):
    """Shard 0's halo-extended ``cat`` [N_src, C+M] at ``level``, gathered on
    the host from a random whole-graph ``cat`` (zeros in inactive slots),
    with its ``ux`` [n, M], ``c`` and a cotangent ``dz``."""
    import torch

    from facet_graph_convolution_torch.parallel.halo import extended_rows

    lvl = part.levels[level]
    ids = extended_rows(part, level, 0)
    full = rng.normal(size=(lvl.num_nodes, c_in + m)).astype(np.float32)
    cat = np.where(ids[:, None] >= 0, full[np.maximum(ids, 0)], 0.0).astype(np.float32)
    n = lvl.block

    def dev_t(a, dt=dtype):
        return torch.as_tensor(a, device=dev).to(dt)

    return (dev_t(cat), dev_t(rng.normal(size=(n, m)).astype(np.float32)),
            dev_t(rng.normal(size=(m,)).astype(np.float32), torch.float32),
            dev_t(rng.normal(size=(n, m * c_in)).astype(np.float32)))


def halo_kernel_checks(dev, patch):
    """K1 and K2 on halo-extended sources (N_src > N): shard 0 of a
    HALO_SHARDS-way partition of ``patch``, its cat gathered from the whole
    graph, at the 8 conv shapes, f32 (KERNEL_ATOL) and bf16
    (BF16_KERNEL_TOL), each bitwise repeatable; device times by CUDA-graph
    replay. Returns the worst errors."""
    import torch

    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
    from facet_graph_convolution_torch.parallel.halo import build_partition, partition_operands

    part = build_partition(patch.adjs, HALO_SHARDS)
    tables = partition_operands(part, 0, dev)
    rng = np.random.default_rng(17)
    m = 9
    worst = {"f32": 0.0, "bf16": 0.0}
    print(f"halo kernel checks: K1/K2 on shard 0 of a {HALO_SHARDS}-way partition of the "
          f"{patch.num_nodes}-node patch, halo rows gathered from the whole graph; f32 atol=rtol="
          f"{KERNEL_ATOL:g}, bf16 {BF16_KERNEL_TOL:g} × max|plain|; bitwise repeatable; "
          "device ms by CUDA-graph replay (20 calls)")
    print("  %-8s %6s %6s %4s %3s %9s %9s %9s %9s %9s %9s" % (
        "conv", "N", "N_src", "C", "K'", "K1_err", "K2_err", "K1_ms", "K2_ms", "bf16_K1",
        "bf16_K2"))
    for name, level, c_in in CONVS:
        t = tables[level]
        rows = t.mult_rows[:, :, 0].contiguous()
        row = []
        for dtype in (torch.float32, torch.bfloat16):
            cat, ux, c, dz = _extended_inputs(part, level, c_in, m, rng, dev, dtype)
            if cat.shape[0] <= ux.shape[0]:
                raise AssertionError(f"no halo rows at {name}: N_src {cat.shape[0]}")
            fargs = (cat, ux, t.adj_sm, rows, c)
            bargs = (cat, ux, t.adj_sm, t.adj_t_sm, rows, c, dz)
            label = f"{name} (halo, {dtype})"
            if dtype == torch.float32:
                e1 = fwd_check(k1, fargs, label)[1]
                e2 = bwd_check(k1, bargs, label)[2]
            else:
                z, again = k1.facet_conv_fwd(*fargs), k1.facet_conv_fwd(*fargs)
                g1, g2 = k1.facet_conv_bwd(*bargs), k1.facet_conv_bwd(*bargs)
                torch.cuda.synchronize()
                if not (torch.equal(z, again) and all(torch.equal(a, b) for a, b in zip(g1, g2))):
                    raise AssertionError(f"K1/K2 gave different bits on the same inputs at {label}")
                ref = k1.facet_conv_bwd_plain(*bargs)
                e1 = bf16_close(z, k1.facet_conv_fwd_plain(*fargs), "K1 z", label)
                e2 = max(bf16_close(g1[0], ref[0], "K2 dcat", label),
                         bf16_close(g1[1], ref[1], "K2 dux", label))
            worst["f32" if dtype == torch.float32 else "bf16"] = max(
                worst["f32" if dtype == torch.float32 else "bf16"], e1, e2)
            row.append((e1, e2, cuda_ms(lambda: k1.facet_conv_fwd(*fargs), 20)[0],
                        cuda_ms(lambda: k1.facet_conv_bwd(*bargs), 20)[0]))
        (e1, e2, f_ms, b_ms), (_, _, f16, b16) = row
        print("  %-8s %6d %6d %4d %3d %9.2e %9.2e %9.5f %9.5f %9.5f %9.5f" % (
            name, t.adj_sm.shape[1], t.adj_t_sm.shape[0], c_in, t.adj_sm.shape[0], e1, e2,
            f_ms, b_ms, f16, b16))
    return worst


def level0_row_ns(dev, adj_sm, adj_t_sm, rows, label):
    """K1 and K2 at the level-0 conv shapes (LEVEL0_CONVS, M = 9, f32) over
    the given tables, random inputs; device ms by CUDA-graph replay (5
    calls). Each beside its bound (:func:`bound_ms`, :func:`bwd_bound_ms`;
    for K2 also its two-pass floor, the bound plus :func:`dg_round_trip_ms`)
    from these inputs. Returns {conv: {"ns": (K1, K2) ns an output row,
    "share": (K1, K2) bound over ms, "floor_share": K2's floor over ms}}."""
    import torch

    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1

    rng = np.random.default_rng(23)
    n, m = adj_sm.shape[1], 9
    out = {}
    for name, c_in in LEVEL0_CONVS:
        def t(*shape):
            return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev)

        cat, ux, c, dz = t(adj_t_sm.shape[0], c_in + m), t(n, m), t(m), t(n, m * c_in)
        bargs = (cat, ux, adj_sm, adj_t_sm, rows, c, dz)
        f_ms = cuda_ms(lambda: k1.facet_conv_fwd(cat, ux, adj_sm, rows, c), 5)[0]
        b_ms = cuda_ms(lambda: k1.facet_conv_bwd(*bargs), 5)[0]
        z = k1.facet_conv_fwd(cat, ux, adj_sm, rows, c)
        f_bound = bound_ms(cat, ux, adj_sm, rows, c, z)[0]
        b_bound = bwd_bound_ms(bargs, *k1.facet_conv_bwd(*bargs))[0]
        floor = b_bound + dg_round_trip_ms(bargs)
        out[name] = {"ns": (1e6 * f_ms / n, 1e6 * b_ms / n),
                     "share": (f_bound / f_ms, b_bound / b_ms), "floor_share": floor / b_ms}
        del cat, ux, dz, bargs, z
    print(f"  level 0, {label} ({n} rows): ns an output row, bound / ms: " + ", ".join(
        f"{k}: K1 {r['ns'][0]:.4f} ns {r['share'][0]:.3f}, K2 {r['ns'][1]:.4f} ns "
        f"{r['share'][1]:.3f} (two-pass floor / ms {r['floor_share']:.3f})"
        for k, r in out.items()))
    return out


def halo_parity(dev, group, patch):
    """One sharded step at one rank against the flat ``make_normals_train_step``
    from the same state and draws: loss and every gradient within
    HALO_PARITY_RTOL relative."""
    import torch

    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.parallel.halo import (
        build_partition,
        make_sharded_train_step,
        sample_mask_from,
        shard_rows,
    )
    from facet_graph_convolution_torch.training.trainer import (
        _leaves,
        create_train_state,
        make_normals_train_step,
        patch_tensors,
    )

    cfg = default_config()
    rng = np.random.default_rng(29)
    idx = np.unique(rng.integers(0, patch.num_nodes, size=cfg.train.loss_samples))
    rot = torch.as_tensor(np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32))
    sharded = create_train_state(cfg, device=str(dev))
    flat = create_train_state(cfg, device=str(dev))
    step = make_sharded_train_step(cfg, build_partition(patch.adjs, 1), group)
    sharded, loss = step(sharded, shard_rows(patch.inputs, group),
                         shard_rows(patch.gt_normals, group),
                         sample_mask_from(idx, patch.num_nodes, group), rot=rot)
    flat, loss_ref = make_normals_train_step(cfg)(flat, *patch_tensors(patch, str(dev)), rot=rot,
                                                  sample_idx=torch.as_tensor(idx))
    loss, loss_ref = float(loss), float(loss_ref)
    worst = 0.0
    for a, b in zip(_leaves(sharded.params), _leaves(flat.params)):
        worst = max(worst, float((a.grad - b.grad).abs().max()) / (float(b.grad.abs().max())
                                                                    or 1.0))
    if abs(loss - loss_ref) > HALO_PARITY_RTOL * abs(loss_ref) or worst > HALO_PARITY_RTOL:
        raise AssertionError(f"one-rank sharded step differs from the flat step: loss {loss} vs "
                             f"{loss_ref}, gradient {worst} relative")
    print(f"  one-rank sharded step vs flat step on the {patch.num_nodes}-node patch: loss "
          f"{loss:.6f} vs {loss_ref:.6f}, gradients within {worst:.3e} of max|g| "
          f"(rtol {HALO_PARITY_RTOL:g})")


def _halo_run(cfg, patch, group, prepared, label, bf16):
    """``train_normals_sharded`` for HALO_STEPS steps, then HALO_TIMED timed
    steps of a step on ``prepared`` (the patch's partition and blocks) and
    its profiles; checks finite, falling losses,
    K1/K2 8 launches a step in the run's dtype only, no plain K1/K2, and 8
    K1 and K2 kernels in a profiled step. Returns its numbers."""
    import torch

    from facet_graph_convolution_torch.models.augment import random_rotation
    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
    from facet_graph_convolution_torch.parallel.halo import (
        make_sharded_train_step,
        sample_mask_from,
        train_normals_sharded,
    )

    plain_calls = []
    plains = {"facet_conv_fwd_plain": k1.facet_conv_fwd_plain,
              "facet_conv_bwd_plain": k1.facet_conv_bwd_plain}

    def counted(fn):
        def call(*a, **kw):
            plain_calls.append(fn.__name__)
            return fn(*a, **kw)
        return call

    for fn in (k1.facet_conv_fwd, k1.facet_conv_bwd):
        fn.launches = fn.launches_bf16 = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        for name, fn in plains.items():
            setattr(k1, name, counted(fn))
        t0 = time.perf_counter()
        state, losses = train_normals_sharded(cfg, patch, HALO_STEPS, group=group, log_every=5,
                                              seed=0)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        for name, fn in plains.items():
            setattr(k1, name, fn)
    counts = {k: (fn.launches, fn.launches_bf16)
              for k, fn in (("fwd", k1.facet_conv_fwd), ("bwd", k1.facet_conv_bwd))}
    want = (8 * HALO_STEPS, 8 * HALO_STEPS if bf16 else 0)
    peak = (torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved())
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses}")
    if counts != {"fwd": want, "bwd": want} or plain_calls:
        raise AssertionError(f"{label}: launches (all, bf16) {counts}, want {want} each; plain "
                             f"calls {plain_calls}")
    part, x, gt, n = prepared
    step = make_sharded_train_step(cfg, part, group)
    mask = sample_mask_from(np.random.default_rng(1).integers(0, n, cfg.train.loss_samples), n,
                            group)
    rot = random_rotation(torch.Generator().manual_seed(1))
    times = []
    for i in range(3 + HALO_TIMED):
        t0 = time.perf_counter()
        state, loss = step(state, x, gt, mask, rot=rot)
        float(loss)
        times.append(time.perf_counter() - t0)
    times = sorted(times[3:])
    # the most of GRAPH_PROFILES profiles: the profiler can drop an activity
    prof = profiled_launches(lambda: float(step(state, x, gt, mask, rot=rot)[1]), 1)[0]
    if (prof["K1"], prof["K2"]) != (8, 8):
        raise AssertionError(f"{label}: a profiled step shows K1/K2 kernels {prof} (want 8)")
    wall_ms, busy_ms, _ = device_profile(lambda: float(step(state, x, gt, mask, rot=rot)[1]),
                                         f"one {label} sharded step, {n} nodes")
    median = times[len(times) // 2]
    print(f"  {label}: {HALO_STEPS} steps of train_normals_sharded in {run_s:.2f} s, loss "
          f"{losses[0]:.4f} → {losses[-1]:.4f}; K1/K2 launches (all, bf16) {counts}, plain "
          f"none; profiled step: K1 {prof['K1']}, K2 {prof['K2']} kernels; step median "
          f"{1e3 * median:.3f} ms (min {1e3 * times[0]:.3f}, max {1e3 * times[-1]:.3f}) over "
          f"{HALO_TIMED}; peak allocated {peak[0] / 2**30:.3f} GiB, reserved "
          f"{peak[1] / 2**30:.3f} GiB")
    return {"median_s": median, "min_s": times[0], "max_s": times[-1], "peak": peak,
            "launches": counts, "busy_ms": busy_ms, "wall_ms": wall_ms,
            "losses": (float(losses[0]), float(losses[-1]))}


def halo_phase(dev, workdir, bench_patch):
    """The halo-sharded path (``parallel/``) on one card: a one-rank NCCL
    group; K1/K2 on halo-extended sources; the one-rank sharded step against
    the flat step; the 1,048,576-face torus trained whole (f32, then bf16)
    and served whole; the sharded serving against ``infer_normals`` on the
    subdivision-5 icosphere; the launcher in a subprocess. Returns the
    main path's K1/K2 launches and its numbers."""
    import torch

    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.data.dataset import InferenceMesh, TrainingSet, pad_patch_to
    from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere, torus
    from facet_graph_convolution_torch.inference.driver import infer_normals
    from facet_graph_convolution_torch.inference.sharded import infer_normals_sharded
    from facet_graph_convolution_torch.models.unet import init_unet, train_graph_tensors
    from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
    from facet_graph_convolution_torch.parallel import distributed
    from facet_graph_convolution_torch.parallel.halo import (
        _prepare_sharded_mesh_arrays,
        partition_operands,
    )
    from facet_graph_convolution_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    print("halo phase: the halo-sharded path at one rank (parallel/halo.py)")
    distributed.initialize(f"127.0.0.1:{_free_port()}", num_processes=1, process_id=0,
                           device="cuda")
    group = make_mesh(str(dev))
    if (group.size, group.backend) != (1, "nccl"):
        raise AssertionError(f"the one-rank group: size {group.size}, backend {group.backend}")
    out = {"launches": {"fwd": 0, "bwd": 0, "fwd_bf16": 0, "bwd_bf16": 0}}
    try:
        out["kernel_err"] = halo_kernel_checks(dev, bench_patch)
        halo_parity(dev, group, bench_patch)

        cfg = default_config()
        host = {}
        t0 = time.perf_counter()
        v, f = torus(nu=HALO_TORUS[0], nv=HALO_TORUS[1])
        noisy = add_vertex_noise(v, f, 0.2, np.random.default_rng(0))
        host["mesh"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds = TrainingSet(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3,
                         k_faces=23, seed=0)
        ds.add_mesh(noisy, f, gt_vertices=v)
        patch = ds.patches[0]
        host["dataset_build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        prepared = _prepare_sharded_mesh_arrays(cfg, patch, group)
        host["pad_partition_upload"] = time.perf_counter() - t0
        part = prepared[0]
        edges = count_edges(pad_patch_to(patch, part.fine.num_nodes))
        print(f"  torus {f.shape[0]} faces: padded nodes a level "
              f"{[lvl.num_nodes for lvl in part.levels]}, conv-edges a step {edges}; host s "
              + ", ".join(f"{k} {s:.2f}" for k, s in host.items()))
        runs = {}
        for label, bf16 in (("f32", False), ("bf16", True)):
            c = cfg.replace(model={"compute_dtype": "bfloat16"}) if bf16 else cfg
            r = runs[label] = _halo_run(c, patch, group, prepared, f"torus {label}", bf16)
            print(f"  torus {label}: {edges / r['median_s']:.4e} conv-edges/s")
            for key in ("fwd", "bwd"):
                a, b16 = r["launches"][key]
                out["launches"][key] += a - b16
                out["launches"][key + "_bf16"] += b16
        fine = partition_operands(part, 0, dev)[0]
        big = level0_row_ns(dev, fine.adj_sm, fine.adj_t_sm,
                            fine.mult_rows[:, :, 0].contiguous(), "torus level 0")
        del fine
        s_adjs, s_ts, s_rows = train_graph_tensors(phase_patch().adjs, dev)
        small = level0_row_ns(dev, s_adjs[0], s_ts[0], s_rows[0][:, :, 0].contiguous(),
                              "kernel phase level 0")
        ratios = {k: (big[k]["ns"][0] / small[k]["ns"][0], big[k]["ns"][1] / small[k]["ns"][1])
                  for k in big}
        print("  ns a row, torus level 0 over the kernel phase's level 0: " + ", ".join(
            f"{k}: K1 {a:.3f}x K2 {b:.3f}x" for k, (a, b) in ratios.items()))
        del prepared, part
        torch.cuda.empty_cache()

        # serving: the same torus whole, random full-width weights
        params = init_unet(seed=5, device=str(dev))
        t0 = time.perf_counter()
        mesh = InferenceMesh(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3,
                             k_faces=23, seed=0)
        mesh.add_mesh(noisy, f)
        build_s = time.perf_counter() - t0
        k1.facet_conv_fwd.launches = k1.facet_conv_fwd.launches_bf16 = 0
        t0 = time.perf_counter()
        pts, normals = infer_normals_sharded(mesh, cfg, params, group=group)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        served = k1.facet_conv_fwd.launches
        if (served != 8 or pts.shape != v.shape or normals.shape != (f.shape[0], 3)
                or not (np.isfinite(pts).all() and np.isfinite(normals).all())):
            raise AssertionError(f"serving the torus: K1 {served}, shapes {pts.shape} "
                                 f"{normals.shape}, finite {np.isfinite(pts).all()}")
        out["launches"]["fwd"] += served
        print(f"  served the torus whole: mesh build {build_s:.2f} s, infer_normals_sharded "
              f"{serve_s:.2f} s ({cfg.eval.solver_iterations} solver iterations), K1 {served}")
        del mesh, pts, normals

        v5, f5 = icosphere(5)
        mesh = InferenceMesh(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3,
                             k_faces=23, seed=0)
        mesh.add_mesh(add_vertex_noise(v5, f5, 0.2, np.random.default_rng(6)), f5)
        k1.facet_conv_fwd.launches = 0
        pts, normals = infer_normals_sharded(mesh, cfg, params, group=group)
        out["launches"]["fwd"] += k1.facet_conv_fwd.launches
        ref_pts, ref_normals = infer_normals(mesh, cfg, params, device=str(dev))
        e_n, e_p = float(np.abs(normals - ref_normals).max()), float(np.abs(pts - ref_pts).max())
        if e_n > HALO_SERVE_ATOL or e_p > HALO_SERVE_ATOL:
            raise AssertionError(f"sharded serving vs infer_normals: normals {e_n}, points {e_p}")
        print(f"  subdivision-5 icosphere, one patch: infer_normals_sharded vs infer_normals "
              f"normals {e_n:.2e}, points {e_p:.2e} (atol {HALO_SERVE_ATOL:g})")
        out.update(runs=runs, host=host, edges=edges, ratios=ratios, big=big, small=small)
    finally:
        distributed.shutdown()

    port = _free_port()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "facet_graph_convolution_torch.parallel.launch",
         "--num_processes", "1", "--process_id", "0", "--coordinator", f"127.0.0.1:{port}",
         "train", "--iterations", "40"], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the launcher exited {proc.returncode}: {proc.stderr[-2000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1]
    print(f"  launcher, 1 process over NCCL, 40 steps in {time.perf_counter() - t0:.1f} s: "
          f"{line}")
    print(f"  halo phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # fails outside the repo, before anything is printed
    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.ops import cuda_library

    t_start = time.perf_counter()
    card = card_line()
    print(card)

    from facet_graph_convolution_torch.graph import native

    t0 = time.perf_counter()
    host_lib = []
    gxx = threading.Thread(target=lambda: host_lib.append(native.available()))
    gxx.start()
    built = cuda_library.build()
    gxx.join()
    if host_lib != [True]:
        raise AssertionError("the C++ host library csrc/graphlib.cpp did not build or load")
    print(f"build: {built} and {os.path.basename(native.LIBRARY)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in built:
        with open(os.path.join(cuda_library.BUILD_DIR, name + ".log")) as fh:
            print(fh.read().strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    patch = phase_patch()
    err, totals, bound_by = kernel_phase(dev, patch)
    err2, totals2, bound_by2 = backward_kernel_phase(dev, patch)
    with tempfile.TemporaryDirectory() as workdir:
        launches, _ = serving_phase(dev, workdir)
        batched_serving_phase(dev, workdir, totals["ms"], patch.num_nodes)
        train_launches, trained = training_phase(dev, workdir)
        k3_launches, k3_inputs = rotinv_training_phase(dev, trained)
        err3, totals3, bound_by3 = aggregate_kernel_phase(dev, k3_inputs)
        bf16 = bf16_phase(dev, patch, trained, k3_inputs)
        vertex_launches, vertex_records, vertex_cfg, vertex_params = vertex_serving_phase(
            dev, workdir)
        vertex_trained = vertex_training_phase(dev, workdir)
        naive = naive_training_phase(dev, vertex_trained)
        graphs = graph_training_phase(dev, trained, vertex_trained, naive["cfg"])
        stream = streaming_phase(dev, workdir, trained, graphs)
        budget_phase(dev, vertex_trained, naive["cfg"], graphs["vertex naive"]["held_bytes"])
        err5, totals5, bound_by5 = solver_kernel_phase(dev, vertex_records, vertex_cfg,
                                                       vertex_params)
        err6, totals6, bound_by6 = adjoint_kernel_phase(dev, vertex_trained, naive["cfg"])
        err4, totals4, bound_by4 = pool_kernel_phase(
            dev, vertex_records, default_config().eval.ms_solver_iterations)
        parity_launches = parity_phase(dev, workdir)
        wang_launches = wang_phase(dev, workdir)
        halo = halo_phase(dev, workdir, trained["bench_patch"])
    print("bf16 vs f32 graph step, whole subdivision-5 icosphere (ms a step; device busy share; "
          "activities a step; capture s; graph MiB):")
    for label, r in bf16["graphs"].items():
        f = graphs[label]
        print(f"  {label}: bf16 {r['graph_ms']:.3f} vs f32 {f['graph_ms']:.3f} ms (eager "
              f"{r['eager_ms']:.3f} vs {f['eager_ms']:.3f}); busy "
              f"{100 * r['graph_busy_share']:.1f}% "
              f"vs {100 * f['graph_busy_share']:.1f}%; activities {r['graph_activities']:.1f} vs "
              f"{f['graph_activities']:.1f}; capture {r['capture_s']:.3f} vs {f['capture_s']:.3f}; "
              f"{r['graph_mib']:.1f} vs {f['graph_mib']:.1f} MiB")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "facet_conv_fwd",
        "route": "cuda",
        "source": "facet_graph_convolution_torch/csrc/facet_conv_fwd.cu",
        "replaces": "facet_graph_convolution_tpu/ops/pallas_conv.py:92",
        # serving, the parity capture, cli.wang (warm-up, capture, serving)
        # and the streaming runs (eager steps, warm-ups, captures)
        "launches": (launches + parity_launches + wang_launches["fwd"]
                     + stream["launches"]["fwd"] + halo["launches"]["fwd"]),
        "max_abs_err": err,
        # per patch forward: the sum over the 8 conv launches of the largest
        # subdivision-5 patch
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "facet_conv_bwd",
        "route": "cuda",
        "source": "facet_graph_convolution_torch/csrc/facet_conv_bwd.cu",
        "replaces": "facet_graph_convolution_tpu/ops/pallas_conv.py:111",
        # training, cli.wang's warm-up step and capture, and the streaming runs
        "launches": (train_launches["bwd"] + wang_launches["bwd"] + stream["launches"]["bwd"]
                     + halo["launches"]["bwd"]),
        "max_abs_err": err2,
        # per train step: the sum over the 8 conv launches at the same shapes
        "ms": totals2["ms"],
        "plain_ms": totals2["plain_ms"],
        "bound_ms": totals2["bound_ms"],
        "bound_by": bound_by2,
        # no single PyTorch call computes this backward
        "library_ms": None,
    }, {
        "name": "weighted_aggregate",
        "route": "cuda",
        "source": "facet_graph_convolution_torch/csrc/weighted_aggregate.cu",
        "replaces": "facet_graph_convolution_tpu/ops/pallas_kernels.py:43",
        "launches": k3_launches,
        "max_abs_err": err3,
        # per train step under rotation invariance: its one launch, at conv1
        # of the whole subdivision-5 icosphere
        "ms": totals3["ms"],
        "plain_ms": totals3["plain_ms"],
        "bound_ms": totals3["bound_ms"],
        "bound_by": bound_by3,
        "library_ms": totals3["library_ms"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"facet_graph_convolution_torch/csrc/{source}.cu",
        "replaces": replaces,
        # bf16 training's main path: K1/K2 in its default run (and the halo
        # phase's bf16 torus run), K3 in its rotation-invariant run
        "launches": bf16["launches"][run][key] + halo["launches"].get(halo_key, 0),
        "max_abs_err": bf16["checks"][key][0],
        # per train step: the 8 convs (K1, K2), conv1 (K3)
        "ms": bf16["checks"][key][1]["ms"],
        "plain_ms": bf16["checks"][key][1]["plain_ms"],
        "bound_ms": bf16["checks"][key][1]["bound_ms"],
        "bound_by": bf16["checks"][key][2],
        "library_ms": bf16["checks"][key][1].get("library_ms"),
    } for name, source, replaces, key, run, halo_key in (
        ("facet_conv_fwd_bf16", "facet_conv_fwd",
         "facet_graph_convolution_tpu/ops/pallas_conv.py:92", "K1", "default", "fwd_bf16"),
        ("facet_conv_bwd_bf16", "facet_conv_bwd",
         "facet_graph_convolution_tpu/ops/pallas_conv.py:111", "K2", "default", "bwd_bf16"),
        ("weighted_aggregate_bf16", "weighted_aggregate",
         "facet_graph_convolution_tpu/ops/pallas_kernels.py:43", "K3", "rotation-invariant",
         None),
    )] + [{
        "name": "tree_pool_ignore_zeros",
        "route": "cuda",
        "source": "facet_graph_convolution_torch/csrc/tree_pool_iz.cu",
        "replaces": "facet_graph_convolution_tpu/ops/pallas_kernels.py:91",
        # the naive solver runs the scale kernel below, not this one: 0
        "launches": vertex_launches["K4"],
        "max_abs_err": err4,
        # per served patch of the largest size as the naive solver ran K4
        # before the scale kernel: 180 launches at the two solver shapes
        "ms": totals4["ms"],
        "plain_ms": totals4["plain_ms"],
        "bound_ms": totals4["bound_ms"],
        "bound_by": bound_by4,
        # no single PyTorch call computes a zero-ignoring pairwise mean
        "library_ms": None,
    }, {
        "name": "ms_solver_naive",
        "route": "cuda",
        "source": "facet_graph_convolution_torch/csrc/ms_solver_naive.cu",
        "replaces": "facet_graph_convolution_tpu/ops/pallas_kernels.py:91",
        "launches": vertex_launches["solver"],
        "max_abs_err": err5,
        # per served patch of the largest size: its 3 launches, one a scale
        "ms": totals5["ms"],
        "plain_ms": totals5["plain_ms"],
        "bound_ms": totals5["bound_ms"],
        "bound_by": bound_by5,
        # no single PyTorch call runs the solver's loop
        "library_ms": None,
    }, {
        "name": "ms_solver_naive_bwd",
        "route": "cuda",
        "source": "facet_graph_convolution_torch/csrc/ms_solver_naive_bwd.cu",
        # jax.grad of the naive solver's loop body, which XLA differentiates
        "replaces": "facet_graph_convolution_tpu/ops/vertex_update.py:260",
        "launches": naive["launches"]["adjoint"],
        "max_abs_err": err6,
        # per train step of the largest vertex patch: its 3 launches
        "ms": totals6["ms"],
        "plain_ms": totals6["plain_ms"],
        "bound_ms": totals6["bound_ms"],
        "bound_by": bound_by6,
        # no single PyTorch call computes the loop's adjoint
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
