"""Run chip_smoke.py's multi-GPU phases (19b-19g: sharded vertex serving of
the 1,048,576-face torus, K4's forward and backward kernels at its pool
inputs, sharded vertex training, data parallelism, multi-mesh training and
the tensor-parallel head) alone on one card, in a one-rank NCCL group,
after building the kernels. Card only; a few minutes.

    python3 tools/multi_gpu_phase_probe.py
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("multi_gpu_phase_probe: no CUDA device", file=sys.stderr)
        return 2
    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.data.dataset import TrainingSet
    from facet_graph_convolution_torch.data.synthetic import (
        add_vertex_noise,
        chamfered_box,
        icosphere,
        torus,
    )
    from facet_graph_convolution_torch.ops import cuda_library
    from facet_graph_convolution_torch.parallel import distributed
    from facet_graph_convolution_torch.parallel.mesh import make_mesh

    print(chip_smoke.card_line())
    t0 = time.perf_counter()
    print(f"build: {cuda_library.build()} in {time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    train_set = TrainingSet(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                            k_faces=23, seed=0)
    for v, f in (icosphere(5), torus(nu=128, nv=64), chamfered_box(24)):
        train_set.add_mesh(add_vertex_noise(v, f, 0.2, rng), f, gt_vertices=v)
    v, f = torus(nu=chip_smoke.HALO_TORUS[0], nv=chip_smoke.HALO_TORUS[1])
    noisy = add_vertex_noise(v, f, 0.2, np.random.default_rng(0))
    distributed.initialize(f"127.0.0.1:{chip_smoke._free_port()}", num_processes=1,
                           process_id=0, device="cuda")
    try:
        group = make_mesh(str(dev))
        with tempfile.TemporaryDirectory() as workdir:
            trained = {"cfg": default_config().replace(train={"network_path": workdir}),
                       "train_set": train_set, "bench_patch": chip_smoke.phase_patch()}
            out = chip_smoke.multi_gpu_phases(dev, group, workdir, (noisy, f), trained)
    finally:
        distributed.shutdown()
    print({k: v for k, v in out.items() if k != "pools"})
    print(out["pools"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
