"""Run ``chip_smoke.py``'s training and streaming phases alone on one card.

The streaming phase needs the training phase's OBJ tree; the graph phase's
default step, which it prints beside its own, is not run here (printed as
nan). Builds the CUDA kernels first, as ``chip_smoke.py`` does.

    python tools/stream_phase_probe.py
"""

import os
import sys
import tempfile
import time


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    import chip_smoke
    from facet_graph_convolution_torch.ops import cuda_library

    if not torch.cuda.is_available():
        print("stream_phase_probe: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line())
    t0 = time.perf_counter()
    print(f"build: {cuda_library.build()} in {time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as workdir:
        _, trained = chip_smoke.training_phase(dev, workdir)
        stream = chip_smoke.streaming_phase(dev, workdir, trained,
                                            {"default": {"graph_ms": float("nan")}})
    print(f"stream_phase_probe: passed; wrapper launches {stream['launches']}, uploads' "
          f"overlap with kernels {stream['overlap_share']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
