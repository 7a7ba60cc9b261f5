"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface under ``csrc/build/`` (listed in
``.gitignore``), at first use or when the source is newer than the library,
and loaded with ``ctypes``; a shared header (``csrc/*.cuh``), or a source
that it includes, newer than a library makes it stale too (K2's bfloat16
entry, ``facet_conv_bwd_bf16.cu``, includes ``facet_conv_bwd.cu``).
:func:`build` starts one ``nvcc`` per stale source, all at once, and waits
for them. Nothing is compiled or loaded at
import time: a machine without a card or ``nvcc`` imports this module.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
KERNELS = ("facet_conv_fwd", "facet_conv_bwd", "facet_conv_bwd_bf16", "tree_pool_iz",
           "weighted_aggregate", "ms_solver_naive", "ms_solver_naive_bwd", "windowed_conv_fwd",
           "windowed_conv_bwd", "trace_mark", "bias_lrelu")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _paths(name: str):
    return (os.path.join(CSRC, name + ".cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"),
            os.path.join(BUILD_DIR, f"{name}.log"))


def _stale(name: str) -> bool:
    """No library yet, or one older than its source, a header of ``csrc/``
    or a ``csrc/*.cu`` that its source includes."""
    src, lib, _ = _paths(name)
    if not os.path.exists(lib):
        return True
    headers = [os.path.join(CSRC, h) for h in os.listdir(CSRC) if h.endswith(".cuh")]
    with open(src) as fh:
        included = [os.path.join(CSRC, f) for f in re.findall(r'#include "(\w+\.cu)"', fh.read())]
    return os.path.getmtime(lib) < max(os.path.getmtime(p) for p in [src, *headers, *included])


def build(names: Iterable[str] = KERNELS) -> List[str]:
    """Compile every stale kernel of ``names`` in parallel; returns the names
    built. Raises with nvcc's output if one fails. The compiler's report
    (``-Xptxas -v``: registers, spills) is kept in ``csrc/build/<name>.log``."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return []
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        src, lib, log = _paths(name)
        tmp = f"{lib}.{os.getpid()}.tmp"
        with open(log, "w") as fh:
            procs.append((name, tmp, lib, log, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                stdout=fh, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, lib, log, proc in procs:
        if proc.wait() != 0:
            with open(log) as fh:
                failed.append(f"{name}:\n{fh.read()}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if stale."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_paths(name)[1])
            _LIBS[name] = lib
        return lib
