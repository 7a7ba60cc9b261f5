"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program: the top-level name of every
import (the part before the first dot) compared whole."""

import ast
import os

import pytest

from fgc_bench.core.manifest import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "facet_graph_convolution_tpu", "bench",
             "__graft_entry__"}
PROGRAM = "facet_graph_convolution_torch"


def _modules():
    for base, _, files in os.walk(BENCH_DIR):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.relpath(os.path.join(base, name), BENCH_DIR)


def top_level_imports(path: str):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("module", sorted(_modules()))
def test_no_jax(module):
    assert not top_level_imports(os.path.join(BENCH_DIR, module)) & FORBIDDEN


@pytest.mark.parametrize("module", sorted(m for m in _modules() if m.startswith("reference")))
def test_reference_imports_nothing_of_the_program(module):
    assert PROGRAM not in top_level_imports(os.path.join(BENCH_DIR, module))


def test_the_check_compares_whole_names():
    # the port's name begins with the JAX package's stem but is not it
    assert PROGRAM.split(".")[0] not in FORBIDDEN
    assert "facet_graph_convolution_tpu" in FORBIDDEN
