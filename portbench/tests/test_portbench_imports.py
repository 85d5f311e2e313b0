"""Nothing under portbench/ imports JAX or the JAX package, compared by whole top-level name; the reference imports nothing of the program."""

import ast
import os

import pytest

from portbench import harness

PKG = os.path.join(harness.ROOT, "portbench")
# the JAX package's benchmark folder, spelt so that this file does not name it
JAX_BENCH = "bench" + "marks/"


def _sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax_and_no_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), tops
    with open(path) as f:
        assert JAX_BENCH not in f.read()


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(PKG, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, f))}
            assert tops <= {"__future__", "math", "decimal", "numpy"}, (f, tops)


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["fhe_sorting_tpu_torch", "fhe_sorting_tpu_torch.core",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["fhe_sorting_tpu.core.keys", "jax._src", "jaxlib",
                                      "flax"]) == ["fhe_sorting_tpu", "flax", "jax", "jaxlib"]
