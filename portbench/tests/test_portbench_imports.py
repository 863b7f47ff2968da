"""Nothing the benchmark runs imports JAX or the JAX package, judged by
whole top-level module names; the reference imports nothing of the
program."""
import ast
import os
import sys

import pytest

from portbench import bench

FORBIDDEN = {"jax", "jaxlib", "flax", "asyrp_official_tpu"}


def _py_files(sub=""):
    base = os.path.join(bench.HERE, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".", 1)[0])
    return out


@pytest.mark.parametrize("path", sorted(_py_files()), ids=lambda p: os.path.relpath(p, bench.HERE))
def test_no_jax(path):
    assert not (_top_level_imports(path) & FORBIDDEN)


@pytest.mark.parametrize("path", sorted(_py_files("reference")),
                         ids=lambda p: os.path.relpath(p, bench.HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert "asyrp_official_torch" not in _top_level_imports(path)


def test_the_run_names_loaded_jax_by_whole_top_level_name():
    sys.path.insert(0, bench.HERE)
    import run

    assert run.loaded_forbidden(["jax.numpy", "asyrp_official_torch.ops", "jaxtyping",
                                 "asyrp_official_tpu", "flaxen", "torch"]) == [
        "asyrp_official_tpu", "jax"]
    assert run.loaded_forbidden(["asyrp_official_torch", "asyrp_official_torch.models"]) == []
