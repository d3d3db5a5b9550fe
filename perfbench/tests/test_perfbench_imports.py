"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the plain reference imports nothing of the program."""
import ast
import os

import pytest

from perfbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def modules():
    for base, _, files in os.walk(harness.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_jax_and_no_jax_package(path):
    assert not set(imported(path)) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(harness.HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = set(imported(os.path.join(ref, f)))
            assert "repro_torch" not in tops and not tops & FORBIDDEN


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_loaded(["repro_torch", "repro_torch.gemm",
                                     "reprox", "torch"]) == []
    assert harness.forbidden_loaded(["repro.gemm", "jax.numpy",
                                     "jaxlib"]) == ["jax", "jaxlib", "repro"]
