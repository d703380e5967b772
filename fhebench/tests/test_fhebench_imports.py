"""No module of the benchmark imports JAX or the JAX package, compared
by whole top-level name (ace_tpu_torch is not ace_tpu); the reference
and the network it reads import nothing of the program either."""

import ast
import os

import pytest

from fhb_util import ROOT

HERE = os.path.join(ROOT, "fhebench")
FORBIDDEN = {"jax", "jaxlib", "flax", "ace_tpu"}
# modules that must not import the program either
PLAIN = {"reference.py", "model.py", "check.py", "work.py", "devtrace.py",
         "cells.py"}


def _modules():
    for d, _, files in os.walk(HERE):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), HERE)


def _top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("rel", list(_modules()))
def test_no_jax_or_jax_package(rel):
    found = set(_top_names(os.path.join(HERE, rel))) & FORBIDDEN
    assert not found, f"{rel} imports {found}"


@pytest.mark.parametrize("rel", sorted(PLAIN))
def test_reference_side_imports_nothing_of_the_program(rel):
    names = set(_top_names(os.path.join(HERE, rel)))
    assert "ace_tpu_torch" not in names
    if rel == "reference.py":
        assert names <= {"__future__", "torch", "fhebench"}


def test_the_check_compares_whole_names():
    import sys
    from fhebench import run
    sys.modules["ace_tpu_torch_probe"] = sys
    try:
        assert "ace_tpu" not in run.forbidden_modules()
        sys.modules["jax.numpy"] = sys
        assert run.forbidden_modules() == ["jax"]
    finally:
        sys.modules.pop("ace_tpu_torch_probe", None)
        sys.modules.pop("jax.numpy", None)
