"""No module of the benchmark imports JAX or the JAX package, by top-level
name compared whole; the references import nothing of the program."""

import ast
import os

import pytest

from graphbench import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "gelly_streaming_tpu"}


def _modules():
    for base, _, files in os.walk(manifest.ROOT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, manifest.ROOT))
def test_no_jax_and_no_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(p for p in _modules() if f"{os.sep}reference{os.sep}" in p),
                         ids=lambda p: os.path.relpath(p, manifest.ROOT))
def test_references_import_nothing_of_the_program(path):
    assert set(_imports(path)) <= {"__future__", "numpy", "torch"}


def test_the_scan_tells_the_port_from_the_jax_package(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import gelly_streaming_tpu_torch.datasets\nfrom jax import numpy\n")
    assert set(_imports(str(p))) == {"gelly_streaming_tpu_torch", "jax"}
