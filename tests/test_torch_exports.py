"""The port's package ``__init__`` files re-export what the JAX package's
do.

For each package, every name the reference's ``__init__`` imports from
one of its submodules, and that the port's submodule of the same name
defines, must import from the port's package too (a name the port has
not ported yet is not asked for). Names the port adds to an ``__init__``
of its own (``DeviceVertexDict``) are pinned beside them.
"""

import ast
import importlib
import os

import pytest

import gelly_streaming_tpu

_REF_ROOT = os.path.dirname(gelly_streaming_tpu.__file__)
_PACKAGES = ["", "core", "ops", "summaries", "library", "utils", "models",
             "aggregate", "obs", "resilience"]


def _reference_exports(package):
    """``(submodule, name)`` for each relative import of the reference's
    ``__init__`` of ``package``."""
    path = os.path.join(_REF_ROOT, *package.split("."), "__init__.py") if package \
        else os.path.join(_REF_ROOT, "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1 and node.module:
            out.extend((node.module, a.name) for a in node.names)
    return out


def _ported(package, submodule, name):
    mod = ".".join(p for p in ("gelly_streaming_tpu_torch", package, submodule) if p)
    try:
        return hasattr(importlib.import_module(mod), name)
    except ImportError:
        return False


_CASES = sorted(
    {(pkg, name) for pkg in _PACKAGES for sub, name in _reference_exports(pkg)
     if _ported(pkg, sub, name)}
) + [("ops", "DeviceVertexDict")]


@pytest.mark.parametrize("package,name", _CASES,
                         ids=[f"{p or 'root'}.{n}" for p, n in _CASES])
def test_ported_name_imports_from_the_package(package, name):
    mod = ".".join(p for p in ("gelly_streaming_tpu_torch", package) if p)
    assert hasattr(importlib.import_module(mod), name), f"{mod} does not export {name}"


@pytest.mark.parametrize("package,name", [
    ("summaries", "DisjointSet"), ("core", "blocks_from_edges"), ("", "blocks_from_edges"),
    ("library", "BroadcastTriangleCount"), ("library", "IncidenceSamplingTriangleCount"),
    ("library", "IterativeConnectedComponents"), ("library", "CentralizedWeightedMatching"),
    ("library", "MatchingEvent"), ("library", "MatchingEventType"),
    ("utils", "EngineConfig"), ("utils", "StreamProfiler"), ("utils", "SampledEdge"),
    ("summaries", "Components"), ("ops", "CSR"), ("core", "SnapshotStream"),
])
def test_slice_names_are_cases(package, name):
    """The names this slice ports, and the three imports that used to fail,
    are among the cases above (the reference exports them all)."""
    assert (package, name) in _CASES
