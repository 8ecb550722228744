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
             "aggregate", "obs", "resilience", "control", "eventtime", "fabric",
             "parallel", "serving"]


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
) + [("ops", "DeviceVertexDict"), ("resilience", "DeviceUnavailable")] + [
    # the reference's PEP 562 lazy exports (serving's RPC names, obs's
    # endpoint, and the routing tier's two of slice 9b), which no relative
    # import lists
    ("serving", n) for n in ("HeartbeatLease", "ReplicaServer", "RpcServer",
                             "RpcClient", "RpcError", "ShardRouter",
                             "ReshardWatcher")] + [("obs", "MetricsEndpoint")]


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
    # the durability slice
    ("", "AutoCheckpoint"), ("", "FaultPlan"), ("", "RetryPolicy"), ("", "Supervisor"),
    ("", "GeneratorSource"), ("", "SocketEdgeSource"), ("resilience", "Supervisor"),
    ("resilience", "FaultPlan"), ("resilience", "RetryPolicy"), ("resilience", "exp_backoff"),
    ("resilience", "jittered"), ("obs", "FlightRecorder"), ("obs", "read_dump"),
    ("control", "SignalReader"),
    # event time and the control half of slice 7b
    ("control", "AutoK"), ("control", "PrefetchTuner"), ("control", "AdmissionTuner"),
    ("control", "ControlPlane"), ("control", "default_plane"), ("control", "log_retune"),
    ("eventtime", "SlidingGraphAggregator"), ("eventtime", "WindowResult"),
    ("eventtime", "drive_sliding"), ("eventtime", "PaneAssembler"),
    ("eventtime", "WatermarkTracker"), ("eventtime", "merge_watermarks"),
    ("eventtime", "NO_WATERMARK"), ("eventtime", "DecForest"), ("", "ScheduledCountWindow"),
    # slice 7b (ingest): the fabric, the coordinated layer, the obs exporters
    ("fabric", "SharedDirTransport"), ("fabric", "SocketTransport"), ("fabric", "ElectedK"),
    ("fabric", "ExchangeDaemon"), ("fabric", "CollectiveTransport"), ("fabric", "Transport"),
    ("resilience", "CoordinatedCheckpoint"), ("resilience", "ClusterSupervisor"),
    ("resilience", "ClusterError"), ("resilience", "select_epoch"), ("obs", "ShardSink"),
    ("obs", "ClusterAggregator"), ("obs", "JsonlSink"), ("obs", "replay"),
    ("obs", "prometheus_text"),
    # slice 9a (the single-process serving tier and its wire); the lazy
    # names of serving/__init__ and obs/__init__ are pinned here
    ("serving", "StreamServer"), ("serving", "QueryEngine"), ("serving", "Servable"),
    ("serving", "FailoverServer"), ("serving", "SnapshotStore"), ("serving", "TxnContext"),
    ("serving", "RpcServer"), ("serving", "RpcClient"), ("serving", "RpcError"),
    ("serving", "ReplicaServer"), ("serving", "HeartbeatLease"), ("obs", "MetricsEndpoint"),
    ("obs", "TraceContext"), ("obs", "record_span"), ("obs", "activate"),
])

def test_slice_names_are_cases(package, name):
    """The names the slices port, and the three imports that used to fail,
    are among the cases above (the reference exports them all)."""
    assert (package, name) in _CASES


#: modules of slices 7b (ingest), 9a (serving) and 9b (the routing tier)
#: whose public top-level names are the exports (the reference does not
#: re-export all of them from a package ``__init__``)
_MODULES = ["core.ingest", "fabric.base", "fabric.wire", "fabric.shared_dir",
            "fabric.exchange", "fabric.agreement", "fabric.collective",
            "parallel.multihost", "resilience.coordinated", "resilience.chaos",
            "obs.export", "obs.cluster", "obs.timeline", "obs.flight",
            "obs.trace", "obs.endpoint", "resilience.retry", "resilience.faults",
            "serving.query", "serving.server", "serving.snapshot_store",
            "serving.stats", "serving.txn", "serving.failover", "serving.rpc",
            "serving.client", "serving.router", "serving.reshard",
            "summaries.forest", "example.sharded_ingest_serving"]


def _module_names(module):
    """Public names a reference module defines at top level (functions,
    classes, constants), not the ones it imports."""
    path = os.path.join(_REF_ROOT, *module.split(".")) + ".py"
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return sorted(n for n in out if not n.startswith("_"))


_MODULE_CASES = [(m, n) for m in _MODULES for n in _module_names(m)]


@pytest.mark.parametrize("module,name", _MODULE_CASES,
                         ids=[f"{m}.{n}" for m, n in _MODULE_CASES])
def test_slice_7b_module_defines_the_reference_name(module, name):
    mod = importlib.import_module(f"gelly_streaming_tpu_torch.{module}")
    assert hasattr(mod, name), f"gelly_streaming_tpu_torch.{module} lacks {name}"
