"""Find the benchmark's pieces by name.

- ``workloads/<cell>.json``: one cell (its configuration, window, pass
  shape, metrics, the limits of its check and its ``why``).
- ``configs/<config>.json``: one configuration (source, generator, id
  bound, guarantee, the program's settings, ``reduced``, ``assumed``, job).
- ``jobs/<job>.py``: one job kind, imported as ``graphbench.jobs.<job>``.
- ``metrics/<metric>.py``: one per-layer metric reader, loaded by path
  (metric names hold dots).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.abspath(__file__))


def names(kind: str) -> list:
    """The names of every piece of a kind (``configs``, ``workloads``,
    ``jobs``, ``metrics``)."""
    ext = ".py" if kind in ("jobs", "metrics") else ".json"
    folder = os.path.join(ROOT, kind)
    return sorted(f[: -len(ext)] for f in os.listdir(folder)
                  if f.endswith(ext) and not f.startswith("_"))


def _json(kind: str, name: str) -> dict:
    path = os.path.join(ROOT, kind, name + ".json")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    spec = _json("configs", name)
    spec["name"] = name
    return spec


def workload(name: str) -> dict:
    spec = _json("workloads", name)
    spec["name"] = name
    return spec


def job(kind: str):
    return importlib.import_module(f"graphbench.jobs.{kind}")


def metric(name: str):
    path = os.path.join(ROOT, "metrics", name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no metric named {name!r} ({path})")
    mod_name = "graphbench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
