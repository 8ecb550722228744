"""Census of the serving worker's sweeps around the RPC scenario's kill.

Runs ``resilience.chaos.run_rpc_scenario`` of either package (the JAX
reference or the PyTorch port, both on the CPU) ``--runs`` times at the
``run_mp_sweep`` rpc point's settings (``--clients`` connections, batches
of 8, 15 batches after the kill, the kill at sweep ``--kill-at``), and
prints one JSON line a run:

- ``ok`` and ``crossing`` (the scenario's verdict and its kill-crossing
  traces: batches answered partly by the dead primary, partly by the
  promoted standby);
- ``drained``: the queries each of the ten sweeps before the kill sweep
  drained in the primary (0 is an empty sweep);
- ``pending_at_kill_sweep``: the queries pending when the worker reached
  the kill sweep (0: no batch in flight there);
- ``answer_sweeps_before``: how many sweeps before it answered a batch.

The sweeps are read in the replica processes through a ``sitecustomize``
module written to the work directory and put on their ``PYTHONPATH``: it
wraps ``StreamServer._drain`` and the module's fault hook after the
server module loads. Nothing of either package changes.

    JAX_PLATFORMS=cpu python tools/kill_sweep_census.py --package jax --runs 12
    python tools/kill_sweep_census.py --package torch --runs 12
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HOOK = r'''
import importlib.abc, importlib.util, os, sys
_LOG = os.environ.get("SWEEP_CENSUS_LOG")
_KILL = int(os.environ.get("SWEEP_CENSUS_KILL", "100"))
if _LOG:
    _f = open(f"{_LOG}.{os.getpid()}", "a", buffering=1)
    _srv = [None]

    def _patch(mod):
        S = mod.StreamServer
        drain = S._drain

        def _drain(self):
            _srv[0] = self
            b = drain(self)
            if _KILL - 10 <= self._sweeps - 1 < _KILL:
                _f.write(f"D {self._sweeps - 1} {len(b)}\n")
            return b
        S._drain = _drain
        fm = mod._faults
        fire = fm.fire

        def _fire(site, *a, **k):
            if (site == "serving.worker" and k.get("index") == _KILL
                    and _srv[0] is not None):
                _f.write(f"K {_KILL} {len(_srv[0]._pending)}\n")
            return fire(site, *a, **k)
        fm.fire = _fire

    class _Finder(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if not name.endswith(".serving.server"):
                return None
            sys.meta_path.remove(self)
            try:
                spec = importlib.util.find_spec(name)
            finally:
                sys.meta_path.insert(0, self)
            if spec is None:
                return None
            run = spec.loader.exec_module

            def exec_module(module):
                run(module)
                _patch(module)
            spec.loader.exec_module = exec_module
            return spec
    sys.meta_path.insert(0, _Finder())
'''


def _read_census(log_base: str, kill_at: int) -> dict:
    for path in glob.glob(log_base + ".*"):
        with open(path) as f:
            rows = [line.split() for line in f if line.strip()]
        kill = [int(r[2]) for r in rows if r[0] == "K"]
        if not kill:
            continue  # the standby: it never reached the primary's kill
        drained = {int(r[1]): int(r[2]) for r in rows if r[0] == "D"}
        seq = [drained.get(k) for k in range(kill_at - 10, kill_at)]
        return {"drained": seq, "pending_at_kill_sweep": kill[0],
                "answer_sweeps_before": sum(1 for n in seq if n)}
    return {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--runs", type=int, default=12)
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--kill-at", type=int, default=100)
    ap.add_argument("--seed", type=int, default=4321)
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    kw = {}
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from gelly_streaming_tpu.resilience import chaos
    else:
        from gelly_streaming_tpu_torch.resilience import chaos

        kw["device"] = "cpu"
    work = args.workdir or tempfile.mkdtemp(prefix="sweep_census_")
    hook_dir = os.path.join(work, "hook")
    os.makedirs(hook_dir, exist_ok=True)
    with open(os.path.join(hook_dir, "sitecustomize.py"), "w") as f:
        f.write(_HOOK)
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [hook_dir] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    os.environ["SWEEP_CENSUS_KILL"] = str(args.kill_at)
    try:
        for i in range(args.runs):
            root = os.path.join(work, f"run{i}")
            os.environ["SWEEP_CENSUS_LOG"] = root + ".sweeps"
            t0 = time.perf_counter()
            doc = chaos.run_rpc_scenario(
                root, seed=args.seed, clients=args.clients, batch=8,
                post_kill_batches=15, kill_at_sweep=args.kill_at,
                log=lambda s: None, **kw)
            print(json.dumps({
                "package": args.package, "run": i, "ok": doc["ok"],
                "crossing": doc["attribution"]["kill_crossing_traces"],
                "seconds": time.perf_counter() - t0,
                **_read_census(root + ".sweeps", args.kill_at)}), flush=True)
            shutil.rmtree(root, ignore_errors=True)
    finally:
        if args.workdir is None:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
