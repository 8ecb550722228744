"""Fabric CLI: the exchange daemon and the 2-process smoke.

``python -m gelly_streaming_tpu_torch.fabric --daemon [--host H] [--port N]``
runs :class:`~gelly_streaming_tpu_torch.fabric.exchange.ExchangeDaemon` in
the foreground (prints ``host:port`` on stdout, serves until killed).

``python -m gelly_streaming_tpu_torch.fabric --smoke`` is the gate: for
each locally-runnable backend (shared-dir, socket) it spawns TWO real
subprocesses that allgather, elect one winner, cross a barrier, and
exchange tagged payloads — then asserts both processes agreed. Exit 0
and a JSON verdict on stdout when every backend passes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def _worker(backend: str, target: str, pid: int, nprocs: int) -> int:
    """One smoke participant (run as a subprocess)."""
    from . import SharedDirTransport, SocketTransport

    if backend == "socket":
        tr = SocketTransport(target, pid, nprocs, timeout_s=30.0)
    else:
        tr = SharedDirTransport(target, pid, nprocs, timeout_s=30.0)
    gathered = tr.allgather("smoke.ag", np.array([pid], np.int32))
    k = tr.elect("smoke.k", 10 + pid)
    k_replay = tr.elect("smoke.k", 99)  # replay must re-read, not re-vote
    tr.barrier("smoke.bar")
    tr.put(f"smoke.tag.p{pid}", f"payload-{pid}".encode())
    peers = [
        tr.get(f"smoke.tag.p{r}", timeout_s=30.0)
        for r in range(nprocs)
    ]
    print(json.dumps({
        "pid": pid,
        "gathered": [int(np.asarray(g).reshape(-1)[0]) for g in gathered],
        "k": int(k),
        "k_replay": int(k_replay),
        "peers": [p.decode() if p is not None else None for p in peers],
    }))
    return 0


def _spawn_workers(backend: str, target: str, nprocs: int) -> list:
    procs = []
    outs = []
    try:
        for i in range(nprocs):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "gelly_streaming_tpu_torch.fabric",
                 "--worker", backend, target, str(i), str(nprocs)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
                env=dict(os.environ),
            ))
        for p in procs:
            try:
                out, err = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                raise SystemExit(
                    f"smoke[{backend}]: worker timed out")
            outs.append((p.returncode, out, err))
    finally:
        # every edge (a failed spawn, the timeout, a signal) reaps the
        # whole pack — no orphaned workers, no leaked pipe fds
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.communicate()
    return outs


def _check(backend: str, outs: list, nprocs: int) -> dict:
    docs = []
    for rc, out, err in outs:
        if rc != 0:
            raise SystemExit(
                f"smoke[{backend}]: worker rc={rc}\n{err[-2000:]}")
        docs.append(json.loads(out.strip().splitlines()[-1]))
    ks = {d["k"] for d in docs} | {d["k_replay"] for d in docs}
    want_g = list(range(nprocs))
    want_p = [f"payload-{r}" for r in range(nprocs)]
    ok = (
        len(ks) == 1
        and ks.issubset({10 + r for r in range(nprocs)})
        and all(d["gathered"] == want_g for d in docs)
        and all(d["peers"] == want_p for d in docs)
    )
    if not ok:
        raise SystemExit(f"smoke[{backend}]: disagreement: {docs}")
    return {"ok": True, "elected_k": ks.pop(), "processes": nprocs}


def _smoke() -> int:
    from .exchange import ExchangeDaemon

    nprocs = 2
    verdict = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="fabric-smoke-") as root:
        verdict["shared_dir"] = _check(
            "shared_dir", _spawn_workers("shared_dir", root, nprocs),
            nprocs)
    daemon = ExchangeDaemon().start()
    try:
        verdict["socket"] = _check(
            "socket", _spawn_workers("socket", daemon.address, nprocs),
            nprocs)
    finally:
        daemon.stop()
    verdict["wall_s"] = round(time.perf_counter() - t0, 3)
    print(json.dumps({"smoke": verdict}, indent=2))
    return 0


def _daemon(argv: list) -> int:
    from .exchange import ExchangeDaemon

    host, port = "127.0.0.1", 0
    if "--host" in argv:
        host = argv[argv.index("--host") + 1]
    if "--port" in argv:
        port = int(argv[argv.index("--port") + 1])
    daemon = ExchangeDaemon(host, port).start()
    print(daemon.address, flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        daemon.stop()
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--worker" in argv:
        i = argv.index("--worker")
        backend, target, pid, nprocs = argv[i + 1:i + 5]
        return _worker(backend, target, int(pid), int(nprocs))
    if "--smoke" in argv:
        return _smoke()
    if "--daemon" in argv:
        return _daemon(argv)
    print(
        "usage: python -m gelly_streaming_tpu_torch.fabric "
        "(--smoke | --daemon [--host H] [--port N])",
        file=sys.stderr,
    )
    return 2


if __name__ == "__main__":
    sys.exit(main())
