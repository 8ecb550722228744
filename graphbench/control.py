"""Read the control of a cell at the cell's own size: the plain reference
put in the program's place with the guarantee it must not give up broken
(see each job's ``control``), compared as a run compares the program, at
the windows a run with that seed keeps.

    python3 graphbench/control.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line a seed: the compared numbers beside the cell's
limits, and whether the control came out correct (it must not). The
benchmark's runs never run it; ``tests/test_graphbench_control.py`` runs it
at a small size on the CPU.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read_control(name: str, seed: int, device, overrides=None) -> dict:
    """The control's compared numbers for one seed, with the cell's limits."""
    import torch

    from graphbench import generate, harness, manifest

    overrides = overrides or {}
    cell = harness.merge(manifest.workload(name), overrides.get("workload"))
    config = harness.merge(manifest.config(cell["config"]), overrides.get("config"))
    device = torch.device(device)
    src, dst = generate.edges(config["generator"], seed, device)
    data = harness.Data(src.cpu().numpy(), dst.cpu().numpy(), None, config["id_bound"])
    del src, dst
    job = manifest.job(config["job"]).Job(cell, config, data, device)
    plan = harness.keep_plan(seed, job.windows_per_pass, int(cell["sampled_passes"]))
    positions = [plan[p] for p in sorted(plan)]
    per_answer = job.control(positions)
    limits = {k: v for k, v in cell["limits"].items() if k != "windows_short"}
    numbers = {k: max(a[k] for a in per_answer) for k in limits}
    return {
        "workload": name, "seed": seed, "positions": positions,
        "numbers": numbers, "limits": limits,
        "correct": all(numbers[k] <= limits[k] for k in limits),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("graphbench control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = read_control(args.workload, seed, "cuda")
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
