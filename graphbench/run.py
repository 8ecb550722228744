"""Run one benchmark cell once and print its result as one JSON line.

    python3 graphbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``gelly_streaming_tpu_torch``, on a
machine with an NVIDIA card. The last line of standard output is the
result; the last lines of standard error are the compared numbers, each
beside its limit. Exits with 2 and prints no result without a card, and
with 3 where a JAX module or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: build and kernel caches of the program, at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".graphbench_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)

    import torch

    from graphbench import harness, manifest

    cell = manifest.workload(args.workload)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"graphbench: {args.workload} needs {chips} CUDA card(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                     "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"graphbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
