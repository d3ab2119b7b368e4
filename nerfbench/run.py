"""Run one cell of ``BENCHMARK.json`` on one NVIDIA card.

    python3 -m nerfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It sets the cell up (imports, CUDA, the
program's kernels, data, weights from the seed, warm-up), measures for
``--seconds``, then, with ``--trace 1``, profiles a steady segment after the
window; frees the program's state, decides ``correct`` against the plain
reference, and prints the result as the last line of standard output, with
the numbers compared beside their limits as the last lines of standard
error. Without a card, or with JAX or the JAX package loaded, it exits
with a code other than 0 and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    # The program's one build cache is build/mipnerf360_torch/ inside the
    # checkout (ops/_build.py), a fixed path: only a checkout's first run
    # compiles.
    import torch

    from nerfbench import harness

    chips = next((w.get("chips", 1) for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]
        if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"nerfbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T0, ROOT)
    bad = harness.forbidden_modules()
    if bad:
        print(f"nerfbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    dev = result["device"]
    print(f"nerfbench: {args.workload} seed {args.seed} on {dev['kind']} "
          f"(power limit {dev.get('power_limit', 'unknown')})", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
