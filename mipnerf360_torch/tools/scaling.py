"""Scaling harness -> SCALING_TORCH.json (counterpart of the JAX package's
``tools/scaling.py``).

    python -m mipnerf360_torch.tools.scaling --device cpu [--ranks 1,2,4,8]
    python -m mipnerf360_torch.tools.scaling [--device cuda] [--ranks 1,2]
    ... [--batch 2048 --steps 20 --reps 5 --out SCALING_TORCH.json]

The port runs one device per process ("rank"), so the JAX harness's two
measurements map onto ranks:

1. **Rank rows** (the JAX file's ``virtual_mesh_rows``): the same global
   batch over 1, 2, 4, ... data ranks. On the CPU (gloo) each rank gets
   ``max(1, cores // world)`` threads, so the total is constant and the
   ratio to one rank isolates what sharding adds (the per-rank dispatch,
   the loss statistics and the gradient all-reduce). As in the JAX file,
   ranks that share cores show that the sharded step runs at every width;
   they are not an efficiency.
2. **Process overhead** (the JAX file's ``loopback_process_overhead``):
   world 1 against world 2 at the same global batch. The JAX pair was one
   process of 4 devices against 2 processes of 2; here every rank beyond
   the first is a process of its own, so the pair is the rows of world 1
   and world 2 themselves.

On the card (``--device cuda``) a world runs over NCCL with one card per
rank when the host has cards enough; a world larger than the card count
runs as gloo ranks sharing the cards (NCCL refuses two ranks on one card),
and its row says so: on one card world 2 is a stand-in for two cards, as
the JAX file's gRPC was a stand-in for the DCN. On a host with N cards,
``--ranks 1,2,..,N`` measures NCCL across cards.

Each world's ranks are processes of ``tools/_scaling_worker.py`` that meet
through a ``file://`` rendezvous in a temporary directory; rank 0's JSON
line is the row. Runs on the card unless ``--device cpu``; writes ``--out``
(default ``SCALING_TORCH.json`` in the current directory).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List

import torch

from .bench import card_name

REPO = Path(__file__).resolve().parents[2]
WORKER = "mipnerf360_torch.tools._scaling_worker"
DEFAULT_RANKS = {"cpu": "1,2,4,8", "cuda": "1,2"}
# Seconds each world may take, and between two looks at its ranks.
WORLD_TIMEOUT_S = 1200
POLL_S = 0.2
# CPU threads that each world's ranks share (--device cpu).
CORES = os.cpu_count() or 1


def world_backend(device: str, world: int) -> tuple:
    """(backend, whether ranks share cards) of a world: gloo on the CPU; on
    the card NCCL with one card per rank while the cards suffice, else gloo
    ranks sharing the cards (NCCL refuses two ranks on one card)."""
    if device == "cpu":
        return "gloo", False
    shared = world > torch.cuda.device_count()
    return ("gloo" if shared else "nccl"), shared


def rank_threads(device: str, world: int, cores: int = CORES) -> int:
    """Threads of each rank: ``max(1, cores // world)`` on the CPU, so every
    world uses the same cores in all; 0 (torch's default) on the card."""
    return max(1, cores // world) if device == "cpu" else 0


def run_world(world: int, args, backend: str, workdir: Path) -> dict:
    """Start ``world`` worker processes and return rank 0's JSON line. Each
    rank logs to a file (a rank blocked on a full pipe would stall its
    peers). All ranks are polled against one deadline; once one fails or
    the time is up, the others are killed and the failed rank's log is
    reported."""
    rdv = workdir / f"rdv_{world}"
    threads = rank_threads(args.device, world)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    logs = [workdir / f"world{world}_rank{r}.log" for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", WORKER, "--rank", str(r),
                     "--world", str(world), "--init-method", f"file://{rdv}",
                     "--device", args.device, "--backend", backend,
                     "--batch", str(args.batch), "--steps", str(args.steps),
                     "--reps", str(args.reps), "--threads", str(threads)],
                    cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
                    start_new_session=True))
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        while True:
            codes = [p.poll() for p in procs]
            failed = next((r for r, c in enumerate(codes)
                           if c not in (None, 0)), None)
            if failed is not None:
                raise SystemExit(f"world {world}: rank {failed} exited "
                                 f"{codes[failed]}:\n"
                                 + logs[failed].read_text()[-4000:])
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                late = codes.index(None)
                raise SystemExit(f"world {world}: rank {late} did not finish "
                                 f"in {WORLD_TIMEOUT_S} s:\n"
                                 + logs[late].read_text()[-4000:])
            time.sleep(POLL_S)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    lines = logs[0].read_text().strip().splitlines()
    return json.loads(lines[-1])


def efficiency(one: dict, two: dict) -> tuple:
    """(steps/s of ``two`` over ``one``, [low, high] from the per-rep
    extremes of both), each to 4 places."""
    eff = round(two["steps_per_sec"] / one["steps_per_sec"], 4)
    lo = round(min(two["steps_per_sec_reps"])
               / max(one["steps_per_sec_reps"]), 4)
    hi = round(max(two["steps_per_sec_reps"])
               / min(one["steps_per_sec_reps"]), 4)
    return eff, [lo, hi]


def measure(args) -> dict:
    """Every world of ``args.ranks``, then the result dict of ``--out``."""
    worlds: List[int] = [int(w) for w in args.ranks.split(",")]
    if 1 not in worlds:
        raise SystemExit("--ranks must include 1: every row is a ratio to it")
    card = card_name(args.device)
    rows = []
    with tempfile.TemporaryDirectory(prefix="scaling_") as tmp:
        for world in worlds:
            backend, shared = world_backend(args.device, world)
            row = run_world(world, args, backend, Path(tmp))
            row["cards_shared"] = shared
            rows.append(row)
            print(f"world {world} ({backend}"
                  f"{', ranks sharing cards' if shared else ''}): "
                  f"{json.dumps(row)}", flush=True)
    base = next(r for r in rows if r["global_devices"] == 1)
    for r in rows:
        r["throughput_ratio_vs_1"] = round(
            r["steps_per_sec"] / base["steps_per_sec"], 4)
    two = next((r for r in rows if r["global_devices"] == 2), None)
    eff, band = efficiency(base, two) if two else (None, None)
    if two:
        print(f"world 1 {base['steps_per_sec']} steps/s, world 2 "
              f"{two['steps_per_sec']} steps/s, eff {eff} {band}", flush=True)
    noise = any(r["throughput_ratio_vs_1"] > 1.0 for r in rows[1:])
    on_cpu = args.device == "cpu"
    return {
        "what": ("Scaling measurements of the PyTorch port: one global "
                 "batch over 1, 2, ... data ranks, one device per rank, "
                 + ("gloo ranks on the CPU sharing its cores."
                    if on_cpu else
                    "NCCL with one card per rank where the host has cards "
                    "enough, else gloo ranks sharing the cards "
                    "(cards_shared).")
                 + " See mipnerf360_torch/tools/scaling.py for how the "
                 "JAX harness's measurements map onto ranks."),
        "headline": {
            "metric": "world-2 efficiency (world 2 against world 1, same "
                      "global batch)",
            "efficiency_2proc_vs_1proc": eff,
            "spread_from_rep_extremes": band,
            "reps": args.reps,
        },
        "host": {"physical_cores": CORES},
        "card": card,
        "config": {"batch_total": args.batch, "steps_per_chunk": args.steps,
                   "reps": args.reps, "device": args.device,
                   "model": "num_samples=32 prop64 nerf256x4 f32 joint"},
        "virtual_mesh_rows": {
            "note": (("Ranks on the CPU: " + str(CORES) + " cores "
                      "execute every world (max(1, cores // world) threads "
                      "per rank), so the rows show that the data-parallel "
                      "step runs at every width, not an efficiency (ratios "
                      "> 1.0 are noise" + (", present in this run" if noise
                                          else "") + ").")
                     if on_cpu else
                     ("Ranks on the card(s): a world with cards_shared "
                      "true runs gloo ranks on shared cards, a stand-in "
                      "for cards of its own (gloo moves CUDA tensors "
                      "through the host).")),
            "rows": rows,
        },
        "loopback_process_overhead": None if two is None else {
            "note": ("world 1 against world 2 at the same global batch; in "
                     "the port every rank beyond the first is a process of "
                     "its own, so the JAX pair (1 process x 4 devices "
                     "against 2 processes x 2) is these two rows; the "
                     "delta is the second process and its collectives"
                     + ("" if on_cpu or not two["cards_shared"] else
                        " (gloo through the host on one shared card: a "
                        "stand-in for NCCL between cards)")),
            "one_process": base,
            "two_process": two,
            "efficiency_2proc_vs_1proc": eff,
        },
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks", default=None,
                    help="comma-separated world sizes, 1 among them "
                         "(default 1,2,4,8 on the CPU, 1,2 on the card)")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="SCALING_TORCH.json")
    args = ap.parse_args(argv)
    args.ranks = args.ranks or DEFAULT_RANKS[args.device]
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run on "
                         "the CPU")
    result = measure(args)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(f"wrote {os.path.abspath(args.out)}", flush=True)
    return result


if __name__ == "__main__":
    main()
