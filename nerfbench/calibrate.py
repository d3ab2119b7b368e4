"""Readings that the correctness limits of a cell are set from.

    python3 -m nerfbench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 101,102,103 [--views 2] [--out PATH]

In one process, at the cell's own size: for each of ``--seeds``, the
program's numbers against the float32 reference, through the same set-up
and first steps (train) or views (render) as a run, without the window;
for each of ``--control-seeds``, the same numbers with the reference in the
program's place one precision below the configuration's (``float8``:
e4m3 matrix products), and, for training, with two faults planted in it
(``drop_half``: half of each batch left out, the mean over the rest;
``unchanged``: the step returns its state unchanged); and, for training,
for every seed of ``--seeds`` the reference in the configuration's own
precision (``bfloat16``) in the program's place, beside the program.
Prints one JSON line per reading and a summary (the largest program
reading and the smallest control and fault reading of each number);
``--out`` writes them all. Needs a card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from nerfbench import capture, harness

ROWS = {"train": [("control_float8", {"matmul": "float8"}),
                  ("fault_drop_half", {"fault": "drop_half"}),
                  ("fault_unchanged", {"fault": "unchanged"})],
        "render": [("control_float8", {"matmul": "float8"})]}


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def calibrate(cell_name, seeds, control_seeds, views, device,
              root: Path = harness.ROOT, log=print) -> dict:
    device = torch.device(device)
    cell = harness.find_cell(cell_name, root)
    cap_dir, _ = capture.ensure(cell.config["capture"], cell.folder / ".cache")
    drv = harness.driver_class(cell)(cell, harness.port_config(cell, cap_dir),
                                     cap_dir, device)

    def one(seed, row, **kw):
        t0 = time.perf_counter()
        drv.start(seed)
        if drv.kind == "render":
            drv.views(views)
        drv.stop()
        got = drv.readings(detail=True, **kw)
        line = {"row": row, "seed": seed, **got,
                "seconds": time.perf_counter() - t0}
        log(json.dumps(line))
        return line

    lines = []
    for s in seeds:
        lines.append(one(s, "program"))
        if drv.kind == "train":   # a render reading is in units of this one
            lines.append(one(s, "reference_bfloat16", matmul="bfloat16"))
    for s in control_seeds:
        lines += [one(s, row, **kw) for row, kw in ROWS[drv.kind]]
    numbers = [k for k, v in lines[0].items()
               if k not in ("row", "seed", "seconds") and isinstance(v, float)]
    summary = {}
    for k in numbers:
        summary[k] = {"program_max": max(l[k] for l in lines
                                         if l["row"] == "program")}
        for row in ["reference_bfloat16"] + [r for r, _ in ROWS[drv.kind]]:
            vals = [l[k] for l in lines if l["row"] == row]
            if vals:
                summary[k][f"{row}_min"] = min(vals)
                summary[k][f"{row}_max"] = max(vals)
    return {"workload": cell_name, "device": (
        torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        **harness.card_line(), "lines": lines, "summary": summary}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, required=True)
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--views", type=int, default=2,
                   help="views rendered per seed (render cells)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    out = calibrate(args.workload, args.seeds, args.control_seeds,
                    args.views, args.device)
    print(json.dumps({"summary": out["summary"]}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
