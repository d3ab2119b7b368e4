"""One run of one cell: find the cell's files by name, set it up, measure
for the window, trace a steady segment when asked, free the program's state,
decide ``correct`` against the reference, and assemble the result line.

Nothing here knows a configuration, a traffic mix or a metric by name:
``BENCHMARK.json`` names them, and their files are found under the root's
``nerfbench/`` folder (``configs/``, ``traffic/``, ``drivers/``,
``metrics/``, ``limits/``), so a later cell, mix, driver or metric is new
files and entries only.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from . import capture
from . import yardstick as ys

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "mipnerf360_tpu")
TOP_OPS = 10


@dataclasses.dataclass
class Cell:
    name: str
    root: Path
    config: dict            # configs/<config>.json
    mix: dict               # traffic/<traffic>.json
    end_to_end: List[dict]  # BENCHMARK.json metrics this cell reports
    per_layer: List[dict]
    limits: Dict[str, dict]  # limits/<cell>.json

    @property
    def folder(self) -> Path:
        return self.root / "nerfbench"


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    folder = root / "nerfbench"
    return Cell(
        name=name, root=root,
        config=_read_json(folder / "configs" / f"{w['config']}.json"),
        mix=_read_json(folder / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        limits=_read_json(folder / "limits" / f"{name}.json"))


def _load_file(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_class(cell: Cell):
    """``drivers/<mix driver>.py``'s ``Driver``."""
    name = cell.mix["driver"]
    return _load_file(cell.folder / "drivers" / f"{name}.py",
                      f"nerfbench_driver_{name}").Driver


def reader(cell: Cell, metric: str) -> Callable[[dict], Optional[float]]:
    """``metrics/<metric>.py``'s ``read``."""
    safe = metric.replace(".", "_").replace("-", "_")
    return _load_file(cell.folder / "metrics" / f"{metric}.py",
                      f"nerfbench_metric_{safe}").read


def port_config(cell: Cell, capture_dir: Path):
    """The program's Config of the cell: its preset with the file's
    ``set`` overrides and the capture as ``data.base_dir``. Every number
    the file states under ``model``, ``train`` and ``data`` must be what
    the program runs, or the cell is refused."""
    from mipnerf360_torch.config import get_config

    conf = cell.config
    cfg = get_config(conf["preset"])
    groups: Dict[str, dict] = {}
    for key, value in conf.get("set", {}).items():
        group, field = key.split(".")
        groups.setdefault(group, {})[field] = value
    groups.setdefault("data", {})["base_dir"] = str(capture_dir)
    for group, fields in groups.items():
        cfg = dataclasses.replace(cfg, **{group: dataclasses.replace(
            getattr(cfg, group), **fields)})
    for group in ("model", "train", "data"):
        for key, want in conf[group].items():
            have = getattr(getattr(cfg, group), key)
            if have != want:
                raise ValueError(
                    f"{cell.name}: the program runs {group}.{key}={have!r}, "
                    f"the configuration file states {want!r}")
    return cfg


def card_line() -> dict:
    """Name and power limit of card 0 (nvidia-smi), or {} without one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    if not out:
        return {}
    name, _, limit = out[0].rpartition(",")
    return {"nvidia_smi_name": name.strip(), "power_limit": limit.strip()}


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, its
    relatives' or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_segment(drv, device) -> dict:
    """Run ``drv.segment()`` under ``torch.profiler`` and reduce it: the
    kernel table [(name, launches, seconds)], the union of the device's
    busy intervals, the wall time, and the idle gaps named by the innermost
    host operation running at their midpoint. Writes no trace file."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        w0 = time.perf_counter()
        work = drv.segment()
        _sync(device)
        wall = time.perf_counter() - w0
    dev, host = [], []
    for e in prof.events():
        span = (e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((e.name, *span))
        else:
            host.append((e.name, *span))
    table: Dict[str, list] = {}
    for name, a, b in dev:
        row = table.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += b - a
    kernels = [(n, c, s) for n, (c, s) in table.items()]
    intervals = [(a, b) for _, a, b in dev]
    busy = ys.union_s(intervals)
    longest = []
    if host:
        import numpy as np

        starts = np.array([a for _, a, _ in host])
        ends = np.array([b for _, _, b in host])
        gaps = ys.idle_gaps(intervals, float(starts.min()), float(ends.max()))
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP_OPS]:
            mid = 0.5 * (a + b)
            inside = np.flatnonzero((starts <= mid) & (ends >= mid))
            name = (host[inside[np.argmin(ends[inside] - starts[inside])]][0]
                    if inside.size else "no host operation")
            longest.append((name, b - a))
    top = sorted(kernels, key=lambda k: -k[2])[:TOP_OPS]
    return {
        "kernels": kernels, "busy_s": busy, "wall_s": wall, "work": work,
        "breakdown": {
            "device_ops": [[f"{ys.kernel_class(n)}: {n[:120]}", s]
                           for n, _, s in top],
            "idle_gaps": [[f"host in {n[:120]}", s] for n, s in longest]}}


def _memory(device):
    """(peak allocated bytes, peak reserved bytes) of the run."""
    import torch

    if device.type == "cuda":
        return (torch.cuda.max_memory_allocated(device),
                torch.cuda.max_memory_reserved(device))
    import resource

    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return rss, rss


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t0: float, root: Path = ROOT, log=None) -> dict:
    """Set up, measure, check; returns the result object of the last line
    (``checks`` last). ``t0``: the process's start on the host clock."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    cell = find_cell(name, root)
    cap_dir, write_s = capture.ensure(cell.config["capture"],
                                      cell.folder / ".cache")
    if write_s:
        log(f"capture {cell.config['capture']['name']} written in "
            f"{write_s:.3f} s (a file users have on disk: not in setup_s)")
    cfg = port_config(cell, cap_dir)
    drv = driver_class(cell)(cell, cfg, cap_dir, device)
    drv.start(seed)
    drv.warm()
    _sync(device)
    setup_s = time.perf_counter() - t0 - write_s
    measured, host = drv.window(seconds)
    segment = profile_segment(drv, device) if trace else None
    peak, reserved = _memory(device)
    attempted, failed = drv.attempted, drv.failed
    drv.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = drv.readings()

    checks = {key: {"value": readings[key], "limit": lim["limit"]}
              for key, lim in cell.limits.items()}
    correct = bool(checks) and failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": int(reserved)}
    if device.type == "cuda":
        dev_info.update(card_line())
    values = dict(measured, setup_s=setup_s, peak_mem_gib=peak / 2**30)
    out = {"correct": correct, "attempted": attempted, "failed": failed}
    if trace:
        summary = {"kind": drv.kind, "model": cell.config["model"],
                   "window": host, "segment": segment["work"],
                   "kernels": segment["kernels"], "busy_s": segment["busy_s"],
                   "wall_s": segment["wall_s"]}
        metrics = {}
        for m in cell.per_layer:
            v = reader(cell, m["name"])(summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info.update(busy_s=segment["busy_s"], window_s=segment["wall_s"])
        out.update(metrics=metrics, device=dev_info,
                   breakdown=segment["breakdown"])
    else:
        out.update(metrics={m["name"]: {"value": values[m["name"]],
                                        "unit": m["unit"]}
                            for m in cell.end_to_end},
                   device=dev_info)
    out["checks"] = checks
    return out
