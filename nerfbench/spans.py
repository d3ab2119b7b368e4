"""The port's spans, and the attribution of a traced segment to them.

The program opens the spans of :data:`SPANS` at its layer boundaries while a
``torch.profiler`` records (``mipnerf360_torch/utils/trace.py``). From the
profiler's events of one segment (:func:`events_of`), :func:`attribute` puts

- each device operation (kernel, copy, set) under the innermost span around
  the host operation that launched it: the operation whose correlation id
  the device operation's ``linked_correlation_id`` names, which is the
  innermost range open on the launching thread. Where that range is one
  the profiler does not list (the dispatch range inside a reduction), the
  innermost listed operation around the launch's runtime call. A copy or
  kernel of a thread the profiler does not record, such as the trainer's
  stager, is launched under none.
  The backward runs on the autograd engine's thread, outside the forward's
  spans: an operation under an ``autograd::engine::evaluate_function`` node
  goes through the node's ``sequence_nr`` and ``fwd_thread`` to the forward
  operation that made the node, and takes that operation's span. A span
  opened inside the backward (the recompute of a checkpointed MLP) comes
  first. Operations under no span are :data:`UNASSIGNED`;
- each host sync under the span of the operation that made it. A host sync
  is a synchronize call (:data:`SYNC_CALLS`), a ``cudaMemcpy``, or a
  ``cudaMemcpyAsync`` from pageable memory; the blocking calls of one
  operation (PyTorch's blocking copy is a ``cudaMemcpyAsync`` and a stream
  synchronize) count once. So do a blocking copy made under no recorded
  operation and a stream synchronize that is the next such blocking call.

:func:`name_gaps` names an idle gap of the device by the innermost host
operation at its midpoint, as the harness does, with that operation's span
in front (``host in [model.encode] aten::copy_``), or by the innermost span
open there when no operation runs (``host in [model.sample] no host
operation``).

The attribution lives here, beside the yardstick, so that a change to the
program cannot move it. ``python -m nerfbench.spans --workload <cell> --seed
<n>`` sets a cell up as a run does, traces the cell's segment as a
``--trace 1`` run does, and prints the split and the per-layer numbers as
one JSON line (on a card only). It stands in for the harness until
``harness.profile_segment`` calls :func:`attribute` and :func:`name_gaps`
itself; then ``report``, ``_traced`` and ``main`` go.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import yardstick as ys

# The span names the program opens (PERF.md §3 says what reads each).
SPANS = ("model.sample", "model.encode", "model.mlp", "model.composite",
         "step.losses", "step.adamw", "trainer.wait", "render.chunk",
         "render.upload")
UNASSIGNED = "unassigned"
BACKWARD = "autograd::engine::evaluate_function: "
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
# The profiler's own host events; one may carry an operation's id.
PROFILER_EVENTS = ("Activity Buffer Request", "Buffer Flush")


def events_of(prof) -> list:
    """The events of a finished ``torch.profiler.profile``, each with its
    ``linked_correlation_id``: for a device operation or a runtime call,
    the correlation id of the host operation it was launched or made under
    (0 for none, and for a host operation). Torch 2.13's events carry it;
    torch 2.11's take it from the profiler's Kineto events, which carry it
    by correlation id and name."""
    events = list(prof.events())
    if events and not hasattr(events[0], "linked_correlation_id"):
        link = {(k.correlation_id(), k.name()): k.linked_correlation_id()
                for k in prof.profiler.kineto_results.events()}
        for e in events:
            e.linked_correlation_id = link.get(
                (e.id, getattr(e, "trace_name", e.name)), 0)
    return events


def _is_host(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CPU


def _is_runtime(e) -> bool:
    """A CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...)."""
    return e.name.startswith("cu")


def _parents(host: Sequence) -> Dict[int, object]:
    """The innermost host operation (or span) around each host event, by
    time on its thread. A runtime call or a profiler event encloses
    nothing."""
    parent: Dict[int, object] = {}
    threads: Dict[int, list] = {}
    for e in host:
        threads.setdefault(e.thread, []).append(e)
    for evs in threads.values():
        stack: list = []
        for e in sorted(evs, key=lambda e: (e.time_range.start,
                                            -e.time_range.end)):
            while stack and not (stack[-1].time_range.start
                                 <= e.time_range.start
                                 and e.time_range.end
                                 <= stack[-1].time_range.end):
                stack.pop()
            if stack:
                parent[id(e)] = stack[-1]
            if not (_is_runtime(e) or e.name in PROFILER_EVENTS):
                stack.append(e)
    return parent


class _Spans:
    """The innermost span of the events of one segment."""

    def __init__(self, events: Sequence):
        host = [e for e in events if _is_host(e)]
        self.parent = _parents(host)
        self.ops = {e.id: e for e in host
                    if not _is_runtime(e) and e.name not in PROFILER_EVENTS}
        self.calls = {e.id: e for e in host if _is_runtime(e)}
        self.device = {e.id: e for e in events if not _is_host(e)}
        # An operation records its thread's next sequence number, and only
        # one that makes an autograd node moves it on: node n was made by
        # the last operation to record n.
        self.forward = {(e.sequence_nr, e.thread): e
                        for e in sorted(host, key=lambda e: e.time_range.start)
                        if e.sequence_nr >= 0 and not self.in_backward(e)}
        self.memo: Dict[int, str] = {}

    def in_backward(self, e) -> bool:
        """Whether ``e`` runs inside a node of the backward."""
        while e is not None:
            if e.name.startswith(BACKWARD):
                return True
            e = self.parent.get(id(e))
        return False

    def of(self, e, depth: int = 0) -> str:
        """The span of host operation ``e``."""
        if e is None or depth > 2:
            return UNASSIGNED
        if id(e) not in self.memo:
            found, node = UNASSIGNED, e
            while node is not None:
                if node.name in SPANS:
                    found = node.name
                    break
                if node.name.startswith(BACKWARD):
                    found = self.of(self.forward.get(
                        (node.sequence_nr, node.fwd_thread)), depth + 1)
                    break
                node = self.parent.get(id(node))
            self.memo[id(e)] = found
        return self.memo[id(e)]

    def launcher(self, e):
        """The host operation a device operation or runtime call ``e`` was
        launched or made under; None for none."""
        if not e.linked_correlation_id:
            return None
        op = self.ops.get(e.linked_correlation_id)
        if op is None:
            op = self.parent.get(id(self.calls.get(e.id, e)))
        return op


def _row() -> dict:
    return {"gemm_s": 0.0, "composite_s": 0.0, "other_s": 0.0, "launches": 0,
            "syncs": 0}


def _syncs(spans: _Spans) -> List[str]:
    """The span of each host sync of the segment."""
    def blocking(call) -> bool:
        copied = spans.device.get(call.id)
        return call.name in SYNC_CALLS or call.name == "cudaMemcpy" or (
            call.name == "cudaMemcpyAsync" and copied is not None
            and "Pageable" in copied.name)

    seen, out, prev = set(), [], None
    for call in sorted(spans.calls.values(), key=lambda c: c.id):
        if not blocking(call):
            continue
        op = spans.launcher(call)
        if op is None:
            if not (call.name == "cudaStreamSynchronize" and prev is not None
                    and prev.name.startswith("cudaMemcpy")):
                out.append(UNASSIGNED)
            prev = call
        elif op.id not in seen:
            seen.add(op.id)
            out.append(spans.of(op))
    return out


def attribute(events: Iterable) -> dict:
    """The split of one traced segment (events as :func:`events_of` gives
    them): ``spans``, per span of :data:`SPANS` that holds any work (and
    :data:`UNASSIGNED`), the device seconds of its GEMM, K1/K2 and other
    operations (``yardstick.kernel_class``), its launches and its host
    syncs; ``syncs``, all the host syncs; ``busy_s`` and
    ``assigned_busy_s``, the union of all device operations and of those
    under a span; ``unassigned_ops``, the device seconds of each operation
    name under no span, largest first."""
    events = list(events)
    spans = _Spans(events)
    rows: Dict[str, dict] = {}
    column = {ys.GEMM: "gemm_s", ys.K1: "composite_s", ys.K2: "composite_s",
              ys.OTHER: "other_s"}
    intervals, assigned, loose = [], [], {}
    for d in spans.device.values():
        name = spans.of(spans.launcher(d))
        row = rows.setdefault(name, _row())
        a, b = d.time_range.start / 1e6, d.time_range.end / 1e6
        row[column[ys.kernel_class(d.name)]] += b - a
        row["launches"] += 1
        intervals.append((a, b))
        if name != UNASSIGNED:
            assigned.append((a, b))
        else:
            loose[d.name] = loose.get(d.name, 0.0) + b - a
    syncs = _syncs(spans)
    for name in syncs:
        rows.setdefault(name, _row())["syncs"] += 1
    return {"spans": rows, "syncs": len(syncs),
            "busy_s": ys.union_s(intervals),
            "assigned_busy_s": ys.union_s(assigned),
            "unassigned_ops": sorted(loose.items(), key=lambda r: -r[1])}


def name_gaps(events: Iterable, gaps: Sequence[Tuple[float, float]]
              ) -> List[str]:
    """The name of each gap [a, b) (seconds on the profiler's clock)."""
    events = list(events)
    host = [e for e in events if _is_host(e)]
    spans = _Spans(events)

    def innermost(evs, t):
        inside = [e for e in evs
                  if e.time_range.start / 1e6 <= t <= e.time_range.end / 1e6]
        return min(inside, key=lambda e: e.time_range.elapsed_us(),
                   default=None)

    ops = [e for e in host if e.name not in SPANS]
    opened = [e for e in host if e.name in SPANS]
    names = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        op = innermost(ops, mid)
        if op is not None:
            span = spans.of(spans.launcher(op) if _is_runtime(op) else op)
            what = op.name
        else:
            where = innermost(opened, mid)
            span = where.name if where is not None else UNASSIGNED
            what = "no host operation"
        names.append(f"host in {what}" if span == UNASSIGNED
                     else f"host in [{span}] {what}")
    return names


def _device_s(rows: dict, name: str, gemm: bool = True) -> float:
    """Device seconds under span ``name``; without its GEMMs when not
    ``gemm``."""
    row = rows.get(name, _row())
    return row["composite_s"] + row["other_s"] + (row["gemm_s"] if gemm else 0)


def per_layer(summary: dict) -> Dict[str, float]:
    """The per-layer numbers of a traced segment from a summary that holds
    :func:`attribute`'s ``spans`` and ``syncs`` beside the harness's
    ``kind`` and ``segment`` (the work of ``drivers/<mix>.py``): ms of
    device time per step or view under a span, the MLPs' time outside their
    GEMMs (the epilogue), host syncs per step or view. Empty without
    ``spans``."""
    if "spans" not in summary:
        return {}
    rows, work = summary["spans"], summary["segment"]
    if summary["kind"] == "train":
        n, tag, names = work["steps"], "per_step.train", (
            ("encode", "model.encode"), ("sampling", "model.sample"),
            ("losses", "step.losses"), ("adamw", "step.adamw"))
    else:
        n, tag, names = work["views"], "per_view.render", (
            ("encode", "model.encode"), ("sampling", "model.sample"))
    out = {f"{k}_ms_{tag}": 1e3 * _device_s(rows, s) / n for k, s in names}
    out[f"epilogue_ms_{tag}"] = 1e3 * _device_s(rows, "model.mlp", False) / n
    out[f"syncs_{tag}"] = summary["syncs"] / n
    return out


def assigned_shares(split: dict) -> Dict[str, Optional[float]]:
    """Shares of the segment under a span, in %: of the device time of the
    operations classed other (``yardstick.OTHER``) and of the device's busy
    time."""
    rows = split["spans"].items()
    other = sum(r["other_s"] for _, r in rows)
    under = sum(r["other_s"] for name, r in rows if name != UNASSIGNED)
    return {"other_pct": 100.0 * under / other if other else None,
            "busy_pct": (100.0 * split["assigned_busy_s"] / split["busy_s"]
                         if split["busy_s"] else None)}


def report(kind: str, events: Sequence, work: dict, wall: float,
           top: int = 10) -> dict:
    """The split of one segment of ``kind`` doing ``work`` in ``wall``
    seconds, and the numbers read from it."""
    split = attribute(events)
    summary = {"kind": kind, "segment": work, "spans": split["spans"],
               "syncs": split["syncs"]}
    return {
        "work": work, "wall_s": wall,
        "per_layer": per_layer(summary),
        "shares": assigned_shares(split),
        "spans": split["spans"], "syncs": split["syncs"],
        "busy_s": split["busy_s"], "assigned_busy_s": split["assigned_busy_s"],
        "unassigned_ops": [[n[:100], s]
                           for n, s in split["unassigned_ops"][:top]]}


def _traced(drv, device):
    """``drv.segment()`` under ``torch.profiler`` as
    ``harness.profile_segment`` runs it: (events, work, wall seconds)."""
    from torch.profiler import ProfilerActivity, profile

    from .harness import _sync

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        w0 = time.perf_counter()
        work = drv.segment()
        _sync(device)
        wall = time.perf_counter() - w0
    return events_of(prof), work, wall


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from . import capture, harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("nerfbench.spans: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    cell = harness.find_cell(args.workload)
    cap_dir, _ = capture.ensure(cell.config["capture"], cell.folder / ".cache")
    cfg = harness.port_config(cell, cap_dir)
    drv = harness.driver_class(cell)(cell, cfg, cap_dir, device)
    drv.start(args.seed)
    drv.warm()
    events, work, wall = _traced(drv, device)
    drv.release()
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": torch.cuda.get_device_name(device),
                      **harness.card_line(),
                      **report(drv.kind, events, work, wall, harness.TOP_OPS)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
