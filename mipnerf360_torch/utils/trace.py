"""Named spans at the port's layer boundaries, for ``torch.profiler``.

``span(name)`` opens a profiler range only while a profiler records on the
calling thread; otherwise it returns one shared no-op context. With tracing
off a span costs one flag check (an unguarded range costs several
microseconds an enter and exit even with no profiler running). Tracing is on
exactly when a ``torch.profiler`` records: the trainer's
``train.profile_dir`` window, or a benchmark's traced segment.

The ranges are function-scope ``RecordFunction`` events
(``torch._C._profiler._RecordFunctionFast``), on the profiler's clock with
the CUDA kernels and copies they launch, and linked to them through the
profiler's correlation ids. ``torch.profiler.record_function`` is not used:
its user-scope ranges also leave a device-side copy of each range among the
profiler's CUDA events, which a reader summing device events would count as
device time.

Both are private names of torch, checked on torch 2.11 (CUDA) and 2.13
(CPU). Where a torch lacks either, the span falls back to the public
``torch.autograd.profiler._is_profiler_enabled`` flag and
``torch.profiler.record_function``, whose device-side copies a reader
would then have to leave out.

The span names are a contract with the readers of a trace; the list, and
what reads each, is ``nerfbench/spans.py::SPANS``.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_recording = getattr(torch._C._autograd, "_profiler_enabled", None) or (
    lambda: torch.autograd.profiler._is_profiler_enabled)
_range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


def span(name: str):
    """A profiler range named ``name`` while a profiler records on this
    thread, else a shared no-op context. Changes no value."""
    if _recording():
        return _range(name)
    return _OFF
