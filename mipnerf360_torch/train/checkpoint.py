"""Checkpoint save/restore with exact resume (counterpart of
``mipnerf360_tpu/train/checkpoint.py``).

The directory layout is the JAX package's: ``ckpt_<step>`` files pruned to
the newest ``keep``, ``ckpt_best`` (never pruned), ``manifest.json`` (read,
modified, written) and the trainer's ``config.json`` beside them. The port's
payload is ``torch.save`` of :func:`train.state.state_dict` in
``ckpt_<step>.pt``, written through a tmp file and a rename;
:func:`restore_checkpoint` loads it with ``torch.load(...,
weights_only=True)``, or reads the JAX package's ``ckpt_<step>.msgpack``
(``interop.read_jax_checkpoint``) where no ``.pt`` of that step exists.
Under a process group only global rank 0 writes (a tensor-parallel run
hands it the gathered state, ``parallel.mesh.gather_state``); every rank
reads.
"""
from __future__ import annotations

import io
import json
import os
import re
from typing import Optional

import torch

from ..models.mipnerf360 import map_params
from ..parallel.mesh import is_primary
from .state import TrainState, leaves, load_state_dict, state_dict

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.(pt|msgpack)$")


def _map_tensors(fn, sd: dict) -> dict:
    """A state dict with ``fn`` applied to its params and moments."""
    return {**sd, "params": map_params(fn, sd["params"]),
            "opt_state": {k: {**a, "mu": map_params(fn, a["mu"]),
                              "nu": map_params(fn, a["nu"])}
                          for k, a in sd["opt_state"].items()}}


class AsyncCheckpointer:
    """Non-blocking checkpoint writes.

    ``save()`` copies the state on its device (``clone()``) before it
    returns, then hands the transfer to the host, the serialization and the
    atomic write to a single worker thread. The copy is what makes the
    checkpoint right: the train step updates params and moments in place, so
    a snapshot that only held references would be written torn by the steps
    that follow. At most one write is in flight; a second ``save`` first
    drains the previous one. Call ``wait()`` or ``close()`` before process
    exit or the final synchronous save.
    """

    def __init__(self):
        import concurrent.futures

        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt")
        self._pending = None

    def save(self, ckpt_dir: str, state: TrainState, keep: int = 3,
             name: Optional[str] = None, manifest_extra: Optional[dict] = None):
        if not is_primary():
            return
        snap = _map_tensors(torch.Tensor.clone, state_dict(state))
        self.wait()
        self._pending = self._pool.submit(
            _write, ckpt_dir, snap, keep, name, manifest_extra)

    def wait(self):
        """Drain the in-flight write (re-raises its exception, if any)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self):
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)


def save_checkpoint(ckpt_dir: str, state: TrainState, keep: int = 3,
                    name: Optional[str] = None,
                    manifest_extra: Optional[dict] = None) -> str:
    """Write the state; prune to the newest ``keep`` numbered checkpoints.

    ``name`` overrides the step-derived filename (e.g. "best" ->
    ckpt_best.pt, which the numeric pruner never touches); restore it with
    ``restore_checkpoint(..., step="best")``. ``manifest_extra`` keys are
    merged into manifest.json (read-modify-write, so a "best" save records
    best_step without clobbering latest_step). Off global rank 0 it writes
    nothing and returns the path rank 0 writes."""
    if not is_primary():
        return os.path.join(ckpt_dir, f"ckpt_{name if name else state.step}.pt")
    return _write(ckpt_dir, state_dict(state), keep, name, manifest_extra)


def _write(ckpt_dir: str, sd: dict, keep: int, name: Optional[str],
           manifest_extra: Optional[dict]) -> str:
    step = sd["step"]
    path = os.path.join(ckpt_dir, f"ckpt_{name if name else step}.pt")
    os.makedirs(ckpt_dir, exist_ok=True)
    buf = io.BytesIO()
    torch.save(_map_tensors(torch.Tensor.cpu, sd), buf)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)
    manifest_path = os.path.join(ckpt_dir, "manifest.json")
    manifest = {}
    if os.path.exists(manifest_path):
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError):
            manifest = {}
    manifest["latest_step" if name is None else f"{name}_step"] = step
    manifest.update(manifest_extra or {})
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)
    if name is None:
        _prune(ckpt_dir, keep)
    return path


def _prune(ckpt_dir: str, keep: int):
    """Remove all but the newest ``keep`` of this package's numbered
    checkpoints (``.pt``); JAX checkpoints in the directory are left alone."""
    steps = sorted(int(m.group(1)) for m in map(_CKPT_RE.match,
                                                os.listdir(ckpt_dir))
                   if m and m.group(2) == "pt")
    for s in steps[:-keep] if keep > 0 else []:
        try:
            os.remove(os.path.join(ckpt_dir, f"ckpt_{s}.pt"))
        except OSError:
            pass


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    """The newest numbered checkpoint's step, of this package (``.pt``) or of
    the JAX package (``.msgpack``); None when there is none."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1))
             for m in map(_CKPT_RE.match, os.listdir(ckpt_dir)) if m]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, template: TrainState,
                       step=None) -> TrainState:
    """Restore into ``template`` (from ``init_train_state``, on the device
    to restore onto), in place, and return it.

    ``step``: None = latest numbered checkpoint; an int = that step; a name
    string (e.g. "best") = the correspondingly named checkpoint. The port's
    ``.pt`` is read when it exists, else the JAX package's ``.msgpack`` of
    that step; from the latter the template keeps its generator, as
    ``jax.random`` keys do not carry over."""
    if step is None:
        step = latest_checkpoint_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    device = leaves(template.params)[0].device
    path = os.path.join(ckpt_dir, f"ckpt_{step}.pt")
    if os.path.exists(path):
        sd = torch.load(path, weights_only=True, map_location=device)
        return load_state_dict(template, sd)
    jax_path = os.path.join(ckpt_dir, f"ckpt_{step}.msgpack")
    if not os.path.exists(jax_path):
        raise FileNotFoundError(f"no checkpoint ckpt_{step}.pt or "
                                f"ckpt_{step}.msgpack in {ckpt_dir}")
    from ..interop import read_jax_checkpoint, train_state_from_jax

    from_jax = train_state_from_jax(read_jax_checkpoint(jax_path),
                                    device=device,
                                    generator=template.generator)
    return load_state_dict(template, state_dict(from_jax))
