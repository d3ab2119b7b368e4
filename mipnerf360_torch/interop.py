"""Params and train state between the JAX package's trees and this port.

Both keep the layout ``{"prop": {"layers": [{"w": [in, out], "b": [out]}]},
"nerf": {"trunk"|"density"|"rgb": {"layers": [...]}}}``, so the conversion is
the identity on every array. Only NumPy crosses the boundary: the JAX side
calls ``jax.tree.map(np.asarray, params)`` itself, and this module imports
no JAX. :func:`read_jax_checkpoint` reads the JAX package's checkpoint files
(flax msgpack) with a decoder of its own, so that neither ``flax`` nor
``msgpack`` is needed.
"""
from __future__ import annotations

import struct
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from .core.rays import resolve_device
from .models.mipnerf360 import MipNeRF360, Params, map_params
from .train.state import AdamState, TrainState, make_train_state


def params_from_jax(tree) -> Params:
    """A tree of NumPy arrays (the JAX params) -> the same tree of float32
    CPU tensors, as ``init_model`` returns."""
    return map_params(
        lambda a: torch.tensor(np.asarray(a, dtype=np.float32)), tree)


def params_to_numpy(params) -> dict:
    """A :class:`MipNeRF360` module or a params tree -> the same tree of
    float32 NumPy arrays, as ``jax.tree.map(np.asarray, params)`` gives."""
    if isinstance(params, nn.Module):
        if not isinstance(params, MipNeRF360):
            raise TypeError(f"expected a MipNeRF360 module, got {type(params)}")
        params = params.params()
    return map_params(
        lambda t: t.detach().to("cpu", torch.float32).numpy().copy(), params)


def _adam_state(chain_state):
    """The ``ScaleByAdamState(count, mu, nu)`` of an optax chain's state (a
    tuple of per-transform states)."""
    for s in chain_state:
        if all(hasattr(s, a) for a in ("count", "mu", "nu")):
            return s
    raise ValueError("no ScaleByAdamState (count, mu, nu) in the optimizer "
                     f"state {type(chain_state).__name__}")


def train_state_from_jax(tree, *, device="cuda",
                         generator: torch.Generator = None) -> TrainState:
    """A JAX ``TrainState`` as NumPy arrays (``jax.tree.map(np.asarray,
    state)``) -> the port's :class:`TrainState` on ``device`` (the card
    unless the caller passes ``device="cpu"``), so that a JAX run can be
    continued here: params, ``step``, ``sched_count``, and each subtree's
    Adam count and moments.

    The PRNG key does not carry over: ``jax.random`` and ``torch`` draw
    different numbers. The state's generator is ``generator``, or a new one
    on ``device`` seeded with 0; pass explicit noise to a step to continue
    on the JAX draws.
    """
    device = resolve_device(device)
    params = params_from_jax(tree.params)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    state = make_train_state(params, device=device, generator=generator,
                             step=int(tree.step),
                             sched_count=int(tree.sched_count))

    def to_device(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    for k in ("prop", "nerf"):
        adam = _adam_state(tree.opt_state[k])
        state.opt_state[k] = AdamState(count=int(adam.count),
                                       mu=map_params(to_device, adam.mu),
                                       nu=map_params(to_device, adam.nu))
    return state


def train_state_to_numpy_tree(state: TrainState) -> "JaxTrainState":
    """The port's :class:`TrainState` -> the tree of NumPy arrays that
    ``jax.tree.map(np.asarray, state)`` gives for the JAX package's
    ``TrainState`` (the inverse of :func:`train_state_from_jax`): int32
    ``step`` and ``sched_count``, float32 params, and each subtree's optax
    chain state ``(ScaleByAdamState(count, mu, nu), EmptyState())``.

    ``key`` is None: a torch generator has no ``jax.random`` key, so the
    caller that builds the JAX state supplies one."""
    def chain(a: AdamState) -> tuple:
        return (ScaleByAdamState(count=np.asarray(a.count, np.int32),
                                 mu=params_to_numpy(a.mu),
                                 nu=params_to_numpy(a.nu)), EmptyState())

    return JaxTrainState(step=np.asarray(state.step, np.int32),
                         sched_count=np.asarray(state.sched_count, np.int32),
                         params=params_to_numpy(state.params),
                         opt_state={k: chain(a)
                                    for k, a in state.opt_state.items()},
                         key=None)


# --- the JAX package's checkpoints (flax msgpack) ---------------------------

class JaxTrainState(NamedTuple):
    """``mipnerf360_tpu.train.state.TrainState`` as read from a checkpoint."""

    step: Any
    sched_count: Any
    params: Any
    opt_state: Any
    key: Any


class ScaleByAdamState(NamedTuple):
    """optax's ``ScaleByAdamState``."""

    count: Any
    mu: Any
    nu: Any


class EmptyState(NamedTuple):
    """optax's ``EmptyState`` (the ``add_decayed_weights`` state)."""


# flax's msgpack extension types
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
# msgpack type bytes: those followed by a big-endian length (struct format)
# of bin, str, array or map; fixed-size scalars; ext with a fixed payload
# size or a length
_SIZED = {0xC4: ("B", bytes), 0xC5: ("H", bytes), 0xC6: ("I", bytes),
          0xD9: ("B", str), 0xDA: ("H", str), 0xDB: ("I", str),
          0xDC: ("H", list), 0xDD: ("I", list),
          0xDE: ("H", dict), 0xDF: ("I", dict)}
_SCALARS = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
            0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_EXT = {0xC7: "B", 0xC8: "H", 0xC9: "I"}


def _ndarray(payload: bytes) -> np.ndarray:
    """flax's array payload: a msgpack ``(shape, dtype name, raw bytes)``,
    row-major."""
    shape, dtype, raw = unpackb(payload)
    return np.frombuffer(raw, np.dtype(dtype)).reshape(shape).copy()


class _Reader:
    """A msgpack decoder over one buffer: nil, bool, ints, floats, str, bin,
    arrays, maps, and flax's ext types 1 (ndarray) and 3 (NumPy scalar)."""

    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _SIZED:
            fmt, kind = _SIZED[b]
            n = self.unpack(fmt)
            if kind is bytes:
                return self.take(n)
            if kind is str:
                return self.take(n).decode("utf-8")
            return self.array(n) if kind is list else self.map(n)
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _EXT:
            return self.ext(self.unpack(_EXT[b]))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        payload = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        raise ValueError(f"msgpack ext type {code} is not supported")


def unpackb(data: bytes):
    """Decode one msgpack object, as ``msgpack.unpackb(data, raw=False)``
    with flax's ext hook: maps become dicts, arrays lists, str str, bin
    bytes; ext type 1 an ndarray, ext type 3 a NumPy scalar."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         "msgpack object")
    return out


def _lists(tree):
    """flax writes a list or tuple as a map keyed "0", "1", ...: undo it."""
    if not isinstance(tree, dict):
        return tree
    if tree and set(tree) == {str(i) for i in range(len(tree))}:
        return [_lists(tree[str(i)]) for i in range(len(tree))]
    return {k: _lists(v) for k, v in tree.items()}


def _opt_state(chain: list) -> tuple:
    """An optax chain's state: (ScaleByAdamState, EmptyState)."""
    out = []
    for s in chain:
        if isinstance(s, dict) and set(s) == {"count", "mu", "nu"}:
            out.append(ScaleByAdamState(**s))
        elif s == {}:
            out.append(EmptyState())
        else:
            raise ValueError(f"unexpected optimizer state entry {s!r:.80}")
    return tuple(out)


def read_jax_checkpoint(path: str) -> JaxTrainState:
    """A ``ckpt_<step>.msgpack`` written by the JAX package's
    ``save_checkpoint`` -> the tree ``jax.tree.map(np.asarray, state)`` gives
    for the state it saved: a :class:`JaxTrainState` of NumPy arrays, whose
    ``opt_state`` maps each subtree to ``(ScaleByAdamState, EmptyState)``.
    Feed it to :func:`train_state_from_jax`."""
    with open(path, "rb") as f:
        tree = _lists(unpackb(f.read()))
    if not isinstance(tree, dict) or set(tree) != set(JaxTrainState._fields):
        raise ValueError(f"{path}: not a mipnerf360_tpu TrainState checkpoint")
    tree["opt_state"] = {k: _opt_state(v)
                         for k, v in tree["opt_state"].items()}
    return JaxTrainState(**tree)
