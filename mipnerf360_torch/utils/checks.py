"""Numerical-health guards: non-finite detection over a tree of tensors,
and a debug wrapper that names the op where a NaN first appears
(counterpart of ``mipnerf360_tpu/utils/checks.py``).

A tree is nested dicts, lists and tuples; only its floating tensors are
inspected. The renderer intentionally produces transient NaNs that it
sanitizes at once (distance = sum(w*t)/acc with acc == 0,
``core/rendering.py``), so the guards look at the training state and its
metrics, not inside the forward; :func:`checkify_fn` flags that benign site
too, as the JAX package's does, and is for localizing a real divergence.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def _leaves_with_paths(tree, path: str = "") -> Iterator[Tuple[str, object]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)
        for i, v in enumerate(tree):
            key = f".{fields[i]}" if fields else f"[{i}]"
            yield from _leaves_with_paths(v, path + key)
    else:
        yield path, tree


def _float_leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    return [(path, t) for path, t in _leaves_with_paths(tree)
            if torch.is_tensor(t) and t.is_floating_point()]


def count_nonfinite(tree) -> torch.Tensor:
    """Total count of non-finite (NaN/Inf) scalars across a tree, as a 0-d
    int64 tensor on the device of the first floating leaf. One reduction per
    leaf and no host sync: cheap enough to run every step."""
    leaves = [t for _, t in _float_leaves(tree)]
    if not leaves:
        return torch.zeros((), dtype=torch.int64)
    device = leaves[0].device
    counts = [torch.count_nonzero(~torch.isfinite(t.detach())).to(device)
              for t in leaves]
    return torch.stack(counts).sum()


def first_nonfinite_paths(tree, max_report: int = 8) -> List[str]:
    """Host-side: names of (at most ``max_report``) leaves containing
    non-finite values, for the message after :func:`count_nonfinite`
    fires."""
    bad = []
    for path, t in _float_leaves(tree):
        n = int(torch.count_nonzero(~torch.isfinite(t.detach())))
        if n:
            bad.append(f"{path}: {n} non-finite")
            if len(bad) >= max_report:
                break
    return bad


class NonFiniteError(RuntimeError):
    pass


def assert_tree_finite(tree, context: str = ""):
    """Host-sync check: raise :class:`NonFiniteError` naming the bad leaves."""
    if int(count_nonfinite(tree)):
        detail = "; ".join(first_nonfinite_paths(tree))
        raise NonFiniteError(f"non-finite values {context}: {detail}")


# Ops whose divisor is checked for zeros, as checkify's div_checks do.
_DIVISIONS = {"div", "div_", "reciprocal", "reciprocal_", "remainder",
              "remainder_", "fmod", "fmod_", "floor_divide", "floor_divide_"}


class _FloatChecks(TorchDispatchMode):
    """Runs every op and raises :class:`NonFiniteError` on the first that
    divides by zero or returns a NaN, naming the op."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in _DIVISIONS:
            divisor = args[0] if name.startswith("reciprocal") else args[1]
            if (divisor == 0) is True or (torch.is_tensor(divisor)
                                          and bool((divisor == 0).any())):
                raise NonFiniteError(f"division by zero in {func}")
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if (torch.is_tensor(t) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise NonFiniteError(f"nan generated by {func}")
        return out


def checkify_fn(fn):
    """Wrap ``fn`` for debugging: ``wrapped(*args, **kwargs)`` runs ``fn``
    and raises :class:`NonFiniteError` at the FIRST op inside it that
    returns a NaN or divides by zero (the source of a division's Inf),
    naming the op, as the JAX package's checkify ``float_checks`` do; an
    Inf from overflow passes, as there. Otherwise it returns ``fn``'s
    output. Each op's output is read on the host, so this is a debug tool,
    not for the hot loop; out-of-range indices raise in PyTorch itself."""

    def wrapped(*args, **kwargs):
        with _FloatChecks():
            return fn(*args, **kwargs)

    return wrapped
