"""Numerical-health guards: non-finite detection over a tree of tensors
(counterpart of ``mipnerf360_tpu/utils/checks.py``).

A tree is nested dicts, lists and tuples; only its floating tensors are
inspected. The renderer intentionally produces transient NaNs that it
sanitizes at once (distance = sum(w*t)/acc with acc == 0), so the guards
look at the training state and its metrics, not inside the forward. The JAX package's ``checkify_fn`` has no
counterpart here yet.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import torch


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
