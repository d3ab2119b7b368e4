"""The yardstick: the card's peaks, the work a cell needs (MLP FLOPs and the
composite kernels' bytes, from shapes), the kernel classes and the device's
busy intervals.

Every count here is worked out from the configuration's numbers, never
from the program, so that a change to the program cannot move the
yardstick. The arithmetic is that of the port's ``chip_smoke.py``
(``_mlp_flops_per_sample``, ``_k1_bound_ms``, ``_k2_bound_ms``,
``_kernel_class``), frozen here.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM, data sheet, dense, at the 700 W limit.
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def input_dim(model: dict) -> int:
    """Width of the encoded samples: 42 IPE features per frequency scale and
    4 view-direction features per scale."""
    return (42 * (model["ipe_max_deg"] - model["ipe_min_deg"])
            + 4 * (model["viewdir_max_deg"] - model["viewdir_min_deg"]))


def mlp_towers(model: dict) -> List[Tuple[str, List[int], bool]]:
    """(name, layer sizes [in, ..., out], input needs a gradient) of the
    four MLP stacks, in the order the model runs them."""
    d, hp, hn = input_dim(model), model["hidden_proposal"], model["hidden_nerf"]
    return [("prop", [d] + [hp] * model["proposal_depth"] + [1], False),
            ("trunk", [d] + [hn] * model["nerf_depth"], False),
            ("density", [hn, 1], True),
            ("rgb", [hn, 3], True)]


def mlp_flops_per_sample(model: dict) -> Tuple[int, int]:
    """GEMM FLOPs per sample of both levels' MLPs: forward, 2 * in * out per
    layer; backward, dW for every layer and dX for every layer whose input
    needs a gradient (all but the first layers of the proposal MLP and the
    trunk, whose input is the encoded rays)."""
    fwd = bwd = 0
    for _, sizes, input_needs_grad in mlp_towers(model):
        for i in range(len(sizes) - 1):
            gemm = 2 * sizes[i] * sizes[i + 1]
            fwd += gemm
            bwd += gemm * (2 if i > 0 or input_needs_grad else 1)
    return fwd, bwd


def flops_per_ray(model: dict, train: bool) -> int:
    """MLP FLOPs one ray needs: each level runs its MLP on ``num_samples``
    samples (the proposal MLP on the proposal level's, the NeRF MLPs on the
    resampled ones), so the sum per sample times ``num_samples``."""
    fwd, bwd = mlp_flops_per_sample(model)
    return model["num_samples"] * (fwd + (bwd if train else 0))


def bound_s(nbytes: float, flops: float) -> Tuple[float, str]:
    """Least time for the work: the larger of bytes at the HBM peak and
    float32 operations at the non-tensor-core peak, and which bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound_s(b: int, n: int) -> float:
    """Least time for the composite forward K1 at [b, n]: density, t_vals
    and dirs read once, the weights written once; ~8 float32 operations per
    sample beside the bytes."""
    nbytes = 4 * (b * n + b * (n + 1) + 3 * b) + 4 * b * n
    return bound_s(nbytes, 8 * b * n + 5 * b)[0]


def k2_bound_s(b: int, n: int) -> float:
    """Least time for the composite backward K2 at [b, n]: density, t_vals,
    dirs and the cotangent read once, d_density written once; ~16 float32
    operations per sample."""
    nbytes = 4 * (b * n + b * (n + 1) + 3 * b + b * n) + 4 * b * n
    return bound_s(nbytes, 16 * b * n + 5 * b)[0]


K1, K2 = "K1 composite", "K2 composite backward"
GEMM, OTHER = "matmul (cuBLAS)", "other (elementwise, reductions, copies)"


def kernel_class(name: str) -> str:
    """The class of a device operation, by its name."""
    if "composite_fwd" in name:
        return K1
    if "composite_bwd" in name:
        return K2
    if any(s in name.lower() for s in ("gemm", "nvjet", "cutlass", "sm90_xmma")):
        return GEMM
    return OTHER


def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in sorted(intervals):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def idle_gaps(intervals: Iterable[Tuple[float, float]], lo: float,
              hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    gaps, cursor = [], lo
    for a, b in sorted(intervals):
        if a > cursor:
            gaps.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    return [(a, b) for a, b in gaps if b > a]


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile with linear interpolation between order
    statistics (NumPy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    i = math.floor(pos)
    j = min(i + 1, len(xs) - 1)
    return xs[i] + (xs[j] - xs[i]) * (pos - i)


def class_seconds(kernels: Sequence[Tuple[str, int, float]]) -> Dict[str, float]:
    """Device seconds by class from a kernel table of (name, launches,
    seconds)."""
    out: Dict[str, float] = {}
    for name, _, sec in kernels:
        cls = kernel_class(name)
        out[cls] = out.get(cls, 0.0) + sec
    return out


def class_launches(kernels: Sequence[Tuple[str, int, float]]) -> Dict[str, int]:
    """Launches by class from a kernel table of (name, launches, seconds)."""
    out: Dict[str, int] = {}
    for name, count, _ in kernels:
        cls = kernel_class(name)
        out[cls] = out.get(cls, 0) + count
    return out
