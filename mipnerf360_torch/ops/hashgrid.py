"""H1 and H2: Zip-NeRF's hash-grid encode for Hopper, forward and
backward, with their plain versions.

They replace no TPU kernel: the JAX package has no grid layout. Both are in
``csrc/hashgrid.cu``, whose note gives their design.

- H1, the forward of :func:`encode_grid`: a sampling level's whole MLP
  input [..., N, levels x features] from the ray intervals ``t_vals``
  [..., N+1]: each interval's ``MULTISAMPLES`` points
  (``core/gaussians.py::multisample_cast``), contracted with their
  isotropic scales (``core/contract.py::contract_isotropic``), looked up in
  every level of the table, downweighted and averaged over the points
  (``core/hashgrid.py``); written once in ``dtype``, the MLP's compute
  dtype.
- H2, its backward: the table's gradient, g omega w / MULTISAMPLES
  scattered into each corner's entry with atomic adds (one vector add an
  entry of 4 features). The positions take no gradient: the intervals are
  resampled under stop-gradient.

A CPU tensor takes the plain version: the same arithmetic in float32
composed of PyTorch operations, its backward by ``index_add_``. A CUDA
tensor launches the kernels; an input they do not take raises, and nothing
falls back to the plain version. ``launches`` counts each kernel's calls.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.contract import contract_isotropic
from ..core.gaussians import MULTISAMPLES, multisample_cast
from ..core.hashgrid import (GridSpec, plain_features, plain_table_grad,
                             unit_points)
from . import _build
from .encode import _check_dtype, _rows

# The kernels' bounds (csrc/hashgrid.cu kMaxLevels, kMaxWidth, kFeatures).
MAX_LEVELS, MAX_WIDTH, FEATURES = 16, 64, (1, 2, 4, 8)

# Calls of each kernel in this process. Only the lines that launch a kernel
# add to them, so a run can show that its path went through H1 and H2.
launches = {"H1": 0, "H2": 0}


def _lib() -> ctypes.CDLL:
    lib = _build.load("hashgrid")
    if lib.hashgrid_forward_launch.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        ins = [ptr, i64] * 6
        grid = [ptr, i32, i32, ptr, ptr, i32]
        lib.hashgrid_forward_launch.argtypes = ins + grid + [
            ptr, i32, i64, i32, ptr]
        lib.hashgrid_backward_launch.argtypes = ins + grid + [
            ptr, i64, i32, i64, i32, ptr]
        for fn in (lib.hashgrid_forward_launch, lib.hashgrid_backward_launch):
            fn.restype = ctypes.c_int
        lib.hashgrid_error_string.argtypes = [ctypes.c_int]
        lib.hashgrid_error_string.restype = ctypes.c_char_p
    return lib


def plain_points(t_vals, origins, directions, radii, turn=None, mirror=None):
    """The plain version's points: unit-cube positions [P, 3] and stds [P],
    ``MULTISAMPLES`` a sample, samples in row-major order."""
    means, stds = multisample_cast(t_vals, origins, directions, radii, turn,
                                   mirror)
    pos, su = unit_points(*contract_isotropic(means, stds))
    return pos.reshape(-1, 3), su.reshape(-1)


def _check(spec: GridSpec, table) -> None:
    if not 1 <= len(spec.resolutions) <= MAX_LEVELS \
            or spec.features not in FEATURES or spec.width > MAX_WIDTH:
        raise ValueError(f"the grid kernels take 1-{MAX_LEVELS} levels of "
                         f"{FEATURES} features, at most {MAX_WIDTH} in all; "
                         f"got {len(spec.resolutions)} x {spec.features}")
    if table.dtype != torch.float32 or not table.is_contiguous() \
            or tuple(table.shape) != (spec.entries, spec.features):
        raise ValueError(f"the table must be a contiguous float32 "
                         f"[{spec.entries}, {spec.features}], got "
                         f"{table.dtype} {tuple(table.shape)}")


def _kernel_args(t_vals, origins, directions, radii, turn, mirror, table,
                 spec: GridSpec):
    """(launch arguments of the inputs and the grid, rays, samples, lead)."""
    device = table.device
    lead, edges = t_vals.shape[:-1], t_vals.shape[-1]
    if t_vals.dim() < 2 or edges < 2:
        raise ValueError(f"t_vals must be [..., N+1] with N >= 1, got "
                         f"{tuple(t_vals.shape)}")
    samples = edges - 1
    ins = [_rows("t_vals", t_vals, lead, edges, device),
           _rows("origins", origins, lead, 3, device),
           _rows("directions", directions, lead, 3, device),
           _rows("radii", radii, lead, 1, device)]
    if (turn is None) != (mirror is None):
        raise ValueError("turn and mirror go together")
    if turn is not None:
        ins += [_rows("turn", turn, lead, samples, device),
                _rows("mirror", mirror, lead, samples, device)]
    args = [a for x in ins for a in (x.data_ptr(), x.stride(0))]
    while len(args) < 12:
        args += [None, 0]
    levels = len(spec.resolutions)
    res = (ctypes.c_int * levels)(*spec.resolutions)
    offsets = (ctypes.c_longlong * levels)(*spec.offsets)
    args += [table.data_ptr(), spec.features, levels, res, offsets,
             spec.log2_table]
    return args, ins[0].shape[0], samples, lead


def _raise_on(lib, err: int, name: str) -> None:
    if err:
        msg = lib.hashgrid_error_string(err).decode()
        raise RuntimeError(f"{name} hash-grid kernel launch failed: {msg} "
                           f"({err})")


def grid_forward(table, t_vals, origins, directions, radii, turn, mirror,
                 spec: GridSpec, dtype=torch.float32):
    """The encode's forward, [..., N, width]: H1 on a CUDA table (in
    ``dtype``), the plain version in float32 on a CPU one."""
    lead, samples = t_vals.shape[:-1], t_vals.shape[-1] - 1
    if not table.is_cuda:
        pos, su = plain_points(t_vals, origins, directions, radii, turn,
                               mirror)
        out = plain_features(table, pos, su, spec, MULTISAMPLES)
        return out.view(*lead, samples, spec.width)
    _check(spec, table)
    _check_dtype(dtype)
    args, rays, samples, lead = _kernel_args(
        t_vals, origins, directions, radii, turn, mirror, table, spec)
    out = torch.empty((rays * samples, spec.width), dtype=dtype,
                      device=table.device)
    if out.numel():
        lib = _lib()
        with torch.cuda.device(table.device):
            err = lib.hashgrid_forward_launch(
                *args, out.data_ptr(), int(dtype == torch.bfloat16), rays,
                samples, torch.cuda.current_stream().cuda_stream)
        _raise_on(lib, err, "H1")
        launches["H1"] += 1
    return out.view(*lead, samples, spec.width)


def grid_backward(g, t_vals, origins, directions, radii, turn, mirror,
                  spec: GridSpec):
    """The table's gradient [entries, features] float32 against the
    cotangent ``g`` [..., N, width]: H2 into a zeroed gradient on the card,
    ``index_add_`` on the CPU."""
    if not g.is_cuda:
        pos, su = plain_points(t_vals, origins, directions, radii, turn,
                               mirror)
        return plain_table_grad(g.reshape(-1, spec.width), pos, su, spec,
                                MULTISAMPLES)
    grad = torch.zeros((spec.entries, spec.features), dtype=torch.float32,
                       device=g.device)
    args, rays, samples, _ = _kernel_args(
        t_vals, origins, directions, radii, turn, mirror, grad, spec)
    g2 = g.reshape(-1, spec.width)
    if g2.dtype not in (torch.bfloat16, torch.float32):
        g2 = g2.float()
    if g2.stride(-1) != 1:
        g2 = g2.contiguous()
    if g2.numel():
        lib = _lib()
        with torch.cuda.device(g.device):
            err = lib.hashgrid_backward_launch(
                *args, g2.data_ptr(), g2.stride(0),
                int(g2.dtype == torch.bfloat16), rays, samples,
                torch.cuda.current_stream().cuda_stream)
        _raise_on(lib, err, "H2")
        launches["H2"] += 1
    return grad


class _GridEncode(torch.autograd.Function):
    """The encode with its table's gradient (the only input that takes
    one)."""

    @staticmethod
    def forward(ctx, table, t_vals, origins, directions, radii, turn, mirror,
                spec: GridSpec, dtype):
        ctx.save_for_backward(t_vals, origins, directions, radii, turn,
                              mirror)
        ctx.spec = spec
        return grid_forward(table, t_vals, origins, directions, radii, turn,
                            mirror, spec, dtype)

    @staticmethod
    def backward(ctx, g):
        grad = grid_backward(g, *ctx.saved_tensors, ctx.spec)
        return (grad,) + (None,) * 8


def encode_grid(table, t_vals, rays, spec: GridSpec,
                pattern: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                dtype=torch.float32):
    """A sampling level's encode: ``table`` [entries, features] float32 (the
    level's grid, ``spec``), ``t_vals`` [..., N+1] and ``rays`` (a ``Rays``
    of [..., c] fields) -> [..., N, levels x features], in ``dtype``
    (bfloat16 or float32) on the card, float32 from the plain version on
    the CPU. ``pattern``: (turn, mirror) [..., N] uniforms of the training
    pattern, None for the render's. The table takes a gradient."""
    turn, mirror = pattern if pattern is not None else (None, None)
    return _GridEncode.apply(table, t_vals.detach(), rays.origins,
                             rays.directions, rays.radii, turn, mirror, spec,
                             dtype)
