"""K1 and K2: the composite-weights kernels for Hopper, with their plain
versions.

Counterpart of ``mipnerf360_tpu/ops/pallas/composite.py::composite_weights``,
forward (K1) and custom-VJP backward (K2). Both kernels are in
``csrc/composite.cu``. The plain version of K1 is
``core/rendering.py::compute_alpha_weights``; that of K2 is
:func:`plain_composite_weights_bwd`, the closed form the TPU kernel computes.

A CPU tensor takes the plain version, with ordinary autograd. A CUDA tensor
launches K1; when grad is on and an input requires grad, it goes through
:class:`CompositeWeights`, whose backward launches K2. A CUDA tensor never
falls back to the plain version: a bad input or a failed launch raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core import rendering
from . import _build

# Launches of K1 and of K2 in this process. Only the lines that launch a
# kernel add to them, so a run can show that its path went through K1 and K2.
launches = 0
bwd_launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("composite")
    if lib.composite_fwd.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.composite_fwd.argtypes = [ptr, ptr, ptr, ptr, i64, i32, ptr]
        lib.composite_fwd.restype = ctypes.c_int
        lib.composite_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, ptr]
        lib.composite_bwd.restype = ctypes.c_int
        lib.composite_error_string.argtypes = [ctypes.c_int]
        lib.composite_error_string.restype = ctypes.c_char_p
    return lib


def plain_composite_weights(density, t_vals, dirs):
    """The plain PyTorch version of K1: weights only."""
    return rendering.compute_alpha_weights(density, t_vals, dirs)[0]


def plain_composite_weights_bwd(density, t_vals, dirs, g):
    """The plain PyTorch version of K2: d_density from the cotangent ``g`` of
    the weights, in the closed form of the TPU kernel. The suffix sum over
    i > j is a reversed cumsum of the terms past j, not total - prefix."""
    delta = (t_vals[..., 1:] - t_vals[..., :-1]) * torch.linalg.norm(
        dirs[..., None, :], dim=-1)
    dd = density * delta
    trans = torch.exp(-torch.cat(
        [torch.zeros_like(dd[..., :1]), torch.cumsum(dd[..., :-1], dim=-1)],
        dim=-1))
    gw = g * (-torch.expm1(-dd) * trans)
    suffix = torch.cat(
        [torch.flip(torch.cumsum(torch.flip(gw[..., 1:], [-1]), dim=-1), [-1]),
         torch.zeros_like(gw[..., :1])], dim=-1)
    return (g * torch.exp(-dd) * trans - suffix) * delta


class CompositeWeights(torch.autograd.Function):
    """K1 forward, K2 backward: the port's ``jax.custom_vjp``. Cotangents go
    to ``density`` only; ``t_vals`` and ``dirs`` get None, as the JAX VJP
    gives them exact zeros (they are data or under stop-gradient)."""

    @staticmethod
    def forward(ctx, density, t_vals, dirs):
        ctx.save_for_backward(density, t_vals, dirs)
        return _launch(density, t_vals, dirs)

    @staticmethod
    def backward(ctx, g):
        density, t_vals, dirs = ctx.saved_tensors
        # autograd may hand over an expanded or strided cotangent
        return _launch_bwd(density, t_vals, dirs, g.contiguous()), None, None


def composite_weights(density, t_vals, dirs):
    """Density -> compositing weights.

    density: [..., N] f32; t_vals: [..., N+1] f32; dirs: [..., 3] f32.
    Returns w [..., N]. CPU tensors take the plain version; CUDA tensors
    launch K1, and K2 in the backward when an input requires grad.
    """
    if not density.is_cuda:
        return plain_composite_weights(density, t_vals, dirs)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (density, t_vals, dirs)):
        return CompositeWeights.apply(density, t_vals, dirs)
    return _launch(density, t_vals, dirs)


def _check(tensors: dict, name: str):
    """Device, dtype, layout and shape checks shared by K1 and K2; returns
    (rays, samples)."""
    density = tensors["density"]
    for key, x in tensors.items():
        if not x.is_cuda or x.device != density.device:
            raise ValueError(f"{key} must be a CUDA tensor on {density.device}, "
                             f"got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{key} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{key} must be contiguous")
    lead, n = tuple(density.shape[:-1]), density.shape[-1]
    want = {"density": lead + (n,), "t_vals": lead + (n + 1,),
            "dirs": lead + (3,), "g": lead + (n,)}
    if any(tuple(x.shape) != want[key] for key, x in tensors.items()):
        shapes = ", ".join(f"{k} {tuple(x.shape)}" for k, x in tensors.items())
        raise ValueError(
            "shapes must be density [..., N], t_vals [..., N+1], dirs [..., 3]"
            f" (and g [..., N]); got {shapes}")
    b = math.prod(lead)
    if b < 1 or n < 1:
        raise ValueError(f"{name} needs at least one ray and one sample, "
                         f"got {b} x {n}")
    return b, n


def _raise_on(lib, err: int, name: str) -> None:
    if err:
        msg = lib.composite_error_string(err).decode()
        raise RuntimeError(f"{name} composite kernel launch failed: {msg} ({err})")


def _launch(density, t_vals, dirs):
    global launches
    b, n = _check({"density": density, "t_vals": t_vals, "dirs": dirs}, "K1")
    lib = _lib()
    w = torch.empty_like(density)
    with torch.cuda.device(density.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.composite_fwd(density.data_ptr(), t_vals.data_ptr(),
                                dirs.data_ptr(), w.data_ptr(), b, n, stream)
    _raise_on(lib, err, "K1")
    launches += 1
    return w


def _launch_bwd(density, t_vals, dirs, g):
    global bwd_launches
    b, n = _check({"density": density, "t_vals": t_vals, "dirs": dirs, "g": g},
                  "K2")
    lib = _lib()
    d_density = torch.empty_like(density)
    with torch.cuda.device(density.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.composite_bwd(density.data_ptr(), t_vals.data_ptr(),
                                dirs.data_ptr(), g.data_ptr(),
                                d_density.data_ptr(), b, n, stream)
    _raise_on(lib, err, "K2")
    bwd_launches += 1
    return d_density
