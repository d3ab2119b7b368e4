"""K1: the composite-weights kernel for Hopper, with its plain version.

Counterpart of ``mipnerf360_tpu/ops/pallas/composite.py::composite_weights``
(forward). The kernel is ``csrc/composite.cu``; its plain PyTorch version is
``core/rendering.py::compute_alpha_weights``. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. The backward kernel
(K2) is not written yet, so a CUDA input that requires grad raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core import rendering
from . import _build

# Launches of the K1 kernel in this process. Only the line that launches the
# kernel adds to it, so a run can show that its path went through K1.
launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("composite")
    fn = lib.composite_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.composite_error_string.argtypes = [ctypes.c_int]
        lib.composite_error_string.restype = ctypes.c_char_p
    return lib


def plain_composite_weights(density, t_vals, dirs):
    """The plain PyTorch version of K1: weights only."""
    return rendering.compute_alpha_weights(density, t_vals, dirs)[0]


def composite_weights(density, t_vals, dirs):
    """Density -> compositing weights.

    density: [..., N] f32; t_vals: [..., N+1] f32; dirs: [..., 3] f32.
    Returns w [..., N]. CPU tensors take the plain version; CUDA tensors
    launch K1.
    """
    if not density.is_cuda:
        return plain_composite_weights(density, t_vals, dirs)
    return _launch(density, t_vals, dirs)


def _launch(density, t_vals, dirs):
    global launches
    tensors = {"density": density, "t_vals": t_vals, "dirs": dirs}
    if any(x.requires_grad for x in tensors.values()):
        raise NotImplementedError(
            "K2 not ported: the composite backward kernel does not exist yet, "
            "so K1 takes no input that requires grad")
    for name, x in tensors.items():
        if not x.is_cuda or x.device != density.device:
            raise ValueError(f"{name} must be a CUDA tensor on {density.device}, "
                             f"got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lead, n = tuple(density.shape[:-1]), density.shape[-1]
    if tuple(t_vals.shape) != lead + (n + 1,) or tuple(dirs.shape) != lead + (3,):
        raise ValueError(
            f"shapes must be density [..., N], t_vals [..., N+1], dirs [..., 3]; "
            f"got {tuple(density.shape)}, {tuple(t_vals.shape)}, {tuple(dirs.shape)}")
    b = math.prod(lead)
    if b < 1 or n < 1:
        raise ValueError(f"K1 needs at least one ray and one sample, got {b} x {n}")
    lib = _lib()
    w = torch.empty_like(density)
    with torch.cuda.device(density.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.composite_fwd(density.data_ptr(), t_vals.data_ptr(),
                                dirs.data_ptr(), w.data_ptr(), b, n, stream)
    if err:
        msg = lib.composite_error_string(err).decode()
        raise RuntimeError(f"K1 composite kernel launch failed: {msg} ({err})")
    launches += 1
    return w
