"""ENC and VIEW: the point encode and the view-direction encode for Hopper,
with their plain versions.

They replace no TPU kernel: the JAX package leaves the encode to XLA's
fusion of plain jnp (``mipnerf360_tpu/core/fused_encode.py::factored_ipe``,
``core/encoding.py``). Both are in ``csrc/encode.cu``, whose note gives
their bounds and design.

- ENC, :func:`encode_points`: the first MLP layer's whole input [..., N,
  width] from the ray intervals ``t_vals`` [..., N+1]: ``factored_ipe``'s
  features, then (``view_degs`` given: the repo's layout) ``viewdir_enc``'s
  features of each sample's ray, then zeros to ``width``; written once in
  ``dtype``, the MLP's compute dtype (bf16 rounded to nearest even, as the
  MLP's own cast of the float32 features rounds them).
- VIEW, :func:`encode_viewdirs`: ``unit_viewdir_enc``'s [..., 3 + 6 a
  scale] features of each ray (the published layout's view branch), in
  ``dtype``.

A CPU tensor takes the plain version, which is the composition the model
ran before these kernels, in float32 whatever ``dtype`` (no CPU result
changed). A CUDA tensor launches the kernel; an input it does not take (a
wrong dtype, shape, device or stride, an unknown ray shape, a width under
the features, scales outside 2^-62..2^62) or a failed launch raises, and
nothing falls back to the plain version. ``launches`` counts each kernel's
calls.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..core.encoding import POS_ENC_DIM, unit_viewdir_enc, viewdir_enc
from ..core.fused_encode import factored_ipe
from . import _build

RAY_SHAPES = ("cone", "cylinder")
# The scales 2^i the kernels take (csrc/encode.cu kMinDeg, kMaxDeg).
MIN_DEG, MAX_DEG = -62, 62
# VIEW's grid: at most this many blocks of 256 threads per SM.
VIEW_BLOCKS_PER_SM = 8

# Calls of each kernel in this process. Only the lines that launch a kernel
# add to them, so a run can show that its path went through ENC and VIEW.
launches = {"ENC": 0, "VIEW": 0}


def _lib() -> ctypes.CDLL:
    lib = _build.load("encode")
    if lib.encode_points_launch.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.encode_points_launch.argtypes = [
            ptr, i64, ptr, i64, ptr, i64, ptr, i64, ptr, i64, ptr, i64, i32,
            i32, i32, i32, i32, i32, i32, i32, ptr]
        lib.encode_viewdirs_launch.argtypes = [ptr, i64, ptr, i64, i32, i32,
                                               i32, i32, ptr]
        for fn in (lib.encode_points_launch, lib.encode_viewdirs_launch):
            fn.restype = ctypes.c_int
        lib.encode_error_string.argtypes = [ctypes.c_int]
        lib.encode_error_string.restype = ctypes.c_char_p
    return lib


def features(pos, viewdirs=None, view_degs: Optional[Tuple[int, int]] = None,
             width: Optional[int] = None):
    """The MLP input from point features ``pos`` [..., N, P]: with
    ``view_degs``, ``viewdir_enc(viewdirs, *view_degs)`` of each row's ray
    [..., 3] after them; then zeros up to ``width`` features."""
    x = pos
    if view_degs is not None:
        view = viewdir_enc(viewdirs, *view_degs)
        view = view[..., None, :].expand(pos.shape[:-1] + (view.shape[-1],))
        x = torch.cat([pos, view], dim=-1)
    pad = (width or x.shape[-1]) - x.shape[-1]
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    return x


def plain_encode_points(t_vals, rays, *, ray_shape: str = "cone",
                        min_deg: int = 0, max_deg: int = 1,
                        view_degs: Optional[Tuple[int, int]] = None,
                        width: Optional[int] = None):
    """The plain PyTorch version of ENC, in float32."""
    pos = factored_ipe(t_vals, rays.origins, rays.directions, rays.radii,
                       ray_shape=ray_shape, min_deg=min_deg, max_deg=max_deg)
    return features(pos, rays.viewdirs, view_degs, width)


def encode_points(t_vals, rays, *, ray_shape: str = "cone", min_deg: int = 0,
                  max_deg: int = 1,
                  view_degs: Optional[Tuple[int, int]] = None,
                  width: Optional[int] = None, dtype=torch.float32):
    """ENC: ``t_vals`` [..., N+1] and ``rays`` (a ``Rays`` of [..., c]
    fields) -> [..., N, width] in ``dtype`` (bfloat16 or float32) on the
    card, float32 from the plain version on the CPU. ``view_degs``:
    (min, max) of ``viewdir_enc``'s scales when the view features go in the
    row, else None; ``width`` defaults to the features' count."""
    if not t_vals.is_cuda:
        return plain_encode_points(t_vals, rays, ray_shape=ray_shape,
                                   min_deg=min_deg, max_deg=max_deg,
                                   view_degs=view_degs, width=width)
    if ray_shape not in RAY_SHAPES:
        raise ValueError(f"unknown ray_shape: {ray_shape!r}")
    scales = max_deg - min_deg
    view_scales = 0 if view_degs is None else view_degs[1] - view_degs[0]
    used = POS_ENC_DIM * scales + 4 * view_scales
    width = used if width is None else width
    _check_degrees(min_deg, max_deg)
    if view_degs is not None:
        _check_degrees(*view_degs)
    if width < used:
        raise ValueError(f"width {width} is under the {used} features")
    _check_dtype(dtype)
    device = t_vals.device
    lead, edges = t_vals.shape[:-1], t_vals.shape[-1]
    if t_vals.dim() < 2 or edges < 2:
        raise ValueError(f"t_vals must be [..., N+1] with N >= 1, got "
                         f"{tuple(t_vals.shape)}")
    t2 = _rows("t_vals", t_vals, lead, edges, device)
    fields = [("origins", rays.origins, 3), ("directions", rays.directions, 3),
              ("radii", rays.radii, 1)]
    if view_degs is not None:
        fields.append(("viewdirs", rays.viewdirs, 3))
    ins = [_rows(name, x, lead, c, device) for name, x, c in fields]
    n_rays, samples = t2.shape[0], edges - 1
    out = torch.empty((n_rays * samples, width), dtype=dtype, device=device)
    if out.numel():
        args = [a for x in [t2] + ins for a in (x.data_ptr(), x.stride(0))]
        if view_degs is None:
            args += [None, 0]
        lib = _lib()
        with torch.cuda.device(device):
            err = lib.encode_points_launch(
                *args, out.data_ptr(), n_rays, samples,
                int(ray_shape == "cone"), min_deg, scales,
                view_degs[0] if view_degs else 0, view_scales, width,
                int(dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
        _raise_on(lib, err, "ENC")
        launches["ENC"] += 1
    return out.view(*lead, samples, width)


def encode_viewdirs(viewdirs, min_deg: int = 0, max_deg: int = 4,
                    dtype=torch.float32):
    """VIEW: ``viewdirs`` [..., 3] -> [..., 3 + 6*(max_deg-min_deg)] in
    ``dtype`` on the card; ``unit_viewdir_enc``'s float32 on the CPU."""
    if not viewdirs.is_cuda:
        return unit_viewdir_enc(viewdirs, min_deg, max_deg)
    scales = max_deg - min_deg
    _check_degrees(min_deg, max_deg)
    _check_dtype(dtype)
    lead = viewdirs.shape[:-1]
    v2 = _rows("viewdirs", viewdirs, lead, 3, viewdirs.device)
    out = torch.empty((v2.shape[0], 3 + 6 * scales), dtype=dtype,
                      device=viewdirs.device)
    if out.numel():
        lib = _lib()
        with torch.cuda.device(viewdirs.device):
            err = lib.encode_viewdirs_launch(
                v2.data_ptr(), v2.stride(0), out.data_ptr(), v2.shape[0],
                min_deg, scales, VIEW_BLOCKS_PER_SM * _sms(viewdirs.device),
                int(dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
        _raise_on(lib, err, "VIEW")
        launches["VIEW"] += 1
    return out.view(*lead, out.shape[-1])


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_degrees(lo: int, hi: int) -> None:
    if not MIN_DEG <= lo < hi <= MAX_DEG + 1:
        raise ValueError(f"the encode kernels take scales [lo, hi) with "
                         f"{MIN_DEG} <= lo < hi <= {MAX_DEG + 1}, got "
                         f"[{lo}, {hi})")


def _check_dtype(dtype) -> None:
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the encode kernels write bfloat16 or float32, got "
                        f"{dtype}")


def _rows(name, x, lead, channels, device):
    """``x`` [*lead, channels] float32 on ``device`` as 2-D rows with a unit
    column stride (a view where one exists)."""
    if not x.is_cuda or x.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(lead) + (channels,):
        raise ValueError(f"{name} must have shape "
                         f"{tuple(lead) + (channels,)}, got {tuple(x.shape)}")
    x2 = x.reshape(-1, channels)
    if x2.shape[0] and channels > 1 and x2.stride(1) != 1:
        raise ValueError(f"{name} must have unit stride along its last axis")
    return x2


def _raise_on(lib, err: int, name: str) -> None:
    if err:
        msg = lib.encode_error_string(err).decode()
        raise RuntimeError(f"{name} encode kernel launch failed: {msg} "
                           f"({err})")
