"""E1, E2 and E3: the MLP layers' epilogue kernels for Hopper, with their
plain versions.

They replace no TPU kernel: the JAX package leaves the bias add, the bf16
rounding and the ReLU, and their backward, to XLA's fusion of plain jnp
(``mipnerf360_tpu/models/mlp.py::apply_mlp``). All three are in
``csrc/mlp_epilogue.cu``, whose note gives their bounds and design;
``models/mlp.py::relu_stack_heads`` strings them between cuBLAS's GEMMs.

- E1, :func:`bias_relu`: ``h = relu(bf16(y + b))`` from the f32 GEMM output
  ``y`` and the f32 bias ``b``; for a layer with a second input, ``h =
  relu(bf16((y + y1) + b))``, ``y1`` that input's f32 GEMM output.
- E2, :func:`relu_bwd`: ``g = bf16(dx)`` where ``h > 0``, else 0, from the f32
  dX of the layer above (two parts where its cotangent was split in hi + lo,
  summed in f32 first) and this layer's bf16 output ``h``; ``db`` the column
  sums of ``g`` in f32.
- E3, :func:`heads_relu_bwd`: the same for the last hidden layer under one
  or two heads of at most :data:`MAX_HEAD_OUTPUTS` outputs in all, whose dX
  it forms itself from each head's split cotangent and bf16 weights. With
  ``split`` the heads' rounded dX are summed in f32, masked, and returned
  split in hi + lo; without, one head's is masked as in E2. With ``split``
  and one thin head, ``extra`` is a wide head's f32 dX from its GEMM, rounded
  to bf16 and added to the thin head's.

A CPU tensor takes the plain version. A CUDA tensor launches the kernel; a
bad input (a width :func:`takes_width` refuses, a pointer that is not
16-byte aligned, a wrong dtype, shape or device) or a failed launch raises,
and nothing falls back to the plain version. ``launches`` counts each kernel's calls (an E2 or E3 call is two
CUDA launches: the pass over the rows and the sum of the bias gradient's
per-block partial sums).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

BF16 = torch.bfloat16
# Outputs of E3's heads together, at most (csrc/mlp_epilogue.cu kMaxHeadCols).
MAX_HEAD_OUTPUTS = 4
# Grids: E1 strides over the array with at most this many blocks per SM;
# E2 and E3 give each of this many blocks per SM a run of rows (so the bias
# gradient's scratch is [blocks, N]), and at least ROWS_PER_BLOCK rows.
E1_BLOCKS_PER_SM = 8
ROW_BLOCKS_PER_SM = 4
ROWS_PER_BLOCK = 16
# Columns a thread holds, threads per block (csrc/mlp_epilogue.cu kVec,
# kThreads): the kernels take a width N when N / VEC divides THREADS.
VEC, THREADS = 8, 256

# Calls of each kernel in this process. Only the lines that launch a kernel
# add to them, so a run can show that its path went through E1, E2 and E3.
launches = {"E1": 0, "E2": 0, "E3": 0}


def _lib() -> ctypes.CDLL:
    lib = _build.load("mlp_epilogue")
    if lib.mlp_epilogue_e1.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.mlp_epilogue_e1.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32,
                                        ptr]
        lib.mlp_epilogue_e2.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64,
                                        i32, i32, ptr]
        lib.mlp_epilogue_e3.argtypes = [ptr, ptr, ptr, i32, ptr, ptr, ptr,
                                        i32, i32, ptr, ptr, ptr, ptr, ptr,
                                        ptr, i64, i32, i32, i32, ptr]
        for fn in (lib.mlp_epilogue_e1, lib.mlp_epilogue_e2,
                   lib.mlp_epilogue_e3):
            fn.restype = ctypes.c_int
        lib.mlp_epilogue_error_string.argtypes = [ctypes.c_int]
        lib.mlp_epilogue_error_string.restype = ctypes.c_char_p
    return lib


def takes_width(n: int) -> bool:
    """Whether the kernels take width ``n``: a multiple of 8 whose eighth
    divides 256, so 8 to 2048 in powers of two (every preset's widths).
    ``models/mlp.py`` runs other widths layer by layer."""
    return n > 0 and n % VEC == 0 and THREADS % (n // VEC) == 0


def plain_bias_relu(y, b, y1=None):
    """The plain PyTorch version of E1."""
    if y1 is not None:
        y = y + y1
    return torch.relu((y + b).to(BF16))


def _mask(h, g):
    """``g`` where ``h > 0``, else 0: ``threshold_backward``'s ``h <= 0``
    (a NaN in ``h`` passes ``g``)."""
    return torch.where(h <= 0, torch.zeros((), dtype=g.dtype, device=g.device),
                       g)


def plain_relu_bwd(dx, h):
    """The plain PyTorch version of E2: (g, db) from the parts ``dx`` (one
    or two f32 tensors) and ``h``."""
    d = dx[0] if len(dx) == 1 else dx[0] + dx[1]
    g = _mask(h, d.to(BF16))
    return g, g.float().sum(0)


def _thin_dx(hi, lo, w):
    """A head's dX, ``hi @ w.T + lo @ w.T`` in f32 with each product summed
    over the head's outputs in order, rounded to bf16."""
    wf = w.float()
    a = hi[:, :1].float() * wf[:, 0]
    b = lo[:, :1].float() * wf[:, 0]
    for k in range(1, w.shape[1]):
        a = a + hi[:, k:k + 1].float() * wf[:, k]
        b = b + lo[:, k:k + 1].float() * wf[:, k]
    return (a + b).to(BF16)


def plain_heads_relu_bwd(h, heads, split: bool, extra=None):
    """The plain PyTorch version of E3: ``heads`` is a list of (hi, lo, w)
    per head. Returns ((hi, lo), db) with ``split``, else ((g,), db)."""
    r = [_thin_dx(*head) for head in heads]
    if extra is not None:
        r.append(extra.to(BF16))
    if not split:
        g = _mask(h, r[0])
        return (g,), g.float().sum(0)
    s = r[0].float()
    for x in r[1:]:
        s = s + x.float()
    s = _mask(h, s)
    hi = s.to(BF16)
    return (hi, (s - hi.float()).to(BF16)), s.sum(0)


def bias_relu(y, b, y1=None):
    """E1: y [M, N] f32, b [N] f32 -> relu(bf16(y + b)) [M, N] bf16; with
    ``y1`` [M, N] f32, relu(bf16((y + y1) + b))."""
    if not y.is_cuda:
        return plain_bias_relu(y, b, y1)
    m, n = _check_2d("y", y, torch.float32, y.device)
    _check_width(n)
    _check("b", b, torch.float32, y.device, (n,))
    _check_aligned(y=y, b=b)
    if y1 is not None:
        _check("y1", y1, torch.float32, y.device, (m, n))
        _check_aligned(y1=y1)
    lib = _lib()
    h = torch.empty((m, n), dtype=BF16, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mlp_epilogue_e1(
            y.data_ptr(), None if y1 is None else y1.data_ptr(), b.data_ptr(),
            h.data_ptr(), m, n, E1_BLOCKS_PER_SM * _sms(y.device), stream)
    _raise_on(lib, err, "E1")
    launches["E1"] += 1
    return h


def relu_bwd(dx, h):
    """E2: ``dx`` one or two f32 [M, N] tensors, h [M, N] bf16 -> (g [M, N]
    bf16, db [N] f32)."""
    if not h.is_cuda:
        return plain_relu_bwd(dx, h)
    if len(dx) not in (1, 2):
        raise ValueError(f"E2 takes one or two dX parts, got {len(dx)}")
    m, n = _check_2d("h", h, BF16, h.device)
    _check_width(n)
    for i, d in enumerate(dx):
        _check(f"dx[{i}]", d, torch.float32, h.device, (m, n))
    _check_aligned(h=h, **{f"dx[{i}]": d for i, d in enumerate(dx)})
    lib = _lib()
    g = torch.empty_like(h)
    blocks = _row_blocks(m, h.device)
    partial = torch.empty((blocks, n), dtype=torch.float32, device=h.device)
    db = torch.empty(n, dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mlp_epilogue_e2(
            dx[0].data_ptr(), dx[1].data_ptr() if len(dx) == 2 else None,
            h.data_ptr(), g.data_ptr(), partial.data_ptr(), db.data_ptr(), m,
            n, blocks, stream)
    _raise_on(lib, err, "E2")
    launches["E2"] += 1
    return g, db


def heads_relu_bwd(h, heads, split: bool, extra=None):
    """E3: h [M, N] bf16 and ``heads``, a list of one or two (hi, lo, w):
    hi, lo [M, k] bf16 (the head's f32 cotangent split), w [N, k] bf16,
    with k summed over the heads at most :data:`MAX_HEAD_OUTPUTS`; with
    ``split`` and one head, ``extra`` [M, N] f32 (a wide head's dX) or None.
    Returns ((hi, lo), db) with ``split``, else ((g,), db) for one head."""
    if extra is not None and (not split or len(heads) != 1):
        raise ValueError("E3 adds a wide head's dX only with split and one "
                         f"thin head; got {len(heads)} with split={split}")
    if not h.is_cuda:
        return plain_heads_relu_bwd(h, heads, split, extra)
    m, n = _check_2d("h", h, BF16, h.device)
    _check_width(n)
    if not 1 <= len(heads) <= 2 or (not split and len(heads) != 1):
        raise ValueError(f"E3 takes one head, or two with split; got "
                         f"{len(heads)} with split={split}")
    if extra is not None:
        _check("extra", extra, torch.float32, h.device, (m, n))
        _check_aligned(extra=extra)
    widths = []
    for t, (hi, lo, w) in enumerate(heads):
        k = _check_2d(f"heads[{t}] w", w, BF16, h.device)[1]
        _check(f"heads[{t}] w", w, BF16, h.device, (n, k))
        _check(f"heads[{t}] hi", hi, BF16, h.device, (m, k))
        _check(f"heads[{t}] lo", lo, BF16, h.device, (m, k))
        widths.append(k)
    if sum(widths) > MAX_HEAD_OUTPUTS:
        raise ValueError(f"E3's heads have {sum(widths)} outputs in all, at "
                         f"most {MAX_HEAD_OUTPUTS}")
    _check_aligned(h=h)
    lib = _lib()
    outs = tuple(torch.empty_like(h) for _ in range(2 if split else 1))
    blocks = _row_blocks(m, h.device)
    partial = torch.empty((blocks, n), dtype=torch.float32, device=h.device)
    db = torch.empty(n, dtype=torch.float32, device=h.device)
    ptrs = [[x.data_ptr() for x in head] for head in heads]
    second = ptrs[1] if len(heads) == 2 else [None, None, None]
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mlp_epilogue_e3(
            *ptrs[0], widths[0], *second, widths[-1] if len(heads) == 2 else 0,
            len(heads), h.data_ptr(),
            None if extra is None else extra.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr() if split else None, partial.data_ptr(),
            db.data_ptr(), m, n, blocks, int(split), stream)
    _raise_on(lib, err, "E3")
    launches["E3"] += 1
    return outs, db


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _row_blocks(m: int, device) -> int:
    """Row blocks of E2 and E3 for M rows."""
    return max(1, min(ROW_BLOCKS_PER_SM * _sms(device),
                      -(-m // ROWS_PER_BLOCK)))


def _check(name, x, dtype, device, shape):
    if not x.is_cuda or x.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")


def _check_2d(name, x, dtype, device):
    """Checks of a [M, N] input with M, N >= 1; returns (M, N)."""
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{name} must be [M, N] with M, N >= 1, got "
                         f"{tuple(x.shape)}")
    _check(name, x, dtype, device, x.shape)
    return tuple(x.shape)


def _check_width(n: int) -> None:
    if not takes_width(n):
        raise ValueError(f"the MLP epilogue kernels take widths of 8 to 2048 "
                         f"in powers of two, got {n}")


def _check_aligned(**tensors) -> None:
    """The kernels' 16-byte loads need it (outputs are fresh allocations,
    which the caching allocator aligns)."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _raise_on(lib, err: int, name: str) -> None:
    if err:
        msg = lib.mlp_epilogue_error_string(err).decode()
        raise RuntimeError(f"{name} MLP epilogue kernel launch failed: {msg} "
                           f"({err})")
