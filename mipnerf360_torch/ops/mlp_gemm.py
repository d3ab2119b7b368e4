"""G1: one ReLU layer of the MLP forward in one hand-written Hopper GEMM,
with its plain version.

It replaces no TPU kernel: the JAX package leaves the layer's dot, bias
add, bf16 rounding and ReLU to XLA, which fuses them
(``mipnerf360_tpu/models/mlp.py::apply_linear``, ``apply_mlp``). The kernel
is ``csrc/mlp_gemm.cu``, whose note gives its bound and design;
``models/mlp.py::relu_stack_heads`` runs each hidden layer through it where
:func:`takes` says so, and through cuBLAS's f32 GEMM and E1
(``ops/mlp_epilogue.py``) otherwise.

:func:`bias_relu`: ``h = relu(bf16(x @ w + b))`` from bf16 ``x`` [M, K] and
``w`` [K, N] and the f32 bias ``b`` [N], the product summed in f32; for a
layer with a second input ``x1`` [M, K1], ``w`` is [K + K1, N] and the sum
covers both products. The plain version is the composition it replaces,
:func:`mm_f32` then E1's plain version; the kernel's f32 sum runs in
another order, so its outputs can differ from the plain version's by one
bf16 ulp.

A bad input (a dtype, shape, stride or alignment the kernel does not take)
raises on every device. Then a CPU tensor takes the plain version and a
CUDA tensor launches the kernel; an input on another device or a failed
launch raises, and nothing falls back to the plain version.
:func:`bias_relu_taken` is :func:`bias_relu` for a layer that :func:`takes`
has already accepted, so the router asks the shape rule once a layer.
``launches`` counts the kernel's calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, mlp_epilogue

BF16 = torch.bfloat16
# Output widths the kernel takes are multiples of this (its narrowest tile,
# csrc/mlp_gemm.cu); a row of every input starts on a 16-byte boundary.
WIDTH_STEP = 64
ALIGN = 16

# Calls of the kernel in this process (only the line that launches it adds
# to it), so a run can show that its path went through G1.
launches = {"G1": 0}


def _lib() -> ctypes.CDLL:
    lib = _build.load("mlp_gemm")
    if lib.mlp_gemm_launch.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.mlp_gemm_launch.argtypes = [ptr, i64, i32, ptr, i64, i32, ptr,
                                        ptr, ptr, i64, i32, i32, ptr]
        lib.mlp_gemm_launch.restype = ctypes.c_int
        lib.mlp_gemm_error_string.argtypes = [ctypes.c_int]
        lib.mlp_gemm_error_string.restype = ctypes.c_char_p
    return lib


def mm_f32(a, b):
    """a @ b for 2-D compute-dtype operands, accumulated and returned in f32.

    On CUDA, ``torch.mm(..., out_dtype=float32)`` accumulates in f32 and
    returns f32 without rounding to the operand dtype (a plain bf16 matmul
    rounds before the bias add, which the JAX package does not). The CPU has
    no such overload; there the operands, already rounded to the compute
    dtype, are multiplied in f32: products of bf16 values are exact in f32,
    so only the summation order differs.
    """
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def plain_bias_relu(x, w, b, x1=None):
    """The plain PyTorch version of G1: cuBLAS's f32 product (two with
    ``x1``, on w's first and last rows) and E1's plain version."""
    if x1 is None:
        return mlp_epilogue.plain_bias_relu(mm_f32(x, w), b)
    k = x.shape[-1]
    return mlp_epilogue.plain_bias_relu(mm_f32(x, w[:k]), b,
                                        mm_f32(x1, w[k:]))


def _refusal(inputs, w):
    """Why the kernel does not take a layer of bf16 ``inputs`` (one or two
    [M, k]) and bf16 ``w`` [sum of k, N], or None where it does: every
    tensor 2-D and bf16, w contiguous with N a multiple of
    :data:`WIDTH_STEP`, each input's rows as many, unit-stride and
    16-byte aligned (what TMA can describe). Reads shapes, strides, dtypes
    and addresses only."""
    if not 1 <= len(inputs) <= 2:
        return f"G1 takes one or two inputs, got {len(inputs)}"
    for name, t in [("w", w)] + [(f"x{i}", x) for i, x in enumerate(inputs)]:
        if t.dim() != 2 or t.shape[0] < 1 or t.shape[1] < 1:
            return f"{name} must be 2-D and not empty, got {tuple(t.shape)}"
        if t.dtype != BF16:
            return f"{name} must be bfloat16, got {t.dtype}"
    n = w.shape[1]
    if n % WIDTH_STEP:
        return f"G1 takes widths that are multiples of {WIDTH_STEP}, got {n}"
    if not w.is_contiguous() or w.data_ptr() % ALIGN:
        return "w must be contiguous and start on a 16-byte boundary"
    if sum(x.shape[1] for x in inputs) != w.shape[0]:
        return (f"w has {w.shape[0]} rows for inputs of "
                f"{[x.shape[1] for x in inputs]} features")
    m = inputs[0].shape[0]
    for i, x in enumerate(inputs):
        if x.shape[0] != m:
            return f"x{i} has {x.shape[0]} rows, x0 {m}"
        if x.stride(1) != 1 or (x.stride(0) * x.element_size()) % ALIGN \
                or x.data_ptr() % ALIGN:
            return (f"x{i}'s rows must be unit-stride, 16-byte aligned and "
                    f"a multiple of 16 bytes apart, got strides "
                    f"{x.stride()}")
    return None


def takes(inputs, w) -> bool:
    """Whether G1 takes a layer of ``inputs`` (one or two bf16 [M, k]) and
    ``w``: see :func:`_refusal`. The published view layer's 27 direction
    features (54-byte rows) are not taken."""
    return _refusal(inputs, w) is None


def bias_relu(x, w, b, x1=None):
    """G1: x [M, K] bf16, w [K, N] bf16, b [N] f32 -> relu(bf16(x @ w + b))
    [M, N] bf16; with ``x1`` [M, K1] bf16, w is [K + K1, N] and the sum
    covers x @ w[:K] + x1 @ w[K:]. The inputs are checked alike on every
    device; CPU tensors then take the plain version."""
    inputs = [x] if x1 is None else [x, x1]
    for name, t in [("w", w)] + [(f"x{i}", t) for i, t in enumerate(inputs)]:
        if t.dtype != BF16:
            raise TypeError(f"{name} must be {BF16}, got {t.dtype}")
    why = _refusal(inputs, w)
    if why is not None:
        raise ValueError(why)
    return bias_relu_taken(inputs, w, b)


def bias_relu_taken(inputs, w, b):
    """:func:`bias_relu` of a layer whose ``inputs`` and ``w`` :func:`takes`
    has accepted (``models/mlp.py`` asks it once a layer to route the
    layer): checks the bias and the devices, then CPU tensors take the
    plain version and CUDA tensors launch the kernel."""
    x, x1 = inputs[0], (inputs[1] if len(inputs) == 2 else None)
    m, n = x.shape[0], w.shape[1]
    if b.dtype != torch.float32:
        raise TypeError(f"b must be {torch.float32}, got {b.dtype}")
    if tuple(b.shape) != (n,) or not b.is_contiguous() or b.data_ptr() % ALIGN:
        raise ValueError(f"b must be contiguous [{n}] on a 16-byte boundary")
    if not x.is_cuda:
        return plain_bias_relu(x, w, b, x1)
    for name, t in [("w", w), ("b", b)] + [
            (f"x{i}", t) for i, t in enumerate(inputs)]:
        if t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, "
                             f"got {t.device}")
    lib = _lib()
    h = torch.empty((m, n), dtype=BF16, device=x.device)
    second = (x1.data_ptr(), x1.stride(0), x1.shape[1]) if x1 is not None \
        else (None, 0, 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mlp_gemm_launch(
            x.data_ptr(), x.stride(0), x.shape[1], *second, w.data_ptr(),
            b.data_ptr(), h.data_ptr(), m, n, _sms(x.device), stream)
    if err:
        msg = lib.mlp_gemm_error_string(err).decode()
        raise RuntimeError(f"G1 MLP GEMM launch failed: {msg} ({err})")
    launches["G1"] += 1
    return h


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
