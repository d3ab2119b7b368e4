"""Hand-rolled MLP stacks as nested dicts of tensors (counterpart of
``mipnerf360_tpu/models/mlp.py``).

Params keep the JAX layout — ``{"layers": [{"w": [in, out], "b": [out]}]}`` —
so converting a JAX pytree is the identity on every array (``interop.py``).

Init is Kaiming-uniform (bound sqrt(6/fan_in)) for weights and U(±1/sqrt(fan_in))
for biases, drawn from an explicit ``torch.Generator`` on the CPU, so one seed
gives the same params on every device.

Matmuls run in a configurable compute dtype (bfloat16 by default) with float32
products, as the JAX package's ``jnp.dot(..., preferred_element_type=f32)``:
the bias is added in f32, each hidden pre-activation is cast to the compute
dtype BEFORE its activation, and the final output is returned as f32.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# Activations are referenced by name so configs stay serializable.
ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "none": lambda x: x,
}


def init_linear(generator: torch.Generator, fan_in: int, fan_out: int):
    w_bound = float(np.sqrt(6.0 / fan_in))
    b_bound = float(1.0 / np.sqrt(fan_in))

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return u * (2.0 * bound) - bound

    return {"w": uniform((fan_in, fan_out), w_bound),
            "b": uniform((fan_out,), b_bound)}


def init_mlp(generator: torch.Generator, sizes: Sequence[int]):
    """sizes = [in, h1, ..., out]; returns {"layers": [linear, ...]} on the CPU."""
    return {"layers": [init_linear(generator, sizes[i], sizes[i + 1])
                       for i in range(len(sizes) - 1)]}


def _matmul_f32(x, w):
    """[..., in] @ [in, out] with compute-dtype operands and an f32 product.

    On CUDA, ``torch.mm(..., out_dtype=float32)`` accumulates in f32 and
    returns f32 without rounding to the operand dtype (a plain bf16 matmul
    rounds before the bias add, which the JAX package does not). The CPU has
    no such overload; there the operands, already rounded to the compute
    dtype, are multiplied in f32: products of bf16 values are exact in f32,
    so only the summation order differs.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        y = torch.mm(x2, w)
    elif x.is_cuda:
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = torch.mm(x2.float(), w.float())
    return y.reshape(*lead, w.shape[-1])


def apply_linear(layer, x, compute_dtype=torch.bfloat16):
    y = _matmul_f32(x.to(compute_dtype), layer["w"].to(compute_dtype))
    return y + layer["b"]


def apply_mlp(params, x, activations: Sequence[str],
              compute_dtype=torch.bfloat16):
    """Apply the stack; ``activations[i]`` follows layer i ("none" for linear out)."""
    layers = params["layers"]
    if len(layers) != len(activations):
        raise ValueError(f"{len(layers)} layers but {len(activations)} activations")
    for i, (layer, act) in enumerate(zip(layers, activations)):
        y = apply_linear(layer, x, compute_dtype)
        if i + 1 < len(layers):
            y = y.to(compute_dtype)
        x = ACTIVATIONS[act](y)
    return x.to(torch.float32)
