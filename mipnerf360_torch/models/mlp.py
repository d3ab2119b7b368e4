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

Gradients follow what ``jax.grad`` of the JAX package computes: the f32
cotangent of each product is multiplied by the compute-dtype operand with f32
accumulation, and dX and dW are rounded to the compute dtype (the cotangent
of each ``.astype``) before they come back as f32.

With a tensor-parallel group, :func:`apply_mlp` runs this rank's shard of
the stack (the JAX package leaves that to GSPMD through its
``param_shardings``); the sums over the group are taken in f32, before any
rounding, so the shards compute the one-rank stack up to summation order.

On the card in bf16 without a tensor-parallel group, a stack of ReLU layers
under thin heads (:func:`relu_stack_heads`: the proposal MLP, and the NeRF
trunk with its density and rgb heads) runs as one autograd Function whose
epilogue around each cuBLAS GEMM is a hand-written kernel
(``ops/mlp_epilogue.py``: E1 forward, E2 and E3 backward): the same
arithmetic as the layer-by-layer chain, one pass over each activation.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops import mlp_epilogue
from ..parallel.collectives import all_reduce_, gather
from ..utils.trace import span

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


def _mm_f32(a, b):
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


def _split(g, dtype):
    """An f32 tensor as hi + lo in ``dtype`` (hi = g rounded, lo = the rounded
    rest): two compute-dtype GEMMs then carry g to ~16 mantissa bits, far
    below the compute-dtype rounding of the result."""
    hi = g.to(dtype)
    return [hi, (g - hi.float()).to(dtype)]


class _MatmulF32(torch.autograd.Function):
    """:func:`_mm_f32` with the backward of ``jnp.dot(...,
    preferred_element_type=f32)`` on compute-dtype operands.

    ``torch.mm(..., out_dtype=)`` has no derivative, so the card needs this.
    dX = g @ W^T and dW = X^T @ g, accumulated in f32 and rounded to the
    operands' dtype. ``g_rounded`` says that the cotangent g already holds
    compute-dtype values (a hidden layer, whose output is cast before its
    activation): one compute-dtype GEMM is then exact up to summation order.
    Otherwise (an MLP's last layer) g is true f32 and is split in hi + lo.
    f32 operands, and the CPU, multiply the f32 cotangent in f32, as
    ordinary autograd does.

    With a tensor-parallel ``group`` this is one shard of a layer, in
    Megatron's pair: a column split (w [in, out/P]) all-reduces dX, a sum
    over the ranks' columns, in f32 before it is rounded; a row split (w
    [in/P, out], x the rank's [.., in/P]) all-reduces its f32 partial
    outputs forward, and their cotangent reaches each partial unchanged.
    """

    @staticmethod
    def forward(ctx, x, w, g_rounded: bool, group=None,
                row_split: bool = False):
        ctx.save_for_backward(x, w)
        ctx.g_rounded, ctx.group, ctx.row_split = g_rounded, group, row_split
        y = _mm(x, w)
        return all_reduce_(y, group) if group is not None and row_split else y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if x.dtype == torch.float32 or not x.is_cuda:
            parts = [g]
        else:
            parts = [g.to(x.dtype)] if ctx.g_rounded else _split(g, x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_sum([(p, w.t()) for p in parts])
            if ctx.group is not None and not ctx.row_split:
                all_reduce_(dx, ctx.group)
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _mm_sum([(x.t(), p) for p in parts]).to(w.dtype)
        return dx, dw, None, None, None


def _mm(a, b):
    """a @ b with an f32 result: ``torch.mm`` for f32 operands, else
    :func:`_mm_f32`."""
    if a.dtype == b.dtype == torch.float32:
        return torch.mm(a, b)
    return _mm_f32(a, b)


def _mm_sum(pairs):
    """The sum of :func:`_mm` over (a, b) ``pairs``, in f32, in order: a
    product whose cotangent is split in hi + lo."""
    out = _mm(*pairs[0])
    for a, b in pairs[1:]:
        out += _mm(a, b)
    return out


def _matmul_f32(x, w, g_rounded: bool = False, group=None,
                row_split: bool = False):
    """[..., in] @ [in, out] with compute-dtype operands and an f32 product.

    In one process, float32 operands take ``torch.mm``, and other compute
    dtypes :func:`_mm_f32`: on the CPU with ordinary autograd, on CUDA
    through :class:`_MatmulF32`, whose backward is written out
    (``g_rounded`` as there). A shard of a tensor-parallel layer (``group``
    and ``row_split`` as there) always takes :class:`_MatmulF32`.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if group is not None or (x.is_cuda and x.dtype != torch.float32):
        y = _MatmulF32.apply(x2, w, g_rounded, group, row_split)
    elif x.dtype == torch.float32:
        y = torch.mm(x2, w)
    else:
        y = _mm_f32(x2, w)
    return y.reshape(*lead, w.shape[-1])


def apply_linear(layer, x, compute_dtype=torch.bfloat16, *,
                 g_rounded: bool = False, group=None, row_split: bool = False):
    """``x @ w + b`` with compute-dtype operands and an f32 result;
    ``g_rounded``: the caller casts the result to ``compute_dtype``, so its
    cotangent holds compute-dtype values (see :class:`_MatmulF32`). With
    ``group``, this rank's shard of a column-split (``row_split`` False: w
    [in, out/P], b [out/P]) or row-split (w [in/P, out], b [out], added
    after the sum) layer."""
    y = _matmul_f32(x.to(compute_dtype), layer["w"].to(compute_dtype),
                    g_rounded, group, row_split)
    return y + layer["b"]


def apply_mlp(params, x, activations: Sequence[str],
              compute_dtype=torch.bfloat16, tp_group=None):
    """Apply the stack; ``activations[i]`` follows layer i ("none" for linear out).

    ``tp_group``: the stack is split over this group, Megatron-style (the
    layout of ``parallel/mesh.py::shard_params``): even layers split their
    columns, odd layers their rows, so the activations alternate between
    this rank's columns and whole. An odd depth ends on split columns, which
    are gathered (every rank uses the whole output alike)."""
    layers = params["layers"]
    if len(layers) != len(activations):
        raise ValueError(f"{len(layers)} layers but {len(activations)} activations")
    with span("model.mlp"):
        if len(layers) > 1 and fused_relu_stack(
                x, compute_dtype, tp_group, layers[:-1], activations[:-1],
                layers[-1:]):
            (y,) = relu_stack_heads(layers[:-1], layers[-1:], x, split=False)
            return ACTIVATIONS[activations[-1]](y).to(torch.float32)
        for i, (layer, act) in enumerate(zip(layers, activations)):
            hidden = i + 1 < len(layers)
            y = apply_linear(layer, x, compute_dtype, g_rounded=hidden,
                             group=tp_group, row_split=i % 2 == 1)
            if hidden:
                y = y.to(compute_dtype)
            x = ACTIVATIONS[act](y)
        if tp_group is not None and len(layers) % 2:
            x = gather(x, tp_group, dim=-1, sum_backward=False)
        return x.to(torch.float32)


def fused_relu_stack(x, compute_dtype, tp_group, hidden, hidden_activations,
                     heads) -> bool:
    """Whether :func:`relu_stack_heads` takes these layers: a CUDA input, a
    bf16 compute dtype, no tensor-parallel group (its all-reduce comes
    before the rounding), ReLU after every hidden layer (sigmoid does not
    commute with the rounding), hidden widths the kernels take
    (``mlp_epilogue.takes_width``), and one or two heads of at most
    ``mlp_epilogue.MAX_HEAD_OUTPUTS`` outputs in all."""
    return (x.is_cuda and compute_dtype == torch.bfloat16 and tp_group is None
            and len(hidden_activations) > 0
            and all(a == "relu" for a in hidden_activations)
            and all(mlp_epilogue.takes_width(layer["w"].shape[-1])
                    for layer in hidden)
            and 1 <= len(heads) <= 2
            and sum(h["w"].shape[-1] for h in heads)
            <= mlp_epilogue.MAX_HEAD_OUTPUTS)


def relu_stack_heads(hidden, heads, x, split: bool):
    """ReLU layers ``hidden`` (bf16 GEMMs, f32 bias, bf16 outputs), then each
    of ``heads`` (one linear layer each) on the last one's output; returns
    each head's f32 ``h @ w + b``, [..., out], its activation left to the
    caller. The values and gradients of :func:`apply_mlp`'s layer-by-layer
    chain, with the epilogues in the kernels of ``ops/mlp_epilogue.py``.

    ``split`` says how the heads' gradients meet, as in that chain: False
    for one head that is the stack's own last layer (the last hidden
    output's cotangent is its head's dX rounded to bf16: a proposal MLP);
    True for heads that each read the f32 output of a separate stack (their
    rounded dX summed in f32, a true f32 cotangent, split in hi + lo for the
    last hidden layer's GEMMs: the NeRF trunk under its two heads).
    """
    flat = [t for layer in list(hidden) + list(heads)
            for t in (layer["w"], layer["b"])]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in [x2] + flat):
        outs = _ReluStackHeads.apply(x2, split, len(hidden), *flat)
    else:
        outs = _relu_stack_forward(x2, flat, len(hidden), keep=False)[-1]
    return [y.reshape(*lead, y.shape[-1]) for y in outs]


def _relu_stack_forward(x, flat, n_hidden: int, keep: bool):
    """The forward of :func:`relu_stack_heads` on [M, in] ``x`` and the
    layers' (w, b) flattened: (x in bf16, the bf16 weights, the hidden
    outputs when ``keep``, the heads' f32 outputs)."""
    xb = x.to(torch.bfloat16)
    ws = [w.to(torch.bfloat16) for w in flat[0::2]]
    bs = flat[1::2]
    h, acts = xb, []
    for w, b in zip(ws[:n_hidden], bs[:n_hidden]):
        h = mlp_epilogue.bias_relu(_mm_f32(h, w), b)
        if keep:
            acts.append(h)
    outs = [_mm_f32(h, w) + b for w, b in zip(ws[n_hidden:], bs[n_hidden:])]
    return xb, ws, acts, outs


class _ReluStackHeads(torch.autograd.Function):
    """:func:`relu_stack_heads` with the backward of the layer-by-layer
    chain (:class:`_MatmulF32`'s rules): dX and dW bf16 GEMMs with f32
    accumulation rounded to bf16, g_rounded cotangents in one GEMM, true f32
    cotangents split in hi + lo. Saves the bf16 input, the bf16 weights and
    the hidden layers' bf16 outputs, which the chain's GEMMs save too; no
    f32 activation. Each head's bias gradient is its f32 cotangent's column
    sum; each hidden layer's comes from E3 or E2."""

    @staticmethod
    def forward(ctx, x, split: bool, n_hidden: int, *flat):
        xb, ws, acts, outs = _relu_stack_forward(x, flat, n_hidden, keep=True)
        ctx.save_for_backward(xb, *ws, *acts)
        ctx.split, ctx.n_hidden, ctx.x_dtype = split, n_hidden, x.dtype
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        n = ctx.n_hidden
        xb, *ws = ctx.saved_tensors
        ws, acts = ws[:len(ws) - n], ws[len(ws) - n:]
        needs = ctx.needs_input_grad[3:]
        grads = [None] * len(needs)

        def weight_grad(i, x, parts):
            if needs[2 * i]:
                grads[2 * i] = _mm_sum([(x.t(), p) for p in parts]).to(
                    torch.bfloat16).float()

        heads = []
        for t, g in enumerate(gs):
            i = n + t
            hi, lo = _split(g.contiguous(), torch.bfloat16)
            weight_grad(i, acts[-1], [hi, lo])
            if needs[2 * i + 1]:
                grads[2 * i + 1] = g.sum(0)
            heads.append((hi, lo, ws[i]))
        parts, db = mlp_epilogue.heads_relu_bwd(acts[-1], heads, ctx.split)
        dx = None
        for i in reversed(range(n)):
            grads[2 * i + 1] = db if needs[2 * i + 1] else None
            weight_grad(i, acts[i - 1] if i else xb, parts)
            if i:
                g, db = mlp_epilogue.relu_bwd(
                    [_mm(p, ws[i].t()) for p in parts], acts[i - 1])
                parts = (g,)
            elif ctx.needs_input_grad[0]:
                dx = _mm_sum([(p, ws[0].t()) for p in parts]).to(
                    torch.bfloat16).to(ctx.x_dtype)
        return (dx, None, None, *grads)
