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
:func:`apply_mlp` and :func:`apply_tower` (the NeRF trunk under its heads)
alone choose between the two, by :func:`fused_relu_stack`.

A hidden layer may take a second input (:class:`Extra`: the published
trunk's skip, the view branch's direction encoding) as a second product
added in f32 before the bias, and a stack may end in a wide head whose
output is read in bf16 (the published trunk's bottleneck): the chain and the
fused stack take both alike.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

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


class Extra(NamedTuple):
    """A second input of hidden layer ``layer`` of a stack: features ``x``
    (None: the stack's own input), one row of them per row of the layer's
    input. The layer's weight rows are its input's, then these; its
    pre-activation is (in @ w[:k] + x @ w[k:]) + b in f32. ``x`` takes no
    gradient."""

    layer: int
    x: Optional[torch.Tensor] = None


def _linear_extra(layer, x, extra_x, compute_dtype, g_rounded):
    """:func:`apply_linear` of a layer with a second input (:class:`Extra`):
    two compute-dtype products with f32 results, added in f32, then the
    bias."""
    k = x.shape[-1]
    w = layer["w"]
    y = _matmul_f32(x.to(compute_dtype), w[:k].to(compute_dtype), g_rounded)
    y1 = _matmul_f32(extra_x.to(compute_dtype), w[k:].to(compute_dtype),
                     g_rounded)
    return (y + y1) + layer["b"]


def apply_mlp(params, x, activations: Sequence[str],
              compute_dtype=torch.bfloat16, tp_group=None,
              extras: Sequence[Extra] = ()):
    """Apply the stack; ``activations[i]`` follows layer i ("none" for linear out).

    ``tp_group``: the stack is split over this group, Megatron-style (the
    layout of ``parallel/mesh.py::shard_params``): even layers split their
    columns, odd layers their rows, so the activations alternate between
    this rank's columns and whole. An odd depth ends on split columns, which
    are gathered (every rank uses the whole output alike).

    ``extras``: second inputs of hidden layers (:class:`Extra`; not with
    ``tp_group``)."""
    layers = params["layers"]
    if len(layers) != len(activations):
        raise ValueError(f"{len(layers)} layers but {len(activations)} activations")
    if extras and tp_group is not None:
        raise ValueError("a layer with a second input has no tensor-parallel "
                         "split")
    with span("model.mlp"):
        if len(layers) > 1 and fused_relu_stack(
                x, compute_dtype, tp_group, layers[:-1], activations[:-1],
                layers[-1:], False, extras):
            (y,) = relu_stack_heads(layers[:-1], layers[-1:], x, split=False,
                                    extras=extras)
            return ACTIVATIONS[activations[-1]](y).to(torch.float32)
        second = {e.layer: e for e in extras}
        x0 = x
        for i, (layer, act) in enumerate(zip(layers, activations)):
            hidden = i + 1 < len(layers)
            e = second.get(i)
            if e is None:
                y = apply_linear(layer, x, compute_dtype, g_rounded=hidden,
                                 group=tp_group, row_split=i % 2 == 1)
            else:
                y = _linear_extra(layer, x, x0 if e.x is None else e.x,
                                  compute_dtype, hidden)
            if hidden:
                y = y.to(compute_dtype)
            x = ACTIVATIONS[act](y)
        if tp_group is not None and len(layers) % 2:
            x = gather(x, tp_group, dim=-1, sum_backward=False)
        return x.to(torch.float32)


def apply_tower(params, heads, x, activations: Sequence[str],
                compute_dtype=torch.bfloat16, tp_group=None,
                extras: Sequence[Extra] = (), rounded_head: bool = False):
    """The trunk ``params`` (the rest as in :func:`apply_mlp`) under
    ``heads``, one linear layer each; returns each head's f32
    pre-activation, the last one's rounded to ``compute_dtype`` with
    ``rounded_head`` (the published bottleneck). :func:`relu_stack_heads`
    with ``split`` where :func:`fused_relu_stack` takes the layers, else the
    chain: :func:`apply_mlp`, then each head on its f32 output."""
    layers = params["layers"]
    with span("model.mlp"):
        if fused_relu_stack(x, compute_dtype, tp_group, layers, activations,
                            heads, rounded_head, extras):
            return relu_stack_heads(layers, heads, x, split=True,
                                    rounded_head=rounded_head, extras=extras)
        feat = apply_mlp(params, x, activations, compute_dtype, tp_group,
                         extras)
        thin = heads[:-1] if rounded_head else heads
        ys = [apply_linear(h, feat, compute_dtype) for h in thin]
        if rounded_head:
            ys.append(apply_linear(heads[-1], feat, compute_dtype,
                                   g_rounded=True).to(compute_dtype))
        return ys


def fused_relu_stack(x, compute_dtype, tp_group, hidden, hidden_activations,
                     heads, rounded_head: bool = False,
                     extras: Sequence[Extra] = ()) -> bool:
    """Whether :func:`relu_stack_heads` takes these layers: a CUDA input, a
    bf16 compute dtype, no tensor-parallel group (its all-reduce comes
    before the rounding), ReLU after every hidden layer (sigmoid does not
    commute with the rounding), hidden widths the kernels take
    (``mlp_epilogue.takes_width``), one or two thin heads of at most
    ``mlp_epilogue.MAX_HEAD_OUTPUTS`` outputs in all, then with
    ``rounded_head`` one more head, beside a single thin one (E3 adds its dX
    to that head's). ``extras`` (:class:`Extra`) at distinct hidden layers,
    their features without gradient."""
    thin = heads[:-1] if rounded_head else heads
    n = len(hidden)
    layers = [e.layer for e in extras]
    return (x.is_cuda and compute_dtype == torch.bfloat16 and tp_group is None
            and len(hidden_activations) > 0
            and all(a == "relu" for a in hidden_activations)
            and all(mlp_epilogue.takes_width(layer["w"].shape[-1])
                    for layer in hidden)
            and 1 <= len(thin) <= 2
            and sum(h["w"].shape[-1] for h in thin)
            <= mlp_epilogue.MAX_HEAD_OUTPUTS
            and (not rounded_head or len(thin) == 1)
            and len(set(layers)) == len(layers)
            and all(0 <= i < n for i in layers)
            and not any((x if e.x is None else e.x).requires_grad
                        for e in extras))


def relu_stack_heads(hidden, heads, x, split: bool, rounded_head: bool = False,
                     extras: Sequence[Extra] = ()):
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

    With ``rounded_head`` the last head returns ``h @ w + b`` rounded to
    bf16, the value its reader casts to (the published trunk's bottleneck):
    its cotangent holds bf16 values, so its dW and dX are one GEMM each, and
    its dX reaches E3 as an f32 part. ``extras``: second inputs of
    hidden layers (:class:`Extra`), as in :func:`apply_mlp`; a layer's dX
    covers its first input only.
    """
    flat = [t for layer in list(hidden) + list(heads)
            for t in (layer["w"], layer["b"])]
    plan = (len(hidden), len(heads) - int(rounded_head),
            tuple((e.layer, e.x is not None) for e in extras))
    ex = [e.x.reshape(-1, e.x.shape[-1]) for e in extras if e.x is not None]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in [x2] + flat):
        outs = _ReluStackHeads.apply(x2, split, plan, len(ex), *ex, *flat)
    else:
        outs = _relu_stack_forward(x2, ex, flat, plan, keep=False)[-1]
    return [y.reshape(*lead, y.shape[-1]) for y in outs]


def _second_inputs(plan, xb, exb):
    """{layer: bf16 features} of the extras in ``plan``: the stack's input
    ``xb``, or the next of ``exb``."""
    feats = iter(exb)
    return {layer: next(feats) if own else xb for layer, own in plan[2]}


def _relu_stack_forward(x, ex, flat, plan, keep: bool):
    """The forward of :func:`relu_stack_heads` on [M, in] ``x``, the 2-D
    features of the extras that bring their own (``ex``) and the layers'
    (w, b) flattened; ``plan`` is (hidden layers, thin heads, (layer, own
    features) of each extra). Returns (x in bf16, ``ex`` in bf16, the
    bf16 weights, the hidden outputs when ``keep``, the heads' outputs)."""
    n_hidden, n_thin, _ = plan
    xb = x.to(torch.bfloat16)
    exb = [f.to(torch.bfloat16) for f in ex]
    second = _second_inputs(plan, xb, exb)
    ws = [w.to(torch.bfloat16) for w in flat[0::2]]
    bs = flat[1::2]
    h, acts = xb, []
    for i, (w, b) in enumerate(zip(ws[:n_hidden], bs[:n_hidden])):
        if i in second:
            k = h.shape[-1]
            h = mlp_epilogue.bias_relu(_mm_f32(h, w[:k]), b,
                                       _mm_f32(second[i], w[k:]))
        else:
            h = mlp_epilogue.bias_relu(_mm_f32(h, w), b)
        if keep:
            acts.append(h)
    outs = []
    for t, (w, b) in enumerate(zip(ws[n_hidden:], bs[n_hidden:])):
        y = _mm_f32(h, w) + b
        outs.append(y if t < n_thin else y.to(torch.bfloat16))
    return xb, exb, ws, acts, outs


class _ReluStackHeads(torch.autograd.Function):
    """:func:`relu_stack_heads` with the backward of the layer-by-layer
    chain (:class:`_MatmulF32`'s rules): dX and dW bf16 GEMMs with f32
    accumulation rounded to bf16, g_rounded cotangents in one GEMM, true f32
    cotangents split in hi + lo. Saves the bf16 input and extras' features,
    the bf16 weights and the hidden layers' bf16 outputs, which the chain's
    GEMMs save too; no f32 activation. Each head's bias gradient is its
    cotangent's column sum; each hidden layer's comes from E3 or E2."""

    @staticmethod
    def forward(ctx, x, split: bool, plan, n_ex: int, *rest):
        xb, exb, ws, acts, outs = _relu_stack_forward(
            x, rest[:n_ex], rest[n_ex:], plan, keep=True)
        ctx.save_for_backward(xb, *exb, *ws, *acts)
        ctx.split, ctx.plan, ctx.n_ex, ctx.x_dtype = split, plan, n_ex, x.dtype
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        n, n_thin, _ = ctx.plan
        xb, *rest = ctx.saved_tensors
        exb, rest = rest[:ctx.n_ex], rest[ctx.n_ex:]
        ws, acts = rest[:len(rest) - n], rest[len(rest) - n:]
        second = _second_inputs(ctx.plan, xb, exb)
        needs = ctx.needs_input_grad[4 + ctx.n_ex:]
        grads = [None] * len(needs)

        def weight_grad(i, x, parts):
            if not needs[2 * i]:
                return
            dw = _mm_sum([(x.t(), p) for p in parts]).to(torch.bfloat16)
            if i in second:
                dw = torch.cat([dw, _mm_sum(
                    [(second[i].t(), p) for p in parts]).to(torch.bfloat16)])
            grads[2 * i] = dw.float()

        thin, wide = [], None
        for t, g in enumerate(gs):
            i = n + t
            if t < n_thin:
                hi, lo = _split(g.contiguous(), torch.bfloat16)
                weight_grad(i, acts[-1], [hi, lo])
                if needs[2 * i + 1]:
                    grads[2 * i + 1] = g.sum(0)
                thin.append((hi, lo, ws[i]))
            else:
                g = g.contiguous()
                weight_grad(i, acts[-1], [g])
                if needs[2 * i + 1]:
                    grads[2 * i + 1] = g.float().sum(0)
                wide = _mm(g, ws[i].t())
        parts, db = mlp_epilogue.heads_relu_bwd(acts[-1], thin, ctx.split,
                                                extra=wide)
        dx = None
        for i in reversed(range(n)):
            grads[2 * i + 1] = db if needs[2 * i + 1] else None
            x = acts[i - 1] if i else xb
            weight_grad(i, x, parts)
            w = ws[i][:x.shape[-1]]
            if i:
                g, db = mlp_epilogue.relu_bwd([_mm(p, w.t()) for p in parts],
                                              acts[i - 1])
                parts = (g,)
            elif ctx.needs_input_grad[0]:
                dx = _mm_sum([(p, w.t()) for p in parts]).to(
                    torch.bfloat16).to(ctx.x_dtype)
        return (dx, None, None, None, *[None] * ctx.n_ex, *grads)
