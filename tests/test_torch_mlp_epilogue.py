"""The MLP epilogue kernels E1, E2 and E3 (``ops/mlp_epilogue.py``) and the
fused ReLU stack that strings them between the GEMMs
(``models/mlp.py::relu_stack_heads``).

On the CPU: each plain version against the layer-by-layer chain it replaces
(``models/mlp.py``'s ops, with the card's GEMM backward, :class:`_CardMatmul`
below), and the whole fused stack on the CPU against that chain: forward
values, cotangents and the hi + lo split bit for bit, bias gradients to
float32 summation order. On the card (marker ``cuda``, skipped here): each
kernel against its plain version at the main path's shapes, the wrappers'
refusals (other widths, unaligned inputs, wrong dtypes, shapes, devices), the launches per train step and per render chunk, and a
garden_quality step's gradients against the unfused chain.

This file imports no JAX, so its card tests run on a machine without JAX
(``--noconftest``, see README).
"""
import dataclasses

import numpy as np
import pytest
import torch

from mipnerf360_torch.config import get_config
from mipnerf360_torch.core.rays import dummy_rays, rays_to_device
from mipnerf360_torch.models import mipnerf360 as tm
from mipnerf360_torch.models import mlp as tmlp
from mipnerf360_torch.ops import composite
from mipnerf360_torch.ops import mlp_epilogue as epi
from mipnerf360_torch.ops import mlp_gemm
from mipnerf360_torch.train import init_train_state, joint_cadence_grads
from mipnerf360_torch.train.state import make_train_state

BF16 = torch.bfloat16


class _CardMatmul(torch.autograd.Function):
    """``models/mlp.py::_MatmulF32`` as it runs on the card, run on the
    CPU: bf16 operands, dX and dW as f32-accumulated products rounded to
    bf16, a true f32 cotangent split in hi + lo (``_MatmulF32`` itself
    multiplies the f32 cotangent on the CPU)."""

    @staticmethod
    def forward(ctx, x, w, g_rounded):
        ctx.save_for_backward(x, w)
        ctx.g_rounded = g_rounded
        return tmlp._mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        parts = [g.to(BF16)] if ctx.g_rounded else tmlp._split(g, BF16)
        dx = tmlp._mm(parts[0], w.t())
        dw = tmlp._mm(x.t(), parts[0])
        for p in parts[1:]:
            dx += tmlp._mm(p, w.t())
            dw += tmlp._mm(x.t(), p)
        return dx.to(x.dtype), dw.to(w.dtype), None


def _chain_linear(layer, x, g_rounded):
    """``apply_linear`` with the card's GEMM backward."""
    y = _CardMatmul.apply(x.reshape(-1, x.shape[-1]).to(BF16),
                          layer["w"].to(BF16), g_rounded)
    return y + layer["b"]


def _chain_mlp(layers, x, acts):
    """``apply_mlp``'s layer-by-layer chain (one process, bf16) with the
    card's GEMM backward."""
    for i, (layer, act) in enumerate(zip(layers, acts)):
        hidden = i + 1 < len(layers)
        y = _chain_linear(layer, x, hidden)
        x = tmlp.ACTIVATIONS[act](y.to(BF16) if hidden else y)
    return x.to(torch.float32)


def _layers(sizes, seed):
    return tmlp.init_mlp(torch.Generator().manual_seed(seed), sizes)["layers"]


def _normal(shape, seed, scale=1.0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        scale=scale, size=shape).astype(np.float32))


def _sum_order_close(got, want, terms):
    """Column sums taken in another order: within 2^-18 of the sum of the
    terms' magnitudes (about 2^5 roundings of 2^-23 each; the orders here
    differ over at most a few hundred terms)."""
    tol = 2.0 ** -18 * terms.float().abs().sum(0) + 1e-30
    assert ((got - want).abs() <= tol).all(), (got - want).abs().max()


# The main path's widths (proposal 256, NeRF 1024), a narrow one, and rows
# that fill no whole block.
SHAPES = [(300, 256), (37, 1024), (64, 16), (5, 12)]


@pytest.mark.parametrize("m,n", SHAPES)
def test_plain_e1_is_the_chain_bit_for_bit(m, n):
    y = _normal((m, n), 0, 2.0)
    b = _normal((n,), 1)
    y[0, :4] = -b[:4]  # y + b exactly 0: the mask's edge
    want = torch.relu((y + b).to(BF16))
    got = epi.plain_bias_relu(y, b)
    assert got.dtype == BF16 and torch.equal(got, want)
    assert (got[0, :4] == 0).all()


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("m,n", SHAPES)
def test_plain_e2_is_the_chain_bit_for_bit(m, n, parts):
    """g: the cotangent of the f32 pre-activation through the cast, the
    ReLU and the rounding of the layer above's dX (the sum of its hi and lo
    products with ``parts`` 2), bit for bit; db to summation order."""
    y = _normal((m, n), 2, 2.0).requires_grad_()
    b = _normal((n,), 3).requires_grad_()
    with torch.no_grad():
        y[0, :4] = -b[:4]
    h = torch.relu((y + b).to(BF16))
    dx = [_normal((m, n), 4 + i) for i in range(parts)]
    cot = dx[0].clone()
    for d in dx[1:]:
        cot += d
    h.backward(cot.to(BF16))
    g, db = epi.plain_relu_bwd(dx, h.detach())
    assert g.dtype == BF16 and torch.equal(g.float(), y.grad)
    assert (g[0, :4] == 0).all()
    _sum_order_close(db, b.grad, y.grad)


def _heads(widths, m, n, seed):
    heads = []
    for i, k in enumerate(widths):
        hi, lo = tmlp._split(_normal((m, k), seed + 2 * i), BF16)
        heads.append((hi, lo, _normal((n, k), seed + 2 * i + 1).to(BF16)))
    return heads


def _chain_head_dx(hi, lo, w):
    """The card's thin dX of a head: two f32 products and the rounding."""
    dx = tmlp._mm(hi, w.t())
    dx += tmlp._mm(lo, w.t())
    return dx.to(BF16)


@pytest.mark.parametrize("widths", [(1,), (3,), (4,)])
@pytest.mark.parametrize("m,n", SHAPES)
def test_plain_e3_one_head_is_the_chain_bit_for_bit(m, n, widths):
    """A proposal MLP's last hidden layer under its output layer: the
    head's dX rounded to bf16 is the ReLU output's cotangent."""
    y = _normal((m, n), 5, 2.0).requires_grad_()
    b = _normal((n,), 6).requires_grad_()
    with torch.no_grad():
        y[0, :4] = -b[:4]
    h = torch.relu((y + b).to(BF16))
    heads = _heads(widths, m, n, 7)
    h.backward(_chain_head_dx(*heads[0]))
    (g,), db = epi.plain_heads_relu_bwd(h.detach(), heads, split=False)
    assert torch.equal(g.float(), y.grad)
    _sum_order_close(db, b.grad, y.grad)


@pytest.mark.parametrize("widths", [(1, 3), (1,), (2, 2)])
@pytest.mark.parametrize("m,n", SHAPES)
def test_plain_e3_split_is_the_chain_bit_for_bit(m, n, widths):
    """The NeRF trunk's last layer under the density and rgb heads: each
    head casts the f32 ReLU output to bf16, their rounded dX meet in f32,
    the f32 ReLU's mask, then the hi + lo split of the trunk's last GEMMs."""
    y = _normal((m, n), 8, 2.0).requires_grad_()
    b = _normal((n,), 9).requires_grad_()
    with torch.no_grad():
        y[0, :4] = -b[:4]
    feat = torch.relu(y + b)
    heads = _heads(widths, m, n, 10)
    casts = [feat.to(BF16) for _ in heads]
    torch.autograd.backward(casts, [_chain_head_dx(*hd) for hd in heads])
    (hi, lo), db = epi.plain_heads_relu_bwd(feat.detach().to(BF16), heads,
                                            split=True)
    want_hi, want_lo = tmlp._split(y.grad, BF16)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    assert (hi[0, :4] == 0).all() and (lo[0, :4] == 0).all()
    _sum_order_close(db, b.grad, y.grad)


def _stack_grads(fn, layers, x, r):
    """fn(layers, x) -> outputs; gradients of sum(out * r) over x and every
    w and b."""
    layers = [{k: v.clone().requires_grad_() for k, v in l.items()}
              for l in layers]
    x = x.clone().requires_grad_()
    outs = fn(layers, x)
    loss = sum((o * ri).sum() for o, ri in zip(outs, r))
    leaves = [x] + [l[k] for l in layers for k in ("w", "b")]
    return [o.detach() for o in outs], torch.autograd.grad(loss, leaves)


def _check_stack(fused, chain, n_layers):
    (out_f, g_f), (out_c, g_c) = fused, chain
    for a, b in zip(out_f, out_c):
        assert torch.equal(a, b)
    # x, then (w, b) per layer: dX and dW bit for bit; db to summation order
    assert torch.equal(g_f[0], g_c[0])
    for i in range(n_layers):
        assert torch.equal(g_f[1 + 2 * i], g_c[1 + 2 * i]), f"w of layer {i}"
        torch.testing.assert_close(g_f[2 + 2 * i], g_c[2 + 2 * i],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m", [300, 37])
def test_fused_proposal_stack_matches_the_chain_on_the_cpu(m):
    """A proposal MLP (4 ReLU layers of 256, one output): the fused stack
    with the plain versions against the chain."""
    layers = _layers([40, 256, 256, 256, 256, 1], 11)
    x = _normal((m, 40), 12)
    r = [_normal((m, 1), 13)]
    fused = _stack_grads(lambda ls, xx: tmlp.relu_stack_heads(
        ls[:-1], ls[-1:], xx, split=False), layers, x, r)
    chain = _stack_grads(lambda ls, xx: [_chain_mlp(
        ls, xx, ["relu"] * 4 + ["none"])], layers, x, r)
    _check_stack(fused, chain, len(layers))


@pytest.mark.parametrize("m", [64, 37])
def test_fused_trunk_and_heads_match_the_chain_on_the_cpu(m):
    """A NeRF trunk of 1024 (3 ReLU layers here) with its density (1) and
    rgb (3) heads: the fused stack against the trunk's chain and each head
    on its f32 output."""
    trunk = _layers([24, 1024, 1024, 1024], 14)
    heads = _layers([1024, 1], 15) + _layers([1024, 3], 16)
    x = _normal((m, 24), 17)
    r = [_normal((m, 1), 18), _normal((m, 3), 19)]

    def chain(ls, xx):
        feat = _chain_mlp(ls[:3], xx, ["relu"] * 3)
        return [_chain_mlp([l], feat, ["none"]) for l in ls[3:]]

    fused = _stack_grads(lambda ls, xx: tmlp.relu_stack_heads(
        ls[:3], ls[3:], xx, split=True), trunk + heads, x, r)
    _check_stack(fused, _stack_grads(chain, trunk + heads, x, r), 5)


def test_fused_stack_without_grad_gives_the_same_outputs():
    layers = _layers([24, 64, 64, 2], 20)
    x = _normal((33, 24), 21)
    with torch.no_grad():
        want = tmlp.relu_stack_heads(layers[:-1], layers[-1:], x, split=False)
    got = tmlp.relu_stack_heads(
        [{k: v.requires_grad_() for k, v in l.items()} for l in layers[:-1]],
        layers[-1:], x, split=False)
    assert torch.equal(got[0].detach(), want[0])


def test_the_cpu_keeps_the_layer_by_layer_chain():
    """The fused path is the card's: apply_mlp on the CPU launches nothing
    and calls no plain epilogue, whatever the dtype."""
    layers = _layers([8, 16, 16, 1], 22)
    x = _normal((10, 8), 23)
    assert not tmlp.fused_relu_stack(x, BF16, None, layers[:-1],
                                     ["relu", "relu"], layers[-1:])
    before = dict(epi.launches)
    tmlp.apply_mlp({"layers": layers}, x, ["relu", "relu", "none"], BF16)
    assert epi.launches == before


@pytest.mark.parametrize("n,taken", [(8, True), (16, True), (64, True),
                                     (128, True), (256, True), (1024, True),
                                     (2048, True), (4, False), (12, False),
                                     (24, False), (300, False), (384, False),
                                     (4096, False), (0, False)])
def test_kernels_take_widths_whose_eighth_divides_256(n, taken):
    """Every preset's hidden width (64, 128, 256, 1024) is taken; other
    widths keep the layer-by-layer chain."""
    assert epi.takes_width(n) is taken


# --- on the card ------------------------------------------------------------

# The main path's row counts: a train step's 4096 rays x 64 samples, a
# render chunk's 8192 x 64, and a ragged count.
CARD_ROWS = [4096 * 64, 8192 * 64, 4097 * 64 + 3]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_normal(shape, seed, device, scale=1.0):
    g = torch.Generator(device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device) * scale


def _card_h(m, n, seed, device):
    h = torch.relu(_card_normal((m, n), seed, device)).to(BF16)
    h[0, :8] = 0.0
    return h


def _db_close(got, want, g):
    """db within 1e-6 of the column's sum of magnitudes."""
    tol = 1e-6 * g.float().abs().sum(0) + 1e-30
    assert ((got - want).abs() <= tol).all(), (got - want).abs().max()
    assert ((got - want).norm() / want.norm()).item() < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 256])
@pytest.mark.parametrize("m", CARD_ROWS)
def test_e1_matches_plain_on_card(cuda, m, n):
    y = _card_normal((m, n), 1, cuda, 2.0)
    b = _card_normal((n,), 2, cuda)
    y[0, :8] = -b[:8]
    before = epi.launches["E1"]
    got = epi.bias_relu(y, b)
    assert epi.launches["E1"] == before + 1
    assert torch.equal(got, epi.plain_bias_relu(y, b))


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("n", [1024, 256])
@pytest.mark.parametrize("m", [CARD_ROWS[0], CARD_ROWS[2]])
def test_e2_matches_plain_on_card(cuda, m, n, parts):
    dx = [_card_normal((m, n), 3 + i, cuda) for i in range(parts)]
    h = _card_h(m, n, 5, cuda)
    g, db = epi.relu_bwd(dx, h)
    want_g, want_db = epi.plain_relu_bwd(dx, h)
    assert torch.equal(g, want_g)
    _db_close(db, want_db, g)


@pytest.mark.cuda
@pytest.mark.parametrize("widths,split,n", [((1, 3), True, 1024),
                                            ((1,), False, 256),
                                            ((4,), False, 1024)])
@pytest.mark.parametrize("m", [CARD_ROWS[0], CARD_ROWS[2]])
def test_e3_matches_plain_on_card(cuda, m, widths, split, n):
    h = _card_h(m, n, 6, cuda)
    heads = []
    for i, k in enumerate(widths):
        hi, lo = tmlp._split(_card_normal((m, k), 7 + i, cuda), BF16)
        heads.append((hi, lo, _card_normal((n, k), 9 + i, cuda).to(BF16)))
    outs, db = epi.heads_relu_bwd(h, heads, split)
    want, want_db = epi.plain_heads_relu_bwd(h, heads, split)
    for a, b in zip(outs, want):
        assert torch.equal(a, b)
    _db_close(db, want_db, want[0])


@pytest.mark.cuda
def test_kernels_refuse_other_widths_and_unaligned_inputs(cuda):
    """Widths :func:`takes_width` refuses, and inputs 2 or 4 bytes off a
    16-byte boundary, raise before any launch."""
    m = 64
    before = dict(epi.launches)
    for n in (12, 300, 384):
        y = torch.zeros(m, n, device=cuda)
        h = torch.zeros(m, n, dtype=BF16, device=cuda)
        hl = torch.zeros(m, 1, dtype=BF16, device=cuda)
        with pytest.raises(ValueError, match="widths"):
            epi.bias_relu(y, torch.zeros(n, device=cuda))
        with pytest.raises(ValueError, match="widths"):
            epi.relu_bwd([y], h)
        with pytest.raises(ValueError, match="widths"):
            epi.heads_relu_bwd(h, [(hl, hl, torch.zeros(
                n, 1, dtype=BF16, device=cuda))], split=False)
    n = 256
    h = torch.zeros(m * n + 1, dtype=BF16, device=cuda)[1:].view(m, n)
    y = torch.zeros(m * n + 1, device=cuda)[1:].view(m, n)
    b = torch.zeros(n, device=cuda)
    hl = torch.zeros(m, 1, dtype=BF16, device=cuda)
    w = torch.zeros(n, 1, dtype=BF16, device=cuda)
    good_h = torch.zeros(m, n, dtype=BF16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        epi.bias_relu(y, b)
    with pytest.raises(ValueError, match="16-byte"):
        epi.bias_relu(torch.zeros(m, n, device=cuda),
                      torch.zeros(n + 1, device=cuda)[1:])
    with pytest.raises(ValueError, match="16-byte"):
        epi.relu_bwd([y], good_h)
    with pytest.raises(ValueError, match="16-byte"):
        epi.relu_bwd([torch.zeros(m, n, device=cuda)], h)
    with pytest.raises(ValueError, match="16-byte"):
        epi.heads_relu_bwd(h, [(hl, hl, w)], split=False)
    assert epi.launches == before


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take(cuda):
    y = torch.zeros(8, 16, device=cuda)
    b = torch.zeros(16, device=cuda)
    h = torch.zeros(8, 16, dtype=BF16, device=cuda)
    w = torch.zeros(16, 1, dtype=BF16, device=cuda)
    hl = torch.zeros(8, 1, dtype=BF16, device=cuda)
    before = dict(epi.launches)
    with pytest.raises(TypeError):
        epi.bias_relu(y.to(BF16), b)
    with pytest.raises(ValueError):
        epi.bias_relu(y, b[:8])
    with pytest.raises(ValueError):
        epi.bias_relu(y, b.cpu())
    with pytest.raises(ValueError):
        epi.bias_relu(y.t().contiguous().t(), b)
    with pytest.raises(ValueError):
        epi.relu_bwd([y, y, y], h)
    with pytest.raises(ValueError):
        epi.relu_bwd([y[:4]], h)
    with pytest.raises(TypeError):
        epi.relu_bwd([y], h.float())
    with pytest.raises(ValueError):
        epi.heads_relu_bwd(h, [(hl, hl, w)] * 2, split=False)
    with pytest.raises(ValueError):
        four = torch.zeros(8, 4, dtype=BF16, device=cuda)
        epi.heads_relu_bwd(h, [(hl, hl, w), (four, four, w.expand(16, 4)
                                             .contiguous())], split=True)
    with pytest.raises(ValueError):
        epi.heads_relu_bwd(h, [(hl, hl, w[:8])], split=False)
    assert epi.launches == before


def _launches():
    """G1's and E1-E3's launch counts."""
    return {**mlp_gemm.launches, **epi.launches}


def _garden(batch):
    cfg = get_config("garden_quality")
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=batch))


def _step(cfg, state, rays, pixels, noise):
    return joint_cadence_grads(cfg, state, rays, pixels, noise=noise)


@pytest.mark.cuda
def test_garden_step_launches_and_matches_the_unfused_chain(cuda, monkeypatch):
    """One garden_quality joint step of 1024 rays on the card: 10 G1 and 2
    E1 forward (the preset's 226 input features keep both first layers on
    cuBLAS + E1, ``ops/mlp_gemm.py::takes``), 10 E2 and 2 E3 (proposal: 4,
    3, 1; NeRF tower: 8, 7, 1), and its gradients against the same step
    through the layer-by-layer chain, per leaf by relative L2 at 5e-2
    (ROADMAP's bf16 card rule: another summation order flips bf16 roundings
    and ReLU masks)."""
    cfg = _garden(1024)
    cpu = init_train_state(cfg.model, cfg.train, device="cpu")
    state = make_train_state(cpu.params, device=cuda,
                             generator=torch.Generator(cuda))
    rays = rays_to_device(dummy_rays(1024, seed=3), cuda)
    pixels = _card_normal((1024, 3), 4, cuda).sigmoid()
    n = cfg.model.num_samples + 1
    noise = tm.RenderNoise(torch.rand(1024, n, device=cuda),
                           torch.rand(1024, n, device=cuda) / n)
    before = _launches()
    fused, aux = _step(cfg, state, rays, pixels, noise)
    assert {k: _launches()[k] - before[k] for k in before} == {
        "G1": 10, "E1": 2, "E2": 10, "E3": 2}
    monkeypatch.setattr(tmlp, "fused_relu_stack", lambda *a: False)
    before = _launches()
    chain, aux_chain = _step(cfg, state, rays, pixels, noise)
    assert _launches() == before
    torch.testing.assert_close(aux["loss"], aux_chain["loss"], rtol=1e-2,
                               atol=0)
    for k in ("prop", "nerf"):
        for a, b in zip(fused[k], chain[k]):
            assert ((a - b).norm() / b.norm()).item() < 5e-2


@pytest.mark.cuda
def test_render_launches_twelve_e1_per_chunk(cuda):
    """Twelve forward layers a render chunk: at the cells' 12 IPE scales
    (520 input features) all through G1."""
    cfg = dataclasses.replace(get_config("garden_quality").model,
                              ipe_max_deg=12)
    params = tm.init_model(cfg, torch.Generator().manual_seed(1))
    before = _launches(), composite.launches
    tm.render_image(params, cfg, dummy_rays(3 * 512, seed=2), chunk=512)
    assert {k: _launches()[k] - before[0][k] for k in before[0]} == {
        "G1": 36, "E1": 0, "E2": 0, "E3": 0}
    assert composite.launches - before[1] == 6


@pytest.mark.cuda
def test_fused_path_conditions_on_card(cuda):
    """Taken on CUDA in bf16 with ReLU hidden layers of widths the kernels
    take and thin heads only."""
    x = torch.zeros(4, 8, device=cuda)
    hidden = _layers([8, 16], 26)
    heads = _layers([16, 1], 24)
    assert tmlp.fused_relu_stack(x, BF16, None, hidden, ["relu"], heads)
    assert not tmlp.fused_relu_stack(x, torch.float32, None, hidden,
                                     ["relu"], heads)
    assert not tmlp.fused_relu_stack(x, BF16, None, hidden, ["sigmoid"],
                                     heads)
    assert not tmlp.fused_relu_stack(x, BF16, object(), hidden, ["relu"],
                                     heads)
    assert not tmlp.fused_relu_stack(x, BF16, None, hidden, ["relu"],
                                     _layers([16, 5], 25))
    for n in (12, 384):
        assert not tmlp.fused_relu_stack(x, BF16, None, _layers([8, n], 27),
                                         ["relu"], _layers([n, 1], 28))
    # a stack of another width runs layer by layer, launching nothing
    layers = _layers([8, 384, 384, 1], 29)
    before = dict(epi.launches)
    y = tmlp.apply_mlp({"layers": [{k: v.to(cuda) for k, v in lay.items()}
                                   for lay in layers]}, x,
                       ["relu", "relu", "none"], BF16)
    assert y.shape == (4, 1) and epi.launches == before
    cfg = dataclasses.replace(get_config("garden_quality").model,
                              trunk_final_sigmoid=True)
    params = tm.init_model(cfg, torch.Generator().manual_seed(1))
    before = _launches()
    tm.render_image(params, cfg, dummy_rays(256, seed=2), chunk=256)
    # the proposal's hidden layers end on sigmoid too: neither stack fuses
    assert _launches() == before
