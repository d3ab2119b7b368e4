"""G1, the MLP forward's GEMM with the bias, bf16 rounding and ReLU in its
epilogue (``ops/mlp_gemm.py``), and the rule that routes each hidden layer
of ``models/mlp.py::relu_stack_heads`` to it or to cuBLAS + E1.

On the CPU: the plain version against the layer-by-layer chain (one and two
inputs, the first layers' K tails of 520 and 504), the wrapper's refusals,
the routing of every layout's layers (the counts a forward launches), and
the benchmark's class of the kernel's name. On the card (marker ``cuda``,
skipped here): the kernel against its plain version at the main path's
shapes, and the fused stack's forward and gradients against the chain.

This file imports no JAX, so its card tests run on a machine without JAX
(``--noconftest``, see README).
"""
import dataclasses

import numpy as np
import pytest
import torch

from mipnerf360_torch.config import get_config
from mipnerf360_torch.core.rays import dummy_rays
from mipnerf360_torch.models import mipnerf360 as tm
from mipnerf360_torch.models import mlp as tmlp
from mipnerf360_torch.ops import mlp_epilogue as epi
from mipnerf360_torch.ops import mlp_gemm
from nerfbench import yardstick

BF16 = torch.bfloat16


def _normal(shape, seed, scale=1.0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        scale=scale, size=shape).astype(np.float32))


def _layer(m, ks, n, seed):
    """Inputs [m, k] for each k of ``ks`` in bf16, w [sum(ks), n] bf16 of
    fan-in scale, b [n] f32."""
    xs = [_normal((m, k), seed + i).to(BF16) for i, k in enumerate(ks)]
    w = _normal((sum(ks), n), seed + 7, sum(ks) ** -0.5).to(BF16)
    return xs, w, _normal((n,), seed + 8, 0.1)


# (M, input widths, N): the first layer of the repo's layout (520) and of
# the published one (504), a 1024-wide layer, the published trunk's skip
# layer (1024 + 504) and view layer (256 + 27), ragged rows.
CPU_CASES = [(37, (520,), 1024), (300, (504,), 256), (64, (1024,), 1024),
             (33, (1024, 504), 1024), (45, (256, 27), 128)]


@pytest.mark.parametrize("m,ks,n", CPU_CASES)
def test_plain_g1_is_the_chain_bit_for_bit(m, ks, n):
    """The plain version is the chain it replaces: each input's product in
    f32, summed in f32, the bias, the rounding, the ReLU."""
    xs, w, b = _layer(m, ks, n, m)
    k = ks[0]
    y = xs[0].float() @ w[:k].float()
    if len(xs) == 2:
        y = y + xs[1].float() @ w[k:].float()
    want = torch.relu((y + b).to(BF16))
    got = mlp_gemm.plain_bias_relu(xs[0], w, b, *xs[1:])
    assert got.dtype == BF16 and torch.equal(got, want)
    y1 = [tmlp._mm_f32(xs[1], w[k:])] if len(xs) == 2 else []
    assert torch.equal(got, epi.plain_bias_relu(tmlp._mm_f32(xs[0], w[:k]),
                                                b, *y1))
    if mlp_gemm.takes(xs, w):
        assert torch.equal(mlp_gemm.bias_relu(xs[0], w, b, *xs[1:]), got)


def _refuses(error, x, w, b, x1=None, match=None):
    before = dict(mlp_gemm.launches)
    with pytest.raises(error, match=match):
        mlp_gemm.bias_relu(x, w, b, x1)
    assert mlp_gemm.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Wrong dtypes, widths that are not multiples of 64, rows TMA cannot
    describe (27 features: 54-byte rows; a view 2 bytes off a 16-byte
    boundary), mismatched shapes: each raises, whatever the device, and
    nothing launches."""
    (x,), w, b = _layer(16, (64,), 128, 1)
    _refuses(TypeError, x.float(), w, b, match="bfloat16")
    _refuses(TypeError, x, w.float(), b, match="bfloat16")
    _refuses(TypeError, x, w, b.to(BF16), match="float32")
    (x96,), w96, b96 = _layer(16, (64,), 96, 2)
    _refuses(ValueError, x96, w96, b96, match="multiples of 64")
    (x27,), w27, b27 = _layer(16, (27,), 128, 3)
    _refuses(ValueError, x27, w27, b27, match="16 bytes")
    off = torch.zeros(16 * 64 + 1, dtype=BF16)[1:].view(16, 64)
    _refuses(ValueError, off, w, b, match="16-byte")
    _refuses(ValueError, x.t().contiguous().t(), w, b, match="unit-stride")
    _refuses(ValueError, x, w[:32], b, match="rows")
    _refuses(ValueError, x, w, b[:64], match="contiguous")
    (x0, x1), w2, b2 = _layer(16, (64, 27), 128, 4)
    _refuses(ValueError, x0, w2, b2, x1, match="16 bytes")
    _refuses(ValueError, x0, w2, b2, x1[:8], match="rows")


@pytest.mark.parametrize("k,taken", [(520, True), (504, True), (1024, True),
                                     (256, True), (8, True), (226, False),
                                     (58, False), (27, False)])
def test_rows_a_multiple_of_16_bytes_apart_are_taken(k, taken):
    """TMA reads rows 16 bytes apart: an input width that is a multiple of 8
    bf16. The presets as shipped (5 IPE scales: 226 features; fern's 58)
    keep their first layer on cuBLAS + E1."""
    xs, w, _ = _layer(4, (k,), 256, 5)
    assert mlp_gemm.takes(xs, w) is taken


def _count_forward(monkeypatch, model, rays: int):
    """G1 and E1 calls of one forward of every level of ``model`` at its
    widths on the CPU, with the fused stack forced as on the card."""
    calls = {"G1": 0, "E1": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(mlp_gemm, "bias_relu_taken",
                        counted("G1", mlp_gemm.bias_relu_taken))
    monkeypatch.setattr(epi, "bias_relu", counted("E1", epi.bias_relu))
    monkeypatch.setattr(tmlp, "fused_relu_stack", lambda *a, **k: True)
    params = tm.init_model(model, torch.Generator().manual_seed(1))
    with torch.no_grad():
        tm.render_image(params, model, dummy_rays(rays, seed=2), chunk=rays,
                        device="cpu")
    return calls


@pytest.mark.parametrize("preset,scales,want", [
    ("garden_quality", 12, {"G1": 12, "E1": 0}),
    ("blender_lego_quality", 12, {"G1": 12, "E1": 0}),
    ("garden_paper", None, {"G1": 16, "E1": 1}),
    ("garden_quality", None, {"G1": 10, "E1": 2})])
def test_routing_of_each_layout(monkeypatch, preset, scales, want):
    """A forward of each level (a train step's, a render chunk's): the
    cells' repo layout (12 IPE scales: 520 features) runs its 4 proposal
    and 8 trunk layers through G1; the published layout its 2 x 4 proposal
    and 8 trunk layers (the skip's two inputs among them), and its view
    layer (27 direction features) through cuBLAS + E1; the preset as
    shipped (226 features) both first layers through cuBLAS + E1."""
    model = get_config(preset).model
    if scales is not None:
        model = dataclasses.replace(model, ipe_max_deg=scales)
    assert _count_forward(monkeypatch, model, 2) == want


def test_the_kernel_name_is_classed_gemm():
    """``nerfbench`` classes device operations by name: G1's instances (as
    the profiler names them) are GEMMs, so ``gemm_roofline.*`` counts the
    forward's FLOPs over the time of the kernels that do them."""
    for bn in (64, 128, 256):
        name = (f"void (anonymous namespace)::mlp_gemm_bias_relu<{bn}>("
                "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
                "CUtensorMap_st, CUtensorMap_st, float const*, int, int, "
                "int, int, int)")
        assert yardstick.kernel_class(name) == yardstick.GEMM


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_layer(m, ks, n, seed, device):
    g = torch.Generator(device).manual_seed(seed)
    xs = [torch.randn(m, k, generator=g, device=device).to(BF16) for k in ks]
    w = (torch.randn(sum(ks), n, generator=g, device=device)
         * sum(ks) ** -0.5).to(BF16)
    return xs, w, torch.randn(n, generator=g, device=device) * 0.1


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (the smallest normal's below it)."""
    e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126)).exponent
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _assert_close_to_plain(got, want, xs, w):
    """G1 against its plain version. The kernel sums x w in f32 in another
    order than cuBLAS (and, with two inputs, in one sum where cuBLAS made
    two and added them), so the f32 pre-activations differ by a few
    roundings of the sum's terms: an output may differ by one bf16 ulp
    where the two sums straddle a rounding boundary, and by more only where
    the sum nearly cancels (an output below the f32 sums' error, bounded
    here by 2^-21 of the sum of |x||w|). At most 1% of outputs differ."""
    k = xs[0].shape[1]
    mag = xs[0].float().abs() @ w[:k].float().abs()
    if len(xs) == 2:
        mag += xs[1].float().abs() @ w[k:].float().abs()
    diff = (got.float() - want.float()).abs()
    tol = _bf16_ulp(torch.maximum(got.float().abs(), want.float().abs())) \
        + 2.0 ** -21 * mag
    assert (diff <= tol).all(), (diff - tol).max().item()
    assert (got != want).float().mean().item() <= 0.01


# (M, input widths, N): a train step's proposal and NeRF layers (4096 rays
# x 64 samples), a render chunk's (8192 x 64) at the first layers' K tails,
# a garden_paper step's skip layer (16,384 x 32) and its proposal first
# layer, rows that fill no tile, the parity presets' 64 rays x 64 samples.
CARD_CASES = [(262144, (256,), 256), (262144, (1024,), 1024),
              (524288, (520,), 1024), (524288, (256,), 256),
              (524288, (1024, 504), 1024), (524288, (504,), 256),
              (4097 * 64 + 3, (520,), 1024), (4097 * 64 + 3, (1024, 504), 1024),
              (4096, (1024,), 1024), (4096 + 5, (256,), 256),
              (1000, (504, 256), 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,ks,n", CARD_CASES)
def test_g1_matches_plain_on_card(cuda, m, ks, n):
    xs, w, b = _card_layer(m, ks, n, m + n, cuda)
    before = mlp_gemm.launches["G1"]
    got = mlp_gemm.bias_relu(xs[0], w, b, *xs[1:])
    assert mlp_gemm.launches["G1"] == before + 1
    _assert_close_to_plain(got, mlp_gemm.plain_bias_relu(xs[0], w, b, *xs[1:]),
                           xs, w)


@pytest.mark.cuda
def test_g1_refuses_on_card(cuda):
    (x,), w, b = _card_layer(64, (256,), 256, 1, cuda)
    before = dict(mlp_gemm.launches)
    with pytest.raises(ValueError, match="16-byte"):
        mlp_gemm.bias_relu(torch.zeros(64 * 256 + 1, dtype=BF16, device=cuda)
                           [1:].view(64, 256), w, b)
    with pytest.raises(ValueError, match="CUDA"):
        mlp_gemm.bias_relu(x, w.cpu(), b)
    with pytest.raises(TypeError):
        mlp_gemm.bias_relu(x.float(), w, b)
    with pytest.raises(ValueError, match="multiples of 64"):
        mlp_gemm.bias_relu(x, w[:, :96].contiguous(), b[:96].contiguous())
    assert mlp_gemm.launches == before


def _grads(fused, layers, x, r, extras):
    """Outputs and gradients (each layer's w and b) of sum(out * r) of the
    published trunk under its density head, fused or the chain. Its input
    takes no gradient, as the encode's output."""
    layers = [{k: v.clone().requires_grad_() for k, v in l.items()}
              for l in layers]
    trunk, head = layers[:-1], layers[-1]
    if fused:
        (y,) = tmlp.relu_stack_heads(trunk, [head], x, split=True,
                                     extras=extras)
    else:
        feat = tmlp.apply_mlp({"layers": trunk}, x, ["relu"] * len(trunk),
                              BF16, extras=extras)
        y = tmlp.apply_linear(head, feat, BF16)
    leaves = [l[k] for l in layers for k in ("w", "b")]
    return y.detach(), torch.autograd.grad((y * r).sum(), leaves)


# Limits on the relative L2 difference of the trunk's output and of each
# gradient leaf: G1's bf16 outputs differ from the chain's by an ulp where
# the f32 sums, in another order, straddle a rounding, and that spreads
# through the later layers and ReLU masks. About four times the reading on
# an H100: output 3.2e-4, gradient leaves at most 8.2e-3 (the first layer's
# w; the deeper the layer, the smaller).
STACK_OUT_RTOL, STACK_GRAD_RTOL = 1.5e-3, 3.5e-2


@pytest.mark.cuda
def test_fused_stack_with_g1_matches_the_chain_on_card(cuda, monkeypatch):
    """The published trunk (504 inputs, 8 layers of 1024, the skip into the
    sixth) under its density head on 8,192 rows: the stack through G1,
    E2 and E3 against the layer-by-layer chain. Outputs and every gradient
    leaf by relative L2 under STACK_OUT_RTOL and STACK_GRAD_RTOL."""
    m, sizes = 8192, [504] + [1024] * 8
    gen = torch.Generator().manual_seed(3)
    layers = tmlp.init_mlp(gen, sizes)["layers"]
    layers[5]["w"] = torch.cat([layers[5]["w"], tmlp.init_mlp(
        gen, [504, 1024])["layers"][0]["w"] * 0.5])
    layers += tmlp.init_mlp(gen, [1024, 1])["layers"]
    layers = [{k: v.to(cuda) for k, v in l.items()} for l in layers]
    x = torch.randn(m, 504, device=cuda).to(BF16)
    r = torch.randn(m, 1, device=cuda)
    extras = [tmlp.Extra(5)]
    before = dict(mlp_gemm.launches)
    out_f, g_f = _grads(True, layers, x, r, extras)
    assert mlp_gemm.launches["G1"] == before["G1"] + 8
    monkeypatch.setattr(tmlp, "fused_relu_stack", lambda *a, **k: False)
    out_c, g_c = _grads(False, layers, x, r, extras)
    rel = ((out_f - out_c).norm() / out_c.norm()).item()
    grel = [((a - b).norm() / b.norm()).item() for a, b in zip(g_f, g_c)]
    print(f"trunk: output rel L2 {rel:.3e}; gradient leaves rel L2 max "
          f"{max(grel):.3e} {grel}")
    assert rel < STACK_OUT_RTOL
    for i, r in enumerate(grel):
        assert r < STACK_GRAD_RTOL, i
