"""The encode kernels ENC and VIEW (``ops/encode.py``, ``csrc/encode.cu``).

On the CPU: the plain version, which the model takes for a CPU tensor, equals
the composition ``models/mipnerf360.py::_encode`` ran before the kernels
(``factored_ipe``, the view features' and the padding's ``torch.cat``) bit
for bit, in float32, over cone and cylinder rays, 1, 5 and 12 scales, the view
features in the row or not, padding, and a sliced ``t_vals``; VIEW's plain
version is ``unit_viewdir_enc``; the kernel's copy of ``P_BASIS`` is the
module's. On the card (marker ``cuda``, skipped here): ENC's float32 output
no further from a float64 evaluation than the plain float32 path on the card,
at every scale; its bf16 output within one bf16 ulp of the plain features
rounded; refusals of what it does not take; its launch counts, alone and in
the model's forwards; and no host sync.

This file imports no JAX, so its card tests run on a machine without JAX
(``--noconftest``, see README).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mipnerf360_torch.config import ModelConfig
from mipnerf360_torch.core.encoding import P_BASIS, unit_viewdir_enc, viewdir_enc
from mipnerf360_torch.core.fused_encode import factored_ipe
from mipnerf360_torch.core.rays import Rays, rays_map
from mipnerf360_torch.models import mipnerf360 as tm
from mipnerf360_torch.ops import encode

CSRC = Path(encode.__file__).resolve().parents[1] / "csrc" / "encode.cu"
# The view branch's layout: the direction features go to the branch, not to
# the MLP's input row.
BRANCH = dict(bottleneck_width=256, viewdir_width=128)


def _rays(n, seed, samples, device="cpu", span=2):
    """``n`` rays and their sorted ``t_vals`` [n, span * samples + 1]: origins
    around the scene's centre, directions of other lengths than 1, cone
    radii as a capture's pixels give them, edges from 0.05 to 6 (inside and
    outside the unit ball). Two rays hit viewdir_enc's edge cases: x = -1e-6
    (the tiny denominator) and z = 1."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    view = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    view[0] = [np.float32(-1e-6), 0.0, np.float32(np.sqrt(1 - 1e-12))]
    view[1] = [0.0, 0.0, 1.0]
    t = np.sort(rng.uniform(0.05, 6.0, (n, span * samples + 1)), -1)
    ones = np.ones((n, 1), np.float32)
    arrays = Rays(
        origins=rng.normal(scale=1.5, size=(n, 3)).astype(np.float32),
        directions=d, viewdirs=view,
        radii=rng.uniform(5e-4, 2e-3, (n, 1)).astype(np.float32),
        near=ones * 0.05, far=ones * 6.0)
    return (rays_map(lambda x: torch.as_tensor(x, device=device), arrays),
            torch.as_tensor(t.astype(np.float32), device=device))


def _before(cfg, rays, t_vals):
    """``models/mipnerf360.py::_encode``'s factored path as it was before
    ENC: the features in float32."""
    pos = factored_ipe(t_vals, rays.origins, rays.directions, rays.radii,
                       ray_shape=cfg.ray_shape, min_deg=cfg.ipe_min_deg,
                       max_deg=cfg.ipe_max_deg)
    x = pos
    if not cfg.bottleneck_width:
        view = viewdir_enc(rays.viewdirs, cfg.viewdir_min_deg,
                           cfg.viewdir_max_deg)
        view = view[..., None, :].expand(pos.shape[:-1] + (view.shape[-1],))
        x = torch.cat([pos, view], dim=-1)
    pad = cfg.padded_input_dim - cfg.input_dim
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    return x


def _cfg(ray_shape, scales, layout, **kw):
    return ModelConfig(ray_shape=ray_shape, ipe_max_deg=scales,
                       **(BRANCH if layout == "branch" else {}), **kw)


@pytest.mark.parametrize("variant", ["plain", "padded", "sliced"])
@pytest.mark.parametrize("layout", ["row", "branch"])
@pytest.mark.parametrize("scales", [1, 5, 12])
@pytest.mark.parametrize("ray_shape", ["cone", "cylinder"])
def test_plain_version_is_the_composition_it_replaces(ray_shape, scales,
                                                      layout, variant):
    cfg = _cfg(ray_shape, scales, layout,
               pad_input_lanes=variant == "padded")
    rays, t = _rays(6, scales, 8)
    t = t[:, 3:12] if variant == "sliced" else t[:, :9].contiguous()
    before = dict(encode.launches)
    got = tm._encode(cfg, rays, t)
    want = _before(cfg, rays, t)
    assert got.dtype == torch.float32 and cfg.compute_dtype == "bfloat16"
    assert got.shape == (6, 8, cfg.padded_input_dim)
    assert torch.equal(got, want)
    assert encode.launches == before


def test_plain_view_version_is_unit_viewdir_enc():
    rays, _ = _rays(7, 0, 4)
    before = dict(encode.launches)
    got = encode.encode_viewdirs(rays.viewdirs, 0, 4, torch.bfloat16)
    assert got.dtype == torch.float32
    assert torch.equal(got, unit_viewdir_enc(rays.viewdirs, 0, 4))
    assert encode.launches == before


def test_kernel_basis_is_the_modules():
    """``csrc/encode.cu``'s constant table holds P_BASIS's float32 values,
    in order."""
    src = CSRC.read_text()
    table = src[src.index("kP[kBasis][3] = {"):]
    table = table[:table.index("};")]
    nums = re.findall(r"(-?\d+\.\d+(?:e-?\d+)?)f", table)
    got = np.array([np.float32(float(x)) for x in nums]).reshape(-1, 3)
    np.testing.assert_array_equal(got, P_BASIS)


# --- on the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _args(cfg):
    return dict(ray_shape=cfg.ray_shape, min_deg=cfg.ipe_min_deg,
                max_deg=cfg.ipe_max_deg,
                view_degs=None if cfg.bottleneck_width
                else (cfg.viewdir_min_deg, cfg.viewdir_max_deg),
                width=cfg.padded_input_dim)


def _card_case(cuda, ray_shape, scales, layout, sliced, n=512, samples=64):
    cfg = _cfg(ray_shape, scales, layout, pad_input_lanes=layout == "row")
    rays, t = _rays(n, scales, samples, cuda)
    t = t[:, 5:samples + 6] if sliced else t[:, :samples + 1].contiguous()
    return cfg, rays, t


def _columns(cfg):
    """(name, column slice) of each scale's 42 features, then the view
    features."""
    cols = [(f"scale {i}", slice(42 * i, 42 * i + 42))
            for i in range(cfg.ipe_max_deg - cfg.ipe_min_deg)]
    if not cfg.bottleneck_width:
        cols.append(("view", slice(42 * len(cols), cfg.input_dim)))
    return cols


@pytest.mark.cuda
@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("layout", ["row", "branch"])
@pytest.mark.parametrize("scales", [1, 12])
@pytest.mark.parametrize("ray_shape", ["cone", "cylinder"])
def test_enc_f32_no_further_from_f64_than_plain(cuda, ray_shape, scales,
                                                layout, sliced):
    cfg, rays, t = _card_case(cuda, ray_shape, scales, layout, sliced)
    kw = _args(cfg)
    got = encode.encode_points(t, rays, dtype=torch.float32, **kw)
    plain = encode.plain_encode_points(t, rays, **kw)
    truth = encode.plain_encode_points(
        t.double(), rays_map(lambda x: x.double(), rays), **kw)
    assert got.dtype == torch.float32 and got.shape == plain.shape
    for name, cols in _columns(cfg):
        err = (got[..., cols].double() - truth[..., cols]).abs().max().item()
        ref = (plain[..., cols].double() - truth[..., cols]).abs().max().item()
        assert err <= 1.5 * ref + 1e-7, (name, err, ref)
    assert not got[..., cfg.input_dim:].any()
    same = (got == plain).float().mean().item()
    print(f"ENC float32 {ray_shape} {scales} scales {layout}: "
          f"{100 * (1 - same):.4f}% of features differ from the plain "
          "version's")


def _ordered(x):
    """bf16 values as integers in their order (+0 and -0 both 0)."""
    bits = x.view(torch.int16).int()
    mag = bits & 0x7FFF
    return torch.where(bits < 0, -mag, mag)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["row", "branch"])
@pytest.mark.parametrize("scales", [1, 5, 12])
@pytest.mark.parametrize("ray_shape", ["cone", "cylinder"])
def test_enc_bf16_within_one_ulp_of_plain(cuda, ray_shape, scales, layout):
    cfg, rays, t = _card_case(cuda, ray_shape, scales, layout, False)
    kw = _args(cfg)
    got = encode.encode_points(t, rays, dtype=torch.bfloat16, **kw)
    want = encode.plain_encode_points(t, rays, **kw).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    ulps = (_ordered(got) - _ordered(want)).abs()
    print(f"ENC bf16 {ray_shape} {scales} scales {layout}: "
          f"{100 * (ulps > 0).float().mean().item():.4f}% of features differ "
          f"from the plain version's rounded, by at most "
          f"{ulps.max().item()} ulp")
    assert ulps.max().item() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_view_matches_plain(cuda, dtype):
    rays, _ = _rays(1000, 3, 4, cuda)
    # a strided view: three columns of a wider array
    wide = torch.cat([rays.origins, rays.viewdirs], dim=-1)
    view = wide[:, 3:]
    got = encode.encode_viewdirs(view, 0, 4, dtype)
    want = unit_viewdir_enc(view, 0, 4)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        assert (_ordered(got) - _ordered(want.to(dtype))).abs().max() <= 1


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take(cuda):
    cfg, rays, t = _card_case(cuda, "cone", 2, "row", False, n=8, samples=4)
    kw = _args(cfg)
    before = dict(encode.launches)
    with pytest.raises(TypeError):
        encode.encode_points(t.double(), rays, **kw)
    with pytest.raises(TypeError):
        encode.encode_points(t, rays, dtype=torch.float16, **kw)
    with pytest.raises(ValueError):
        encode.encode_points(t, rays._replace(origins=rays.origins[:, :2]),
                             **kw)
    with pytest.raises(ValueError):
        encode.encode_points(t[:4], rays, **kw)
    with pytest.raises(ValueError):
        encode.encode_points(t, rays._replace(radii=rays.radii.cpu()), **kw)
    with pytest.raises(ValueError):
        encode.encode_points(t, rays, **dict(kw, ray_shape="prism"))
    with pytest.raises(ValueError):
        encode.encode_points(t, rays, **dict(kw, width=cfg.input_dim - 1))
    with pytest.raises(ValueError):
        encode.encode_points(t, rays, **dict(kw, max_deg=0))
    with pytest.raises(ValueError):
        encode.encode_points(t, rays, **dict(kw, max_deg=64))
    with pytest.raises(ValueError):
        encode.encode_points(t[:, :1], rays, **kw)
    with pytest.raises(ValueError):
        every_other = torch.zeros(8, 10, device=cuda)[:, ::2]
        encode.encode_points(every_other, rays, **kw)
    with pytest.raises(TypeError):
        encode.encode_viewdirs(rays.viewdirs.half(), 0, 4)
    with pytest.raises(ValueError):
        encode.encode_viewdirs(rays.viewdirs[:, :2], 0, 4)
    assert encode.launches == before


@pytest.mark.cuda
def test_launches_counted(cuda):
    cfg, rays, t = _card_case(cuda, "cone", 2, "row", False, n=8, samples=4)
    before = dict(encode.launches)
    encode.encode_points(t, rays, dtype=torch.bfloat16, **_args(cfg))
    encode.encode_viewdirs(rays.viewdirs, 0, 4, torch.bfloat16)
    assert encode.launches == {"ENC": before["ENC"] + 1,
                               "VIEW": before["VIEW"] + 1}
    small = dict(num_samples=8, hidden_proposal=16, hidden_nerf=32,
                 nerf_depth=4)
    for kw, want in ((small, (2, 0)), (dict(small, proposal_rounds=2,
                                            nerf_samples=4, trunk_skip=2,
                                            **BRANCH), (3, 1))):
        mcfg = ModelConfig(**kw)
        params = tm.map_params(lambda p: p.to(cuda), tm.init_model(mcfg))
        rays, _ = _rays(16, 0, 2, cuda)
        before = dict(encode.launches)
        with torch.no_grad():
            tm.render_rays(params, mcfg, rays, False)
        assert (encode.launches["ENC"] - before["ENC"],
                encode.launches["VIEW"] - before["VIEW"]) == want


@pytest.mark.cuda
def test_no_host_sync(cuda):
    cfg, rays, t = _card_case(cuda, "cylinder", 12, "row", True)
    kw = _args(cfg)
    encode.encode_points(t, rays, dtype=torch.bfloat16, **kw)
    encode.encode_viewdirs(rays.viewdirs, 0, 4, torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        encode.encode_points(t, rays, dtype=torch.bfloat16, **kw)
        encode.encode_viewdirs(rays.viewdirs, 0, 4, torch.bfloat16)
        tm._encode(cfg, rays, t)
    finally:
        torch.cuda.set_sync_debug_mode(0)
