"""The hash-grid kernels H1 and H2 (``ops/hashgrid.py``, ``csrc/hashgrid.cu``)
and their plain versions (``core/hashgrid.py``).

On the CPU: the corner indices and weights against a literal per-corner loop
over dense and hashed levels; the plain backward (``index_add_``) against
autograd through the plain forward; the encode's table gradient; the
kernel's copies of the pattern's angles and the hash's primes.

On the card (marker ``cuda``, skipped here): H1 against the plain version
on the card at the ``garden_zip`` cell's shapes (float32: to round-off of
the points; bf16: within one bf16 ulp of the plain features rounded, where
the float32 gap allows), and H2 against the plain version's ``index_add_``
(to the float32 summation order of the atomic adds), the refusals and the
launch counts of a train step and a render.

This file imports no JAX, so its card tests run on a machine without JAX
(``--noconftest``, see README).
"""
import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mipnerf360_torch.config import get_config
from mipnerf360_torch.core import hashgrid as hg
from mipnerf360_torch.core.gaussians import MULTISAMPLES, PATTERN_ANGLES
from mipnerf360_torch.core.rays import Rays, rays_map
from mipnerf360_torch.ops import hashgrid

CSRC = Path(hashgrid.__file__).resolve().parents[1] / "csrc" / "hashgrid.cu"
ZIP = get_config("garden_zip").model


def _points(n, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand((n, 3), generator=g)
    pos[:4] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0],
                            [0.5, 0.25, 0.125], [1.0, 0.0, 0.999999]])
    su = torch.rand((n,), generator=g) * 0.01
    return pos.to(device), su.to(device)


def _literal(pos, n, size, log2_table):
    """Indices and weights of each point's 8 corners, corner by corner in
    Python, the arithmetic in float32."""
    f32 = np.float32
    idx, wts = [], []
    for p in pos.numpy():
        x = [f32(min(max(c, f32(0)), f32(1))) * f32(n) for c in p]
        lo = [min(max(math.floor(c), 0), n - 1) for c in x]
        f = [c - f32(l) for c, l in zip(x, lo)]
        row_i, row_w = [], []
        for k in range(8):
            b = [(k >> a) & 1 for a in range(3)]
            c = [lo[a] + b[a] for a in range(3)]
            w = f32(1)
            for a in range(3):
                w *= f[a] if b[a] else f32(1) - f[a]
            if (n + 1) ** 3 <= 2 ** log2_table:
                i = c[0] + (n + 1) * (c[1] + (n + 1) * c[2])
            else:
                i = ((c[0] * 1) % 2**32 ^ (c[1] * 2654435761) % 2**32
                     ^ (c[2] * 805459861) % 2**32) % size
            row_i.append(i)
            row_w.append(w)
        idx.append(row_i)
        wts.append(row_w)
    return torch.tensor(idx), torch.tensor(np.array(wts, np.float32))


@pytest.mark.parametrize("n,log2", [(16, 21), (127, 21), (128, 21),
                                    (2048, 21), (40, 12)])
def test_corners_are_a_literal_per_corner_loop(n, log2):
    pos, _ = _points(64, n)
    size = min((n + 1) ** 3, 2 ** log2)
    idx, w = hg.corners(pos, n, size, log2)
    want_i, want_w = _literal(pos, n, size, log2)
    assert torch.equal(idx, want_i)
    torch.testing.assert_close(w, want_w, rtol=0, atol=0)
    assert int(idx.max()) < size and int(idx.min()) >= 0


def test_grid_spec_of_the_cell():
    """The NeRF level's 10 levels from 16 to 8,192, 3 dense; about 84M
    entries over the three levels."""
    specs = [hg.model_grid_spec(ZIP, level) for level in range(3)]
    nerf = specs[-1]
    assert nerf.resolutions[0] == 16 and nerf.resolutions[-1] == 8192
    assert sum(s < 2**21 for s in nerf.sizes) == 3
    assert nerf.width == 40 and specs[0].width == specs[1].width == 10
    total = sum(s.entries * s.features for s in specs)
    assert 80e6 < total < 90e6


@pytest.mark.parametrize("features", [1, 4])
def test_plain_backward_is_autograd_of_the_plain_forward(features):
    spec = hg.grid_spec(4, 96, 5, 14, features)
    pos, su = _points(6 * 40, 3)
    g = torch.Generator().manual_seed(1)
    table = torch.randn((spec.entries, features), generator=g,
                        requires_grad=True)
    cot = torch.randn((40, spec.width), generator=g)
    out = hg.plain_features(table, pos, su, spec, 6)
    (want,) = torch.autograd.grad((out * cot).sum(), table)
    got = hg.plain_table_grad(cot, pos, su, spec, 6)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _rays(n, samples, seed, device="cpu"):
    """``n`` rays of the capture's kind (from around the scene's centre,
    directions of other lengths than 1, pixel-sized cone radii) and sorted
    edges from 0.05 to 60, inside and far outside the unit ball."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    t = np.sort(rng.uniform(0.05, 60.0, (n, samples + 1)), -1)
    ones = np.ones((n, 1), np.float32)
    rays = Rays(origins=rng.normal(scale=0.5, size=(n, 3)).astype(np.float32),
                directions=d, viewdirs=d / np.linalg.norm(d, axis=-1,
                                                          keepdims=True),
                radii=rng.uniform(5e-4, 2e-3, (n, 1)).astype(np.float32),
                near=ones * 0.05, far=ones * 60.0)
    return (rays_map(lambda x: torch.as_tensor(x, device=device), rays),
            torch.as_tensor(t.astype(np.float32), device=device))


def test_encode_grid_table_gradient_on_the_cpu():
    spec = hg.grid_spec(8, 256, 6, 14, 2)
    rays, t = _rays(16, 8, 5)
    g = torch.Generator().manual_seed(2)
    table = (torch.rand((spec.entries, 2), generator=g) * 2 - 1
             ).requires_grad_()
    pattern = (torch.rand((16, 8), generator=g), torch.rand((16, 8),
                                                            generator=g))
    out = hashgrid.encode_grid(table, t, rays, spec, pattern)
    assert out.shape == (16, 8, spec.width) and out.dtype == torch.float32
    cot = torch.randn(out.shape, generator=g)
    (got,) = torch.autograd.grad((out * cot).sum(), table)
    pos, su = hashgrid.plain_points(t, rays.origins, rays.directions,
                                    rays.radii, *pattern)
    want = hg.plain_table_grad(cot.reshape(-1, spec.width), pos, su, spec,
                               MULTISAMPLES)
    assert torch.equal(got, want)
    assert hashgrid.launches == {"H1": 0, "H2": 0}


def test_kernel_constants_are_the_modules():
    text = CSRC.read_text()
    angles = re.search(r"kAngles\[kPoints\] = \{([^}]*)\}", text).group(1)
    assert [float(a.strip().rstrip("f")) for a in angles.split(",")] == [
        float(a) for a in PATTERN_ANGLES]
    assert f"kPrimeY = {hg.PRIMES[1]}u" in text
    assert f"kPrimeZ = {hg.PRIMES[2]}u" in text
    assert f"kPoints = {MULTISAMPLES};" in text
    assert f"kBox = {hg.BOX}f" in text
    assert f"kMaxWidth = {hashgrid.MAX_WIDTH};" in text
    assert f"kMaxLevels = {hashgrid.MAX_LEVELS};" in text


# --- on the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _card_case(cuda, level, rays_n, seed, pattern=True):
    spec = hg.model_grid_spec(ZIP, level)
    samples = ZIP.nerf_samples if level == 2 else ZIP.num_samples
    rays, t = _rays(rays_n, samples, seed, cuda)
    g = torch.Generator(cuda).manual_seed(seed)
    table = torch.rand((spec.entries, spec.features), generator=g,
                       device=cuda) * 4 - 2
    pat = ((torch.rand((rays_n, samples), generator=g, device=cuda),
            torch.rand((rays_n, samples), generator=g, device=cuda))
           if pattern else None)
    return spec, rays, t, table, pat


def _plain_on_card(spec, rays, t, table, pat, block=4096):
    """The plain version on the card, in blocks of rays."""
    outs = []
    for lo in range(0, t.shape[0], block):
        sl = slice(lo, lo + block)
        p = None if pat is None else (pat[0][sl], pat[1][sl])
        pos, su = hashgrid.plain_points(
            t[sl], rays.origins[sl], rays.directions[sl], rays.radii[sl],
            *(p or (None, None)))
        outs.append(hg.plain_features(table, pos, su, spec, MULTISAMPLES))
    return torch.cat(outs)


@pytest.mark.cuda
@pytest.mark.parametrize("level,pattern", [(0, True), (1, True), (2, True),
                                           (2, False)])
def test_h1_matches_the_plain_version_on_card(cuda, level, pattern):
    """At the cell's 65,536 rays (each proposal round's 64 samples, the NeRF
    level's 32). The points differ from the plain version's by float32
    round-off (FMA contraction; CUDA's sincosf, cbrtf and erff), which moves
    a feature by its slope times that shift: at the finest levels up to a
    few 1e-4 of the table's scale of 2 in a few points; the mean gap stays
    at round-off."""
    spec, rays, t, table, pat = _card_case(cuda, level, 65536, 10 + level,
                                           pattern)
    before = hashgrid.launches["H1"]
    got = hashgrid.encode_grid(table, t, rays, spec, pat, torch.float32)
    assert hashgrid.launches["H1"] == before + 1
    want = _plain_on_card(spec, rays, t, table, pat).view(got.shape)
    gap = (got - want).abs()
    assert float(gap.max()) < 2e-2, float(gap.max())
    assert float(gap.mean()) < 1e-6 * 2 * 64, float(gap.mean())
    bf = hashgrid.encode_grid(table, t, rays, spec, pat, torch.bfloat16)
    ulp = torch.finfo(torch.bfloat16).eps * want.abs()
    off = (bf.float() - want.to(torch.bfloat16).float()).abs()
    assert float((off > ulp + gap + 1e-30).float().mean()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("level,dtype", [(0, torch.bfloat16),
                                         (2, torch.bfloat16),
                                         (2, torch.float32)])
def test_h2_is_h1s_adjoint_and_matches_index_add_on_card(cuda, level, dtype):
    """At the cell's shapes. H2 forms the points as H1 does, so <H1(T), c>
    = <T, H2(c)> up to float32 summation (a relative gap of a few 1e-7;
    1e-5 allowed). Against the plain version's ``index_add_``, whose points
    differ from the kernels' by float32 round-off (which moves a corner's
    weight by up to ~1e-3 of itself at the finest levels, and at a cell
    boundary moves an addend within round-off of 0 to the next corner), and
    whose atomic adds sum in another order: a relative L2 gap of about 1e-4
    over the table (1e-3 allowed)."""
    spec, rays, t, table, pat = _card_case(cuda, level, 65536, 20 + level)
    g = torch.Generator(cuda).manual_seed(3)
    cot = torch.randn((65536, t.shape[1] - 1, spec.width), generator=g,
                      device=cuda).to(dtype)
    before = hashgrid.launches["H2"]
    got = hashgrid.grid_backward(cot, t, rays.origins, rays.directions,
                                 rays.radii, *pat, spec)
    assert hashgrid.launches["H2"] == before + 1
    fwd = hashgrid.grid_forward(table, t, rays.origins, rays.directions,
                                rays.radii, *pat, spec, torch.float32)
    lhs = (fwd.double() * cot.double()).sum()
    rhs = (table.double() * got.double()).sum()
    scale = (fwd.double().abs() * cot.double().abs()).sum()
    assert float((lhs - rhs).abs() / scale) < 1e-5
    want = torch.zeros_like(got)
    for lo in range(0, 65536, 4096):
        sl = slice(lo, lo + 4096)
        pos, su = hashgrid.plain_points(t[sl], rays.origins[sl],
                                        rays.directions[sl], rays.radii[sl],
                                        pat[0][sl], pat[1][sl])
        want += hg.plain_table_grad(cot[sl].reshape(-1, spec.width), pos, su,
                                    spec, MULTISAMPLES)
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    assert rel < 1e-3, rel


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    spec, rays, t, table, pat = _card_case(cuda, 0, 64, 1)
    with pytest.raises(ValueError, match="table"):
        hashgrid.encode_grid(table[:-1], t, rays, spec, pat, torch.bfloat16)
    with pytest.raises(TypeError):
        hashgrid.encode_grid(table, t, rays, spec, pat, torch.float16)
    wide = hg.grid_spec(16, 512, 16, 21, 8)
    with pytest.raises(ValueError, match="levels"):
        hashgrid.encode_grid(torch.zeros((wide.entries, 8), device=cuda), t,
                             rays, wide, pat, torch.bfloat16)
    with pytest.raises(ValueError, match="go together"):
        hashgrid.encode_grid(table, t, rays, spec, (pat[0], None),
                             torch.bfloat16)


@pytest.mark.cuda
def test_a_train_step_and_a_render_launch_three_of_each(cuda):
    """One H1 a sampling level a forward and one H2 a level a step; the
    render launches H1 alone."""
    from mipnerf360_torch.config import Config, TrainConfig
    from mipnerf360_torch.models import mipnerf360 as tm
    from mipnerf360_torch.train.state import init_train_state
    from mipnerf360_torch.train.step import make_train_step

    m = dataclasses.replace(ZIP, grid_max_res="64,128,256",
                            grid_log2_table=16)
    cfg = Config(model=m, train=TrainConfig(batch_size=256))
    state = init_train_state(m, cfg.train, device=cuda)
    rays, _ = _rays(256, 8, 4, cuda)
    before = dict(hashgrid.launches)
    state, aux = make_train_step(cfg)(state, rays, torch.rand(256, 3,
                                                              device=cuda))
    assert torch.isfinite(aux["loss"])
    assert hashgrid.launches["H1"] - before["H1"] == 3
    assert hashgrid.launches["H2"] - before["H2"] == 3
    before = dict(hashgrid.launches)
    tm.render_image(state.params, m, rays, chunk=128, device=cuda)
    assert hashgrid.launches["H1"] - before["H1"] == 3 * 2
    assert hashgrid.launches["H2"] == before["H2"]
