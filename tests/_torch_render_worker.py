"""Worker of tests/test_torch_render_mesh.py (not a pytest module); 4 ranks,
usage in ``_torch_ranks.py``.

Renders 200 rays (not a multiple of the chunk) on the all-data mesh with
chunk 64 and chunk 50 (not a multiple of the data axis), beside the
one-rank render of the same params. With the argument ``cuda`` (2 ranks,
on a card): the ``sample_shards=2`` render with ``device="cuda"`` and no
mesh, its K1 launches, beside the one-rank render on the CPU.
"""
import dataclasses
import sys

import torch

from _torch_ranks import join, save

RANK, NPROC, OUT, ARGS = join(sys.argv)

from mipnerf360_torch.config import ModelConfig  # noqa: E402
from mipnerf360_torch.core.rays import dummy_rays  # noqa: E402
from mipnerf360_torch.models import mipnerf360 as tm  # noqa: E402
from mipnerf360_torch.parallel import default_render_mesh  # noqa: E402

cfg = ModelConfig(num_samples=8, hidden_proposal=16, hidden_nerf=32,
                  nerf_depth=2, compute_dtype="float32")
params = tm.init_model(cfg, torch.Generator().manual_seed(0))
rays = dummy_rays(200)
out = {}
if ARGS == ["cuda"]:
    # on the card under gloo: the sample-sharded render without a mesh
    # stays on the card and launches K1
    from mipnerf360_torch.ops import composite

    composite.launches = 0
    rgb, dist, acc = tm.render_image(
        params, dataclasses.replace(cfg, sample_shards=2), rays, chunk=64,
        device="cuda")
    out["on_card"] = int(all(x.is_cuda for x in (rgb, dist, acc)))
    out["k1_launches"] = composite.launches
    out["one_rank_rgb"], _, _ = tm.render_image(params, cfg, rays, chunk=64,
                                                device="cpu")
    out["card_rgb"] = rgb
else:
    mesh = default_render_mesh(device="cpu")
    out.update(mesh_data=mesh.data, mesh_model=mesh.model)
    for tag, m, chunk in (("one_rank", None, 64), ("mesh", mesh, 64),
                          ("mesh_50", mesh, 50)):
        rgb, dist, acc = tm.render_image(params, cfg, rays, chunk=chunk,
                                         mesh=m, device="cpu")
        out.update({f"{tag}_rgb": rgb, f"{tag}_distance": dist,
                    f"{tag}_acc": acc})
save(OUT, RANK, **out)
