"""Sample-axis (context-parallel) volume rendering across the mesh's model
axis (counterpart of ``mipnerf360_tpu/parallel/sample_axis.py``).

The transmittance prefix sum is associative, so it splits exactly across
the ranks that each hold a contiguous run of every ray's samples:

    T_i = exp(-(prefix of the shards before mine + local exclusive cumsum))

Each rank computes its run's optical-depth sum; a gather gives every
shard's sum and a masked sum the exclusive cross-shard prefix; then the
local weights, and the per-ray partials (rgb, acc, distance numerator)
summed over the group in one all_reduce. Two collectives per composite.
The composite is plain PyTorch, as it is ``jnp`` in the JAX package: the
NeRF level's K1 launch is replaced by these collectives, and the proposal
level, which every rank runs whole, keeps K1.

Each rank runs the NeRF MLP on its own samples only (samples are
independent through the MLP), so the composite takes this rank's slice of
rgb and density and the full t edges. The ray-batch axis composes with it:
``render_image`` hands each data rank its own rows.
"""
from __future__ import annotations

import torch

from .collectives import gather, global_sum, group_rank, group_size


class SampleShardedComposite:
    """``fn(rgb, density, t_vals, dirs) -> (rgb, distance, acc, weights)``
    over the samples split across ``group``: rgb [B, n, 3] and density
    [B, n] are this rank's ``local_slice`` of the N samples, t_vals [B, N+1]
    and dirs [B, 3] whole; weights come back as this rank's [B, n]. The
    gradients reach density and rgb as those of the one-rank composite."""

    def __init__(self, group, white_bkgd: bool = False):
        self.group = group
        self.white_bkgd = white_bkgd
        self.shards = group_size(group)
        self.index = group_rank(group)

    def local_slice(self, n: int) -> slice:
        """This rank's run of ``n`` samples."""
        if n % self.shards:
            raise ValueError(f"sample axis {n} must divide over "
                             f"{self.shards} sample shards")
        k = n // self.shards
        return slice(self.index * k, (self.index + 1) * k)

    def __call__(self, rgb, density, t_vals, dirs):
        sl = self.local_slice(t_vals.shape[-1] - 1)
        if density.shape[-1] != sl.stop - sl.start:
            raise ValueError(f"density holds {density.shape[-1]} samples, "
                             f"this shard's run is {sl.stop - sl.start}")
        t = t_vals[..., sl.start:sl.stop + 1]
        delta = (t[..., 1:] - t[..., :-1]) * torch.linalg.norm(
            dirs[..., None, :], dim=-1)
        density_delta = density * delta                       # [B, n]

        # Exclusive prefix of optical depth across the shards.
        sums = gather(density_delta.sum(-1, keepdim=True), self.group,
                      dim=-1, sum_backward=True)              # [B, P]
        before = torch.arange(self.shards, device=sums.device) < self.index
        prefix = torch.where(before, sums, torch.zeros_like(sums)).sum(-1)

        local_excl = torch.cat([torch.zeros_like(density_delta[..., :1]),
                                torch.cumsum(density_delta[..., :-1], dim=-1)],
                               dim=-1)
        trans = torch.exp(-(prefix[..., None] + local_excl))
        weights = -torch.expm1(-density_delta) * trans         # [B, n]

        t_mids = 0.5 * (t[..., :-1] + t[..., 1:])
        partial = torch.cat([torch.sum(weights[..., None] * rgb, dim=-2),
                             weights.sum(-1, keepdim=True),
                             (weights * t_mids).sum(-1, keepdim=True)], dim=-1)
        total = global_sum(partial, self.group)                # [B, 5]
        comp_rgb, acc, dist_num = total[..., :3], total[..., 3], total[..., 4]
        distance = torch.clamp(torch.nan_to_num(dist_num / acc, nan=0.0),
                               t_vals[..., 0], t_vals[..., -1])
        if self.white_bkgd:
            comp_rgb = comp_rgb + (1.0 - acc[..., None])
        return comp_rgb, distance, acc, weights


def make_sample_sharded_composite(mesh, white_bkgd: bool = False
                                  ) -> SampleShardedComposite:
    """The composite over ``mesh``'s model axis (one shard when the mesh
    has none)."""
    return SampleShardedComposite(mesh.model_group, white_bkgd)
