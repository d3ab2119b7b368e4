"""Typed configuration system with named presets.

A copy of ``mipnerf360_tpu/config.py`` (stdlib only), kept field for field so
that a ``config.json`` written by the JAX trainer loads here with
``Config.from_json``. The only field whose meaning differs is ``use_pallas``
(see its comment).

Replaces the reference's single argparse blob (its config.py:6-85),
whose ~10 dead flags (SURVEY.md C22) we either wire for real (``ray_shape``)
or drop. Presets cover BASELINE.json's five benchmark configs; every field can
be overridden from the CLI (see apps/) and the resolved config is serialized
into the checkpoint directory.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    num_samples: int = 64            # reference config.py:20 default
    hidden_proposal: int = 256
    proposal_depth: int = 4          # hidden layers in the proposal tower
    hidden_nerf: int = 1024
    nerf_depth: int = 8              # hidden layers in the NeRF tower
    density_bias: float = -1.0
    rgb_padding: float = 0.001
    resample_padding: float = 0.01
    white_bkgd: bool = False
    viewdir_min_deg: int = 0
    viewdir_max_deg: int = 4
    # IPE frequency scales 2^i, i in [ipe_min_deg, ipe_max_deg). The
    # reference drops the paper's 2^k scaling entirely (README.md:7) — its
    # own README blames non-convergence on such simplifications — so the
    # parity default is a single scale [0, 1). The paper-faithful encoding
    # (and the main quality lever) is max_deg ~ 5-8.
    ipe_min_deg: int = 0
    ipe_max_deg: int = 1
    ray_shape: str = "cone"          # "cone" | "cylinder"
    # Reference quirks, reproduced by default for parity (model.py:51,147,150-158):
    # a Sigmoid on the last trunk layer and on the raw-density head.
    trunk_final_sigmoid: bool = True
    density_head_sigmoid: bool = True
    # Quirk-exact ablation flag (default OFF even in parity presets): the
    # reference's inverse-CDF draw is ``u = 2u + noise`` (ray.py:33, a typo
    # for stratified u + noise) which clamps ~half the fine samples into the
    # last CDF interval. Used by tools/parity_psnr.py --mode ablate to
    # attribute the equal-iteration train-PSNR gap.
    resample_u_typo: bool = False
    compute_dtype: str = "bfloat16"  # matmul dtype; params/accumulation stay f32
    # Kept for config.json compatibility with the JAX package. In this port
    # the composite dispatch goes by the tensor's device: a CUDA tensor
    # takes the hand-written Hopper kernel (ops/composite.py) and a CPU
    # tensor the plain PyTorch version. "auto" and "on" do exactly that;
    # "off" with a CUDA tensor raises (there is no plain path on the card).
    use_pallas: str = "auto"
    # Rematerialize the NeRF tower in backward (trade ~1/3 more FLOPs for
    # O(depth) less activation memory -> much larger ray batches per chip).
    remat: bool = False
    # Factored frustum->IPE encode (core/fused_encode.py): exploits the rank-1
    # structure of the lifted covariance and contraction Jacobian to skip all
    # [B, N, 3, 3] tensors. Numerically equivalent to the general path
    # (tests/test_fused_encode.py); "off" falls back to cast_rays + IPE.
    factored_encode: bool = True
    # Sample-axis (CP) compositing in render_image: shard the NeRF level's
    # samples-per-ray axis over this many devices on the mesh "model" axis
    # (parallel/sample_axis.py — exact cross-shard transmittance via
    # all_gather + psum). 1 = off (the default and the right answer at sane
    # sample counts: tools/sample_axis_bench.py measures the crossover).
    # Intended for huge samples-per-ray render tiles (SURVEY §2.2).
    sample_shards: int = 1

    # Zero-pad the encoded input features (and the first-layer weight rows)
    # up to the next multiple of 128 — the TPU lane width — so the first
    # matmul's contraction dim is tile-aligned (e.g. the quality model's
    # 226-wide encoding -> 256). Function-preserving: pad features are zero,
    # pad weight rows start at zero and receive zero gradient. Whether this
    # beats XLA's own internal padding is an empirical question per shape;
    # see DESIGN.md §7c for the measured verdict.
    pad_input_lanes: bool = False

    @property
    def input_dim(self) -> int:
        # 21*2 IPE features per scale + 4 viewdir scales * 2 angles * 2
        # (sin,cos); reference hardcodes 58 at model.py:39,127 (one IPE
        # scale).
        return (42 * (self.ipe_max_deg - self.ipe_min_deg)
                + 4 * (self.viewdir_max_deg - self.viewdir_min_deg))

    @property
    def padded_input_dim(self) -> int:
        """First-matmul fan-in: input_dim rounded up to a lane multiple when
        ``pad_input_lanes`` is set, else input_dim itself."""
        d = self.input_dim
        return -(-d // 128) * 128 if self.pad_input_lanes else d


@dataclass(frozen=True)
class TrainConfig:
    max_steps: int = 200_000
    batch_size: int = 64             # rays per step (reference config.py:41)
    lr_init: float = 2e-3
    lr_final: float = 2e-5
    lr_delay_steps: int = 2500
    lr_delay_mult: float = 0.1
    # LR-decay horizon in schedule counts; 0 = follow max_steps. The trainer
    # resolves 0 to a concrete value at train start and persists it in the
    # checkpoint's config.json, so `--resume --set train.max_steps=N`
    # EXTENDS training on the ORIGINAL decay schedule instead of re-mapping
    # (and re-inflating) the LR onto the longer horizon.
    lr_max_steps: int = 0
    weight_decay: float = 1e-5
    # Distortion-regularizer strength + reduction. The reference uses
    # 0.01 x SUM over its fixed 64-ray batch (config.py:32, train.py:77);
    # because the photometric term (30 - PSNR) is batch-size-invariant, that
    # sum makes the regularizer batch/64 times stronger at other batch sizes.
    # Default: per-ray MEAN with weight 0.64 = 0.01 * 64 — identical total
    # loss at the reference's operating point, invariant everywhere else.
    # Strict parity: dist_loss_weight=0.01, dist_loss_reduction="sum".
    dist_loss_weight: float = 0.64
    dist_loss_reduction: str = "mean"  # "mean" | "sum"
    # Training cadence. "reference": 2 inner proposal updates + 1 nerf update
    # per global step, scheduler stepped 3x (train.py:51-82). "joint": one
    # fused update of all losses per step (the paper's cadence; ~3x faster).
    cadence: str = "joint"
    prop_inner_steps: int = 2
    # Quirk-exact ablation flag: reproduce the reference's batch-collapsed
    # distillation bound (distillation.py:27-29 — boolean-mask indexing
    # flattens batch+sample dims, so each bound becomes the SUM of all rays'
    # per-ray bounds, broadcast back to every ray). Default OFF: the per-ray
    # bound is the intended semantics.
    quirk_collapsed_bounds: bool = False
    randomized: bool = True
    seed: int = 0
    save_every: int = 1000
    eval_every: int = 100
    # Full held-out-image eval during training: every N steps render test
    # views and log eval/psnr_image + eval/ssim (MEAN over the rendered
    # views). 0 = off. This goes beyond the reference, whose in-training
    # eval is a single random 64-ray batch (train.py:106-116) — kept as
    # eval_every for cadence parity.
    eval_image_every: int = 0
    # How many test views per eval-image boundary: -1 = ALL views (the
    # claim-grade mean); k >= 1 = a FIXED window of the first k views
    # (cheaper for large test splits; fixed so the mean stays comparable
    # across boundaries).
    eval_image_views: int = -1
    eval_image_chunk: int = 8192
    # Retain the best-mean-eval checkpoint as ckpt_best.msgpack (never
    # pruned) whenever eval/psnr_image improves; restore with step="best".
    keep_best: bool = True
    log_every: int = 20
    checkpoint_dir: str = "ckpt"
    keep_checkpoints: int = 3
    # Dump a jax.profiler trace of steps [profile_start, profile_start+5)
    # into <profile_dir> (view with TensorBoard's profile plugin).
    profile_dir: str = ""
    profile_start: int = 10
    # Background double-buffered batch staging (train/trainer.py
    # BackgroundStager): the native-sampler gather + host->device upload run
    # on a worker thread ahead of the loop, overlapping device compute and
    # the main thread's log-boundary sync. False = inline staging on the
    # main thread (identical batches; the index stream is stateless).
    async_staging: bool = True
    # What crosses the host->device boundary per chunk:
    #   "device_bank": upload the whole flattened dataset REPLICATED into
    #     HBM once; per chunk ship only [K, B] int32 indices and gather on
    #     device inside the scanned loop (~15x fewer staged bytes, zero
    #     host gather work).
    #   "host": native-sampler host gather + [K, B, c] f32 upload per chunk
    #     (the pre-r5 path; required when the dataset exceeds HBM).
    #   "auto" (default): device_bank while the bank fits the byte budget
    #     (train/trainer.py _BANK_AUTO_BYTES), else host.
    # Batch selection is bit-identical across modes (stateless index stream).
    stage_mode: str = "auto"
    # Guard training state/metrics for NaN/Inf at every log boundary and abort
    # with the offending param paths (utils/checks.py). Cheap on-device
    # reduction; off by default for the hot loop.
    check_nans: bool = False


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"       # blender | llff | nerf_360 | synthetic
    base_dir: str = ""
    scene: str = "lego"
    factor: int = 2
    near: float = 2.0
    far: float = 6.0
    # LLFF only. True mirrors the reference, which hard-wires NDC projection
    # for every LLFF scene (dataset.py:364-387, near=0/far=1). False keeps
    # METRIC-space rays and derives near/far from the scene's poses_bounds
    # depth bounds (near = 0.9*bds.min, far = bds.max, the standard no-NDC
    # LLFF operating point) — the "NDC-free contract() parameterization"
    # benchmark config (BASELINE.json configs[2]): contract() then handles
    # the unbounded far field on real metric geometry.
    use_ndc: bool = True
    # synthetic (procedural) scene controls — used when no data is on disk
    synthetic_resolution: int = 64
    synthetic_views: int = 16
    # Render-split (video path) controls for blender/synthetic scenes —
    # counterpart of the reference's NeRFDataset ctor args (dataset.py:39)
    # and generate_render_poses (dataset.py:75-89): a synthesized camera
    # path, spiral (spherify=False) or spherical (spherify=True), rendered
    # at a fixed resolution/focal independent of the training images.
    # LLFF/nerf_360 use only n_render_poses of these (their path SHAPE is
    # fit to the scene's recentered training poses, data/llff.py; the
    # spherify choice comes from the dataset family, not render_spherify).
    n_render_poses: int = 120
    render_spherify: bool = False
    render_radius: float = 4.0       # spherical-path orbit radius
    render_radii: float = 1.0        # spiral-path radii (broadcast to xyz)
    render_h: int = 800
    render_w: int = 800
    render_focal: float = 1200.0


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. data*model must divide the device count at runtime."""
    data: int = -1                   # -1: all devices on the data axis
    model: int = 1


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    preset: str = ""

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)
        return Config(
            model=ModelConfig(**d["model"]),
            train=TrainConfig(**d["train"]),
            data=DataConfig(**d["data"]),
            mesh=MeshConfig(**d.get("mesh", {})),
            preset=d.get("preset", ""),
        )


def _replace(cfg: Config, **groups) -> Config:
    out = cfg
    for name, overrides in groups.items():
        group = dataclasses.replace(getattr(out, name), **overrides)
        out = dataclasses.replace(out, **{name: group})
    return out


# --- Quality overrides (the proven-converging operating point) ------------
#
# The parity-default ModelConfig reproduces the reference's quirks, and the
# reference's own README admits that family does not converge (README.md:9).
# Measured root causes (tools/parity_psnr.py, PARITY_PSNR.json "convergence"):
# the density-head sigmoid caps density at softplus(sigmoid(x)+bias) <= 0.69
# so surfaces can never go opaque; the trunk-final sigmoid squashes features;
# single-scale IPE caps spatial frequency. The quality overrides disable all
# three quirks and restore the paper-faithful model; with a LINEAR density
# head, training must then start from low density (density_bias=-5) with a
# strong warmup (lr_delay_mult=0.01, multinerf's value) or a mostly-background
# first batch drives alpha to underflow and the model goes dead.
QUALITY_MODEL = dict(density_head_sigmoid=False, trunk_final_sigmoid=False,
                     ipe_max_deg=5, density_bias=-5.0)
QUALITY_TRAIN = dict(lr_delay_mult=0.01)


# --- Named presets (BASELINE.json "configs") ------------------------------

def tiny_lego() -> Config:
    """blender/lego single-scale, tiny MLP, 64 samples/ray, low-res, CPU-runnable."""
    cfg = Config(preset="tiny_lego")
    cfg = _replace(
        cfg,
        model=dict(hidden_proposal=64, hidden_nerf=128, nerf_depth=4,
                   white_bkgd=True, compute_dtype="float32"),
        train=dict(max_steps=200, batch_size=256, lr_delay_steps=20),
        data=dict(dataset="blender", scene="lego", factor=8),
    )
    return cfg


def blender_lego() -> Config:
    """blender/lego full Mip-NeRF IPE with hierarchical coarse/fine sampling."""
    cfg = Config(preset="blender_lego")
    return _replace(
        cfg,
        model=dict(white_bkgd=True),
        data=dict(dataset="blender", scene="lego", factor=2, near=2.0, far=6.0),
    )


def llff_fern() -> Config:
    """LLFF forward-facing fern with contract() parameterization."""
    cfg = Config(preset="llff_fern")
    return _replace(
        cfg,
        model=dict(white_bkgd=False, ray_shape="cylinder"),
        data=dict(dataset="llff", scene="fern", factor=8, near=0.0, far=1.0),
    )


def llff_fern_contract() -> Config:
    """LLFF fern, NDC-free contract() parameterization (BASELINE configs[2]).

    Metric-space rays with near/far from poses_bounds.npy; contract() handles
    the far field. Parity model; the converging operating point is
    ``llff_fern_quality``."""
    cfg = llff_fern()
    cfg = dataclasses.replace(cfg, preset="llff_fern_contract")
    return _replace(cfg, data=dict(use_ndc=False))


def garden() -> Config:
    """nerf_360 garden: proposal distillation + distortion regularization."""
    cfg = Config(preset="garden")
    return _replace(
        cfg,
        model=dict(white_bkgd=False, ray_shape="cylinder"),
        train=dict(max_steps=10_000),
        data=dict(dataset="nerf_360", scene="garden", factor=8, near=0.0, far=1.0),
    )


def bicycle_multihost() -> Config:
    """nerf_360 bicycle full-res multi-host: sharded ray batches, video render."""
    cfg = Config(preset="bicycle_multihost")
    return _replace(
        cfg,
        model=dict(white_bkgd=False, ray_shape="cylinder"),
        train=dict(max_steps=10_000, batch_size=4096),
        data=dict(dataset="nerf_360", scene="bicycle", factor=4, near=0.0, far=1.0),
        mesh=dict(data=-1, model=1),
    )


def bicycle_multihost_quality() -> Config:
    """nerf_360 bicycle multi-host at the converging operating point.

    The flagship multi-host + video-render regime (BASELINE configs[4];
    reference demo/demo_360.sh:1-8 and config.py:64-74 define the nerf_360
    defaults it inherits: cylinder rays, black background) with the
    QUALITY_MODEL/QUALITY_TRAIN overrides — ``bicycle_multihost`` ships the
    reference-parity model, which the parity record proves cannot converge
    (README.md:9; PARITY_PSNR.json "convergence"). Mesh/batch shape is
    exercised in the JAX package's dry run (__graft_entry__.py); live stand-in
    convergence + video render recorded in PRESET_VALIDATION_r5.json."""
    cfg = bicycle_multihost()
    cfg = dataclasses.replace(cfg, preset="bicycle_multihost_quality")
    # use_ndc=False: the parity preset inherits the reference's quirk of
    # pushing inward-facing 360 rays through the forward-facing NDC
    # projection (its LLFF loader is NDC-only, dataset.py:364-387 — sideways
    # rays divide by dz ~ 0). The CONVERGING operating point uses the
    # paper's 360 regime instead: metric rays with near/far from
    # poses_bounds and contract() handling the far field (llff.py:151-159).
    return _replace(cfg, model=dict(QUALITY_MODEL, white_bkgd=False,
                                    ray_shape="cylinder"),
                    train=dict(QUALITY_TRAIN, eval_image_every=1000,
                               eval_image_views=4),
                    data=dict(use_ndc=False))


def garden_quality() -> Config:
    """nerf_360 garden at the paper-faithful (converging) operating point.

    Same scene/schedule as ``garden`` but with the QUALITY_MODEL/QUALITY_TRAIN
    overrides — the configuration PARITY_PSNR.json "convergence" proves
    converges (the parity presets deliberately reproduce the reference's
    quirks, including its README.md:9 non-convergence)."""
    cfg = garden()
    cfg = dataclasses.replace(cfg, preset="garden_quality")
    # eval_image_every + keep_best so `apps.eval --step best` (demo_360.sh)
    # has a best-eval checkpoint; 4 fixed views bounds the eval cost on the
    # real scene's large test split.
    #
    # use_ndc=False (r5): the parity `garden` preset keeps the reference's
    # quirk of pushing inward-facing 360 rays through the forward-facing NDC
    # projection (dataset.py:364-387). MEASURED on the 360 stand-in scene
    # the quirk NaNs the quality model within 2k steps (sideways rays divide
    # by dz~0; PRESET_VALIDATION_r5.json "garden_quality_ndc_ablation") —
    # the converging preset uses the paper's regime: metric near/far from
    # poses_bounds + contract() (llff.py:151-159), like
    # bicycle_multihost_quality.
    return _replace(cfg, model=dict(QUALITY_MODEL, white_bkgd=False),
                    train=dict(QUALITY_TRAIN, batch_size=4096,
                               eval_image_every=1000, eval_image_views=4),
                    data=dict(use_ndc=False))


def blender_lego_quality() -> Config:
    """blender/lego at the paper-faithful (converging) operating point.

    QUALITY_MODEL with white_bkgd (the blender regime); convergence of this
    white-background quality model is evidenced on the procedural white-bkgd
    stand-in (PRESET_VALIDATION artifacts) since no real dataset ships in
    this environment."""
    cfg = blender_lego()
    cfg = dataclasses.replace(cfg, preset="blender_lego_quality")
    return _replace(cfg, model=dict(QUALITY_MODEL, white_bkgd=True),
                    train=dict(QUALITY_TRAIN, max_steps=10_000,
                               batch_size=4096, eval_image_every=1000,
                               eval_image_views=4))


def llff_fern_quality() -> Config:
    """LLFF fern, NDC-free contract() + quality model (converging preset).

    The NDC-free metric parameterization (see ``llff_fern_contract``) with
    the QUALITY_MODEL overrides — the converging operating point for
    BASELINE configs[2]."""
    cfg = llff_fern_contract()
    cfg = dataclasses.replace(cfg, preset="llff_fern_quality")
    return _replace(cfg, model=dict(QUALITY_MODEL, white_bkgd=False,
                                    ray_shape="cylinder"),
                    train=dict(QUALITY_TRAIN, max_steps=10_000,
                               batch_size=4096, eval_image_every=1000,
                               eval_image_views=4))


def synthetic_quality() -> Config:
    """Dataset-free convergence demo: quality model on the procedural scene.

    The flagship operating point of PARITY_PSNR.json "convergence" (joint
    cadence, batch 4096, 10k steps) on the built-in analytic sphere scene —
    runs with no data on disk and reaches ~27-29 dB held-out image PSNR."""
    cfg = Config(preset="synthetic_quality")
    return _replace(
        cfg,
        model=dict(QUALITY_MODEL, white_bkgd=True),
        train=dict(QUALITY_TRAIN, max_steps=10_000, batch_size=4096,
                   cadence="joint", save_every=1000, eval_every=100,
                   eval_image_every=100, log_every=20),
        data=dict(dataset="synthetic", synthetic_resolution=64,
                  synthetic_views=28, near=2.0, far=6.0),
    )


PRESETS = {
    "tiny_lego": tiny_lego,
    "blender_lego": blender_lego,
    "blender_lego_quality": blender_lego_quality,
    "llff_fern": llff_fern,
    "llff_fern_contract": llff_fern_contract,
    "llff_fern_quality": llff_fern_quality,
    "garden": garden,
    "garden_quality": garden_quality,
    "synthetic_quality": synthetic_quality,
    "bicycle_multihost": bicycle_multihost,
    "bicycle_multihost_quality": bicycle_multihost_quality,
}


def get_config(preset: str = "", **overrides) -> Config:
    cfg = PRESETS[preset]() if preset else Config()
    if overrides:
        cfg = _replace(cfg, **overrides)
    return cfg
