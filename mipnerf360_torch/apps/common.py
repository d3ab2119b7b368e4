"""Shared CLI plumbing for the apps (a copy of
``mipnerf360_tpu/apps/common.py`` with ``--device``).

Preset selection + typed dotted overrides, e.g.:

    python -m mipnerf360_torch.apps.train --preset synthetic_quality \
        --set train.batch_size=4096 --set model.num_samples=64

``--device`` (default ``cuda``) is where the app runs; ``--device cpu`` runs
it on the CPU. Launched under torchrun with more than one rank, eval and
video render data-parallel (:func:`render_setup`).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os

from ..config import Config, PRESETS, get_config
from ..core.rays import resolve_device
from ..parallel.mesh import default_render_mesh, init_distributed, shutdown


def add_config_args(ap: argparse.ArgumentParser):
    ap.add_argument("--preset", default="",
                    choices=[""] + sorted(PRESETS.keys()))
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="dotted config override, e.g. train.batch_size=1024")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; cpu for the CPU)")


def _coerce(current, raw: str):
    t = type(current)
    if t is bool:
        # Strict parse: a typo'd boolean must not silently become False
        # (the numeric path already dies on unparseable input).
        s = raw.strip().lower()
        if s in ("1", "true", "yes"):
            return True
        if s in ("0", "false", "no"):
            return False
        raise ValueError(f"cannot parse {raw!r} as bool "
                         "(use true/false, yes/no, or 1/0)")
    return t(raw) if current is not None else raw


def apply_overrides(cfg: Config, sets) -> Config:
    """Apply dotted K=V overrides with actionable error messages."""
    groups = {}
    for kv in sets:
        key, eq, raw = kv.partition("=")
        if not eq:
            raise SystemExit(f"--set {kv!r}: expected K=V (e.g. train.batch_size=1024)")
        group_name, dot, field_name = key.partition(".")
        if not dot or not hasattr(cfg, group_name):
            valid = ", ".join(f.name for f in dataclasses.fields(cfg)
                              if dataclasses.is_dataclass(getattr(cfg, f.name)))
            raise SystemExit(f"--set {key!r}: unknown group {group_name!r} "
                             f"(valid groups: {valid})")
        group = getattr(cfg, group_name)
        if not hasattr(group, field_name):
            valid = ", ".join(f.name for f in dataclasses.fields(group))
            raise SystemExit(f"--set {key!r}: unknown field {field_name!r} "
                             f"in {group_name} (valid: {valid})")
        current = getattr(group, field_name)
        try:
            value = _coerce(current, raw)
        except ValueError:
            raise SystemExit(
                f"--set {key}={raw!r}: cannot parse as {type(current).__name__}")
        groups.setdefault(group_name, {})[field_name] = value
    for name, overrides in groups.items():
        updated = dataclasses.replace(getattr(cfg, name), **overrides)
        cfg = dataclasses.replace(cfg, **{name: updated})
    return cfg


def config_from_args(args, ckpt_dir: str = "") -> Config:
    """Resolve a Config.

    Without a checkpoint: preset -> CLI --set overrides.

    With a checkpoint (``--resume``): the saved config.json is AUTHORITATIVE —
    it already embeds whatever preset and --set overrides produced the run, so
    replacing it with a freshly-built preset would silently drop the original
    model.* overrides (shape-mismatch crash on restore at best, silent config
    divergence at worst). ``--preset`` alongside a checkpoint is only accepted
    when it matches the saved preset (the documented `--resume --preset X`
    flow); a different preset is an error rather than a footgun. CLI --set
    overrides still apply on top (highest precedence)."""
    import os

    cfg = None
    if ckpt_dir:
        cfg_path = os.path.join(ckpt_dir, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = Config.from_json(f.read())
    if cfg is None:
        cfg = get_config(args.preset)
    elif args.preset and args.preset != cfg.preset:
        raise SystemExit(
            f"--preset {args.preset!r} conflicts with the checkpoint's saved "
            f"config (preset {cfg.preset!r}). On resume the saved config is "
            "authoritative; drop --preset or use --set for deliberate "
            "overrides.")
    return apply_overrides(cfg, args.set)


@contextlib.contextmanager
def render_setup(args, cfg: Config):
    """(device, mesh) for the render apps. Under torchrun with a world size
    above 1 the process joins the group (NCCL on the card, gloo on the CPU)
    and renders on ``default_render_mesh`` (all ranks on the data axis, or
    ``cfg.model.sample_shards`` on the model axis), and leaves the group on
    exit; otherwise ``args.device`` and no mesh."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        yield resolve_device(args.device), None
        return
    device = init_distributed(args.device)
    try:
        yield device, default_render_mesh(cfg.model.sample_shards, device)
    finally:
        shutdown()
